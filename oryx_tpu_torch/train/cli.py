"""Training entry point (port of `oryx_tpu.train.cli`):

    python -m oryx_tpu_torch.train.cli --config cfg.json --data data.json \
        --tokenizer-path TOKENIZER_DIR [--device cpu] ...

One process on one device (the card unless `--device cpu`): the records of
`--data` (the LLaVA-mix conversation schema, media under `--media-root`:
images, and videos as directories of frames) through
`train/data.grouped_batch_iterator` at the config's global batch size into
`Trainer.fit`, with the JAX CLI's options for the metric stream, the
telemetry exporter, the anomaly policy and the numerics probes.
`--output-dir` writes the trained weights (not the optimizer state, which
the config's checkpoint_dir holds) as a `save_pretrained` directory.

The weights start from `--init-from` (a `save_pretrained` directory), else
from `--hf-llm` with `--hf-vision` (and a `--projector` npz), else from the
Trainer's seeded random init. The tokenizer comes from
`serve/builder.load_tokenizer`. `$ORYX_FAULTS` arms the trainer's fault
points (utils/faults.py).

Multi-process training: `--coordinator HOST:PORT --num-processes N
--process-id I`, one command a process, each started on its own. They meet
through `parallel/mesh.initialize_distributed` (gloo when the processes
share a card or run on the CPU, NCCL with a card each: process I on
cuda:(I % device_count)) and form one world of ranks (parallel/tp.adopt).
Process 0 is the controller: it reads the records, runs the Trainer over
cfg.mesh (which must have N devices) and sends each step's whole batch to
every rank, each rank taking its share (parallel/zero.py), so the numbers
are the one-process fit's over the same global batch. The other processes
are followers: they serve process 0's dispatches and return None when it
is done.
"""

from __future__ import annotations

import argparse
import dataclasses

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.data import media
from oryx_tpu_torch.models import splice
from oryx_tpu_torch.serve import builder
from oryx_tpu_torch.train import data as data_lib
from oryx_tpu_torch.train.trainer import SHARDING_MODES, Trainer
from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils.metrics import rank0_print


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Oryx SFT (PyTorch/CUDA port)")
    ap.add_argument("--config", required=True, help="OryxConfig json file")
    ap.add_argument("--data", required=True,
                    help="conversation-records json (LLaVA-mix schema)")
    ap.add_argument("--media-root", default="")
    ap.add_argument("--tokenizer-path", required=True)
    ap.add_argument("--template", default="qwen")
    ap.add_argument("--output-dir", default=None,
                    help="save a loadable model dir here at the end")
    ap.add_argument("--init-from", default=None,
                    help="save_pretrained model dir to start from (else "
                    "random init)")
    ap.add_argument("--hf-llm", default=None,
                    help="HF safetensors dir for the LLM backbone")
    ap.add_argument("--hf-vision", default=None,
                    help="HF safetensors dir for the vision tower")
    ap.add_argument("--projector", default=None,
                    help="projector-only npz (stage-1 checkpoint)")
    ap.add_argument("--sharding", default="fsdp",
                    choices=list(SHARDING_MODES))
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--tensorboard-dir", default=None,
                    help="also report metrics as TensorBoard scalars")
    ap.add_argument(
        "--metrics-port", type=int, default=None,
        help="serve oryx_train_* Prometheus metrics + /healthz + /readyz "
        "on this port (0 = ephemeral port)",
    )
    ap.add_argument(
        "--events-path", default=None,
        help="append structured anomaly events (NaN loss, loss spike, "
        "grad explosion, throughput collapse) as JSONL here",
    )
    ap.add_argument(
        "--on-anomaly", choices=["warn", "halt"], default="warn",
        help="anomaly policy: 'warn' logs + counts and keeps training; "
        "'halt' raises out of the step loop",
    )
    ap.add_argument(
        "--numerics-every", type=int, default=0, metavar="N",
        help="every N steps the step runs its numerics probes (per-layer "
        "grad absmax, activation/param absmax -> oryx_numerics_* gauges + "
        "the absmax_explosion sentinel); 0 = off",
    )
    ap.add_argument("--num-steps", type=int, default=None)
    ap.add_argument("--video-frames", type=int, default=64)
    # Multi-process rendezvous (all three, or none).
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0's rendezvous")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda, or cpu)")
    return ap


def load_params(args, cfg: OryxConfig):
    """The initial model: a save_pretrained dir > the HF backbone and tower
    (with the projector npz) > None (the Trainer's random init)."""
    if args.init_from:
        _, params, _ = builder.load_pretrained_model(
            args.init_from, tokenizer=object(), cfg=cfg, device=args.device
        )
        return params
    if args.hf_llm and args.hf_vision:
        _, params, _ = builder.load_from_hf(
            args.hf_llm, args.hf_vision, cfg, projector_path=args.projector,
            tokenizer=object(), device=args.device,
        )
        return params
    return None


def join_world(args):
    """Meet the other processes (`--coordinator` and the rest): the world
    this process is a rank of, or None without the flags."""
    flags = (args.coordinator, args.num_processes, args.process_id)
    if all(f is None for f in flags):
        return None
    if any(f is None for f in flags):
        raise ValueError("--coordinator, --num-processes and --process-id "
                         "go together")
    import torch

    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.parallel import tp as tp_lib

    devices = tp_lib.default_devices(args.num_processes, args.device)
    mine = devices[args.process_id]
    if mine.type == "cuda":
        torch.cuda.set_device(mine)
    mesh_lib.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        backend=tp_lib.choose_backend(devices))
    return tp_lib.adopt(devices, tag=args.coordinator)


def main(argv: list[str] | None = None) -> Trainer | None:
    """Train as the arguments say; returns the Trainer, not closed, so its
    telemetry server answers until the caller closes it (None on a
    follower process of a multi-process run, once process 0 is done)."""
    args = build_argparser().parse_args(argv)
    if faults.configure_from_env():
        # Chaos testing only, never a production config.
        rank0_print("fault injection armed from $ORYX_FAULTS")
    world = join_world(args)
    if world is not None and not world.controller:
        world.follow()
        return None

    with open(args.config) as f:
        cfg = OryxConfig.from_json(f.read())
    if args.num_steps:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(
                cfg.train, num_train_steps=args.num_steps
            )
        )

    tokenizer = builder.load_tokenizer(args.tokenizer_path)

    def media_loader(rec):
        frames, _ = media.load_record_media(
            rec, media_root=args.media_root, num_frames=args.video_frames
        )
        return frames

    dataset = data_lib.SupervisedDataset(
        args.data, tokenizer,
        template=args.template,
        patch_size=cfg.vision.patch_size,
        max_patches_per_image=cfg.vision.max_patches_per_image,
        video_frames=args.video_frames,
        media_loader=media_loader,
    )
    rank0_print(f"dataset: {len(dataset)} records")
    batches = data_lib.grouped_batch_iterator(
        dataset,
        cfg.train.global_batch_size,
        seed=cfg.train.seed,
        grad_accum_steps=cfg.train.grad_accum_steps,
        length_group_size=cfg.train.length_group_size,
        patch_size=cfg.vision.patch_size,
        base_grid=cfg.vision.base_grid,
        max_len=cfg.train.max_seq_len,
        frame_separator_ids=splice.frame_separator_ids(
            tokenizer, cfg.frame_separator
        ),
    )

    trainer = Trainer(
        cfg,
        params=load_params(args, cfg),
        device=args.device,
        sharding_mode=args.sharding,
        metrics_path=args.metrics_path,
        tensorboard_dir=args.tensorboard_dir,
        metrics_port=args.metrics_port,
        events_path=args.events_path,
        on_anomaly=args.on_anomaly,
        numerics_every=args.numerics_every,
    )
    if trainer.telemetry is not None and trainer.telemetry.port is not None:
        rank0_print(
            f"telemetry: http://127.0.0.1:{trainer.telemetry.port}/metrics"
        )
    state = trainer.fit(batches)

    if args.output_dir:
        # Weights only: the optimizer moments are 2/3 of a state's bytes,
        # and cfg.train.checkpoint_dir already holds the resumable state.
        model = state.params
        if trainer.world is not None:
            from oryx_tpu_torch.parallel.sharding import frozen_model

            model = frozen_model(cfg, trainer.full_params())
        builder.save_pretrained(args.output_dir, cfg, model,
                                step=state.step)
        rank0_print(f"saved model to {args.output_dir}")
    return trainer


if __name__ == "__main__":
    main()
