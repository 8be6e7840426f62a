"""SFT trainer: state, step loop, checkpoint/resume, telemetry (port of
`oryx_tpu.train.trainer`).

The mesh is cfg.mesh, over the ranks the caller provides: the running
world's (parallel/tp.py), or `devices=`, or the Trainer's one device. As
JAX's `build_mesh`, a mesh whose size is not the number of devices raises
("mesh 1x16x1x1=16 != 1 devices"). A one-device mesh is the one-device
path below. A wider one (dp x fsdp x sp ranks; tp is not trained) runs
each step on every rank through the ZeRO stages of parallel/zero.py: rank
0 (this process) owns the loop, the logging and the telemetry, each rank
its shards; `full_params()` gathers the trained leaves, `rank_reports()`
lists what each rank holds.

`Trainer(cfg, params=..., device=...)` takes ownership of `params` (an
`OryxModel`; a random init from cfg.train.seed when None): with
cfg.train.lora.enable it attaches LoRA adapters (seed + 1) unless the model
carries them already, then trainable leaves become fp32 masters and frozen
leaves are held in the compute dtype, in place, and every step updates the
parameters in place. `fit` keeps the JAX loop's order: data -> batch check
-> host-to-device -> step -> one sync for the metrics -> log -> checkpoint
-> telemetry, with the `max_consecutive_skipped` abort and a final save.
Each step's record in `history` carries its model FLOPs (utils/flops.py)
and, on a card whose peak is known, its MFU over the step's wall.

Observability, as JAX's options give it:
  * every step is one `train_step` trace in the flight recorder (`tracer`,
    `flight_recorder_size`) with the spans data, h2d, step_dispatch,
    device_sync and checkpoint_save; `data_s`, `dispatch_s` and `sync_s`
    in the logged record and in `history` are those spans' seconds;
  * `stall_timeout` arms a `StallWatchdog` that dumps the thread stacks and
    the recorder's tail when no step completes in time;
  * `numerics_every=N` runs `train_step(numerics=True)` every N steps and
    publishes the probes (train/telemetry.py `record_numerics`);
  * a `TrainTelemetry` (/metrics, /healthz, /readyz and the anomaly
    monitor) is built when `metrics_port`, `events_path` or
    on_anomaly="halt" asks for one, or passed in as `telemetry`; under
    "halt" an anomaly raises `AnomalyHalt` out of `fit`;
  * `tensorboard_dir`: the logged records as TensorBoard scalars.
`sharding_mode` ("fsdp", "zero2", "ddp") places the state over the mesh
(parallel/zero.py); on one device the three compute the same step, as
JAX's do on a one-device mesh.

Fault containment (utils/faults.py sites): a loader exception at
`data_loader_next` skips to the next batch (`max_data_faults` consecutive
ones abort), `data_loader_next:corrupt=1` poisons one float field with NaN
for the non-finite guard to skip, `trainer_crash` ends fit at the top of a
step (a fresh Trainer resumes from the last checkpoint), and checkpoint
saves retry (utils/checkpoint.py).
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import oryx
from oryx_tpu_torch.models.params import resolve_device
from oryx_tpu_torch.parallel import mesh as mesh_lib
from oryx_tpu_torch.parallel import tp as tp_lib
from oryx_tpu_torch.parallel import zero as zero_lib
from oryx_tpu_torch.train import step as step_lib
from oryx_tpu_torch.train import telemetry as telemetry_lib
from oryx_tpu_torch.train.data import PrefetchIterator
from oryx_tpu_torch.train.optimizer import make_optimizer, make_schedule
from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils import flops as flops_lib
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils.anomaly import AnomalyThresholds
from oryx_tpu_torch.utils.checkpoint import CheckpointManager
from oryx_tpu_torch.utils.metrics import MetricLogger, rank0_print

SHARDING_MODES = ("fsdp", "zero2", "ddp")


def validate_train_batch(cfg: OryxConfig, batch: dict) -> None:
    """Fail fast on config x data combinations that would train silently
    wrong: packed text under ring attention, which has no segment support
    (samples packed into one row would attend across sample boundaries)."""
    if "text_segment_ids" in batch and cfg.attn_impl.startswith("ring"):
        raise ValueError(
            f"packed-text batches (text_segment_ids) cannot train under "
            f"attn_impl={cfg.attn_impl!r}: ring attention has no "
            "segment support, so packed samples would attend across "
            "sample boundaries. Use attn_impl='xla'|'pallas' (sp=1) "
            "or disable text packing (see docs/MIGRATING.md)."
        )


def _poison_one_float_leaf(batch: dict) -> dict:
    """`data_loader_next:corrupt=1`: NaN one element of the first floating
    field, as a corrupt record would; the non-finite guard should skip the
    step, not crash the run."""
    batch = dict(batch)
    for k, v in batch.items():
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating) and arr.size:
            bad = arr.copy()
            bad.flat[0] = np.nan
            batch[k] = bad
            rank0_print(f"fault injection: poisoned batch field {k!r}")
            break
    return batch


def setup_lora(cfg: OryxConfig, params: oryx.OryxModel) -> oryx.OryxModel:
    """The JAX Trainer's LoRA set-up and refusals: tune='lora' needs
    lora.enable and lora.enable needs targets; a model without adapters
    gets them (drawn from seed + 1 on its device), one that carries them
    must carry them on exactly the configured targets."""
    lora = cfg.train.lora
    if cfg.train.tune == "lora" and not lora.enable:
        raise ValueError(
            "tune='lora' requires train.lora.enable=True (otherwise "
            "no adapters exist and only the projector would train)"
        )
    if not lora.enable:
        return params
    if not lora.targets:
        raise ValueError("lora.enable with empty lora.targets")
    layer = params.llm.layers[0]
    have = [t for t in lora.targets
            if "lora_a" in getattr(getattr(layer, t, None), "_parameters",
                                   {})]
    if not have:
        dev = params.llm.final_norm.weight.device
        gen = torch.Generator(dev).manual_seed(cfg.train.seed + 1)
        return oryx.enable_lora(params, cfg, gen)
    if set(have) != set(lora.targets):
        raise ValueError(
            f"params carry adapters on {sorted(have)} but "
            f"config targets {sorted(lora.targets)} "
            f"- refusing to train a silently narrower adapter"
        )
    return params


@torch.no_grad()
def prepare_params(model: torch.nn.Module, mask: dict[str, bool],
                   compute_dtype: torch.dtype) -> torch.nn.Module:
    """In place: trainable leaves (mask True) to fp32 masters, frozen ones
    to the compute dtype, and every leaf requires grad (the step takes the
    gradient of all of them for grad_norm)."""
    for name, p in model.named_parameters():
        want = torch.float32 if mask[name] else compute_dtype
        if p.dtype != want:
            p.data = p.data.to(want)
    return model.requires_grad_(True)


class Trainer:
    def __init__(
        self,
        cfg: OryxConfig,
        *,
        params: oryx.OryxModel | None = None,
        device="cuda",
        devices=None,
        sharding_mode: str = "fsdp",
        metrics_path: str | None = None,
        tensorboard_dir: str | None = None,
        tracer: trace_lib.Tracer | None = None,
        flight_recorder_size: int = 64,
        stall_timeout: float | None = None,
        metrics_port: int | None = None,
        events_path: str | None = None,
        on_anomaly: str = "warn",
        anomaly_thresholds: AnomalyThresholds | None = None,
        telemetry: telemetry_lib.TrainTelemetry | None = None,
        max_data_faults: int = 8,
        numerics_every: int = 0,
    ) -> None:
        self.cfg = cfg
        if not isinstance(numerics_every, int) or numerics_every < 0:
            raise ValueError(
                "numerics_every must be a non-negative integer (steps "
                f"between probe samples; 0 = off), got {numerics_every!r}"
            )
        if sharding_mode not in SHARDING_MODES:
            raise ValueError(
                f"sharding_mode={sharding_mode!r}: one of {SHARDING_MODES}")
        self.numerics_every = numerics_every
        self.sharding_mode = sharding_mode
        # A transient loader exception skips to the next batch; this many
        # in a row abort. `data_faults` counts the recoveries.
        self.max_data_faults = max_data_faults
        self.data_faults = 0
        self.device = resolve_device(device)
        # The mesh over the caller's ranks (None: one device).
        self.world = self.mesh = self.zero = None
        m = cfg.mesh
        if m.num_devices > 1 or devices is not None:
            world = tp_lib.current()
            if devices is None:
                devices = (world.devices if world is not None
                           else [self.device])
            if m.num_devices != len(devices):
                raise ValueError(
                    f"mesh {m.dp}x{m.fsdp}x{m.tp}x{m.sp}={m.num_devices} "
                    f"!= {len(devices)} devices")
        if m.num_devices > 1:
            self.mesh = mesh_lib.build_mesh(m, devices)
            self.world = tp_lib.current()
            self.device = self.world.device
        self.logger = MetricLogger(metrics_path,
                                   log_every=cfg.train.log_every,
                                   tensorboard_dir=tensorboard_dir)
        ckpt_dir = cfg.train.checkpoint_dir
        if self.world is not None:
            ckpt_dir = zero_lib.rank_dir(ckpt_dir, 0, self.world.size)
        self.ckpt = CheckpointManager(ckpt_dir)
        # Off unless asked for; on_anomaly="halt" must build the monitor
        # (registry-only without a port) rather than leave the run
        # unprotected.
        self.telemetry = telemetry
        if self.telemetry is None and (
            metrics_port is not None or events_path or on_anomaly == "halt"
        ):
            self.telemetry = telemetry_lib.TrainTelemetry(
                port=metrics_port, events_path=events_path,
                thresholds=anomaly_thresholds, on_anomaly=on_anomaly,
                device=self.device,
            )
        if self.telemetry is not None and faults.armed():
            faults.bind_registry(self.telemetry.registry)
        self._lr_fn = make_schedule(cfg.train, cfg.train.learning_rate)
        self.tracer = tracer or trace_lib.Tracer(flight_recorder_size)
        self.watchdog: trace_lib.StallWatchdog | None = None
        if stall_timeout is not None:
            self.watchdog = trace_lib.StallWatchdog(
                self.tracer, stall_timeout, name="trainer"
            ).start()
        if self.world is not None:
            # Every rank builds its shards from the same whole model: the
            # seeded init, or the caller's weights sent by value.
            source = None if params is None else {
                n: t.detach().cpu() for n, t in params.state_dict().items()}
            self.zero = self.world.call(
                zero_lib.start, cfg, source, sharding_mode,
                (m.dp, m.fsdp, m.tp, m.sp), bind=True)
            self.tx = self.zero.tx
            self.state = self.zero.state
        else:
            if params is None:
                gen = torch.Generator(self.device).manual_seed(
                    cfg.train.seed)
                params = oryx.init_params(cfg, gen, device=self.device)
            params = setup_lora(cfg, params.to(self.device))
            self.tx = make_optimizer(cfg.train, params)
            prepare_params(params, self.tx.mask, oryx.compute_dtype(cfg))
            self.state = step_lib.init_state(params, self.tx)
        # Host metrics of every step fit ran (the logged record's inputs,
        # the model FLOPs, plus, on a card, the device time of the step's
        # two phases and MFU).
        self.history: list[dict[str, float]] = []
        self.peak_flops = (
            flops_lib.chip_peak_flops(torch.cuda.get_device_name(self.device))
            if self.device.type == "cuda" else None
        )

    def close(self) -> None:
        """Stop the watchdog thread and the telemetry server, and close the
        metric writers. fit() may still run again before close()."""
        if self.watchdog is not None:
            self.watchdog.stop()
            self.watchdog = None
        if self.telemetry is not None:
            self.telemetry.close()
            self.telemetry = None
        self.logger.close()

    def resume_if_available(self) -> int:
        """Restore the latest checkpoint if there is one; the start step.
        The restore's seconds go to the telemetry's restore counter."""
        if self.ckpt.latest_step() is None:
            return 0
        t0 = time.perf_counter()
        if self.world is not None:
            self.world.call(zero_lib.rank_restore, self.zero,
                            self.cfg.train.checkpoint_dir)
            self.state = self.zero.state
        else:
            self.state = self.ckpt.restore(self.state)
        if self.telemetry is not None:
            self.telemetry.record_restore(time.perf_counter() - t0)
        rank0_print(f"resumed from step {self.state.step}")
        return self.state.step

    def _stacked(self, batch: dict[str, np.ndarray]
                 ) -> dict[str, np.ndarray]:
        """Host batch with the leading [accum, ...] axis (with
        grad_accum_steps > 1 the batch must come stacked from
        data.collate_microbatches)."""
        accum = self.cfg.train.grad_accum_steps
        out = {}
        for name, x in batch.items():
            x = np.asarray(x)
            if accum > 1:
                if x.shape[0] != accum:
                    raise ValueError(
                        f"{name}: expected stacked [accum={accum}, ...] "
                        f"microbatches (use data.collate_microbatches), got "
                        f"shape {x.shape}"
                    )
            else:
                x = x[None]
            out[name] = np.ascontiguousarray(x)
        return out

    def _device_batch(self, batch: dict[str, np.ndarray]):
        """Host batch -> the step's input: device tensors [accum, ...] on
        one device; on a mesh the stacked host arrays, each rank taking
        its share of every field by `sharding.batch_field_spec`
        (parallel/zero.RankTrainer)."""
        stacked = self._stacked(batch)
        if self.world is not None:
            return stacked
        return {k: torch.from_numpy(x).to(self.device)
                for k, x in stacked.items()}

    def full_params(self) -> dict[str, torch.Tensor]:
        """Every trained leaf whole, {name: CPU tensor}."""
        if self.world is not None:
            return self.world.call(zero_lib.rank_full_params, self.zero)
        return {n: p.detach().cpu()
                for n, p in self.state.params.named_parameters()}

    def rank_reports(self) -> list[dict]:
        """Each rank's holdings (parallel/zero.RankTrainer.report), by
        rank; one entry on one device."""
        if self.world is not None:
            return self.world.call(zero_lib.rank_reports, self.zero)
        return []

    def _next_batch(self, batches: Iterator, tr) -> tuple[dict, object]:
        """The next host batch and its `data` span, skipping a transient
        loader exception (`max_data_faults` in a row still abort);
        StopIteration passes through."""
        consecutive = 0
        while True:
            try:
                with tr.span("data") as sp_data:
                    corrupt = faults.fault_point("data_loader_next")
                    batch = next(batches)
                    if corrupt:
                        batch = _poison_one_float_leaf(batch)
                    return batch, sp_data
            except StopIteration:
                raise
            # fault-boundary: a transient data fault skips this fetch
            except Exception as e:
                consecutive += 1
                self.data_faults += 1
                rank0_print(f"data loader fault ({consecutive}/"
                            f"{self.max_data_faults} consecutive): "
                            f"{type(e).__name__}: {e}; skipping to next "
                            "batch")
                if consecutive >= self.max_data_faults:
                    raise RuntimeError(
                        f"{consecutive} consecutive data-loader failures "
                        "- aborting (see Trainer max_data_faults)"
                    ) from e

    def _save(self, step: int, *, force: bool = False) -> None:
        if self.world is not None:
            self.world.call(zero_lib.rank_save, self.zero,
                            self.cfg.train.checkpoint_dir, step, force)
            return
        self.ckpt.save(step, self.state, self.tx.trainable(), force=force)

    def fit(
        self,
        batches: Iterator[dict[str, np.ndarray]],
        *,
        num_steps: int | None = None,
        resume: bool = True,
        prefetch: int = 2,
    ) -> step_lib.TrainState:
        cfg = self.cfg
        num_steps = num_steps or cfg.train.num_train_steps
        start = self.resume_if_available() if resume else 0
        prefetcher = None
        if prefetch > 0 and start < num_steps:
            batches = prefetcher = PrefetchIterator(batches, depth=prefetch)
        cuda = self.device.type == "cuda"
        consecutive_skipped = 0
        if self.watchdog is not None and start < num_steps:
            self.watchdog.set_active(True)
        if self.telemetry is not None:
            self.telemetry.mark_ready(True, "ok")
        try:
            for step_i in range(start, num_steps):
                # Fault site: a process death mid-run; nothing contains it
                # (a fresh Trainer resumes from the last checkpoint).
                faults.fault_point("trainer_crash")
                t0 = time.perf_counter()
                tr = self.tracer.start_trace("train_step",
                                             label=f"step {step_i + 1}")
                try:
                    host_batch, sp_data = self._next_batch(batches, tr)
                except StopIteration:
                    tr.finish(exhausted=True)
                    rank0_print("data exhausted; stopping")
                    break
                validate_train_batch(cfg, host_batch)
                with tr.span("h2d") as sp_h2d:
                    batch = self._device_batch(host_batch)
                numer = (self.numerics_every > 0
                         and step_i % self.numerics_every == 0)
                marks = {}
                if cuda:
                    torch.cuda.reset_peak_memory_stats(self.device)
                    marks["start"] = torch.cuda.Event(enable_timing=True)
                    marks["start"].record()

                def mark(name):
                    if cuda:
                        marks[name] = torch.cuda.Event(enable_timing=True)
                        marks[name].record()

                with tr.span("step_dispatch") as sp_disp:
                    if self.world is not None:
                        metrics, rank_marks = self.world.call(
                            zero_lib.rank_step, self.zero, batch, numer)
                        marks.update(rank_marks)
                        self.state = self.zero.state
                    else:
                        self.state, metrics = step_lib.train_step(
                            self.state, batch, cfg, self.tx, mark=mark,
                            numerics=numer,
                        )
                # The step loop's one deliberate sync: logging, the skip
                # count and the telemetry need host scalars.
                with tr.span("device_sync") as sp_sync:
                    layer_absmax = metrics.pop("grad_layer_absmax", None)
                    keys = list(metrics)
                    vals = torch.cat([
                        metrics[k].to(self.device, torch.float64).reshape(1)
                        for k in keys
                    ] + ([] if layer_absmax is None else
                         [layer_absmax.to(self.device, torch.float64)])
                    ).tolist()
                t_synced = time.perf_counter()
                host = dict(zip(keys, vals))
                if self.watchdog is not None:
                    self.watchdog.beat()
                # The per-layer vector is telemetry-only: the logged record
                # holds scalars.
                if numer and self.telemetry is not None:
                    self.telemetry.record_numerics(
                        step_i + 1, host,
                        layer_absmax=(None if layer_absmax is None
                                      else vals[len(keys):]),
                    )
                data_s = sp_data.dur_ns / 1e9
                dispatch_s = sp_disp.dur_ns / 1e9
                sync_s = sp_sync.dur_ns / 1e9
                host["data_s"] = data_s
                host["dispatch_s"] = dispatch_s
                host["sync_s"] = sync_s
                self.logger.log_step(step_i + 1, host)
                if cuda:
                    host["h2d_s"] = sp_h2d.dur_ns / 1e9
                    host["fwd_bwd_ms"] = marks["start"].elapsed_time(
                        marks["grads"])
                    host["optimizer_ms"] = marks["grads"].elapsed_time(
                        marks["update"])
                    host["peak_bytes"] = torch.cuda.max_memory_allocated(
                        self.device)
                host["wall_s"] = t_synced - t0
                host["tokens"] = int(np.asarray(host_batch["attn_mask"]).sum())
                host["model_flops"] = flops_lib.batch_flops(cfg, host_batch)
                if self.peak_flops:
                    host["mfu"] = (host["model_flops"] / host["wall_s"]
                                   / self.peak_flops)
                self.history.append(host)
                if int(host.get("skipped", 0)):
                    consecutive_skipped += 1
                    if consecutive_skipped >= cfg.train.max_consecutive_skipped:
                        raise RuntimeError(
                            f"{consecutive_skipped} consecutive non-finite "
                            "steps skipped - aborting (see "
                            "train.max_consecutive_skipped)"
                        )
                else:
                    consecutive_skipped = 0
                ckpt_s = 0.0
                if (step_i + 1) % cfg.train.checkpoint_every == 0:
                    with tr.span("checkpoint_save") as sp_ckpt:
                        self._save(step_i + 1)
                    ckpt_s = sp_ckpt.dur_ns / 1e9
                tr.finish(step=step_i + 1,
                          skipped=int(host.get("skipped", 0)))
                if self.telemetry is not None:
                    # May raise AnomalyHalt under on_anomaly="halt" (the
                    # finally below still releases the loop's resources).
                    self.telemetry.record_step(
                        step_i + 1, host,
                        step_seconds=time.perf_counter() - t0,
                        data_s=data_s, dispatch_s=dispatch_s, sync_s=sync_s,
                        checkpoint_s=ckpt_s, flops=host["model_flops"],
                        lr=float(self._lr_fn(step_i + 1)),
                    )
        finally:
            if self.watchdog is not None:
                self.watchdog.set_active(False)
            if prefetcher is not None:
                prefetcher.close()
            # /readyz stops saying ready once the loop is gone (a halt has
            # set its own reason already: keep it).
            if self.telemetry is not None and self.telemetry.ready:
                self.telemetry.mark_ready(False, "step loop exited")
        final_step = self.state.step
        if final_step > 0 and self.ckpt.latest_step() != final_step:
            self._save(final_step, force=True)
        self.ckpt.wait()
        return self.state
