"""SFT trainer: state, step loop, checkpoint/resume (port of
`oryx_tpu.train.trainer`, one device: no mesh, no sharding, no telemetry,
no fault injection).

`Trainer(cfg, params=..., device=...)` takes ownership of `params` (an
`OryxModel`; a random init from cfg.train.seed when None): trainable leaves
become fp32 masters and frozen leaves are held in the compute dtype, in
place, and every step updates the parameters in place. `fit` keeps the JAX
loop's order: data -> host-to-device -> step -> one sync for the metrics ->
log -> checkpoint, with the `max_consecutive_skipped` abort and a final
save.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import oryx
from oryx_tpu_torch.models.params import resolve_device
from oryx_tpu_torch.train import step as step_lib
from oryx_tpu_torch.train.data import PrefetchIterator
from oryx_tpu_torch.train.optimizer import make_optimizer
from oryx_tpu_torch.utils.checkpoint import CheckpointManager
from oryx_tpu_torch.utils.metrics import MetricLogger


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
        metrics_path: str | None = None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(self.device).manual_seed(cfg.train.seed)
            params = oryx.init_params(cfg, gen, device=self.device)
        params = params.to(self.device)
        self.tx = make_optimizer(cfg.train, params)
        prepare_params(params, self.tx.mask, oryx.compute_dtype(cfg))
        self.state = step_lib.init_state(params, self.tx)
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir)
        self.logger = MetricLogger(metrics_path,
                                   log_every=cfg.train.log_every)
        # Host metrics of every step fit ran (the logged record's inputs
        # plus, on a card, the device time of the step's two phases).
        self.history: list[dict[str, float]] = []

    def close(self) -> None:
        self.logger.close()

    def resume_if_available(self) -> int:
        """Restore the latest checkpoint if there is one; the start step."""
        if self.ckpt.latest_step() is None:
            return 0
        self.state = self.ckpt.restore(self.state)
        print(f"resumed from step {self.state.step}")
        return self.state.step

    def _device_batch(self, batch: dict[str, np.ndarray]):
        """Host batch -> device tensors with the leading [accum, ...] axis
        (with grad_accum_steps > 1 the batch must come stacked from
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
            out[name] = torch.from_numpy(np.ascontiguousarray(x)).to(
                self.device
            )
        return out

    def _save(self, step: int, *, force: bool = False) -> None:
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
        try:
            for step_i in range(start, num_steps):
                t0 = time.perf_counter()
                try:
                    host_batch = next(batches)
                except StopIteration:
                    print("data exhausted; stopping")
                    break
                t1 = time.perf_counter()
                batch = self._device_batch(host_batch)
                marks = {}
                if cuda:
                    torch.cuda.reset_peak_memory_stats(self.device)
                    marks["start"] = torch.cuda.Event(enable_timing=True)
                    marks["start"].record()

                def mark(name):
                    if cuda:
                        marks[name] = torch.cuda.Event(enable_timing=True)
                        marks[name].record()

                t2 = time.perf_counter()
                self.state, metrics = step_lib.train_step(
                    self.state, batch, cfg, self.tx, mark=mark,
                )
                t3 = time.perf_counter()
                # The step loop's one deliberate sync: logging and the
                # skip count need host scalars.
                keys = list(metrics)
                vals = torch.stack([
                    metrics[k].to(self.device, torch.float64).reshape(())
                    for k in keys
                ]).tolist()
                host = dict(zip(keys, vals))
                t4 = time.perf_counter()
                host["data_s"] = t1 - t0
                host["dispatch_s"] = t3 - t2
                host["sync_s"] = t4 - t3
                self.logger.log_step(step_i + 1, host)
                if cuda:
                    host["h2d_s"] = t2 - t1
                    host["fwd_bwd_ms"] = marks["start"].elapsed_time(
                        marks["grads"])
                    host["optimizer_ms"] = marks["grads"].elapsed_time(
                        marks["update"])
                    host["peak_bytes"] = torch.cuda.max_memory_allocated(
                        self.device)
                host["wall_s"] = t4 - t0
                host["tokens"] = int(np.asarray(host_batch["attn_mask"]).sum())
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
                if (step_i + 1) % cfg.train.checkpoint_every == 0:
                    self._save(step_i + 1)
        finally:
            if prefetcher is not None:
                prefetcher.close()
        final_step = self.state.step
        if final_step > 0 and self.ckpt.latest_step() != final_step:
            self._save(final_step, force=True)
        self.ckpt.wait()
        return self.state
