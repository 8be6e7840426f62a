"""Trainer telemetry exporter: the fleet-level view of a training run
(port of `oryx_tpu.train.telemetry`).

The same exposition path as serving (utils/metrics.Registry), served from
a background stdlib HTTP endpoint (`--metrics-port`):

  GET /metrics - oryx_train_* series: per-step loss / grad-norm / lr,
                 tokens/sec(/chip), MFU (utils/flops.py's model over the
                 card's peak), phase seconds (data / dispatch / sync /
                 checkpoint), goodput accounting, card memory, process
                 collectors, the sampled oryx_numerics_* probes, plus the
                 cross-source oryx_anomaly_total{kind=} counter.
  GET /healthz - process liveness.
  GET /readyz  - 200 while the step loop runs (503 with a reason before
                 the first step, after the loop and after a halt).

Goodput is the ratio of seconds spent in steps that advanced the model
(skipped non-finite steps and checkpoint time excluded) to wall seconds
since the trainer came up; checkpoint and restore time have counters of
their own, so a low ratio says where the time went.

An `AnomalyMonitor` (utils/anomaly.py) rides the same stream: NaN/Inf
loss, loss spikes, grad-norm explosions, throughput collapses and
absmax explosions each fire one structured event into `events_path`,
increment `oryx_anomaly_total{kind=...}`, and under on_anomaly="halt"
raise `AnomalyHalt` out of `Trainer.fit()`.

The port trains on one device, so the per-chip rates divide by 1.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from oryx_tpu_torch.utils import flops as flops_lib
from oryx_tpu_torch.utils.anomaly import (
    AnomalyHalt,
    AnomalyMonitor,
    AnomalyThresholds,
)
from oryx_tpu_torch.utils.metrics import (
    Registry,
    TelemetryServer,
    register_device_memory_collector,
    register_process_collector,
)

# Model FLOPs of one step over a host batch, where JAX's package has it.
batch_flops = flops_lib.batch_flops

# Step wall-clock ladder (seconds): tiny CPU smoke steps to multi-minute
# steps.
STEP_TIME_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0)

# The trainer's per-step gauges, one place.
TRAIN_GAUGES = (
    "loss", "grad_norm", "lr", "tokens_per_sec", "tokens_per_sec_per_chip",
    "mfu", "model_flops_per_sec", "goodput_ratio", "last_step",
)

# The wall-time attribution counters (`<phase>_seconds_total`).
PHASES = ("productive", "checkpoint", "restore", "data_wait", "dispatch",
          "device_sync")


class TrainTelemetry:
    """Registry + exporter + anomaly monitor for one Trainer.

    Construct with `port` (0 = ephemeral, see `.port`) to serve HTTP, or
    `port=None` for a registry-only instance. `device`: the trainer's
    device, whose name (`torch.cuda.get_device_name`) gives the peak of
    the MFU gauge; the gauge reads 0 where the peak is unknown (the CPU).
    All recording is host-side floats."""

    def __init__(
        self,
        *,
        port: int | None = 0,
        host: str = "127.0.0.1",
        registry: Registry | None = None,
        events_path: str | None = None,
        thresholds: AnomalyThresholds | None = None,
        on_anomaly: str = "warn",
        device=None,
    ):
        if on_anomaly not in ("warn", "halt"):
            raise ValueError(
                f"on_anomaly must be 'warn' or 'halt', got {on_anomaly!r}"
            )
        self.on_anomaly = on_anomaly
        dev = torch.device(device if device is not None else "cpu")
        self.device_kind = (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else dev.type)
        self.registry = registry or Registry(prefix="oryx_train")
        register_process_collector(self.registry)
        register_device_memory_collector(self.registry)
        self.anomaly = AnomalyMonitor(
            source="train", thresholds=thresholds,
            events_path=events_path, registry=self.registry,
        )
        r = self.registry
        self._gauges = {name: r.declare(name, "gauge")
                        for name in TRAIN_GAUGES}
        self._steps = r.counter("steps_total")
        self._skipped = r.counter("skipped_steps_total")
        self._tokens = r.counter("tokens_total")
        self._checkpoints = r.counter("checkpoints_total")
        self._step_time = r.histogram(
            "step_time_seconds", STEP_TIME_BUCKETS
        )
        # productive + checkpoint + restore + data-wait never exceed wall;
        # the remainder is start-up and stalls.
        self._phase = {k: r.declare(f"{k}_seconds_total", "counter")
                       for k in PHASES}
        self._t0 = time.perf_counter()
        self._ready = False
        self._ready_reason = "training loop not started"
        self.server: TelemetryServer | None = None
        if port is not None:
            self.server = TelemetryServer(
                self.registry, host=host, port=port,
                ready_check=lambda: (self._ready, self._ready_reason),
            ).start()

    @property
    def port(self) -> int | None:
        return self.server.port if self.server else None

    @property
    def ready(self) -> bool:
        return self._ready

    def mark_ready(self, ready: bool = True,
                   reason: str = "ok") -> None:
        self._ready, self._ready_reason = ready, reason

    def record_restore(self, seconds: float) -> None:
        self._phase["restore"].inc(max(0.0, seconds))

    def _halt_on(self, events: list) -> list:
        if events and self.on_anomaly == "halt":
            self.mark_ready(False, f"halted: {events[0].kind}")
            raise AnomalyHalt(events)
        return events

    def record_numerics(
        self,
        step: int,
        metrics: dict[str, Any],
        *,
        layer_absmax=None,
    ) -> list:
        """Publish one sampled numerics probe (train_step's `numerics`
        flag): the absmax scalars as raw-named oryx_numerics_* gauges (the
        family names the serving registry publishes), the per-layer grad
        absmax as a `layer`-labelled gauge, and the absmax_explosion
        sentinel. Returns the anomalies fired, after honouring the halt
        policy as record_step does."""
        r = self.registry
        grad_absmax = metrics.get("grad_absmax")
        for name, fam in (
            ("grad_absmax", r.gauge(
                "oryx_numerics_grad_absmax", raw_name=True
            )),
            ("act_absmax", r.gauge(
                "oryx_numerics_act_absmax", raw_name=True
            )),
            ("param_absmax", r.gauge(
                "oryx_numerics_param_absmax", raw_name=True
            )),
        ):
            v = metrics.get(name)
            if v is not None:
                v = float(v)
                fam.set(v if np.isfinite(v) else float("nan"))
        r.counter("oryx_numerics_samples_total", raw_name=True).inc()
        if layer_absmax is not None:
            fam = r.gauge(
                "oryx_numerics_grad_layer_absmax", ("layer",),
                raw_name=True,
            )
            for i, v in enumerate(np.asarray(layer_absmax).tolist()):
                fam.labels(layer=str(i)).set(float(v))
        events = self.anomaly.observe_numerics(
            absmax=(
                float(grad_absmax) if grad_absmax is not None else None
            ),
            step=step,
        )
        return self._halt_on(events)

    def record_step(
        self,
        step: int,
        metrics: dict[str, Any],
        *,
        step_seconds: float,
        data_s: float = 0.0,
        dispatch_s: float = 0.0,
        sync_s: float = 0.0,
        checkpoint_s: float = 0.0,
        flops: float | None = None,
        lr: float | None = None,
    ) -> list:
        """Publish one completed step; returns anomalies fired (after
        raising AnomalyHalt when the policy says so)."""
        g = self._gauges
        loss = float(metrics.get("loss", float("nan")))
        tokens = int(metrics.get("num_tokens", 0))
        skipped = bool(int(metrics.get("skipped", 0)))
        n_chips = 1
        dt = max(step_seconds, 1e-9)
        tps = tokens / dt

        g["loss"].set(loss if np.isfinite(loss) else float("nan"))
        if "grad_norm" in metrics:
            g["grad_norm"].set(float(metrics["grad_norm"]))
        if lr is not None:
            g["lr"].set(float(lr))
        g["tokens_per_sec"].set(tps)
        g["tokens_per_sec_per_chip"].set(tps / n_chips)
        g["last_step"].set(step)
        self._steps.inc()
        self._tokens.inc(tokens)
        if skipped:
            self._skipped.inc()
        self._step_time.observe(step_seconds)
        self._phase["data_wait"].inc(max(0.0, data_s))
        self._phase["dispatch"].inc(max(0.0, dispatch_s))
        self._phase["device_sync"].inc(max(0.0, sync_s))
        if checkpoint_s > 0:
            self._phase["checkpoint"].inc(checkpoint_s)
            self._checkpoints.inc()
        # Productive: the step's own wall, checkpoint excluded, and only
        # when the step advanced the params.
        if not skipped:
            self._phase["productive"].inc(
                max(0.0, step_seconds - checkpoint_s)
            )
        wall = max(time.perf_counter() - self._t0, 1e-9)
        g["goodput_ratio"].set(
            min(1.0, self._phase["productive"].value / wall)
        )
        if flops is not None:
            rate = flops / dt
            g["model_flops_per_sec"].set(rate)
            peak = flops_lib.chip_peak_flops(self.device_kind)
            # Unknown peak (the CPU): pinned to 0 rather than absent, so a
            # scrape gate can assert the series; never a made-up number.
            g["mfu"].set(rate / (n_chips * peak) if peak else 0.0)
        events = self.anomaly.observe_train_step(
            step, loss,
            grad_norm=metrics.get("grad_norm"),
            tokens_per_sec=tps if tokens else None,
        )
        return self._halt_on(events)

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None
        self.anomaly.close()
