"""Rolling-window anomaly detection for train and serve (port of
`oryx_tpu.utils.anomaly`, whole).

Detectors (all host-side, O(window) memory, no deps):

  * ``nan_loss``        - loss is NaN/Inf.
  * ``loss_spike``      - loss > `loss_spike_factor` x rolling median.
  * ``grad_norm_explosion`` - grad norm > `grad_norm_factor` x rolling
                          median.
  * ``throughput_collapse`` - tokens/sec < `throughput_floor_frac` x
                          rolling median.
  * ``ttft_slo``        - serving time-to-first-token above the SLO.
  * ``queue_depth_slo`` - serving admission queue above the SLO.
  * ``entropy_collapse`` - logits entropy < `entropy_floor_frac` x
                          rolling median.
  * ``absmax_explosion`` - logits/grad absmax > `absmax_factor` x
                          rolling median.
  * ``audit_drift``     - an output audit returned a non-pass verdict;
                          re-arms on the next pass.
  * ``spec_accept_collapse`` - speculative accept-rate <
                          `spec_accept_floor_frac` x rolling baseline.

A detector is ARMED, fires once when its condition becomes true, and
re-arms only after the condition clears (hysteresis for queue depth). A
firing emits a structured JSONL event (the ``events.jsonl`` sink,
size-capped with one ``.1`` generation), increments the shared
``oryx_anomaly_total{kind=...}`` counter (the same family name in the
train and serve registries) and writes one log line.

Event schema (one JSON object per line)::

    {"time_unix_s": float, "source": "train"|"serve", "kind": str,
     "message": str, "value": float, "threshold": float,
     "context": {...}}

Policy is the caller's job: serving only counts and logs. The API server
always builds a monitor, so `oryx_anomaly_total` exists on every replica.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import statistics
import time
from collections import deque
from typing import Any

from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.utils.rolling_sink import RollingSink

_LOG = logging.getLogger("oryx.anomaly")


class AnomalyHalt(RuntimeError):
    """Raised by the trainer when an anomaly fires under
    --on-anomaly=halt. Carries the triggering events."""

    def __init__(self, events: list["AnomalyEvent"]):
        self.events = events
        super().__init__(
            "anomaly halt: " + "; ".join(e.message for e in events)
        )


@dataclasses.dataclass(frozen=True)
class AnomalyThresholds:
    """Detector configuration. A None SLO disables that detector; the
    statistical detectors stay silent until `min_window` finite
    observations exist (a cold start must not alert on noise)."""

    window: int = 32
    min_window: int = 8
    loss_spike_factor: float = 3.0
    grad_norm_factor: float = 10.0
    throughput_floor_frac: float = 0.3
    ttft_slo_s: float | None = None
    queue_depth_slo: int | None = None
    # Numerics sentinels (utils/numerics.py probes feed these): logits
    # entropy collapsing toward a delta, absmax heading for overflow.
    entropy_floor_frac: float = 0.25
    absmax_factor: float = 10.0
    # Speculation drift guard: accept-rate (tokens advanced per spec
    # step) falling off its own rolling baseline.
    spec_accept_floor_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class AnomalyEvent:
    kind: str
    source: str
    message: str
    value: float
    threshold: float
    time_unix_s: float
    context: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        def js(v):
            # Non-finite floats -> JSON null (same RFC-strictness rule
            # as MetricLogger: a NaN value is the NORMAL payload of a
            # nan_loss event and must not emit the non-RFC NaN token).
            if isinstance(v, float) and not math.isfinite(v):
                return None
            return v

        return {
            "time_unix_s": self.time_unix_s,
            "source": self.source,
            "kind": self.kind,
            "message": self.message,
            "value": js(self.value),
            "threshold": js(self.threshold),
            "context": {k: js(v) for k, v in self.context.items()},
        }


class _Window:
    """Rolling window of finite observations + armed flag."""

    __slots__ = ("values", "armed")

    def __init__(self, size: int):
        self.values = deque(maxlen=size)
        self.armed = True

    def median(self) -> float | None:
        if not self.values:
            return None
        return float(statistics.median(self.values))


class AnomalyMonitor:
    """One monitor per engine (trainer / scheduler), thread-safe.

    ``observe_*`` calls return the events they fired (empty list when
    healthy) so the caller can apply policy; the side effects (JSONL
    sink, counter, log line) have already happened by then."""

    def __init__(
        self,
        *,
        source: str = "train",
        thresholds: AnomalyThresholds | None = None,
        events_path: str | None = None,
        registry=None,
        keep: int = 256,
        events_max_bytes: int = 16 * 1024 * 1024,
    ):
        self.source = source
        self.thresholds = thresholds or AnomalyThresholds()
        # Size-capped rotation: a long-lived server's sink must not
        # grow without bound. When the file crosses events_max_bytes
        # the current file rolls to `<events_path>.1` (replacing the
        # previous roll) and a fresh file starts — one generation of
        # history survives, disk usage stays <= ~2x the cap. 0 disables
        # rotation.
        self.events_path = (
            os.path.abspath(events_path) if events_path else None
        )
        self.events_max_bytes = events_max_bytes
        self.recent: deque[AnomalyEvent] = deque(maxlen=keep)
        self.counts: dict[str, int] = {}
        self.total = 0
        self._lock = named_lock("anomaly._lock")
        self._sink = None
        if self.events_path:
            self._sink = RollingSink(
                self.events_path, max_bytes=events_max_bytes
            )
        # The shared cross-registry family: oryx_anomaly_total{kind=}.
        # raw_name — deliberately NOT prefixed, so the train and serve
        # exporters publish the same series name and one Prometheus
        # alert rule (`rate(oryx_anomaly_total[5m]) > 0`) covers both.
        self._counter = None
        if registry is not None:
            self._counter = registry.counter(
                "oryx_anomaly_total", ("kind",), raw_name=True
            )
        t = self.thresholds
        self._loss = _Window(t.window)
        self._gnorm = _Window(t.window)
        self._tput = _Window(t.window)
        self._entropy = _Window(t.window)
        self._absmax = _Window(t.window)
        self._spec = _Window(t.window)
        self._nan_armed = True
        self._ttft_armed = True
        self._queue_armed = True
        self._audit_armed = True

    # ---- firing ----------------------------------------------------------

    def _fire(self, kind: str, message: str, value: float,
              threshold: float, **context: Any) -> AnomalyEvent:
        ev = AnomalyEvent(
            kind=kind, source=self.source, message=message,
            value=float(value), threshold=float(threshold),
            time_unix_s=time.time(), context=context,
        )
        with self._lock:
            self.recent.append(ev)
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.total += 1
            if self._sink is not None:
                # Rotation contract (rotate AFTER the crossing write,
                # one `.1` generation) lives in utils/rolling_sink.py,
                # shared with the request-log and journal sinks.
                self._sink.write(json.dumps(ev.to_dict()))
        if self._counter is not None:
            self._counter.labels(kind=kind).inc()
        _LOG.warning("anomaly[%s] %s: %s", self.source, kind, message)
        return ev

    # ---- training signals ------------------------------------------------

    def observe_train_step(
        self,
        step: int,
        loss: float,
        grad_norm: float | None = None,
        tokens_per_sec: float | None = None,
    ) -> list[AnomalyEvent]:
        """Feed one step's host metrics; returns the anomalies fired."""
        t = self.thresholds
        out: list[AnomalyEvent] = []
        loss = float(loss)
        if not math.isfinite(loss):
            if self._nan_armed:
                self._nan_armed = False
                out.append(self._fire(
                    "nan_loss",
                    f"non-finite loss {loss} at step {step}",
                    loss, 0.0, step=step,
                ))
        else:
            self._nan_armed = True
            med = self._loss.median()
            if (
                med is not None
                and len(self._loss.values) >= t.min_window
                and loss > t.loss_spike_factor * med
            ):
                if self._loss.armed:
                    self._loss.armed = False
                    out.append(self._fire(
                        "loss_spike",
                        f"loss {loss:.4g} > {t.loss_spike_factor:g}x "
                        f"rolling median {med:.4g} at step {step}",
                        loss, t.loss_spike_factor * med,
                        step=step, window_median=med,
                    ))
            else:
                self._loss.armed = True
            self._loss.values.append(loss)
        if grad_norm is not None:
            g = float(grad_norm)
            if math.isfinite(g):
                med = self._gnorm.median()
                if (
                    med is not None and med > 0
                    and len(self._gnorm.values) >= t.min_window
                    and g > t.grad_norm_factor * med
                ):
                    if self._gnorm.armed:
                        self._gnorm.armed = False
                        out.append(self._fire(
                            "grad_norm_explosion",
                            f"grad norm {g:.4g} > {t.grad_norm_factor:g}x "
                            f"rolling median {med:.4g} at step {step}",
                            g, t.grad_norm_factor * med,
                            step=step, window_median=med,
                        ))
                else:
                    self._gnorm.armed = True
                self._gnorm.values.append(g)
        if tokens_per_sec is not None:
            tp = float(tokens_per_sec)
            if math.isfinite(tp) and tp >= 0:
                med = self._tput.median()
                if (
                    med is not None and med > 0
                    and len(self._tput.values) >= t.min_window
                    and tp < t.throughput_floor_frac * med
                ):
                    if self._tput.armed:
                        self._tput.armed = False
                        out.append(self._fire(
                            "throughput_collapse",
                            f"throughput {tp:.4g} tok/s < "
                            f"{t.throughput_floor_frac:g}x rolling median "
                            f"{med:.4g} at step {step}",
                            tp, t.throughput_floor_frac * med,
                            step=step, window_median=med,
                        ))
                    # Collapsed values do NOT enter the window: they
                    # would drag the median down and silently re-baseline
                    # the detector onto the collapsed level.
                else:
                    self._tput.armed = True
                    self._tput.values.append(tp)
        return out

    # ---- serving signals -------------------------------------------------

    def observe_ttft(self, seconds: float,
                     request_id: str = "") -> list[AnomalyEvent]:
        slo = self.thresholds.ttft_slo_s
        if slo is None:
            return []
        if seconds > slo:
            if self._ttft_armed:
                self._ttft_armed = False
                return [self._fire(
                    "ttft_slo",
                    f"TTFT {seconds:.3f}s > SLO {slo:g}s"
                    + (f" (request {request_id})" if request_id else ""),
                    seconds, slo, request_id=request_id,
                )]
        else:
            self._ttft_armed = True
        return []

    def observe_queue_depth(self, depth: int) -> list[AnomalyEvent]:
        slo = self.thresholds.queue_depth_slo
        if slo is None:
            return []
        if depth > slo:
            if self._queue_armed:
                self._queue_armed = False
                return [self._fire(
                    "queue_depth_slo",
                    f"admission queue depth {depth} > SLO {slo}",
                    depth, slo,
                )]
        elif depth <= slo // 2:
            # Hysteresis: re-arm only once the backlog has genuinely
            # drained, not on every oscillation around the line.
            self._queue_armed = True
        return []

    # ---- numerics & output-quality signals -------------------------------

    def observe_numerics(self, *, entropy: float | None = None,
                         absmax: float | None = None,
                         **context: Any) -> list[AnomalyEvent]:
        """Feed one numerics probe sample (utils/numerics.py, from the
        serving dispatch or a sampled train step). entropy_collapse
        mirrors throughput_collapse (collapsed values never enter the
        window — they would re-baseline the detector onto the collapsed
        level); absmax_explosion mirrors grad_norm_explosion (spikes
        enter the window: a new, genuinely higher plateau should stop
        firing once it IS the baseline)."""
        t = self.thresholds
        out: list[AnomalyEvent] = []
        if entropy is not None:
            e = float(entropy)
            if math.isfinite(e) and e >= 0:
                med = self._entropy.median()
                if (
                    med is not None and med > 0
                    and len(self._entropy.values) >= t.min_window
                    and e < t.entropy_floor_frac * med
                ):
                    if self._entropy.armed:
                        self._entropy.armed = False
                        out.append(self._fire(
                            "entropy_collapse",
                            f"logits entropy {e:.4g} < "
                            f"{t.entropy_floor_frac:g}x rolling median "
                            f"{med:.4g}",
                            e, t.entropy_floor_frac * med,
                            window_median=med, **context,
                        ))
                else:
                    self._entropy.armed = True
                    self._entropy.values.append(e)
        if absmax is not None:
            a = float(absmax)
            if math.isfinite(a):
                med = self._absmax.median()
                if (
                    med is not None and med > 0
                    and len(self._absmax.values) >= t.min_window
                    and a > t.absmax_factor * med
                ):
                    if self._absmax.armed:
                        self._absmax.armed = False
                        out.append(self._fire(
                            "absmax_explosion",
                            f"absmax {a:.4g} > {t.absmax_factor:g}x "
                            f"rolling median {med:.4g}",
                            a, t.absmax_factor * med,
                            window_median=med, **context,
                        ))
                else:
                    self._absmax.armed = True
                self._absmax.values.append(a)
        return out

    def observe_audit(self, verdict: str, *,
                      request_id: str = "",
                      **context: Any) -> list[AnomalyEvent]:
        """Feed one output-audit verdict (serve/audit.py). Fires
        `audit_drift` once per drift EPISODE: armed, fires on the first
        non-pass verdict, re-arms only after a pass — a systematically
        drifting path produces one page, not one per sampled request."""
        if verdict == "pass":
            self._audit_armed = True
            return []
        if not self._audit_armed:
            return []
        self._audit_armed = False
        return [self._fire(
            "audit_drift",
            f"output audit verdict {verdict!r}"
            + (f" (request {request_id})" if request_id else ""),
            1.0, 0.0, verdict=verdict, request_id=request_id, **context,
        )]

    def observe_spec_accept(self, rate: float,
                            **context: Any) -> list[AnomalyEvent]:
        """Feed one speculative step's accept signal (mean tokens a
        live slot advanced this dispatch, 1.0 = every draft rejected).
        Same collapsed-values-stay-out-of-the-window contract as
        throughput_collapse: a degraded drafter must not silently
        become its own baseline."""
        t = self.thresholds
        r = float(rate)
        if not (math.isfinite(r) and r > 0):
            return []
        med = self._spec.median()
        if (
            med is not None and med > 0
            and len(self._spec.values) >= t.min_window
            and r < t.spec_accept_floor_frac * med
        ):
            if self._spec.armed:
                self._spec.armed = False
                return [self._fire(
                    "spec_accept_collapse",
                    f"speculative accept {r:.4g} tokens/step < "
                    f"{t.spec_accept_floor_frac:g}x rolling baseline "
                    f"{med:.4g}",
                    r, t.spec_accept_floor_frac * med,
                    window_median=med, **context,
                )]
        else:
            self._spec.armed = True
            self._spec.values.append(r)
        return []

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
