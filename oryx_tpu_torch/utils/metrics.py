"""The JSONL metric stream of a training run (port of the `MetricLogger`
half of `oryx_tpu.utils.metrics`)."""

from __future__ import annotations

import json
import math
import os
import sys
import time
from typing import Any


class MetricLogger:
    """Every `log_every` steps: one JSON record (the step's metrics,
    steps/s and tokens/s/chip over the window; the port trains on one
    device) appended to `path` and a line on stdout. Non-finite values are
    written as null."""

    def __init__(self, path: str | None = None, *,
                 log_every: int = 10) -> None:
        self.path = path
        self.log_every = log_every
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        self._last_time = time.perf_counter()
        self._last_step = 0
        self._tokens_since = 0
        self._skipped_since = 0

    def log_step(self, step: int, metrics: dict[str, Any]) -> None:
        self._tokens_since += int(metrics.get("num_tokens", 0))
        # Accumulated, not sampled: a skip on a step that is not logged
        # still shows in the next record.
        self._skipped_since += int(metrics.get("skipped", 0))
        if step % self.log_every != 0:
            return
        now = time.perf_counter()
        dt = max(now - self._last_time, 1e-9)
        nsteps = max(step - self._last_step, 1)

        def js(v):
            f = float(v)
            return f if math.isfinite(f) else None

        rec = {
            "step": step,
            **{
                k: js(v) for k, v in metrics.items()
                if k not in ("num_tokens", "skipped")
            },
            "steps_per_sec": nsteps / dt,
            "tokens_per_sec_per_chip": self._tokens_since / dt,
        }
        if "skipped" in metrics:
            rec["skipped"] = self._skipped_since
        self._last_time, self._last_step = now, step
        self._tokens_since = 0
        self._skipped_since = 0
        print(
            f"step {step}: " + " ".join(
                f"{k}={'nan' if v is None else format(v, '.4g')}"
                for k, v in rec.items() if k != "step"
            )
        )
        sys.stdout.flush()
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
