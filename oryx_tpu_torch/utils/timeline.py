"""Per-step engine timeline: a bounded lock-free ring of step records (port
of `oryx_tpu.utils.timeline`).

The metrics answer "how is the engine doing on average" and the tracer
"why was THIS request slow"; the timeline answers "what was the engine
doing, step by step": one fixed-shape record per device dispatch (step
wall time, dispatch kind, packed rows, live slots, accepted tokens, queue
depth, free pages, degraded mode, the device time of a sampled step),
kept in a bounded ring, served at ``GET /debug/timeline?n=``
(serve/api_server.py) and snapshotted into scripts/loadgen.py's stage
reports.

Concurrency: the ring has one writer (the engine thread, from the
scheduler's dispatch accounting) and no lock. A record is an immutable
dict swapped into the ring in one reference assignment, so a reader may
see a slightly stale ring but never a torn record. The per-kind counts
are cumulative since construction, so their deltas reconcile with
``oryx_serving_dispatches_total`` over any window, however deep the ring.

Stdlib only.
"""

from __future__ import annotations

import time
from typing import Any

# Every record carries exactly these keys (the /debug/timeline consumers
# and the loadgen snapshot depend on them).
STEP_RECORD_KEYS = (
    "step",             # monotone step ordinal (1-based, never wraps)
    "ts_unix_s",        # wall-clock time the dispatch COMPLETED
    "dur_s",            # step wall time (dispatch + harvest sync)
    "kind",             # ragged | spec | prefill | decode | fused | ...
    "rows",             # valid query rows the dispatch carried
    "live_slots",       # slots decoding during the dispatch
    "accepted_tokens",  # client-progress tokens this step (all slots)
    "queue_depth",      # admission queue depth at the step
    "free_pages",       # allocator free pages at the step
    "degraded_mode",    # degraded-ladder level at the step
    "device_us",        # device busy time of a sampled step (within its
                        # dur_s, one clock); null when not sampled
)


class StepTimeline:
    """Bounded ring of per-engine-step records. `record` is engine-thread
    only and never waits on a reader; `snapshot` / `counts_by_kind` are
    safe from any thread."""

    def __init__(self, capacity: int = 1024):
        self.capacity = max(1, int(capacity))
        self._buf: list[dict[str, Any] | None] = [None] * self.capacity
        # Monotone write counter: the step ordinal and the step count.
        # Written by the engine thread only; a bare int read is atomic.
        self._n = 0
        # Cumulative dispatches per kind since construction (engine thread
        # writes; a racing reader sees a value before or after one
        # increment).
        self._by_kind: dict[str, int] = {}

    def record(
        self,
        *,
        dur_s: float,
        kind: str,
        rows: int,
        live_slots: int,
        accepted_tokens: int,
        queue_depth: int,
        free_pages: int,
        degraded_mode: int,
        device_us: int | None = None,
        ts_unix_s: float | None = None,
    ) -> None:
        """Append one step record, built whole and published in one
        reference assignment."""
        n = self._n + 1
        rec = {
            "step": n,
            "ts_unix_s": time.time() if ts_unix_s is None else ts_unix_s,
            "dur_s": round(float(dur_s), 6),
            "kind": kind,
            "rows": int(rows),
            "live_slots": int(live_slots),
            "accepted_tokens": int(accepted_tokens),
            "queue_depth": int(queue_depth),
            "free_pages": int(free_pages),
            "degraded_mode": int(degraded_mode),
            "device_us": None if device_us is None else int(device_us),
        }
        self._buf[(n - 1) % self.capacity] = rec
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
        self._n = n  # publish last: a reader indexing off _n sees rec

    @property
    def total_steps(self) -> int:
        return self._n

    def counts_by_kind(self) -> dict[str, int]:
        """Cumulative dispatches per kind since construction: their deltas
        equal those of ``oryx_serving_dispatches_total{kind=}``."""
        return dict(self._by_kind)

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """Newest-first copies of the last `n` records (all retained when
        None). Under a concurrent writer a slot may hold a newer record
        than the count read promised: still a whole, real record."""
        end = self._n
        avail = min(end, self.capacity)
        want = avail if n is None else max(0, min(int(n), avail))
        out: list[dict[str, Any]] = []
        for i in range(want):
            rec = self._buf[(end - 1 - i) % self.capacity]
            if rec is not None:
                out.append(dict(rec))
        return out

    def to_dict(self, n: int | None = None) -> dict[str, Any]:
        """The /debug/timeline body (less the engine label the server
        adds)."""
        return {
            "capacity": self.capacity,
            "total_steps": self.total_steps,
            "counts_by_kind": self.counts_by_kind(),
            "records": self.snapshot(n),
        }
