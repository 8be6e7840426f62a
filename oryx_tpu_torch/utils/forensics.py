"""OOM forensics: a bounded ring of memory-pressure incident records (port
of `oryx_tpu.utils.forensics`).

An `OutOfPagesError` is survivable by design (the scheduler defers,
evicts or recomputes and the client never sees it), which is why a
capacity incident leaves no trace but a counter once the pool recovers.
At each one the scheduler captures one bounded record while the state
that caused it is still live: the pool summary (utils/pagemap.summarize),
the top-K residents by pages held with their in-flight cost ledgers, the
prefix cache's LRU tail and the step-timeline tail, served at
``GET /debug/oom?n=``.

The scheduler's engine thread is the only writer; debug-endpoint threads
read copies. One leaf lock guards the ring, held only for the append or
the copy.

Stdlib only.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

from oryx_tpu_torch.analysis.sanitizers import named_lock

# Residents / cache entries kept per record: enough to name the pressure
# sources, few enough that a record stays one readable screen.
TOP_K = 8


class ForensicRing:
    """Bounded newest-last ring of forensic records. `append` returns the
    record's monotone index, the join key of its oom_pressure wide
    event."""

    def __init__(self, keep: int = 64):
        self._lock = named_lock("forensics._lock")
        self._ring: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max(1, int(keep))
        )
        self._total = 0  # guarded-by: _lock

    def append(self, record: dict[str, Any]) -> int:
        """Record one incident; stamps ts_unix_s (when absent) and index,
        and returns the index."""
        with self._lock:
            idx = self._total
            record.setdefault("ts_unix_s", time.time())
            record["index"] = idx
            self._ring.append(record)
            self._total += 1
        return idx

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """Newest-first copies of the retained records (the last `n` when
        given)."""
        with self._lock:
            records = list(self._ring)
        if n is not None:
            records = records[-max(0, int(n)):]
        return [dict(r) for r in reversed(records)]

    def to_dict(self, n: int | None = None) -> dict[str, Any]:
        """The /debug/oom body (less the engine label the server adds)."""
        return {
            "total": self.total,
            "records": self.snapshot(n),
        }
