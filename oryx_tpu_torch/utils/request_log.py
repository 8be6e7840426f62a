"""Wide-event request log: one canonical JSONL event per terminal request
(port of `oryx_tpu.utils.request_log`).

At the moment a request reaches any terminal state (finish / error /
cancel / reject) the scheduler merges its cost ledger, the span-derived
wall times inside it, the outcome and the engine's identity into ONE flat
JSON object, every field drawn from the declared registry
`utils.metrics.REQUEST_EVENT_KEYS`.

Two sinks, same events:

  * a bounded in-memory ring, exported at
    ``GET /debug/requests?format=jsonl``;
  * optionally a size-capped ``requests.jsonl`` file (``--requests-log``),
    rolling to ``<path>.1`` past ``max_bytes`` (utils/rolling_sink.py).

``build_request_event`` rejects undeclared or non-snake_case keys, so the
JSONL schema cannot drift from the metrics. The sink also carries the
memory-pressure events (``build_oom_event``, kind "oom_pressure",
utils/forensics.py holds the full records) and the output-audit events
(``build_audit_event``, kind "audit", serve/audit.py), each validated
against its own declared schema, dispatched on `kind`.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import deque
from typing import Any

from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.utils.metrics import (
    AUDIT_EVENT_KEYS,
    OOM_EVENT_KEYS,
    REQUEST_EVENT_KEYS,
)
from oryx_tpu_torch.utils.rolling_sink import RollingSink

# The wide-event schema version, stamped into every event.
EVENT_SCHEMA = 1

_SNAKE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_KEYSET = frozenset(REQUEST_EVENT_KEYS)
# Non-request events share the sink under their own schema, dispatched on
# `kind` (not a request-event key, so a request event is never one).
_KIND_KEYSETS = {
    "oom_pressure": frozenset(OOM_EVENT_KEYS),
    "audit": frozenset(AUDIT_EVENT_KEYS),
}


def build_request_event(**fields: Any) -> dict[str, Any]:
    """Assemble one wide event from keyword fields, validating every key
    against the declared registry. `schema` and `ts_unix_s` are filled
    when absent. Raises ValueError on an undeclared or non-snake_case
    key."""
    bad = sorted(
        k for k in fields
        if k not in _KEYSET or not _SNAKE_RE.match(k)
    )
    if bad:
        raise ValueError(
            f"undeclared request-event field(s) {bad}: add them to "
            "utils.metrics.REQUEST_EVENT_KEYS (the wide-event schema "
            "registry) or fix the name"
        )
    ev: dict[str, Any] = {"schema": EVENT_SCHEMA, "ts_unix_s": time.time()}
    ev.update(fields)
    return ev


def _kind_event(kind: str, registry: str, fields: dict[str, Any]
                ) -> dict[str, Any]:
    bad = sorted(
        k for k in fields
        if k not in _KIND_KEYSETS[kind] or not _SNAKE_RE.match(k)
    )
    if bad:
        raise ValueError(
            f"undeclared {kind} event field(s) {bad}: add them to "
            f"utils.metrics.{registry} or fix the name"
        )
    ev: dict[str, Any] = {
        "schema": EVENT_SCHEMA, "ts_unix_s": time.time(), "kind": kind,
    }
    ev.update(fields)
    return ev


def build_oom_event(**fields: Any) -> dict[str, Any]:
    """One memory-pressure wide event (`kind="oom_pressure"`), validated
    against utils.metrics.OOM_EVENT_KEYS; `forensic_index` joins it to
    its full record at /debug/oom."""
    return _kind_event("oom_pressure", "OOM_EVENT_KEYS", fields)


def build_audit_event(**fields: Any) -> dict[str, Any]:
    """One output-audit wide event (`kind="audit"`), validated against
    utils.metrics.AUDIT_EVENT_KEYS; `audit_index` joins it to its full
    record at /debug/audit."""
    return _kind_event("audit", "AUDIT_EVENT_KEYS", fields)


class RequestLog:
    """Bounded ring + optional rotating JSONL file of wide events.

    ``append`` runs on the engine thread's terminal paths (and in submit()
    on a rejection); readers are debug-endpoint handler threads. All
    shared state sits under one lock held only for the ring edit and the
    file write."""

    def __init__(self, path: str | None = None, *, keep: int = 512,
                 max_bytes: int = 16 * 1024 * 1024):
        self.path = os.path.abspath(path) if path else None
        self.max_bytes = max_bytes
        self._lock = named_lock("request_log._lock")
        self._ring: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max(1, keep)
        )
        self._total = 0  # guarded-by: _lock
        self._sink = None  # guarded-by: _lock
        if self.path:
            with self._lock:
                self._sink = RollingSink(self.path, max_bytes=max_bytes)

    def append(self, event: dict[str, Any]) -> None:
        """Record one event (normally built by build_request_event,
        build_oom_event or build_audit_event; re-validated here against
        the schema its `kind` names, so a hand-rolled dict cannot bypass
        the registry)."""
        keyset = _KIND_KEYSETS.get(event.get("kind"), _KEYSET)
        bad = sorted(k for k in event if k not in keyset)
        if bad:
            raise ValueError(
                f"undeclared request-event field(s) {bad} "
                "(utils.metrics.REQUEST_EVENT_KEYS / OOM_EVENT_KEYS / "
                "AUDIT_EVENT_KEYS is the schema)"
            )
        line = json.dumps(event)
        with self._lock:
            self._ring.append(event)
            self._total += 1
            if self._sink is not None:
                self._sink.write(line)

    # ---- readers ---------------------------------------------------------

    @property
    def total(self) -> int:
        with self._lock:
            return self._total

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """Oldest-first copies of the retained events (the last `n` when
        given): log order, the order the file carries."""
        with self._lock:
            events = list(self._ring)
        if n is not None:
            events = events[-max(0, int(n)):]
        return [dict(e) for e in events]

    def export_jsonl(self, n: int | None = None) -> str:
        """The ring as JSONL text (the ?format=jsonl body)."""
        lines = [json.dumps(e) for e in self.snapshot(n)]
        return "\n".join(lines) + ("\n" if lines else "")

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None
