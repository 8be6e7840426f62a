"""The engine flight recorder: a deterministic decision journal (port of
`oryx_tpu.serve.journal`; the same entries, fingerprints and file format,
so a journal either package wrote replays through the other).

The observatories say what the engine DID (traces, timeline, wide events),
what it SPENT (memory, device time) and what it PRODUCED (numerics,
audits); none of them lets you re-run it. This module records the
scheduler's decision STREAM: one entry per engine dispatch and one per
scheduling decision — submit, admission/placement, prefix-cache
splice/COW, host-spill reload, eviction victim choice, degraded-mode
transition, fault-point firing, supervisor restart, terminal finish —
each carrying exactly the inputs the scheduler needed, with
flags/seeds/pool geometry stamped ONCE in a header line. Because every
stochastic input is already pinned (a generator per request seeded from
its seed, deterministic drafters, seeded fault schedules, byte-identical
eviction/restart replay), the journal is SUFFICIENT to rebuild a cold
scheduler and replay the window offline: serve/replay.py asserts
byte-identical reply tokens, decision-for-decision stream equality and
cost-ledger equality, and its overrides re-run the identical workload
under altered flags.

Armed with ``journal_path=`` (api_server) — disarmed, the scheduler holds
``journal=None`` and every instrumentation site is a single attribute
check (armed and unarmed runs produce byte-identical replies and dispatch
schedules). Two sinks, same entries: a bounded in-memory ring at
``GET /debug/journal?n=``, and the size-capped JSONL file
(utils/rolling_sink.py `.1`-roll semantics; the header line is re-written
at the top of every rotation generation so the live file is always
self-describing).

Every field is declared in ``utils.metrics.JOURNAL_EVENT_KEYS``;
``build_journal_event`` rejects undeclared or non-snake_case keys at
runtime.

Entry kinds (the `kind` field):

  ======== ============================================================
  header   first line of the file only (not a ring entry): schema,
           scheduler geometry/flags/seed, faults_spec, model name
  submit   arrival: request id, arrival seq, prompt payload (text-only
           requests carry the replayable payload; media requests a
           fingerprint), requested sampling/max_new/streaming
  reject   admission control refused the submit (reason)
  admit    placement into a slot (first admission AND eviction
           re-admissions; replay_tokens > 0 marks the latter), with the
           EFFECTIVE max_new (degraded clamp applied)
  splice   prefix-cache hit at admission: spliced tokens, shared pages,
           COW tail copies, host-tier pages re-uploaded
  evict    victim choice under page pressure
  step     one engine dispatch: kind/rows/live_slots/accepted/free_pages
           (wall-clock and device time deliberately absent — the journal
           records only what replays deterministically)
  degraded degraded-mode ladder transition (journaled, not replayed:
           the ladder is driven by wall-clock SLO breaches; its effect
           on decisions is captured by the admit entries' clamped
           max_new)
  fault    a fault-point firing (site, cumulative count)
  restart  supervisor restart: restart count, requests requeued
  finish   terminal state: status, finish reason, reply-bytes and
           token-stream fingerprints, the deterministic cost subset
  ======== ============================================================
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from collections import deque
from typing import Any

from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.utils.metrics import JOURNAL_EVENT_KEYS
from oryx_tpu_torch.utils.rolling_sink import RollingSink

# Journal schema version, stamped in the header and every entry.
JOURNAL_SCHEMA = 1

# The cost-ledger keys that replay deterministically (token and page
# COUNTS). The wall-clock half of REQUEST_COST_KEYS (queue_s, prefill_s,
# decode_s, e2e_s, page_seconds, peak_page_seconds) depends on host
# timing and is deliberately NOT journaled — cost-ledger equality in
# serve/replay.py means THIS subset.
DETERMINISTIC_COST_KEYS = (
    "prefill_tokens", "cached_tokens", "decode_steps", "decode_tokens",
    "peak_pages",
)

# Entry kinds the replay harness compares decision-for-decision. The
# rest are timing-coupled (submit arrival, admission-control rejects,
# degraded transitions) and excluded by contract.
REPLAYED_KINDS = (
    "admit", "splice", "evict", "step", "fault", "restart", "finish",
)

_SNAKE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_KEYSET = frozenset(JOURNAL_EVENT_KEYS)


def build_journal_event(**fields: Any) -> dict[str, Any]:
    """Assemble one journal entry from keyword fields, validating every
    key against utils.metrics.JOURNAL_EVENT_KEYS — the same loud-failure
    contract as request_log.build_request_event (`seq` and `ts_unix_s`
    are stamped by DecisionJournal.append; `schema` here)."""
    bad = sorted(
        k for k in fields
        if k not in _KEYSET or not _SNAKE_RE.match(k)
    )
    if bad:
        raise ValueError(
            f"undeclared journal-event field(s) {bad}: add them to "
            "utils.metrics.JOURNAL_EVENT_KEYS (the decision-journal "
            "schema registry) or fix the name"
        )
    ev: dict[str, Any] = {"schema": JOURNAL_SCHEMA}
    ev.update(fields)
    return ev


def fingerprint_text(text: str) -> str:
    """The journal's byte fingerprint: sha256 hex of UTF-8 bytes."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def fingerprint_tokens(tokens) -> str:
    """Fingerprint of a token-id stream (order-sensitive)."""
    return hashlib.sha256(
        ",".join(str(int(t)) for t in tokens).encode()
    ).hexdigest()


class DecisionJournal:
    """Bounded ring + rotating JSONL file of decision entries.

    ``append`` is called from the engine thread (most decisions) and
    from HTTP handler threads (submit/reject, fault observers); all
    shared state sits under one leaf lock (`journal._lock`) held only
    for the seq stamp, ring edit and file write."""

    def __init__(self, path: str | None = None, *, keep: int = 2048,
                 max_bytes: int = 64 * 1024 * 1024):
        self._lock = named_lock("journal._lock")
        self._ring: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max(1, keep)
        )
        self._seq = 0  # guarded-by: _lock
        self._arrival = 0  # guarded-by: _lock
        self._counts: dict[str, int] = {}  # guarded-by: _lock
        # The header accretes across construction (build_server stamps
        # flags/faults/model, the scheduler stamps its effective
        # geometry) and seals before the first entry — single-threaded
        # construction, no lock needed.
        self.header: dict[str, Any] = {
            "kind": "header", "schema": JOURNAL_SCHEMA,
            "ts_unix_s": time.time(), "config": {},
        }
        self._sink = (  # guarded-by: _lock
            RollingSink(path, max_bytes=max_bytes) if path else None
        )
        self.path = self._sink.path if self._sink else None

    # ---- header ----------------------------------------------------------

    def stamp_header(self, **config: Any) -> None:
        """Merge configuration into the header's `config` block. Called
        during construction only (build_server, then the scheduler's
        __init__); `seal_header` writes the merged result as the file's
        first line."""
        self.header["config"].update(config)

    def seal_header(self) -> None:
        """Write the header as the sink's prologue — the first line of
        the live file and of every rotation generation."""
        with self._lock:
            if self._sink is not None:
                self._sink.set_prologue(json.dumps(self.header))

    # ---- writers ---------------------------------------------------------

    def next_arrival(self) -> int:
        """Monotone submit index (stamped into submit entries; the
        replay harness feeds the workload in this order)."""
        with self._lock:
            n = self._arrival
            self._arrival += 1
            return n

    def append(self, entry: dict[str, Any]) -> int:
        """Stamp seq + timestamp into one entry (normally built by
        build_journal_event; re-validated here so a hand-rolled dict
        can't bypass the registry) and record it; returns the seq."""
        bad = sorted(k for k in entry if k not in _KEYSET)
        if bad:
            raise ValueError(
                f"undeclared journal-event field(s) {bad} "
                "(utils.metrics.JOURNAL_EVENT_KEYS is the schema)"
            )
        kind = entry.get("kind")
        with self._lock:
            seq = self._seq
            self._seq += 1
            entry["seq"] = seq
            entry["ts_unix_s"] = time.time()
            self._ring.append(entry)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if self._sink is not None:
                self._sink.write(json.dumps(entry))
        return seq

    def close(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.close()
                self._sink = None

    # ---- readers ---------------------------------------------------------

    @property
    def total(self) -> int:
        with self._lock:
            return self._seq

    def snapshot(self, n: int | None = None) -> list[dict[str, Any]]:
        """Oldest-first copies of the retained entries (last `n` when
        given) — seq order, the same order the file carries."""
        with self._lock:
            entries = list(self._ring)
        if n is not None:
            entries = entries[-max(0, int(n)):]
        return [dict(e) for e in entries]

    def to_dict(self, n: int | None = None) -> dict[str, Any]:
        """The /debug/journal body (the _ring_debug contract shared
        with /debug/timeline|oom|audit): armed state + header + counts
        that reconcile with `total` + the newest-first entries."""
        entries = self.snapshot(n)
        entries.reverse()
        with self._lock:
            counts = dict(self._counts)
            total = self._seq
        return {
            "armed": True,
            "path": self.path,
            "total": total,
            "counts_by_kind": counts,
            "header": self.header,
            "entries": entries,
        }


class _DisarmedJournal:
    """What /debug/journal serves when --journal was not given: the
    same body shape, armed=false, zero entries — so consumers and the
    router merge never special-case the disarmed replica."""

    def to_dict(self, n: int | None = None) -> dict[str, Any]:
        return {
            "armed": False, "path": None, "total": 0,
            "counts_by_kind": {}, "header": None, "entries": [],
        }


DISARMED = _DisarmedJournal()


# ---------------------------------------------------------------------------
# Offline reading (serve/replay.py, tests)
# ---------------------------------------------------------------------------


def read_journal(path: str) -> tuple[dict[str, Any], list[dict[str, Any]]]:
    """(header, entries oldest-first) from a journal file. When the
    sink rotated, ``<path>.1`` is read first and the two generations
    are merged on seq (each generation re-carries the header line, so
    either file alone is self-describing)."""
    header: dict[str, Any] | None = None
    by_seq: dict[int, dict[str, Any]] = {}
    for p in (path + ".1", path):
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                if obj.get("kind") == "header":
                    header = obj
                else:
                    by_seq[obj["seq"]] = obj
    if header is None:
        raise ValueError(f"no header line in journal {path}")
    return header, [by_seq[s] for s in sorted(by_seq)]
