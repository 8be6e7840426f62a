"""Span tracing, the request flight recorder and the stall watchdog (port
of `oryx_tpu.utils.trace`).

The metrics layer (utils/metrics.py) answers "how is the system doing on
average"; this module answers "why was THIS request slow" and "what was
the system doing when it stalled". Three pieces, all stdlib:

  * ``Trace`` / ``Tracer`` - a thread-safe span tracer. A Trace is one
    request: a flat append-only list of ``Span``s with parent indices,
    timed on a perf_counter clock anchored to wall nanoseconds at import.
    Exports as Chrome trace-event JSON (loads in Perfetto) and as JSONL.
  * a bounded in-memory flight recorder: the Tracer keeps the last N
    traces (in-flight and finished); ``GET /debug/requests`` serves their
    summaries and ``GET /debug/trace?id=`` one span tree.
  * ``StallWatchdog`` - a daemon thread that dumps every Python thread
    stack plus the recorder's tail to stderr when no unit of progress
    (a decode dispatch) completes within a deadline; one dump per stall.

Context propagation: ``activate(trace)`` binds a trace to the current
context (``contextvars``: per thread, per task); the module-level
``span`` / ``add_complete`` / ``event`` helpers record into whichever
trace is active and do nothing when none is, so library code
(serve/pipeline.py) adds spans without holding a tracer.

The locks are ``named_lock``s (``trace._lock``, ``tracer._lock``,
``watchdog._lock`` in oryx_tpu_torch/concurrency.py's order): plain
``threading.Lock``s unless ``ORYX_LOCK_SANITIZER`` armed the lock-order
sanitizer, which then checks every acquire.
"""

from __future__ import annotations

import contextlib
import contextvars
import io
import json
import re
import sys
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Iterable, Iterator

from oryx_tpu_torch.analysis.sanitizers import named_lock

# perf_counter anchored to the wall clock once at import: spans get the
# monotonicity of perf_counter AND absolute unix-ns starts.
_WALL_ANCHOR_NS = time.time_ns()
_PERF_ANCHOR = time.perf_counter()


def now_ns() -> int:
    """Monotonic unix-epoch nanoseconds (perf_counter past the anchor)."""
    return _WALL_ANCHOR_NS + int(
        (time.perf_counter() - _PERF_ANCHOR) * 1e9
    )


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


# Client-supplied request ids (X-Request-Id) are honoured end to end, but
# they land in log lines and debug URLs, so they are validated: short,
# printable, URL/label-safe. Anything else falls back to a minted id.
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


def sanitize_request_id(raw: str | None) -> str | None:
    """The client-supplied id when it is safe to honour, else None (the
    caller mints). Strips surrounding whitespace; 1-64 chars of
    [A-Za-z0-9._-] starting alphanumeric."""
    if not raw:
        return None
    raw = raw.strip()
    return raw if _REQUEST_ID_RE.match(raw) else None


class Span:
    """One timed region. ``dur_ns`` is None while the span is open;
    ``parent`` indexes the owning Trace's span list (None = root)."""

    __slots__ = ("name", "start_ns", "dur_ns", "parent", "args")

    def __init__(self, name: str, start_ns: int,
                 parent: int | None = None,
                 args: dict[str, Any] | None = None):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns: int | None = None
        self.parent = parent
        self.args = args or None

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {
            "name": self.name, "start_ns": self.start_ns,
            "dur_ns": self.dur_ns, "parent": self.parent,
        }
        if self.args:
            d["args"] = self.args
        return d


class Trace:
    """Span tree for ONE request. Spans are appended by the owning thread;
    readers (debug endpoints, the watchdog) snapshot under ``_lock``, so a
    trace can be serialized mid-flight without torn state."""

    def __init__(self, kind: str, label: str = "",
                 id: str | None = None):
        self.id = id or new_request_id()
        self.kind = kind
        self.label = label
        self.created_ns = now_ns()
        self.end_ns: int | None = None
        self.meta: dict[str, Any] = {}
        self.done = False
        self.spans: list[Span] = []  # guarded-by: _lock
        self._stack: list[int] = []  # open-span indices # guarded-by: _lock
        self._lock = named_lock("trace._lock")

    # ---- recording -------------------------------------------------------

    def begin(self, name: str, **args) -> int:
        """Open a span (child of the innermost open span); returns a
        handle for ``end``, for spans that outlive one scope (the
        scheduler's queue_wait, opened in submit() and closed at
        admission)."""
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            self.spans.append(Span(name, now_ns(), parent, args))
            idx = len(self.spans) - 1
            self._stack.append(idx)
            return idx

    def end(self, handle: int) -> None:
        with self._lock:
            span = self.spans[handle]
            if span.dur_ns is None:
                span.dur_ns = max(0, now_ns() - span.start_ns)
            if handle in self._stack:
                self._stack.remove(handle)

    @contextlib.contextmanager
    def span(self, name: str, **args) -> Iterator[Span]:
        h = self.begin(name, **args)
        with self._lock:
            sp = self.spans[h]
        try:
            yield sp
        finally:
            self.end(h)

    def add_complete(self, name: str, start_ns: int,
                     dur_ns: int | None = None, **args) -> None:
        """Record an already-elapsed region (a device dispatch whose
        window is known only after it returns)."""
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            s = Span(name, start_ns, parent, args)
            s.dur_ns = (
                max(0, now_ns() - start_ns) if dur_ns is None
                else max(0, int(dur_ns))
            )
            self.spans.append(s)

    def event(self, name: str, **args) -> None:
        """Instant (zero-duration) marker, e.g. an eviction."""
        self.add_complete(name, now_ns(), 0, **args)

    def annotate(self, **meta) -> None:
        """Merge metadata into the trace without closing it."""
        with self._lock:
            self.meta.update(meta)

    def finish(self, **meta) -> None:
        """Close the trace: any still-open spans end now."""
        with self._lock:
            t = now_ns()
            for idx in self._stack:
                if self.spans[idx].dur_ns is None:
                    self.spans[idx].dur_ns = max(
                        0, t - self.spans[idx].start_ns
                    )
            self._stack.clear()
            self.meta.update(meta)
            self.end_ns = t
            self.done = True

    def span_seconds(self) -> dict[str, float]:
        """Total recorded duration per span NAME, in seconds (open spans
        count up to now): the cost ledger's queue/prefill/decode wall
        times."""
        t = now_ns()
        with self._lock:
            out: dict[str, float] = {}
            for s in self.spans:
                d = s.dur_ns if s.dur_ns is not None \
                    else max(0, t - s.start_ns)
                out[s.name] = out.get(s.name, 0.0) + d / 1e9
            return out

    # ---- serialization ---------------------------------------------------

    def summary(self) -> dict[str, Any]:
        with self._lock:
            end = self.end_ns or now_ns()
            return {
                "id": self.id, "kind": self.kind, "label": self.label,
                "created_unix_s": self.created_ns / 1e9,
                "duration_ms": (end - self.created_ns) / 1e6,
                "done": self.done,
                "num_spans": len(self.spans),
                "meta": dict(self.meta),
            }

    def to_dict(self) -> dict[str, Any]:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        out = self.summary()
        out["spans"] = spans
        return out

    def chrome_events(self, tid: int = 0) -> list[dict[str, Any]]:
        """Chrome trace-event "X" (complete) events; open spans are drawn
        up to now. ts/dur are microseconds (the format's unit)."""
        t_now = now_ns()
        with self._lock:
            snap = [
                (s.name, s.start_ns,
                 s.dur_ns if s.dur_ns is not None
                 else max(0, t_now - s.start_ns),
                 s.args)
                for s in self.spans
            ]
        events: list[dict[str, Any]] = [{
            "name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
            "args": {"name": f"{self.kind} {self.id} {self.label}".strip()},
        }]
        for name, start, dur, args in snap:
            ev: dict[str, Any] = {
                "name": name, "cat": self.kind, "ph": "X",
                "ts": start / 1e3, "dur": dur / 1e3,
                "pid": 0, "tid": tid,
            }
            if args:
                ev["args"] = args
            events.append(ev)
        return events


class Tracer:
    """Trace factory + bounded flight recorder of the last N traces.
    Traces register at creation, so in-flight work shows in
    ``/debug/requests`` before it completes."""

    def __init__(self, capacity: int = 256):
        self.capacity = max(1, capacity)
        self._lock = named_lock("tracer._lock")
        self._traces: deque[Trace] = deque(maxlen=self.capacity)  # guarded-by: _lock
        self._by_id: dict[str, Trace] = {}  # guarded-by: _lock

    def start_trace(self, kind: str, label: str = "",
                    id: str | None = None) -> Trace:
        """New registered trace. A caller-supplied `id` (an honoured
        X-Request-Id) gives way to a minted one when the recorder still
        holds it, checked and registered under one lock hold: an id names
        one trace."""
        with self._lock:
            if id is not None and id in self._by_id:
                id = None  # collision: mint instead
            tr = Trace(kind, label, id=id)
            if len(self._traces) == self.capacity:
                evicted = self._traces[0]
                self._by_id.pop(evicted.id, None)
            self._traces.append(tr)
            self._by_id[tr.id] = tr
        return tr

    def get(self, id: str) -> Trace | None:
        with self._lock:
            return self._by_id.get(id)

    def traces(self) -> list[Trace]:
        with self._lock:
            return list(self._traces)

    def snapshot(self) -> list[dict[str, Any]]:
        """Newest-first summaries (the /debug/requests body)."""
        return [t.summary() for t in reversed(self.traces())]

    def chrome_trace(
        self, traces: Iterable[Trace] | None = None
    ) -> dict[str, Any]:
        """Perfetto/chrome://tracing-loadable JSON object, one tid track a
        trace."""
        events: list[dict[str, Any]] = []
        for tid, tr in enumerate(traces or self.traces()):
            events.extend(tr.chrome_events(tid=tid))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_jsonl(self, path: str) -> int:
        """Append every recorded trace as one JSON object per line;
        returns the number written."""
        traces = self.traces()
        with open(path, "a") as f:
            for tr in traces:
                f.write(json.dumps(tr.to_dict()) + "\n")
        return len(traces)


# ---------------------------------------------------------------------------
# Context propagation
# ---------------------------------------------------------------------------

_active: contextvars.ContextVar[Trace | None] = contextvars.ContextVar(
    "oryx_active_trace", default=None
)


@contextlib.contextmanager
def activate(trace: Trace | None) -> Iterator[Trace | None]:
    """Bind `trace` as the current context's active trace; the module-level
    span helpers below record into it."""
    token = _active.set(trace)
    try:
        yield trace
    finally:
        _active.reset(token)


def current() -> Trace | None:
    return _active.get()


@contextlib.contextmanager
def span(name: str, **args) -> Iterator[None]:
    """Span on the context-active trace; nothing when none is active."""
    tr = _active.get()
    if tr is None:
        yield None
        return
    with tr.span(name, **args):
        yield None


def add_complete(name: str, start_ns: int, dur_ns: int | None = None,
                 **args) -> None:
    tr = _active.get()
    if tr is not None:
        tr.add_complete(name, start_ns, dur_ns, **args)


def event(name: str, **args) -> None:
    tr = _active.get()
    if tr is not None:
        tr.event(name, **args)


# ---------------------------------------------------------------------------
# Post-hoc span <-> device-time join helpers
# ---------------------------------------------------------------------------


def windows_from_traces(
    traces: Iterable[dict[str, Any]], span_name: str = "decode_chunk"
) -> list[tuple[str, int, int]]:
    """Flight-recorder JSONL/`to_dict` records -> (label, start_ns, end_ns)
    windows for `span_name` spans, the input shape
    utils/xplane.attribute_device_time expects. Labels are
    ``<trace-id>:<span-name>[<ordinal>]``."""
    windows: list[tuple[str, int, int]] = []
    for rec in traces:
        n = 0
        for s in rec.get("spans", []):
            if s.get("name") != span_name or s.get("dur_ns") is None:
                continue
            windows.append((
                f"{rec.get('id', '?')}:{span_name}[{n}]",
                int(s["start_ns"]),
                int(s["start_ns"]) + int(s["dur_ns"]),
            ))
            n += 1
    return windows


def windows_from_jsonl(
    path: str, span_name: str = "decode_chunk"
) -> list[tuple[str, int, int]]:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return windows_from_traces(recs, span_name)


# ---------------------------------------------------------------------------
# Stall watchdog
# ---------------------------------------------------------------------------


class StallWatchdog:
    """Daemon thread that dumps all Python thread stacks + the flight
    recorder tail to `out` when no ``beat()`` arrives within `deadline_s`
    while work is in flight (``set_active(True)``). Exactly ONE dump per
    stall: the next beat re-arms it."""

    def __init__(self, tracer: Tracer | None, deadline_s: float,
                 *, name: str = "oryx", tail: int = 8, out=None):
        self.tracer = tracer
        self.deadline_s = float(deadline_s)
        self.name = name
        self.tail = tail
        self.out = out  # None => sys.stderr resolved at dump time
        self.dumps = 0
        self._lock = named_lock("watchdog._lock")
        self._last_beat = time.perf_counter()  # guarded-by: _lock
        self._active = False  # guarded-by: _lock
        self._armed = True  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"stall-watchdog-{name}", daemon=True
        )

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)

    def beat(self) -> None:
        """A unit of progress (a decode dispatch) completed."""
        with self._lock:
            self._last_beat = time.perf_counter()
            self._armed = True

    def set_active(self, active: bool) -> None:
        """Only in-flight work can stall; an idle engine never dumps."""
        with self._lock:
            if active and not self._active:
                self._last_beat = time.perf_counter()
                self._armed = True
            self._active = active

    def stalled(self) -> bool:
        """True while in-flight work has gone `deadline_s` without a beat
        (the /readyz signal)."""
        with self._lock:
            return (
                self._active
                and time.perf_counter() - self._last_beat > self.deadline_s
            )

    def _run(self) -> None:
        interval = max(0.01, min(self.deadline_s / 4, 1.0))
        while not self._stop.wait(interval):
            with self._lock:
                stalled = (
                    self._active and self._armed
                    and time.perf_counter() - self._last_beat
                    > self.deadline_s
                )
                if stalled:
                    self._armed = False  # one dump per stall
            if stalled:
                self.dump()

    def dump(self) -> None:
        """Thread stacks + recorder tail, built in a buffer and written in
        one call so concurrent stderr writers cannot interleave."""
        buf = io.StringIO()
        buf.write(
            f"\n==== STALL WATCHDOG [{self.name}]: no progress beat in "
            f"{self.deadline_s:g}s ====\n"
        )
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        for ident, frame in frames.items():
            buf.write(
                f"\n-- thread {names.get(ident, '?')} ({ident}) --\n"
            )
            buf.write("".join(traceback.format_stack(frame)))
        if self.tracer is not None:
            buf.write(
                f"\n-- flight recorder tail (last {self.tail}) --\n"
            )
            for rec in self.tracer.traces()[-self.tail:]:
                buf.write(json.dumps(rec.to_dict()) + "\n")
        buf.write(f"==== END STALL DUMP [{self.name}] ====\n")
        out = self.out or sys.stderr
        out.write(buf.getvalue())
        try:
            out.flush()
        # fault-boundary: a closed/broken sink must not turn the stall
        # dump itself into a second crash
        except Exception:
            pass
        self.dumps += 1
