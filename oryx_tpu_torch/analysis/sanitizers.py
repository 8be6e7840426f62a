"""Runtime sanitizers: the dynamic half of oryxlint, for the port.

Static checks catch the patterns; these catch the behaviours, in unit
tests and canary runs, on the CPU or the card:

  * `recompile_watchdog()` counts CUDA graph captures per graph key for
    the duration of a `with` block (through the capture hook of
    `ops/cuda/graphs.CountedGraph`, which `_DecodeGraph` and
    `_EngineStepGraph` capture through), exports every capture beyond a
    key's first as `oryx_recompiles_total{fn=<key>}` on a metrics
    registry, and raises `RecompileStormError` when one key captures more
    than `budget` times. An engine that re-captures its decode graph every
    dispatch (a key that churns) fails a test in seconds instead of
    showing up as a TTFT regression. It is the port's counterpart of the
    JAX package's watchdog over compilation-cache misses: a capture is
    what a compile was there.
  * `donation_guard()` is the in-place guard: it tracks tensors that a
    call must update in place (the optimizer step's parameters, the pool
    writers' pages). `assert_consumed()` proves each kept its storage
    (same `data_ptr`) and was written (its `_version` advanced), and
    `check()` raises `UseAfterDonateError` naming the first tracked tensor
    whose storage was swapped, where a caller holding the old storage
    would read stale bytes.
  * `LockOrderSanitizer`: port code creates its locks through
    `named_lock(name, kind=...)`. Disarmed (the default) that returns a
    plain `threading.Lock/RLock/Condition` at the cost of one global
    read; armed (`ORYX_LOCK_SANITIZER=1`, or `lock_sanitizer()` in tests)
    it returns an instrumented wrapper that keeps a per-thread held-lock
    stack, raises `LockOrderViolation` at the acquire that inverts the
    declared order (oryx_tpu_torch/concurrency.py), forms a cycle or
    re-enters a non-reentrant lock, counts re-entrant acquires per name,
    and exports `oryx_lock_wait_seconds{lock=}` /
    `oryx_lock_hold_seconds{lock=}` histograms through a bound Registry.
    `hot_dispatch(name)` flags a device dispatch entered while holding
    any instrumented lock.
  * `RaceDetector`: a LockSet/Eraser-style happens-before race detector
    over the `# guarded-by:` / `# thread-owned:` annotated fields, read
    from the modules' source with the same three patterns the static
    rules use (`field_annotations` below). Armed, it installs data
    descriptors on the annotated classes: per-field last-accessor
    tracking with ownership handoff (A A B B is a legal transfer; A B A,
    a prior live accessor interleaving back, makes the field shared),
    after which a guarded field must be accessed under its declared lock
    and a thread-owned field must not be touched by a second live thread.
    Thread death is a happens-before edge: a dead owner's state hands off
    freely (what makes supervisor restart and drain of a dead engine
    legal).

This module imports only the standard library at import time, so every
module of the port (the metrics registry included) can take its locks
from it.
"""

from __future__ import annotations

import ast
import contextlib
import io
import os
import re
import threading
import time
import tokenize
from typing import Any, Iterator


class RecompileStormError(RuntimeError):
    """A graph key exceeded its capture budget inside a
    `recompile_watchdog` block."""


class UseAfterDonateError(RuntimeError):
    """A tracked tensor's storage was swapped: a reader of the old storage
    would see stale bytes."""


class RecompileStats:
    """Per-graph-key capture counts observed by the watchdog."""

    def __init__(self, budget: int):
        self.budget = budget
        self.counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def record(self, fn_name: str) -> int:
        with self._lock:
            self.counts[fn_name] = self.counts.get(fn_name, 0) + 1
            return self.counts[fn_name]

    @property
    def total(self) -> int:
        with self._lock:
            return sum(self.counts.values())

    def over_budget(self) -> dict[str, int]:
        with self._lock:
            return {
                k: v for k, v in self.counts.items() if v > self.budget
            }


@contextlib.contextmanager
def recompile_watchdog(
    budget: int = 1,
    *,
    registry=None,
    action: str = "raise",
) -> Iterator[RecompileStats]:
    """Count CUDA graph captures per graph key inside the block; over
    budget raises (action="raise") at exit or just records
    (action="record").

    budget: the most captures allowed per graph key (the label a
    `CountedGraph` capture reports: its owner and a digest of the key that
    fixes its launches). The first capture of a key is expected (a cold
    start); every capture beyond it increments
    `oryx_recompiles_total{fn=...}` on `registry` (a `utils.metrics.
    Registry`; pass `serving_metrics.registry` from serving code)."""
    if action not in ("raise", "record"):
        raise ValueError(f"action must be 'raise' or 'record', got {action!r}")
    from oryx_tpu_torch.ops.cuda import graphs

    stats = RecompileStats(budget)
    counter = None
    if registry is not None:
        counter = registry.counter(
            "oryx_recompiles_total", ("fn",), raw_name=True
        )

    def on_capture(fn_name: str) -> None:
        n = stats.record(fn_name)
        if n > 1 and counter is not None:
            counter.labels(fn=fn_name).inc()

    graphs.add_capture_hook(on_capture)
    try:
        yield stats
    finally:
        graphs.remove_capture_hook(on_capture)
    over = stats.over_budget()
    if over and action == "raise":
        worst = max(over, key=over.get)
        raise RecompileStormError(
            f"recompile storm: {worst!r} captured {over[worst]} times "
            f"(budget {stats.budget}) inside a recompile_watchdog block; "
            f"all over budget: {over}. A graph key that changes every "
            "dispatch, or a graph dropped and captured again, is the "
            "usual cause."
        )


def _tensors(tree: Any) -> list:
    """The tensor leaves of a tensor, module, dict, list or tuple, in
    order (a module's parameters and buffers by name)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return [t for _, t in sorted(tree.state_dict(keep_vars=True).items())]
    if isinstance(tree, dict):
        return [t for k in tree for t in _tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


class DonationGuard:
    """Tracks tensors across calls that must update them in place."""

    def __init__(self, *trees: Any, label: str = ""):
        self.label = label
        self._leaves = [t for tree in trees for t in _tensors(tree)]
        self._ptrs = [t.data_ptr() for t in self._leaves]
        self._versions = [t._version for t in self._leaves]

    def _tag(self) -> str:
        return f"donation_guard{f' [{self.label}]' if self.label else ''}"

    def _swapped(self, t, i: int) -> bool:
        return t.data_ptr() != self._ptrs[i]

    @property
    def consumed(self) -> bool:
        """True when every tracked tensor was written in place."""
        return bool(self._leaves) and all(
            not self._swapped(t, i) and t._version > self._versions[i]
            for i, t in enumerate(self._leaves)
        )

    def assert_consumed(self) -> None:
        """The in-place contract held: every tracked tensor kept its
        storage and was written. Failing means an update silently became
        a copy (twice the memory on the card, and a holder of the old
        storage reads stale bytes) or never ran. Tracking no tensor also
        fails: a guard over a tree without tensors verifies nothing."""
        if not self._leaves:
            raise AssertionError(
                f"{self._tag()}: no tensors were tracked: the guarded tree "
                "holds none, so the in-place update cannot be verified"
            )
        copied = [i for i, t in enumerate(self._leaves)
                  if self._swapped(t, i)]
        unwritten = [i for i, t in enumerate(self._leaves)
                     if t._version <= self._versions[i]]
        if copied or unwritten:
            raise AssertionError(
                f"{self._tag()}: of {len(self._leaves)} tracked tensors, "
                f"{len(copied)} were NOT updated in place (storage "
                f"swapped) and {len(unwritten)} were never written"
            )

    def check(self, tree: Any = None) -> None:
        """Raise `UseAfterDonateError` if a tracked tensor (of `tree`, by
        default every tracked one) had its storage swapped: call this
        before a read that must see the updated bytes."""
        index = {id(t): i for i, t in enumerate(self._leaves)}
        leaves = self._leaves if tree is None else _tensors(tree)
        for t in leaves:
            i = index.get(id(t))
            if i is not None and self._swapped(t, i):
                raise UseAfterDonateError(
                    f"{self._tag()}: tensor {i} "
                    f"({tuple(t.shape)} {t.dtype}) had its storage "
                    "swapped; reading the old storage is use-after-donate"
                )


@contextlib.contextmanager
def donation_guard(
    *trees: Any, expect_consumed: bool = False, label: str = ""
) -> Iterator[DonationGuard]:
    """Context-manager sugar over `DonationGuard`. With
    `expect_consumed=True` the exit asserts every tracked tensor was
    updated in place (use in tests around one updating call)."""
    guard = DonationGuard(*trees, label=label)
    yield guard
    if expect_consumed:
        guard.assert_consumed()


# ---------------------------------------------------------------------------
# The annotation reader (the static rules' language, read from source)
# ---------------------------------------------------------------------------

# A field declaration line carrying a concurrency marker in a real
# comment (tokenized, so quoted syntax in docstrings never counts):
#   self._queue: deque = deque()   # guarded-by: _cond
#   cost_decode_steps: int = 0     # thread-owned: engine
# The declaration covers `self.x = ...`, `self.x: T = ...` and bare
# dataclass / class-body fields (`x: T = ...`, `x: T`).
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*(\w+)")
_THREAD_OWNED_RE = re.compile(r"#\s*thread-owned:\s*(\w+)")
_FIELD_DECL_RE = re.compile(
    r"^\s*(?:self\.)?([A-Za-z_]\w*)\s*(?::[^=#]+)?(?:=(?!=)|$)"
)


def _comments(source: str) -> dict[int, str]:
    """line (1-based) -> the text of the comment token on it."""
    out: dict[int, str] = {}
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.COMMENT:
            out[tok.start[0]] = tok.string
    return out


def field_annotations(source: str) -> list[tuple[str, dict]]:
    """(class name, {field: ("guarded-by", lock attr) | ("thread-owned",
    owner tag)}) for every class of `source`, nested ones included, from
    the marker comments on declaration lines inside its body."""
    lines = source.splitlines()
    comments = _comments(source)
    out = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.ClassDef):
            continue
        fields: dict[str, tuple[str, str]] = {}
        for line in range(node.lineno, (node.end_lineno or node.lineno) + 1):
            comment = comments.get(line, "")
            m = _GUARDED_RE.search(comment)
            kind = "guarded-by"
            if not m:
                m = _THREAD_OWNED_RE.search(comment)
                kind = "thread-owned"
            if not m:
                continue
            decl = _FIELD_DECL_RE.match(lines[line - 1].split("#", 1)[0])
            if decl:
                fields[decl.group(1)] = (kind, m.group(1))
        out.append((node.name, fields))
    return out


# ---------------------------------------------------------------------------
# Lock-order sanitizer + race detector
# ---------------------------------------------------------------------------


class LockOrderViolation(RuntimeError):
    """An instrumented lock acquire inverted the declared order, formed a
    cycle, re-entered a non-reentrant lock, or a hot-path dispatch ran
    while a lock was held."""


class RaceViolation(RuntimeError):
    """An annotated field was touched off its declared lock (shared state)
    or by an interloping live thread (thread-owned state)."""


class LockStats:
    """What the sanitizer observed: violations (recorded even when
    action='record') and per-name acquire / re-entrant-acquire counts."""

    def __init__(self) -> None:
        self.violations: list[str] = []
        self.acquires: dict[str, int] = {}
        self.reentrant: dict[str, int] = {}


class _Held:
    __slots__ = ("lock", "t0")

    def __init__(self, lock: "_InstrumentedLock", t0: float):
        self.lock = lock
        self.t0 = t0


class LockOrderSanitizer:
    """Per-thread held-lock stacks + declared-order / cycle checking for
    every lock created through `named_lock` while armed."""

    _SAMPLE_CAP = 100_000  # buffered (kind, name, seconds) samples

    def __init__(self, order: tuple[str, ...] | None = None,
                 action: str = "raise"):
        if action not in ("raise", "record"):
            raise ValueError(
                f"action must be 'raise' or 'record', got {action!r}"
            )
        if order is None:
            from oryx_tpu_torch.concurrency import LOCK_ORDER

            order = LOCK_ORDER
        self.order = tuple(order)
        self.rank = {name: i for i, name in enumerate(self.order)}
        self.action = action
        self.stats = LockStats()
        # Internal state lock: a plain lock outside the instrumented world
        # (a leaf; it never recurses into the sanitizer).
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._edges: dict[str, set[str]] = {}
        self._samples: list[tuple[str, str, float]] = []
        self._dropped_samples = 0
        # The newest bind_registry() owns the sample stream; a superseded
        # binding's collector does nothing.
        self._bind_gen: object | None = None

    def make(self, name: str, kind: str = "lock") -> "_InstrumentedLock":
        return _InstrumentedLock(self, name, kind)

    def _held(self) -> list[_Held]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_names(self) -> list[str]:
        return [e.lock.name for e in self._held()]

    def _violation(self, msg: str) -> None:
        with self._mu:
            self.stats.violations.append(msg)
        if self.action == "raise":
            raise LockOrderViolation(msg)

    def before_acquire(self, lock: "_InstrumentedLock") -> bool:
        """Order/cycle check; True when this is a re-entrant acquire of
        the same (reentrant) instance."""
        held = self._held()
        if any(e.lock is lock for e in held):
            if lock.kind == "lock":
                self._violation(
                    f"re-entrant acquire of non-reentrant lock "
                    f"'{lock.name}': guaranteed self-deadlock"
                )
            with self._mu:
                self.stats.reentrant[lock.name] = (
                    self.stats.reentrant.get(lock.name, 0) + 1
                )
            return True
        flagged: set[str] = set()  # held-lock names already reported
        for e in held:
            h = e.lock
            if h.name == lock.name:
                flagged.add(h.name)
                self._violation(
                    f"acquiring '{lock.name}' while already holding a "
                    f"DIFFERENT lock of the same name: same-rank locks "
                    "must never nest (no order between instances)"
                )
                continue
            ra = self.rank.get(h.name)
            rb = self.rank.get(lock.name)
            if ra is not None and rb is not None and rb < ra:
                flagged.add(h.name)
                self._violation(
                    f"acquiring '{lock.name}' while holding '{h.name}' "
                    f"inverts the declared lock order "
                    f"('{lock.name}' < '{h.name}' in "
                    "oryx_tpu_torch/concurrency.py)"
                )
        with self._mu:
            # Pairs reported above are kept out of both the cycle check
            # and the edge insert: in record mode an inverted edge would
            # otherwise make every later legal nesting of the pair a
            # spurious "cycle".
            for e in held:
                if e.lock.name in flagged:
                    continue
                if self._reaches(lock.name, e.lock.name):
                    cycle = f"'{e.lock.name}' -> '{lock.name}'"
                    self.stats.violations.append(
                        f"lock-order cycle closed by acquiring "
                        f"'{lock.name}' while holding '{e.lock.name}' "
                        f"(the reverse path {cycle} was already "
                        "observed)"
                    )
                    if self.action == "raise":
                        raise LockOrderViolation(
                            self.stats.violations[-1]
                        )
            for e in held:
                if e.lock.name not in flagged \
                        and e.lock.name != lock.name:
                    self._edges.setdefault(
                        e.lock.name, set()
                    ).add(lock.name)
        return False

    def _reaches(self, a: str, b: str) -> bool:
        # Caller holds self._mu.
        seen: set[str] = set()
        stack = [a]
        while stack:
            n = stack.pop()
            if n == b:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def note_acquired(self, lock: "_InstrumentedLock",
                      waited_s: float) -> None:
        self._held().append(_Held(lock, time.perf_counter()))
        with self._mu:
            self.stats.acquires[lock.name] = (
                self.stats.acquires.get(lock.name, 0) + 1
            )
            self._sample("wait", lock.name, waited_s)

    def note_release(self, lock: "_InstrumentedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is lock:
                e = held.pop(i)
                with self._mu:
                    self._sample(
                        "hold", lock.name,
                        time.perf_counter() - e.t0,
                    )
                return
        # Released a lock this thread never acquired through the
        # sanitizer (armed mid-flight): the inner lock complains if wrong.

    def _sample(self, kind: str, name: str, seconds: float) -> None:
        # Caller holds self._mu. Buffered and flushed by the registry's
        # collector at scrape time: observing here would take
        # registry._lock inside lock bookkeeping, the hidden nesting this
        # sanitizer exists to forbid.
        if len(self._samples) >= self._SAMPLE_CAP:
            self._dropped_samples += 1
            return
        self._samples.append((kind, name, seconds))

    def bind_registry(self, registry) -> None:
        """Pre-register the oryx_lock_* histograms on `registry` and flush
        buffered samples into them at every scrape. The newest binding
        owns the samples buffered after it; a superseded registry's
        scrape does nothing. Samples dropped at the buffer cap show as
        `oryx_lock_samples_dropped_total`."""
        from oryx_tpu_torch.utils.metrics import LOCK_SECONDS_BUCKETS

        wait_hist = registry.histogram(
            "oryx_lock_wait_seconds", LOCK_SECONDS_BUCKETS, ("lock",),
            raw_name=True,
        )
        hold_hist = registry.histogram(
            "oryx_lock_hold_seconds", LOCK_SECONDS_BUCKETS, ("lock",),
            raw_name=True,
        )
        dropped = registry.counter(
            "oryx_lock_samples_dropped_total", raw_name=True
        )
        self._bind_gen = gen = object()

        def flush() -> None:
            if self._bind_gen is not gen:
                return  # superseded by a newer binding
            with self._mu:
                samples, self._samples = self._samples, []
                d, self._dropped_samples = self._dropped_samples, 0
            for kind, name, seconds in samples:
                hist = wait_hist if kind == "wait" else hold_hist
                hist.labels(lock=name).observe(seconds)
            if d:
                dropped.inc(d)

        self._flush = flush
        registry.register_collector(flush)

    def flush_metrics(self) -> None:
        """Flush into the current binding (nothing when never bound)."""
        flush = getattr(self, "_flush", None)
        if flush is not None:
            flush()


class _InstrumentedLock:
    """Wrapper over threading.Lock/RLock/Condition that reports to a
    LockOrderSanitizer: the wrapped primitive's surface, plus Condition's
    wait/notify family, which keeps the held stack honest across the
    wait's internal release and re-acquire."""

    __slots__ = ("_san", "name", "kind", "_inner")

    def __init__(self, san: LockOrderSanitizer, name: str, kind: str):
        if kind not in ("lock", "rlock", "condition"):
            raise ValueError(f"unknown lock kind {kind!r}")
        self._san = san
        self.name = name
        self.kind = kind
        self._inner = (
            threading.Condition() if kind == "condition"
            else threading.RLock() if kind == "rlock"
            else threading.Lock()
        )

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentrant = self._san.before_acquire(self)
        t0 = time.perf_counter()
        ok = self._inner.acquire(blocking, timeout)
        if ok and not reentrant:
            self._san.note_acquired(self, time.perf_counter() - t0)
        elif ok and reentrant:
            self._san._held().append(_Held(self, time.perf_counter()))
        return ok

    def release(self) -> None:
        self._san.note_release(self)
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        if hasattr(inner, "locked"):
            return inner.locked()
        return bool(inner._is_owned())

    def held_by_current(self) -> bool:
        return any(e.lock is self for e in self._san._held())

    def _wait_around(self, fn, *args):
        # Condition.wait releases the lock and re-acquires it before it
        # returns, but the entry stays on the held stack: while blocked
        # the thread runs nothing, and wait_for's predicate runs with the
        # lock really held (a guarded-field read there is legal). Only the
        # hold-time metric honours the release: the segment up to the
        # wait is sampled now and the clock restarts at wake-up.
        san = self._san
        entry = next(
            (e for e in reversed(san._held()) if e.lock is self), None
        )
        if entry is not None:
            with san._mu:
                san._sample(
                    "hold", self.name,
                    time.perf_counter() - entry.t0,
                )
        try:
            return fn(*args)
        finally:
            if entry is not None:
                entry.t0 = time.perf_counter()

    def wait(self, timeout: float | None = None):
        return self._wait_around(self._inner.wait, timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        return self._wait_around(self._inner.wait_for, predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


_MISSING = object()


class _FieldState:
    __slots__ = ("owner", "prior", "shared")

    def __init__(self, owner: threading.Thread):
        self.owner = owner
        self.prior: set[threading.Thread] = set()
        self.shared = False


class _RaceField:
    """Data descriptor installed over an annotated field. Shadows the
    class attribute, keeps the live value in the instance __dict__ (or
    delegates to the original slot descriptor) and runs the handoff /
    lockset state machine on every access."""

    __slots__ = ("det", "field", "kind", "arg", "orig", "skey")

    def __init__(self, det: "RaceDetector", field: str, kind: str,
                 arg: str, orig: Any):
        self.det = det
        self.field = field
        self.kind = kind  # "guarded-by" | "thread-owned"
        self.arg = arg    # lock attr name | owner tag
        self.orig = orig  # original slot/other descriptor, or _MISSING
        self.skey = f"__race_{field}"

    def _check(self, obj: Any, write: bool) -> None:
        det = self.det
        # The exemption is module-wide (per thread), not per detector: a
        # descriptor can outlive the arming that installed it (arming from
        # the environment has no disarm point, and a re-arming skips
        # fields already instrumented).
        if getattr(_EXEMPT, "depth", 0):
            return
        t = threading.current_thread()
        with det._mu:
            state = obj.__dict__.get(self.skey)
            if state is None:
                obj.__dict__[self.skey] = _FieldState(t)
                return
            if state.owner is t:
                if state.shared and self.kind == "guarded-by":
                    self._require_lock(obj, t)
                return
            if not state.owner.is_alive():
                # Happens-before through thread death: a fresh exclusive
                # epoch (the supervisor touching a dead engine's state).
                state.owner = t
                state.prior.clear()
                state.shared = False
                return
            state.prior = {p for p in state.prior if p.is_alive()}
            if state.shared or t in state.prior:
                # A prior live accessor interleaved back: the field is
                # shared from here on.
                state.shared = True
                state.prior.add(state.owner)
                state.owner = t
                if self.kind == "thread-owned":
                    self.det._violation(
                        f"thread-owned field "
                        f"'{type(obj).__name__}.{self.field}' (owner: "
                        f"{self.arg}) touched by interleaving live "
                        f"threads ({t.name} while prior accessors are "
                        "alive) — ownership never transferred"
                    )
                else:
                    self._require_lock(obj, t)
            else:
                # Clean handoff: the previous owner never came back.
                state.prior.add(state.owner)
                state.owner = t

    def _require_lock(self, obj: Any, t: threading.Thread) -> None:
        lock = getattr(obj, self.arg, None)
        if not _held_by_current(lock):
            self.det._violation(
                f"guarded field '{type(obj).__name__}.{self.field}' "
                f"accessed by {t.name} without holding its declared "
                f"lock 'self.{self.arg}' while the field is shared "
                "between live threads"
            )

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        self._check(obj, write=False)
        if self.orig is not _MISSING and hasattr(self.orig, "__get__"):
            return self.orig.__get__(obj, objtype)
        try:
            return obj.__dict__[self.field]
        except KeyError:
            raise AttributeError(self.field) from None

    def __set__(self, obj, value) -> None:
        self._check(obj, write=True)
        if self.orig is not _MISSING and hasattr(self.orig, "__set__"):
            self.orig.__set__(obj, value)
        else:
            obj.__dict__[self.field] = value

    def __delete__(self, obj) -> None:
        self._check(obj, write=True)
        if self.orig is not _MISSING and hasattr(self.orig, "__delete__"):
            self.orig.__delete__(obj)
        else:
            del obj.__dict__[self.field]


def _held_by_current(lock: Any) -> bool:
    if lock is None:
        return False
    if isinstance(lock, _InstrumentedLock):
        return lock.held_by_current()
    if hasattr(lock, "_is_owned"):  # Condition / RLock
        try:
            return bool(lock._is_owned())
        # fault-boundary: an exotic lock type degrades to approximate
        # checking, never breaks the run under test
        except Exception:
            return True
    if hasattr(lock, "locked"):
        # A plain Lock has no owner: `locked()` (someone holds it) is the
        # best approximation. Armed runs create instrumented locks, so
        # this covers only locks made before arming.
        return lock.locked()
    return True


class RaceDetector:
    """Installs _RaceField descriptors over every `# guarded-by:` /
    `# thread-owned:` annotated field of the classes in the target
    modules, the annotations read from source by `field_annotations`."""

    def __init__(self, action: str = "raise",
                 stats_sink: LockStats | None = None):
        if action not in ("raise", "record"):
            raise ValueError(
                f"action must be 'raise' or 'record', got {action!r}"
            )
        self.action = action
        self.violations: list[str] = []
        # Race findings mirror into the paired sanitizer's stats, so one
        # `lock_stats().violations` assertion covers both halves.
        self._sink = stats_sink
        self._mu = threading.Lock()
        self._installed: list[tuple[type, str, Any]] = []

    def _violation(self, msg: str) -> None:
        # Caller holds self._mu (list.append is atomic under the GIL, so
        # the sink append needs no lock of its own).
        self.violations.append(msg)
        if self._sink is not None:
            self._sink.violations.append(msg)
        if self.action == "raise":
            raise RaceViolation(msg)

    def install_module(self, module) -> int:
        """Instrument every annotated field of `module`'s classes; returns
        the number of fields instrumented."""
        import inspect

        try:
            source = inspect.getsource(module)
        except (OSError, TypeError):
            return 0
        count = 0
        for name, fields in field_annotations(source):
            cls = getattr(module, name, None)
            if not isinstance(cls, type):
                continue
            for field, (kind, arg) in fields.items():
                orig = cls.__dict__.get(field, _MISSING)
                if isinstance(orig, _RaceField):
                    continue  # already instrumented
                setattr(cls, field, _RaceField(self, field, kind, arg, orig))
                self._installed.append((cls, field, orig))
                count += 1
        return count

    def uninstall(self) -> None:
        for cls, field, orig in reversed(self._installed):
            if orig is _MISSING:
                try:
                    delattr(cls, field)
                except AttributeError:
                    pass
            else:
                setattr(cls, field, orig)
        self._installed.clear()


# ---------------------------------------------------------------------------
# Arming (module-global, as utils.faults: one global read on the hot path
# when disarmed)
# ---------------------------------------------------------------------------

_SAN: LockOrderSanitizer | None = None
_RACE: RaceDetector | None = None
_ENV_VAR = "ORYX_LOCK_SANITIZER"

# The modules whose annotated classes the race detector instruments when
# armed without a list: the serving concurrency surface.
_RACE_MODULES = (
    "oryx_tpu_torch.serve.scheduler",
    "oryx_tpu_torch.serve.prefix_cache",
    "oryx_tpu_torch.serve.api_server",
    "oryx_tpu_torch.utils.trace",
    "oryx_tpu_torch.utils.metrics",
)


def named_lock(name: str, kind: str = "lock"):
    """The lock for a `with self.<lock>:` site. Disarmed: a plain
    threading primitive (one global read of overhead). Armed: an
    instrumented wrapper reporting to the active sanitizer. The name is
    both the runtime identity (held stacks, metric labels, messages) and
    the static one (oryxlint's lock-order rule reads the literal)."""
    san = _SAN
    if san is None:
        if kind == "condition":
            return threading.Condition()
        if kind == "rlock":
            return threading.RLock()
        return threading.Lock()
    return san.make(name, kind)


def hot_dispatch(name: str) -> None:
    """Marker call at the top of a device dispatch: armed, it flags the
    dispatch running while the current thread holds any instrumented lock
    (which would serialize every other thread on device latency).
    Disarmed: one global read."""
    san = _SAN
    if san is None:
        return
    held = san.held_names()
    if held:
        san._violation(
            f"hot-path dispatch '{name}' entered while holding "
            f"{held}: a device dispatch must never run under a lock"
        )


# Per-thread exemption depth, shared by every detector's descriptors.
_EXEMPT = threading.local()


@contextlib.contextmanager
def race_exempt(reason: str = "") -> Iterator[None]:
    """Mark the current thread's annotated-field accesses as externally
    synchronized for the duration (the pool-invariant check and the page
    map, which read a quiesced engine). Applies to any installed race
    descriptor; costs nothing disarmed."""
    _EXEMPT.depth = getattr(_EXEMPT, "depth", 0) + 1
    try:
        yield
    finally:
        _EXEMPT.depth -= 1


def arm_lock_sanitizer(
    *,
    order: tuple[str, ...] | None = None,
    action: str = "raise",
    race_modules=None,
    registry=None,
) -> LockOrderSanitizer:
    """Arm the global sanitizer (locks made through `named_lock` from now
    on are instrumented) and install the race detector over
    `race_modules` (imported modules; by default the serving surface).
    Re-arming replaces the global; locks made earlier keep reporting to
    their own sanitizer."""
    global _SAN, _RACE
    san = LockOrderSanitizer(order=order, action=action)
    det = RaceDetector(action=action, stats_sink=san.stats)
    if race_modules is None:
        import importlib

        race_modules = []
        for name in _RACE_MODULES:
            try:
                race_modules.append(importlib.import_module(name))
            # fault-boundary: a surface module that cannot import here is
            # simply not instrumented
            except Exception:
                pass
    for module in race_modules:
        det.install_module(module)
    if registry is not None:
        san.bind_registry(registry)
    _SAN = san
    _RACE = det
    return san


def disarm_lock_sanitizer() -> None:
    global _SAN, _RACE
    if _RACE is not None:
        _RACE.uninstall()
    _SAN = None
    _RACE = None


@contextlib.contextmanager
def lock_sanitizer(
    *,
    order: tuple[str, ...] | None = None,
    action: str = "raise",
    race_modules=None,
    registry=None,
) -> Iterator[LockOrderSanitizer]:
    """Arming for tests: arm on entry, disarm on exit (descriptors
    uninstalled, classes restored)."""
    san = arm_lock_sanitizer(
        order=order, action=action, race_modules=race_modules,
        registry=registry,
    )
    try:
        yield san
    finally:
        disarm_lock_sanitizer()


def lock_sanitizer_armed() -> bool:
    return _SAN is not None


def lock_stats() -> LockStats | None:
    """The active sanitizer's stats (None disarmed); the paired race
    detector mirrors its findings into these violations too."""
    return _SAN.stats if _SAN is not None else None


def race_violations() -> list[str]:
    return list(_RACE.violations) if _RACE is not None else []


def bind_lock_metrics(registry) -> bool:
    """Attach the armed sanitizer's wait/hold histograms to `registry`
    (nothing disarmed). The API server and the router call this with
    their registries, so armed runs show oryx_lock_* on /metrics."""
    if _SAN is None:
        return False
    _SAN.bind_registry(registry)
    return True


def maybe_arm_from_env(registry=None) -> bool:
    """Arm from $ORYX_LOCK_SANITIZER unless it is empty/0/off/false.
    Called by the API server's and the router's builds, never at import
    (an import must not change classes as a side effect)."""
    spec = os.environ.get(_ENV_VAR, "").strip().lower()
    if spec in ("", "0", "off", "false"):
        return False
    if _SAN is None:
        arm_lock_sanitizer(registry=registry)
    elif registry is not None:
        _SAN.bind_registry(registry)
    return True
