"""CUDA graphs whose replays keep the kernel wrappers' launch counts true.

Each wrapper of `flash_attention`, `paged_attention` and `q8_linear` adds
one to its counter where it launches its kernel (`launches.count`). Under
stream capture nothing launches: the calls are recorded, and every replay
launches them again. So while a thread captures, its calls go to its
tally, not to the counters, and `CountedGraph` adds that tally once per
replay.

A CUDA graph's destructor resets it, which a thread may not do while it
captures another graph: the call fails and invalidates that capture. The
owners release their graphs when they are done with them (an engine's
`close`, a pool reset, an evicted decode graph), and a graph whose last
reference goes while its thread captures (a collection of garbage that
held one) is kept until that capture has ended.

Captures are serialized across the process. Entering a capture
synchronizes the device and empties the allocator's cache, which fails
while another thread's capture is open and invalidates it: two engines
on one card (replicas over one set of weights) would otherwise capture
their first graphs at once and both fail. A thread that is not capturing
may launch, replay, copy and wait on its own stream or events meanwhile;
what acts on the whole device (a profiler session's start and stop) runs
under `no_capture()`, and the scheduler closes a sampled dispatch window
on an event of its own stream, not on a device-wide synchronize.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import threading

import torch

from oryx_tpu_torch.ops.cuda import (
    flash_attention,
    launches,
    paged_attention,
    q8_linear,
)


def counters() -> tuple[collections.Counter, ...]:
    """Every launch counter of the kernel wrappers."""
    fa = flash_attention
    return (fa.LAUNCHES, fa.LAUNCHES_DECODE, fa.LAUNCHES_LSE,
            fa.LAUNCHES_DQ, fa.LAUNCHES_DKV, paged_attention.LAUNCHES,
            q8_linear.LAUNCHES)


# Per thread: None, or, while the thread captures, the graphs whose last
# reference went meanwhile.
_CAPTURING = threading.local()
# Held from a capture's entry to its end (see the module docstring).
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def no_capture():
    """Run the body while no thread captures (it waits for an open capture
    to end, and holds off the next): for calls that act on the whole
    device and would invalidate another thread's open capture."""
    with _CAPTURE_LOCK:
        yield


# False inside `routes(False)`: the graph routes (the dense decode loop,
# the engine's pure-decode step) run their eager steps instead of capturing
# or replaying.
_ENABLED = True


def enabled() -> bool:
    return _ENABLED


@contextlib.contextmanager
def routes(on: bool):
    """Scope in which the graph routes are on or off, process-wide: off is
    the eager witness that graph replays are held against, and
    utils/debug.debug_mode(disable_jit=True). Restored on exit."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(on)
    try:
        yield
    finally:
        _ENABLED = prev


# Observers of finished captures, each called with the graph's label
# (analysis/sanitizers.recompile_watchdog adds one for its block).
_CAPTURE_HOOKS: list = []


def add_capture_hook(hook) -> None:
    _CAPTURE_HOOKS.append(hook)


def remove_capture_hook(hook) -> None:
    _CAPTURE_HOOKS.remove(hook)


def note_capture(label: str) -> None:
    """Tell every capture hook that a graph of `label` was captured."""
    for hook in list(_CAPTURE_HOOKS):
        hook(label)


def key_label(kind: str, key, owner: str = "") -> str:
    """A graph's label: its owner, its kind and a digest of the key that
    fixes its launches (one label per key and owner)."""
    digest = hashlib.blake2s(repr(key).encode(), digest_size=4).hexdigest()
    return f"{owner}/{kind}[{digest}]" if owner else f"{kind}[{digest}]"


def _add(deltas) -> None:
    for counter, delta in zip(counters(), deltas):
        counter.update(delta)


class CountedGraph:
    """A `torch.cuda.CUDAGraph` that replays its captured launch counts.

    `launches` holds, per counter of `counters()`, the wrapper calls the
    capture recorded (keyed as the counters are)."""

    def __init__(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.launches: tuple[collections.Counter, ...] = ()

    @contextlib.contextmanager
    def capture(self, stream: torch.cuda.Stream, generators=(),
                label: str = "graph"):
        """Capture the body on `stream`. Each of `generators` is registered
        with the graph, so every replay draws the numbers that follow the
        generator's state at that replay (an unregistered one would replay
        the Philox offset of the capture). Raises on a failed capture; a
        finished one is reported to the capture hooks under `label`."""
        for g in generators:
            self.graph.register_generator_state(g)
        with _CAPTURE_LOCK:
            _CAPTURING.held = []
            launches.begin_tally()
            try:
                with torch.cuda.graph(self.graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    yield
            finally:
                self.launches = launches.end_tally(counters())
                held, _CAPTURING.held = _CAPTURING.held, None
                del held  # their resets, now that the capture has ended
        note_capture(label)

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches)

    def release(self) -> None:
        """Free the captured graph and its memory now; it replays no more."""
        self.graph.reset()

    def __del__(self) -> None:
        held = getattr(_CAPTURING, "held", None)
        if held is not None:  # this thread is capturing: reset it later
            held.append(self.graph)
