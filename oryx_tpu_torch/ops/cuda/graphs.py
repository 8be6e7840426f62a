"""CUDA graphs whose replays keep the kernel wrappers' launch counts true.

Each wrapper of `flash_attention`, `paged_attention` and `q8_linear` adds
one to its counter where it launches its kernel. Under stream capture
nothing launches: the calls are recorded, and every replay launches them
again. So `CountedGraph` takes back what the wrappers counted while it
captured and adds that count once per replay.

A CUDA graph's destructor resets it, which a thread may not do while it
captures another graph: the call fails and invalidates that capture. The
owners release their graphs when they are done with them (an engine's
`close`, a pool reset, an evicted decode graph), and a graph whose last
reference goes while its thread captures (a collection of garbage that
held one) is kept until that capture has ended.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from oryx_tpu_torch.ops.cuda import flash_attention, paged_attention, q8_linear


def counters() -> tuple[collections.Counter, ...]:
    """Every launch counter of the kernel wrappers."""
    fa = flash_attention
    return (fa.LAUNCHES, fa.LAUNCHES_DECODE, fa.LAUNCHES_LSE,
            fa.LAUNCHES_DQ, fa.LAUNCHES_DKV, paged_attention.LAUNCHES,
            q8_linear.LAUNCHES)


# Per thread: None, or, while the thread captures, the graphs whose last
# reference went meanwhile.
_CAPTURING = threading.local()


def _add(deltas, sign: int) -> None:
    for counter, delta in zip(counters(), deltas):
        for key, n in delta.items():
            counter[key] += sign * n
            if counter[key] == 0:
                del counter[key]


class CountedGraph:
    """A `torch.cuda.CUDAGraph` that replays its captured launch counts.

    `launches` holds, per counter of `counters()`, the wrapper calls the
    capture recorded (keyed as the counters are)."""

    def __init__(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.launches: tuple[collections.Counter, ...] = ()

    @contextlib.contextmanager
    def capture(self, stream: torch.cuda.Stream, generators=()):
        """Capture the body on `stream`. Each of `generators` is registered
        with the graph, so every replay draws the numbers that follow the
        generator's state at that replay (an unregistered one would replay
        the Philox offset of the capture). Raises on a failed capture."""
        for g in generators:
            self.graph.register_generator_state(g)
        before = [collections.Counter(c) for c in counters()]
        _CAPTURING.held = []
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                yield
        finally:
            held, _CAPTURING.held = _CAPTURING.held, None
            del held  # their resets, now that the capture has ended
        self.launches = tuple(c - b for c, b in zip(counters(), before))
        _add(self.launches, -1)  # the capture launched nothing

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches, 1)

    def release(self) -> None:
        """Free the captured graph and its memory now; it replays no more."""
        self.graph.reset()

    def __del__(self) -> None:
        held = getattr(_CAPTURING, "held", None)
        if held is not None:  # this thread is capturing: reset it later
            held.append(self.graph)
