"""CUDA graphs whose replays keep the kernel wrappers' launch counts true.

Each wrapper of `flash_attention` and `paged_attention` adds one to its
counter where it launches its kernel. Under stream capture nothing
launches: the calls are recorded, and every replay launches them again. So
`CountedGraph` takes back what the wrappers counted while it captured and
adds that count once per replay.
"""

from __future__ import annotations

import collections
import contextlib

import torch

from oryx_tpu_torch.ops.cuda import flash_attention, paged_attention


def counters() -> tuple[collections.Counter, ...]:
    """Every launch counter of the kernel wrappers."""
    fa = flash_attention
    return (fa.LAUNCHES, fa.LAUNCHES_DECODE, fa.LAUNCHES_LSE,
            fa.LAUNCHES_DQ, fa.LAUNCHES_DKV, paged_attention.LAUNCHES)


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
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            yield
        self.launches = tuple(c - b for c, b in zip(counters(), before))
        _add(self.launches, -1)  # the capture launched nothing

    def replay(self) -> None:
        self.graph.replay()
        _add(self.launches, 1)
