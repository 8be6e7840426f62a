"""The kernel wrappers' launch counters, kept true across threads and CUDA
graph captures.

Each wrapper adds one to its counter where it launches its kernel, through
`count`. Under stream capture nothing launches: the calls are recorded,
and each replay launches them again. So while a thread captures, `count`
adds that thread's calls to its tally (the graph's launches, which
`graphs.CountedGraph` adds once a replay) and leaves the counters alone;
the other threads, which launch for real meanwhile (two engines on one
card), count as usual.
"""

from __future__ import annotations

import collections
import threading

_TALLY = threading.local()


def count(counter: collections.Counter, key) -> None:
    """One launch of `key` on `counter` (into the tally while this thread
    captures)."""
    tally = getattr(_TALLY, "tally", None)
    if tally is None:
        counter[key] += 1
    else:
        tally.setdefault(id(counter), collections.Counter())[key] += 1


def begin_tally() -> None:
    """From now on this thread's calls are a capture's, not launches."""
    _TALLY.tally = {}


def end_tally(counters) -> tuple[collections.Counter, ...]:
    """End this thread's tally: its calls, per counter of `counters`."""
    tally, _TALLY.tally = _TALLY.tally, None
    return tuple(collections.Counter(tally.get(id(c), {})) for c in counters)
