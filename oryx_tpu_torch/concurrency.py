"""The port's serving concurrency model, in one checkable place.

Threads
-------
  * **engine** (`oryx-engine`, one per ContinuousScheduler): owns the
    slot arrays, block tables, page allocator, the KV pool on the card,
    the prefix cache and the engine-step CUDA graphs. Everything that
    touches the device is single-threaded by design, so a dispatch (and a
    graph capture or replay) never takes a lock.
  * **HTTP handlers** (one per in-flight request): reach the scheduler
    only through `submit()` / `RequestHandle` and the `_queue` and control
    flags under `_cond`. The window engine's handlers share the card
    through `server.stream_lock`, one request at a time.
  * **engine-supervisor**: watches the engine thread and calls `restart()`
    only after observing its death (thread death is the happens-before
    edge that makes touching engine-owned state legal).
  * **stall-watchdog / metric scrapes / debug endpoints**: read the
    tracer's flight recorder and the metrics registry under their own
    locks; they never touch engine-owned state (the page map and the
    pool-invariant check read it quiesced, declared `race_exempt`).
  * **router handlers + router-prober** (serve/router.py, its own
    process in production): the replica table's mutable fields and the
    affinity trie are shared between the proxy handler threads and the
    prober, always under `router._lock`, which is held only for table and
    trie edits, never across network I/O. A router holds no engine lock.

Lock acquisition order
----------------------
The declared order below is enforced two ways: statically by oryxlint's
`lock-order` rule (the repo-wide may-acquire-while-holding graph must
not invert it or form a cycle) and at runtime by
`analysis.sanitizers.LockOrderSanitizer` (armed by
`ORYX_LOCK_SANITIZER=1`), which raises at the acquire that would invert
it. A lock earlier in the chain may be held while acquiring a later one,
never the reverse.

`LOCK_ORDER` is the same manifest as a runtime value, and it is the JAX
package's chain name for name: tests/test_torch_lock_sanitizer.py holds
the comment line, the tuple and the JAX package's tuple equal. (The
declaration below is a real comment, not docstring text: oryxlint reads
directives from tokenized comments only.)
"""

from __future__ import annotations

# The manifest: one declaration, read by the static rule from this
# comment and by the runtime sanitizer from the tuple beneath it.
# lock-order: server.stream_lock < scheduler._cond < anomaly._lock < trace._lock < tracer._lock < request_log._lock < forensics._lock < audit._lock < watchdog._lock < router._lock < registry._lock < metrics.family
LOCK_ORDER: tuple[str, ...] = (
    "server.stream_lock",   # window-engine card lock (api_server)
    "scheduler._cond",      # admission queue + control flags
    "anomaly._lock",        # anomaly episode state + events.jsonl sink
    "trace._lock",          # one request's span list
    "tracer._lock",         # the flight recorder of traces
    "request_log._lock",    # wide-event ring + requests.jsonl sink
                            # (terminal paths emit after closing the
                            # trace, so it ranks after the trace locks)
    "forensics._lock",      # OOM forensic ring (a leaf: captures hold
                            # no other lock while appending)
    "audit._lock",          # output-audit ring + verdict counts (held
                            # only for the ring edit, never across a
                            # replay)
    "watchdog._lock",       # stall-watchdog beat state
    "router._lock",         # router replica table + affinity trie
                            # (its metric bumps nest under this)
    "registry._lock",       # metric family declaration/lookup
    "metrics.family",       # one family's children (innermost: metrics
                            # are bumped under everything)
)
