"""Page-pool observatory: derived views over the allocator's ownership data
(port of `oryx_tpu.utils.pagemap`).

The paged KV pool is the scarcest serving resource; the allocator knows
refcounts, the scheduler block tables, the prefix cache its entries. This
module is the surface that shows who holds which page, for how long, and
how churned the free list is:

  * ``fragmentation_ratio``: the largest contiguous run of free page ids
    over the free total. Block tables indirect every access, so contiguity
    never gates correctness; the ratio measures free-list churn (LIFO
    recycling keeps a healthy pool near 1.0; interleaved grow / evict /
    cache churn drives it toward 1 / free).
  * ``summarize``: one dict from ``PageAllocator.snapshot()``: the state
    counts (free + slot + cache + shared == the pool), fragmentation, the
    peak occupancy since boot and the tenancy-age and idle quantiles of
    resident pages. It feeds ``GET /debug/pages?format=summary``, the OOM
    forensic records (utils/forensics.py) and the loadgen memory block.
  * ``PoolObservatory``: the metrics bridge: the raw-named
    ``oryx_pool_{free,slot,cache,shared}_pages``, ``oryx_pool_size_pages``,
    ``oryx_pool_min_free_pages`` and ``oryx_pool_fragmentation_ratio``
    gauges, refreshed by a scrape-time collector, and the free-time
    ``oryx_page_lifetime_seconds`` / ``oryx_page_idle_seconds`` histograms
    the allocator feeds through its ``observer`` hook when a page's
    refcount reaches 0.

Stdlib and the metrics helpers only.
"""

from __future__ import annotations

import time
from typing import Any, Callable

from oryx_tpu_torch.utils.metrics import (
    PAGE_LIFETIME_BUCKETS,
    Registry,
    sample_quantile,
)


def fragmentation_ratio(free_pages: list[int], num_free: int | None = None
                        ) -> float:
    """Largest contiguous run of free page ids over the free total.
    `free_pages` is sorted ascending. 1.0 = one run (or nothing free); the
    floor is 1 / num_free (every free page an island)."""
    n = len(free_pages) if num_free is None else num_free
    if n <= 0:
        return 1.0
    best = run = 1
    for prev, cur in zip(free_pages, free_pages[1:]):
        run = run + 1 if cur == prev + 1 else 1
        best = max(best, run)
    return round(best / n, 6)


def _quantiles(values: list[float]) -> dict[str, float | None]:
    if not values:
        return {"n": 0, "p50": None, "p95": None, "max": None}
    return {
        "n": len(values),
        "p50": round(sample_quantile(values, 0.5), 6),
        "p95": round(sample_quantile(values, 0.95), 6),
        "max": round(max(values), 6),
    }


def summarize(snapshot: dict) -> dict[str, Any]:
    """The derived summary of one ``PageAllocator.snapshot()``: the state
    partition (its sum equals the pool: the reconciliation
    scripts/check_serving_endpoints.py checks), fragmentation, the peak
    occupancy since boot and resident-page age / idle quantiles."""
    counts = {"free": 0, "slot": 0, "cache": 0, "shared": 0}
    ages: list[float] = []
    idles: list[float] = []
    for rec in snapshot["pages"]:
        counts[rec["state"]] += 1
        if rec["age_s"] is not None:
            ages.append(rec["age_s"])
        if rec["idle_s"] is not None:
            idles.append(rec["idle_s"])
    total = snapshot["num_pages"]
    return {
        "num_pages": total,
        "page_size": snapshot["page_size"],
        **counts,
        "reconciled": sum(counts.values()) == total,
        "peak_pages_in_use": total - snapshot["min_free"],
        "fragmentation_ratio": fragmentation_ratio(
            snapshot["free_pages"], snapshot["num_free"]
        ),
        "resident_age_s": _quantiles(ages),
        "resident_idle_s": _quantiles(idles),
    }


class PoolObservatory:
    """Registry bridge for one engine's page pool.

    Built once per scheduler (families are declared once); the allocator
    is read through ``allocator_fn``, so a rebuilt pool is followed, and
    each fresh allocator is re-``attach``ed so the free-time histograms
    keep flowing. The scrape-time collector reads the allocator's plain
    lists (best-effort under a live engine, exact on a quiesced one) and
    walks them at most once per ``ttl_s``; ``collect(force=True)`` (what
    ``scheduler.pool_snapshot`` calls) refreshes now."""

    def __init__(self, registry: Registry,
                 allocator_fn: Callable[[], Any],
                 ttl_s: float = 1.0):
        self._allocator_fn = allocator_fn
        self._ttl_s = ttl_s
        self._last = float("-inf")
        self._free = registry.gauge("oryx_pool_free_pages", raw_name=True)
        self._slot = registry.gauge("oryx_pool_slot_pages", raw_name=True)
        self._cache = registry.gauge("oryx_pool_cache_pages", raw_name=True)
        self._shared = registry.gauge(
            "oryx_pool_shared_pages", raw_name=True
        )
        self._size = registry.gauge("oryx_pool_size_pages", raw_name=True)
        self._min_free = registry.gauge(
            "oryx_pool_min_free_pages", raw_name=True
        )
        self._frag = registry.gauge(
            "oryx_pool_fragmentation_ratio", raw_name=True
        )
        self._lifetime = registry.histogram(
            "oryx_page_lifetime_seconds", PAGE_LIFETIME_BUCKETS,
            raw_name=True,
        )
        self._idle = registry.histogram(
            "oryx_page_idle_seconds", PAGE_LIFETIME_BUCKETS, raw_name=True,
        )
        registry.register_collector(self.collect)
        self.collect()

    def attach(self, allocator) -> None:
        """Point the allocator's free-time telemetry here (again after
        every pool rebuild: a fresh allocator starts with observer=None)
        and refresh the gauges, which must never report a dead pool."""
        allocator.observer = self
        self.collect(force=True)

    def page_freed(self, lifetime_s: float, idle_s: float) -> None:
        """Allocator callback at refcount 0: the page's whole tenancy and
        its idle tail since the last reference change."""
        self._lifetime.observe(max(0.0, lifetime_s))
        self._idle.observe(max(0.0, idle_s))

    def collect(self, force: bool = False) -> None:
        """Refresh the oryx_pool_* gauges from the live allocator, at most
        once per ``ttl_s`` (0 = always) unless `force`."""
        now = time.monotonic()
        if not force and self._ttl_s and now - self._last < self._ttl_s:
            return
        self._last = now
        alloc = self._allocator_fn()
        if alloc is None:
            return
        counts = {"free": 0, "slot": 0, "cache": 0, "shared": 0}
        for p in range(alloc.num_pages):
            counts[alloc.classify(alloc._refs[p], alloc._owners[p])] += 1
        self._free.set(counts["free"])
        self._slot.set(counts["slot"])
        self._cache.set(counts["cache"])
        self._shared.set(counts["shared"])
        self._size.set(alloc.num_pages)
        self._min_free.set(alloc.min_free)
        self._frag.set(fragmentation_ratio(sorted(alloc._free)))
