"""Paged KV cache: fixed-size pages, block tables, ragged attention (port of
`oryx_tpu.ops.paged_kv`).

K/V of every sequence live in one pool of fixed-size pages per layer
([num_pages, page_size, Hk, D]); a sequence owns an ordered list of page
indices, its block table. Logical slot `s` of a sequence lives at page
`block_table[s // page_size]`, offset `s % page_size`. Unallocated table
entries hold the allocator's sentinel (== num_pages).

Out-of-range semantics are the JAX package's, made explicit (PyTorch raises
on the CPU and device-asserts on CUDA where XLA drops or clips):
  * writes routed through the sentinel, and rows whose write mask is off,
    are DROPPED: they land in a sink page that `init_paged_pool` places
    right after each layer's last page and that nothing ever reads, so a
    masked row costs no branch and no host sync;
  * writes to a slot past the block table's width are dropped too. (The
    JAX writers differ there: the per-row one reads the table with fill
    semantics and lands such a slot in page 0, which may belong to another
    sequence; the packed one clamps it into the row's last page. A decode
    chunk that runs past max_ctx, or a prefill window that overshoots it,
    makes such writes; what they carry is never read.)
  * gathers CLIP to the last real page (P - 1); whatever they read is past
    every row's valid length and masked out of attention.

Pieces:
  * `PageAllocator`: the host-side free list with refcounts and owner tags.
  * `QuantPages` / `init_quant_pages`: an int8 or fp8-e4m3 pool plane, codes
    plus one fp32 scale per token row; the writers quantize on write
    (utils/quant.quantize_kv_rows) and `gather_pages` dequantizes.
  * `copy_pages` / `fetch_page` / `upload_page`: byte-verbatim page moves
    across every layer (copy-on-write, host spill and reload), codes and
    scales together on a quantized pool. They work IN PLACE where the JAX
    functions donate the pool.
  * `write_pages` / `write_pages_packed` / `gather_pages`: page I/O (the
    writers' pool-row index, `write_index` / `write_index_packed`, is the
    same for every layer; the model computes it once per forward and
    each layer only scatters, `scatter_rows`).
  * `ragged_decode_attention` / `ragged_paged_attention`: the plain PyTorch
    twins of the hand-written paged kernels K3/K4
    (ops/cuda/paged_attention.py): gather the rows' pages into a
    contiguous stream and run the plain attention.
  * `stop_window_hit`: the device-side stop predicate of the decode steps.
"""

from __future__ import annotations

import time
from collections import Counter

import torch

from oryx_tpu_torch.ops.attention import attention
from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils import quant as quant_lib


class OutOfPagesError(RuntimeError):
    """The free list cannot satisfy an allocation (caller should evict or
    defer admission: a scheduling signal, not a crash)."""


class PageAllocator:
    """Host-side free-list allocator over `num_pages` fixed-size pages, with
    per-page reference counts.

    LIFO recycling: freshly freed pages are handed out first. Allocation is
    all-or-nothing, so a failed admission never leaks a partial block table.
    `alloc` hands out pages at refcount 1, `share` adds a holder, `free`
    drops one; a page returns to the free list at refcount 0. Freeing an
    unallocated page, or more references than a page holds, raises with the
    page id before anything changes.

    Ownership data (the page map, utils/pagemap.py): every reference
    carries an owner tag stamped at the transition (`alloc` / `share` /
    `free` take `owner=`; the scheduler stamps `req:<request-id>`, the
    prefix cache `cache`; an untagged transition stamps "?"), and every
    page records when its tenancy began (`_born`, at refcount 0 -> 1) and
    when a reference last changed (`_touched`). `snapshot()` is the live
    map /debug/pages serves; an attached `observer` (a
    `pagemap.PoolObservatory`) is told each page's lifetime and idle tail
    when it returns to the free list. Tags and clocks are accounting only:
    they never change what the allocator does.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"need >= 1 page/slot, got {num_pages=} {page_size=}"
            )
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, -1, -1))
        self._refs: list[int] = [0] * num_pages
        self._owners: list[list[str]] = [[] for _ in range(num_pages)]
        # Tenancy clocks (time.monotonic()).
        self._born: list[float] = [0.0] * num_pages
        self._touched: list[float] = [0.0] * num_pages
        # Low-water mark of the free list since construction.
        self.min_free: int = num_pages
        # An object with page_freed(lifetime_s, idle_s), or None.
        self.observer = None

    @property
    def sentinel(self) -> int:
        """Block-table filler for unallocated entries: one past the pool
        (writes drop, gathers clip)."""
        return self.num_pages

    @property
    def num_free(self) -> int:
        return len(self._free)

    def pages_for(self, num_tokens: int) -> int:
        """Pages needed to hold `num_tokens` KV slots."""
        return max(0, -(-num_tokens // self.page_size))

    def _check_page(self, page: int) -> None:
        if not 0 <= page < self.num_pages:
            raise ValueError(f"page {page} outside pool of {self.num_pages}")

    def refcount(self, page: int) -> int:
        """Current holder count of `page` (0 = free)."""
        self._check_page(page)
        return self._refs[page]

    def alloc(self, n: int, *, owner: str | None = None) -> list[int]:
        if n > 0:
            # Fault site: pool exhaustion. Every caller treats
            # OutOfPagesError as a scheduling signal (defer, evict, recompute
            # instead of a copy-on-write), never a crash.
            faults.fault_point(
                "page_alloc_oom",
                exc=lambda: OutOfPagesError(
                    f"injected pool exhaustion (asked {n} pages)"
                ),
            )
        if n > len(self._free):
            raise OutOfPagesError(
                f"need {n} pages, {len(self._free)} free of {self.num_pages}"
            )
        if n <= 0:
            return []
        out = self._free[-n:][::-1]
        del self._free[-n:]
        now = time.monotonic()
        tag = owner or "?"
        for p in out:
            self._refs[p] = 1
            self._owners[p] = [tag]
            self._born[p] = self._touched[p] = now
        self.min_free = min(self.min_free, len(self._free))
        return out

    def share(self, pages: list[int], *, owner: str | None = None) -> None:
        """Add one reference per page. All-or-nothing: sharing a free page
        raises with the page id before anything changes."""
        for p in pages:
            self._check_page(p)
            if self._refs[p] <= 0:
                raise ValueError(f"share of unallocated page {p}")
        now = time.monotonic()
        tag = owner or "?"
        for p in pages:
            self._refs[p] += 1
            self._owners[p].append(tag)
            self._touched[p] = now

    def free(self, pages: list[int], *, owner: str | None = None) -> None:
        """Drop one reference per page; pages reaching refcount 0 return to
        the free list (in `pages` order, LIFO-recycled). Raises with the
        page id, before changing anything, on a double free or when one
        call drops more references to a page than it holds. `owner`
        removes that holder's tag (else the most recent one)."""
        for p, n in Counter(pages).items():
            self._check_page(p)
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            if n > self._refs[p]:
                raise ValueError(
                    f"freeing {n} references to page {p}, which holds "
                    f"only {self._refs[p]}"
                )
        now = time.monotonic()
        released = []
        for p in pages:
            self._refs[p] -= 1
            tags = self._owners[p]
            if owner is not None and owner in tags:
                tags.remove(owner)
            elif tags:
                tags.pop()
            if self._refs[p] == 0:
                released.append(p)
                if self.observer is not None:
                    self.observer.page_freed(
                        now - self._born[p], now - self._touched[p]
                    )
            self._touched[p] = now
        self._free.extend(reversed(released))

    # `release` is `free` under its sharing-aware name: both drop one
    # reference; the page leaves the live set only at refcount 0.
    release = free

    def check_invariant(self, holders=None) -> None:
        """Pool accounting invariant; raises RuntimeError on violation.

        Always: the free list and the refcounts partition the pool. With
        `holders` (one page list per live holder), also: every page's
        refcount equals its holder count (nothing leaked, nothing
        double-held)."""
        allocated = {p for p, r in enumerate(self._refs) if r > 0}
        if any(r < 0 for r in self._refs):
            raise RuntimeError(f"negative refcount: {self._refs}")
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            raise RuntimeError(f"duplicate pages in free list: {self._free}")
        if free_set & allocated:
            raise RuntimeError(
                f"pages both free and allocated: {sorted(free_set & allocated)}"
            )
        if len(self._free) + len(allocated) != self.num_pages:
            raise RuntimeError(
                f"pool accounting broken: {len(self._free)} free + "
                f"{len(allocated)} allocated != {self.num_pages} pages"
            )
        if holders is None:
            return
        held: Counter = Counter()
        for pages in holders:
            held.update(int(p) for p in pages)
        for p in range(self.num_pages):
            if held.get(p, 0) != self._refs[p]:
                raise RuntimeError(
                    f"page {p}: refcount {self._refs[p]} but "
                    f"{held.get(p, 0)} holders"
                )

    @staticmethod
    def classify(refcount: int, owners: list[str]) -> str:
        """A page's state in the map; the four partition the pool: free
        (refcount 0), shared (two or more holders, whoever they are),
        cache (only the prefix cache's reference) or slot (one request's
        reference)."""
        if refcount <= 0:
            return "free"
        if refcount >= 2:
            return "shared"
        return "cache" if owners == ["cache"] else "slot"

    def snapshot(self) -> dict:
        """The live ownership map: one record per page (state, refcount,
        owner tags, tenancy age, idle time) and the pool's geometry;
        summaries live in utils/pagemap.summarize. A read from another
        thread than the engine's is best-effort (each record is whole; the
        map is exact on a quiesced engine)."""
        now = time.monotonic()
        pages = []
        for p in range(self.num_pages):
            r = self._refs[p]
            owners = list(self._owners[p])
            pages.append({
                "page": p,
                "state": self.classify(r, owners),
                "refcount": r,
                "owners": owners,
                "age_s": round(now - self._born[p], 6) if r > 0 else None,
                "idle_s": (
                    round(now - self._touched[p], 6) if r > 0 else None
                ),
            })
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "num_free": len(self._free),
            "min_free": self.min_free,
            "free_pages": sorted(self._free),
            "pages": pages,
        }


def init_paged_pool(
    num_layers: int, num_pages: int, page_size: int, num_kv_heads: int,
    head_dim: int, *, dtype: torch.dtype, device,
) -> torch.Tensor:
    """One zeroed pool plane [L, P, page_size, Hk, D]: a view of a buffer
    holding one more page per layer, the sink that dropped writes land in
    (never read; gathers clip to P - 1 and the kernels clamp there too)."""
    buf = torch.zeros(
        (num_layers, num_pages + 1, page_size, num_kv_heads, head_dim),
        dtype=dtype, device=device,
    )
    return buf[:, :num_pages]


class QuantPages:
    """One quantized pool plane (K or V): storage-dtype codes plus one fp32
    scale per token row, stored page-major.

      q:     [..., P, page_size, Hk, D] int8 or float8_e4m3fn codes
      scale: [..., P, page_size] fp32

    The scale is per token row, not per page, so a token's bytes do not
    depend on how its page was filled (across prefill chunks and decode
    steps); every page carries its own scale block, so copy-on-write,
    spill and reload move codes and scales together, verbatim.
    `dequant_dtype` is the logical dtype consumers see (`dtype`); `shape`
    is the codes' shape, so callers read pool geometry off a plane of
    either kind. Indexing by layer gives that layer's plane, a view."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dequant_dtype: torch.dtype = torch.float32):
        self.q = q
        self.scale = scale
        self.dequant_dtype = dequant_dtype

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:  # the logical dtype after dequant
        return self.dequant_dtype

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.q.dtype

    def __getitem__(self, i) -> "QuantPages":
        return QuantPages(self.q[i], self.scale[i], self.dequant_dtype)

    def __repr__(self) -> str:
        return (
            f"QuantPages(q={tuple(self.q.shape)}:{self.q.dtype}, "
            f"scale={tuple(self.scale.shape)}, dequant={self.dequant_dtype})"
        )


def init_quant_pages(
    num_layers: int, num_pages: int, page_size: int, num_kv_heads: int,
    head_dim: int, *, fmt: str = "int8",
    dequant_dtype: torch.dtype = torch.float32, device,
) -> QuantPages:
    """A zeroed quantized pool plane; codes and scales each get the sink
    page of `init_paged_pool`, so a dropped write drops both."""
    storage, _ = quant_lib.kv_storage_dtype(fmt)
    q = torch.zeros(
        (num_layers, num_pages + 1, page_size, num_kv_heads, head_dim),
        dtype=storage, device=device,
    )
    scale = torch.zeros((num_layers, num_pages + 1, page_size),
                        dtype=torch.float32, device=device)
    return QuantPages(q[:, :num_pages], scale[:, :num_pages],
                      dequant_dtype=dequant_dtype)


def kv_pool_dtype(kv_pages) -> str:
    """The pool's wire format: "int8" / "fp8_e4m3" for a quantized pool,
    else the dense plane dtype's name (e.g. "float32")."""
    leaf = kv_pages["k"] if isinstance(kv_pages, dict) else kv_pages
    if isinstance(leaf, QuantPages):
        try:
            return _quant_fmt(leaf)
        except ValueError:
            return str(leaf.storage_dtype).removeprefix("torch.")
    return str(leaf.dtype).removeprefix("torch.")


def _quant_fmt(pages: QuantPages) -> str:
    """The quant format name of a QuantPages plane."""
    for name, (dt, _) in quant_lib.KV_STORAGE_DTYPES.items():
        if pages.storage_dtype == dt:
            return name
    raise ValueError(
        f"QuantPages carries unknown storage dtype {pages.storage_dtype}"
    )


def _byte_leaves(plane) -> list[torch.Tensor]:
    """The tensors that hold a plane's bytes, the layer axis first and the
    page axis second: the values of a dense plane, or the codes (viewed as
    bytes: not every PyTorch op takes float8) and the scales of a quantized
    one."""
    if isinstance(plane, QuantPages):
        return [plane.q.view(torch.uint8), plane.scale]
    return [plane]


def copy_pages(kv_pages: dict, src: int, dst: int) -> dict:
    """Copy page `src` onto page `dst` across every layer of a paged KV
    pool ({"k", "v"} of [L, P, page_size, Hk, D] planes), IN PLACE (the
    JAX function donates the pool): the device half of copy-on-write. On a
    quantized pool the codes and the page's scale block move verbatim.
    Returns the pool."""
    for plane in kv_pages.values():
        for leaf in _byte_leaves(plane):
            leaf[:, dst] = leaf[:, src]
    return kv_pages


def fetch_page(kv_pages: dict, page: int) -> dict:
    """Host copy of ONE page across the whole pool (every layer, K and V,
    and the scale blocks of a quantized pool): the spill half of the host
    tier. The copy runs on the current stream, after every write queued to
    the page, and is a copy on a CPU pool too (`.cpu()` alone would alias
    the page, which the pool recycles). Returns {"k": [tensors], "v": [...]}
    of [L, page_size, ...] CPU tensors; `upload_page` is its exact
    inverse."""
    return {
        name: [leaf[:, page].to("cpu", copy=True)
               for leaf in _byte_leaves(plane)]
        for name, plane in kv_pages.items()
    }


def host_blob_bytes(blob: dict) -> int:
    """Total host bytes of a `fetch_page` blob (the host_cache_bytes
    accounting unit)."""
    return int(sum(t.numel() * t.element_size()
                   for leaves in blob.values() for t in leaves))


def upload_page(kv_pages: dict, dst: int, blob: dict) -> dict:
    """Write a `fetch_page` blob back into page `dst` of the pool, IN PLACE
    (the JAX function donates the pool): byte-verbatim, same dtype both
    ways. Returns the pool."""
    for name, plane in kv_pages.items():
        for leaf, host in zip(_byte_leaves(plane), blob[name]):
            leaf[:, dst].copy_(host)
    return kv_pages


class HostPage:
    """A `fetch_page` blob as an object a tensor-parallel rank can name
    (parallel/tp.py registers objects, and a dict cannot be watched for
    collection): each rank keeps the blob of its own heads."""

    def __init__(self, blob: dict):
        self.blob = blob

    @classmethod
    def fetch(cls, kv_pages: dict, page: int) -> "HostPage":
        return cls(fetch_page(kv_pages, page))

    def upload(self, kv_pages: dict, dst: int) -> dict:
        return upload_page(kv_pages, dst, self.blob)


def _rows_with_sink(cache_layer: torch.Tensor) -> torch.Tensor:
    """[P * ps + 1, *row] row view of a layer from `init_paged_pool` (or a
    scale plane [P, ps] of `init_quant_pages`): row P * ps is the first row
    of the layer's sink page. Raises for a tensor that has no sink behind
    it."""
    shape = tuple(cache_layer.shape)
    want, acc = [], 1
    for n in reversed(shape):
        want.insert(0, acc)
        acc *= n
    if cache_layer.stride() != tuple(want):
        raise ValueError(
            "cache_layer must be a contiguous [P, page_size, ...] layer "
            "of a pool made by init_paged_pool or init_quant_pages"
        )
    P, ps, row = shape[0], shape[1], want[1]
    end = cache_layer.storage_offset() + (P * ps + 1) * row
    if cache_layer.untyped_storage().nbytes() < end * cache_layer.element_size():
        raise ValueError(
            "cache_layer has no sink page behind it: make the pool with "
            "init_paged_pool (dropped writes need somewhere to land)"
        )
    return cache_layer.as_strided((P * ps + 1, *shape[2:]), tuple(want[1:]))


def write_index(
    num_pages: int, page_size: int,
    block_tables: torch.Tensor,  # [B, max_pages] int (sentinel = P)
    start: torch.Tensor,  # [B] first logical slot per row
    T: int,
    *,
    write_mask: torch.Tensor | None = None,  # [B] bool rows that may write
) -> torch.Tensor:
    """Pool rows [B * T] ((b, t) row-major) that T contiguous tokens per
    row land on: token t of row b at logical slot start[b] + t, page
    block_tables[b, slot // page_size], offset slot % page_size. A dropped
    write (write_mask False, a sentinel page, a slot past the table's
    width) gets the sink row P * page_size. The same for every layer, so a
    forward computes it once."""
    P, ps = num_pages, page_size
    maxp = block_tables.shape[1]
    slots = start.long()[:, None] + torch.arange(T, device=start.device)
    col = torch.div(slots, ps, rounding_mode="floor")
    page = torch.gather(block_tables.long(), 1, col.clamp(0, maxp - 1))
    ok = (col < maxp) & (page >= 0) & (page < P)
    if write_mask is not None:
        ok = ok & write_mask.bool()[:, None]
    return torch.where(ok, page * ps + slots % ps, P * ps).reshape(-1)


def write_index_packed(
    num_pages: int, page_size: int,
    block_tables: torch.Tensor,  # [S, max_pages] int (sentinel = P)
    q_segments: torch.Tensor,  # [R] owning slot per packed row
    q_positions: torch.Tensor,  # [R] logical slot index per row
    *,
    write_mask: torch.Tensor | None = None,  # [R] bool rows that may write
) -> torch.Tensor:
    """Pool rows [R] of R packed tokens, each routed through its own
    sequence's table: row r at logical slot q_positions[r] of sequence
    q_segments[r] (clamped into [0, S - 1]); the sink row P * page_size for
    a dropped write, as in `write_index`."""
    P, ps = num_pages, page_size
    S, maxp = block_tables.shape
    seg = torch.clamp(q_segments.long(), 0, S - 1)
    pos = q_positions.long()
    col = torch.div(pos, ps, rounding_mode="floor")
    page = block_tables.long()[seg, col.clamp(0, maxp - 1)]
    ok = (col >= 0) & (col < maxp) & (page >= 0) & (page < P)
    if write_mask is not None:
        ok = ok & write_mask.bool()
    return torch.where(ok, page * ps + pos % ps, P * ps)


def scatter_rows(cache_layer, index: torch.Tensor,
                 new: torch.Tensor, tp=None) -> None:
    """pool_rows[index[i]] = new[i] ([N, Hk, D] rows), IN PLACE, with an
    index from `write_index` / `write_index_packed`. A quantized plane
    quantizes the rows on write and scatters codes and scales through the
    same index, so a dropped row drops both. tp: the tensor-parallel
    world whose ranks hold the row's other heads; a row's scale is taken
    over all of them (the max of the ranks' amax), so each rank's codes
    are the one-device pool's codes of its heads."""
    if isinstance(cache_layer, QuantPages):
        reduce = None
        if tp is not None and tp.size > 1:
            def reduce(amax):
                return tp.all_reduce(amax, "max")
        codes, scale = quant_lib.quantize_kv_rows(
            new, _quant_fmt(cache_layer), amax_reduce=reduce
        )
        rows = _rows_with_sink(cache_layer.q).view(torch.uint8)
        rows.index_put_((index,), codes.view(torch.uint8))
        _rows_with_sink(cache_layer.scale).index_put_((index,), scale)
        return
    rows = _rows_with_sink(cache_layer)
    rows.index_put_((index,), new.to(rows.dtype))


def write_pages(
    cache_layer,  # [P, page_size, Hk, D] (init_paged_pool) or QuantPages
    new: torch.Tensor,  # [B, T, Hk, D]
    block_tables: torch.Tensor,  # [B, max_pages] int (sentinel = P)
    start: torch.Tensor,  # [B] first logical slot per row
    *,
    write_mask: torch.Tensor | None = None,  # [B] bool rows that may write
) -> torch.Tensor:
    """Write T contiguous tokens per row into the page pool, IN PLACE (see
    `write_index` for where each lands and which writes drop). Returns the
    layer."""
    P, ps, Hk, D = cache_layer.shape
    B, T = new.shape[:2]
    index = write_index(P, ps, block_tables, start, T, write_mask=write_mask)
    scatter_rows(cache_layer, index, new.reshape(B * T, Hk, D))
    return cache_layer


def write_pages_packed(
    cache_layer,  # [P, page_size, Hk, D] (init_paged_pool) or QuantPages
    new: torch.Tensor,  # [R, Hk, D] packed new K or V rows
    block_tables: torch.Tensor,  # [S, max_pages] int (sentinel = P)
    q_segments: torch.Tensor,  # [R] owning slot per packed row
    q_positions: torch.Tensor,  # [R] logical slot index per row
    *,
    write_mask: torch.Tensor | None = None,  # [R] bool rows that may write
) -> torch.Tensor:
    """Write R packed tokens into the pool, IN PLACE, each through its own
    sequence's block table (see `write_index_packed`). Returns the layer."""
    P, ps = cache_layer.shape[:2]
    index = write_index_packed(
        P, ps, block_tables, q_segments, q_positions, write_mask=write_mask
    )
    scatter_rows(cache_layer, index, new)
    return cache_layer


def gather_pages(
    cache_layer,  # [P, page_size, Hk, D] (or a QuantPages plane)
    block_tables: torch.Tensor,  # [B, max_pages]
) -> torch.Tensor:
    """Each row's logical KV stream [B, max_pages * page_size, Hk, D].
    Sentinel entries clip to the last real page; what they read is past
    every row's valid length and masked out of attention. A quantized
    plane is dequantized here, codes.to(dt) * scale.to(dt) with dt its
    dequant_dtype (the scale rounds to dt first), as the kernels do in
    their page walk."""
    P, ps, Hk, D = cache_layer.shape
    B, maxp = block_tables.shape
    idx = torch.clamp(block_tables.long(), 0, P - 1)
    if isinstance(cache_layer, QuantPages):
        dt = cache_layer.dequant_dtype
        codes = cache_layer.q.view(torch.uint8)[idx].view(cache_layer.q.dtype)
        scale = cache_layer.scale[idx]  # [B, maxp, ps]
        out = codes.to(dt) * scale[..., None, None].to(dt)
        return out.reshape(B, maxp * ps, Hk, D)
    return cache_layer[idx].reshape(B, maxp * ps, Hk, D)


def ragged_decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] (or [B, Hq, D])
    k_pages: torch.Tensor,  # [P, page_size, Hk, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages]
    kv_lengths: torch.Tensor,  # [B] valid kv count INCLUDING the current token
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain twin of K3: single-token paged decode attention. Each query
    attends to its own ragged KV prefix through its block table. Returns
    [B, 1, Hq, D] (or [B, Hq, D], matching q)."""
    squeezed = q.dim() == 3
    if squeezed:
        q = q[:, None]
    K = block_tables.shape[1] * k_pages.shape[1]
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    lengths = kv_lengths.long()
    kv_mask = torch.arange(K, device=q.device)[None, :] < lengths[:, None]
    out = attention(
        q, k, v, causal=True,
        q_positions=(lengths - 1)[:, None],
        kv_positions=None,  # arange over logical slots == absolute positions
        kv_mask=kv_mask.int(), scale=scale,
    )
    return out[:, 0] if squeezed else out


def spec_lane_metadata(
    lengths: torch.Tensor,  # [S] int confirmed kv tokens per slot
    k: int,  # drafts per slot
) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_segments, q_positions) of S slots x (1 + k) speculative verify
    lanes, slot-major: lane j of slot s sits at position lengths[s] + j
    (lane 0 the slot's fed token, lanes 1..k its drafts). The packed writer
    and K4 take them unchanged: a draft lane is a prefill-suffix lane whose
    token was proposed, so causal masking at its own position lets lane j
    see lanes < j of its own slot and nothing of another slot's. Returns
    ([S * (1 + k)], [S * (1 + k)]) int32."""
    S = lengths.shape[0]
    dev = lengths.device
    seg = torch.arange(S, dtype=torch.int32, device=dev)[:, None].expand(
        S, k + 1)
    pos = (lengths.to(torch.int32)[:, None]
           + torch.arange(k + 1, dtype=torch.int32, device=dev)[None, :])
    return seg.reshape(-1), pos.reshape(-1)


def stop_window_hit(
    recent: torch.Tensor,  # [S, stop_L] rolling recent-token window
    stop_sequences: torch.Tensor | None,  # [Sq, stop_L] (-1 = wildcard)
) -> torch.Tensor:
    """Row s is True when its window's tail matches ANY stop sequence
    (right-aligned; -1 template entries are wildcards). The window starts
    at -2, which matches nothing. Returns [S] bool."""
    if stop_sequences is None:
        return torch.zeros(recent.shape[0], dtype=torch.bool,
                           device=recent.device)
    m = (stop_sequences[None] == -1) | (recent[:, None, :] == stop_sequences[None])
    return torch.any(torch.all(m, dim=-1), dim=-1)


def ragged_paged_attention(
    q: torch.Tensor,  # [R, Hq, D] packed query rows
    k_pages: torch.Tensor,  # [P, page_size, Hk, D]
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [S, max_pages]
    q_segments: torch.Tensor,  # [R] owning slot per packed row
    q_positions: torch.Tensor,  # [R] absolute position per row
    *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain twin of K4: packed ragged paged attention. Row r attends to
    the KV prefix of sequence q_segments[r] (clamped into [0, S - 1]),
    causally at its own position: slot j is visible iff
    j <= q_positions[r]. A decode row and a chunked-prefill row are the
    same case under this mask. Returns [R, Hq, D]."""
    S = block_tables.shape[0]
    seg = torch.clamp(q_segments.long(), 0, S - 1)
    k_r = gather_pages(k_pages, block_tables)[seg]  # [R, K, Hk, D]
    v_r = gather_pages(v_pages, block_tables)[seg]
    out = attention(
        q[:, None], k_r, v_r, causal=True,
        q_positions=q_positions.long()[:, None],
        kv_positions=None, scale=scale,
    )
    return out[:, 0]
