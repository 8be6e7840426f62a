"""Shared-prefix KV reuse for the serving engine (port of
`oryx_tpu.serve.prefix_cache`, the paged plane).

`TokenTrie` is a radix trie over fixed-size blocks of token ids (block size
== the KV page size, so a cached prefix is always page-aligned) with LRU
stamps. `PagedPrefixCache` gives its nodes meaning for
`ContinuousScheduler`: each node owns ONE page of the paged pool (the
cache's own reference, through `PageAllocator.share`); admission splices
matched pages into a new slot's block table (sharing full pages,
copy-on-writing a partly consumed one) and prefills only the suffix. Under
pool pressure, pages only the cache holds are LRU-evicted back to the free
list before any live request is.

With a host budget and the two copy callbacks, an evicted entry SPILLS to
host RAM, byte-verbatim (codes and scales on a quantized pool), instead of
dying: the prefix survives in a host-side trie, and a later lookup that
walks past the device-resident prefix into spilled blocks re-uploads them
(`reload`) ahead of the suffix prefill. A failed re-upload frees its page
and shortens the match; the suffix recomputes cold.

Matching is on token ids: a tokenizer boundary merge shortens the reuse,
never changes a reply. Only text prompts key the cache (the scheduler
passes None for multimodal ones), so every root key here is `()`.

`SessionPrefixCache` is the dense-cache plane: the same index over
`PrefixCacheState` snapshots of `Pipeline.chat_cached` / `ChatSession`, so a
fresh session over the same media + system prompt inherits a finished
session's KV. Its root keys are media fingerprints.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np

from oryx_tpu_torch.utils import faults


class TrieNode:
    __slots__ = ("children", "payload", "stamp", "parent", "key")

    def __init__(self, parent: "TrieNode | None", key: bytes):
        self.children: dict[bytes, TrieNode] = {}
        self.payload: Any = None
        self.stamp = 0
        self.parent = parent
        self.key = key


class TokenTrie:
    """Radix trie over fixed-size BLOCKS of token ids.

    Only whole blocks index (a partial tail block never creates a node), so
    every match length is a multiple of `block`. `root_key` partitions the
    trie; `stamp` is a global LRU clock bumped on every walk/extend touch.
    """

    def __init__(self, block: int):
        if block < 1:
            raise ValueError(f"block size must be >= 1, got {block}")
        self.block = block
        self.roots: dict[tuple, TrieNode] = {}
        self._clock = 0

    @staticmethod
    def _block_key(tokens: np.ndarray) -> bytes:
        return np.ascontiguousarray(tokens, np.int64).tobytes()

    def _touch(self, node: TrieNode) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _path(self, tokens, root_key: tuple, create: bool) -> list[TrieNode]:
        tokens = np.asarray(tokens)
        node = self.roots.get(root_key)
        if node is None:
            if not create:
                return []
            node = self.roots[root_key] = TrieNode(None, b"")
        path: list[TrieNode] = []
        for i in range(len(tokens) // self.block):
            key = self._block_key(tokens[i * self.block:(i + 1) * self.block])
            child = node.children.get(key)
            if child is None:
                if not create:
                    break
                child = node.children[key] = TrieNode(node, key)
            path.append(child)
            node = child
        for n in path:
            self._touch(n)
        return path

    def walk(self, tokens, root_key: tuple = ()) -> list[TrieNode]:
        """Longest-prefix match: the node path for the leading full blocks
        of `tokens` present in the trie (LRU-touched), possibly empty."""
        return self._path(tokens, root_key, create=False)

    def extend(self, tokens, root_key: tuple = ()) -> list[TrieNode]:
        """Walk + create: the node path for ALL leading full blocks of
        `tokens`, creating missing nodes (payload None) along the way."""
        return self._path(tokens, root_key, create=True)

    def remove(self, node: TrieNode) -> None:
        """Detach a LEAF node from its parent; empty roots are pruned."""
        if node.children:
            raise ValueError("only leaf nodes can be removed")
        parent = node.parent
        if parent is not None:
            del parent.children[node.key]
            if parent.parent is None and not parent.children:
                for rk, root in list(self.roots.items()):
                    if root is parent:
                        del self.roots[rk]
        node.parent = None

    def nodes(self) -> Iterable[TrieNode]:
        """Every block node (roots are structural, not yielded)."""
        stack = list(self.roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.parent is not None:
                yield n

    def leaves(self) -> list[TrieNode]:
        return [n for n in self.nodes() if not n.children]

    def __len__(self) -> int:
        return sum(1 for _ in self.nodes())


class HostEntry:
    """One spilled cache page in host RAM: the byte-verbatim blob of
    `ops/paged_kv.fetch_page` and its size for the host budget."""

    __slots__ = ("blob", "nbytes")

    def __init__(self, blob, nbytes: int):
        self.blob = blob
        self.nbytes = int(nbytes)


class PagedPrefixCache:
    """The serving engine's shared-prefix page cache.

    `insert` takes the cache's OWN reference on newly indexed pages, so a
    donated page outlives the request that computed it; `lookup` returns
    the matched pages for the caller to splice (the caller shares what it
    keeps; lookup takes no references). `evict` frees LRU leaves that only
    the cache holds (refcount 1); entries shared with a live slot are
    pinned until it releases them.

    Host spill tier: with `host_cache_bytes > 0` and both callbacks,
      spill_fetch(page) -> (blob, nbytes): device -> host page copy,
      spill_upload(blob, page) -> None: host -> device into a page the
        cache just allocated,
    an evicted entry's bytes move to host RAM and `reload` brings them
    back onto fresh pages, byte-identical to never having been evicted.

    `metrics` is the engine's `ServingMetrics` (or None): `evict` adds to
    prefix_cache_evicted_pages_total, `reload` to
    oryx_cache_reload_hit_total and oryx_cache_reload_upload_total, and
    every change of the cache refreshes the prefix_cache_entries /
    prefix_cache_pages and oryx_cache_spilled_pages / oryx_cache_host_bytes
    gauges.
    """

    def __init__(self, allocator, *, metrics=None,
                 host_cache_bytes: int = 0,
                 spill_fetch=None, spill_upload=None):
        self.allocator = allocator
        self.page_size = allocator.page_size
        if host_cache_bytes < 0:
            raise ValueError(
                f"host_cache_bytes must be >= 0, got {host_cache_bytes}"
            )
        self.host_cache_bytes = int(host_cache_bytes)
        self.spill_fetch = spill_fetch
        self.spill_upload = spill_upload
        self.spill_enabled = bool(
            host_cache_bytes > 0
            and spill_fetch is not None and spill_upload is not None
        )
        # The device trie (payload: a page id), the host tier's own trie
        # (payload: a HostEntry) and its byte ledger. No locks: the engine
        # thread owns the cache.
        self.trie = TokenTrie(allocator.page_size)  # thread-owned: engine
        self._host = TokenTrie(allocator.page_size)  # thread-owned: engine
        self._host_bytes = 0  # thread-owned: engine
        self._spilled = 0  # thread-owned: engine
        self._pages = 0  # thread-owned: engine
        self.metrics = metrics
        self._gauges()

    def _gauges(self) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge("prefix_cache_pages", self._pages)
            self.metrics.set_gauge("prefix_cache_entries", self.entries)
            reg = self.metrics.registry
            reg.gauge("oryx_cache_spilled_pages", raw_name=True).set(
                self._spilled
            )
            reg.gauge("oryx_cache_host_bytes", raw_name=True).set(
                self._host_bytes
            )

    # ---- accounting ------------------------------------------------------

    @property
    def pages(self) -> int:
        """Pages the cache holds a reference to (== device trie nodes)."""
        return self._pages

    @property
    def entries(self) -> int:
        """Distinct cached prefixes (trie leaves)."""
        return len(self.trie.leaves())

    def held_pages(self) -> list[int]:
        """Every page the cache holds one reference to (for the pool
        invariant check)."""
        return [n.payload for n in self.trie.nodes()]

    def evictable_pages(self, exclude=()) -> int:
        """Upper bound on what `evict` could free right now: pages only the
        cache holds (refcount 1), minus `exclude`. A feasibility screen,
        not a promise (an inner node under a shared leaf is unreachable)."""
        exclude = set(exclude)
        return sum(
            1 for n in self.trie.nodes()
            if n.payload not in exclude
            and self.allocator.refcount(n.payload) == 1
        )

    @property
    def spilled_pages(self) -> int:
        """Host-tier entries (pages living in host RAM only)."""
        return self._spilled

    @property
    def host_bytes(self) -> int:
        """Host RAM the spill tier holds."""
        return self._host_bytes

    # ---- the cache surface -----------------------------------------------

    def lookup(self, tokens, root_key: tuple = ()) -> tuple[int, list[int]]:
        """Longest page-aligned cached prefix of `tokens` on the device:
        (matched_tokens, pages), pages[i] holding tokens
        [i * page_size, (i + 1) * page_size). Takes no references."""
        pages = self._device_pages(self.trie.walk(tokens, root_key))
        return len(pages) * self.page_size, pages

    @staticmethod
    def _device_pages(path: list[TrieNode]) -> list[int]:
        """The walked path's page ids, cut at the first node without one
        (a hole shortens the match, never reaches a splice)."""
        pages: list[int] = []
        for n in path:
            if n.payload is None:
                break
            pages.append(n.payload)
        return pages

    def lookup_tiered(
        self, tokens, root_key: tuple = ()
    ) -> tuple[int, list[int], list[TrieNode]]:
        """`lookup` plus the spilled continuation: (device matched tokens,
        device pages, host nodes), the host nodes being the host-trie nodes
        of the blocks right after the device prefix, contiguous, each
        holding a HostEntry. Takes no references; `reload` brings them
        back."""
        pages = self._device_pages(self.trie.walk(tokens, root_key))
        host_nodes: list[TrieNode] = []
        if self.spill_enabled:
            for node in self._host.walk(tokens, root_key)[len(pages):]:
                if node.payload is None:
                    break
                host_nodes.append(node)
        return len(pages) * self.page_size, pages, host_nodes

    def reload(self, tokens, host_nodes: list[TrieNode],
               root_key: tuple = ()) -> list[int]:
        """Re-upload spilled blocks onto fresh cache-owned pages, in order,
        and index them in the device trie again. Stops at the first failed
        allocation or upload (the page returns, the host entry stays) and
        returns the pages of the blocks reloaded: a shorter splice."""
        depth0 = self._depth(host_nodes[0]) if host_nodes else 0
        reloaded: list[int] = []
        for node in host_nodes:
            try:
                page = self.allocator.alloc(1, owner="cache")[0]
            except Exception:
                break
            try:
                # Fault site: a host -> device re-upload that fails (the
                # page returns, the match shortens, the suffix recomputes).
                faults.fault_point(
                    "host_spill_upload",
                    exc=lambda: RuntimeError(
                        "injected host-tier re-upload failure"
                    ),
                )
                self.spill_upload(node.payload.blob, page)
            # fault-boundary: a failed re-upload degrades to a cold
            # recompute of the suffix; the page returns, nothing leaks
            except Exception:
                self.allocator.free([page], owner="cache")
                break
            reloaded.append(page)
            self._host_forget_node(node)
        if reloaded:
            path = self.trie.extend(
                np.asarray(tokens)[:(depth0 + len(reloaded)) * self.page_size],
                root_key,
            )
            for i, page in enumerate(reloaded):
                node = path[depth0 + i]
                if node.payload is None:
                    node.payload = int(page)
                    self._pages += 1
                else:  # unreachable while the engine thread owns the cache
                    self.allocator.free([page], owner="cache")
            if self.metrics is not None:
                reg = self.metrics.registry
                reg.counter(
                    "oryx_cache_reload_hit_total", raw_name=True
                ).inc()
                reg.counter(
                    "oryx_cache_reload_upload_total", raw_name=True
                ).inc(len(reloaded))
        self._gauges()
        return reloaded

    # ---- host tier internals ---------------------------------------------

    @staticmethod
    def _depth(node: TrieNode) -> int:
        """Block index of a trie node (root children are index 0)."""
        d = -1
        while node is not None and node.parent is not None:
            d += 1
            node = node.parent
        return d

    @staticmethod
    def _node_tokens(node: TrieNode) -> np.ndarray:
        """The token stream a device-trie node indexes (its path's blocks)."""
        keys: list[bytes] = []
        while node is not None and node.parent is not None:
            keys.append(node.key)
            node = node.parent
        return np.frombuffer(b"".join(reversed(keys)), np.int64)

    def _node_root_key(self, node: TrieNode) -> tuple:
        """The root partition a device-trie node lives under."""
        while node.parent is not None:
            node = node.parent
        for rk, root in self.trie.roots.items():
            if root is node:
                return rk
        return ()

    def _spill(self, victim: TrieNode) -> bool:
        """Move a device-trie victim's page bytes to the host tier. False
        (a plain eviction) when the tier is off, the entry cannot fit the
        budget even after LRU drops, or the device copy fails."""
        if not self.spill_enabled:
            return False
        try:
            blob, nbytes = self.spill_fetch(victim.payload)
        # fault-boundary: a failed device->host copy demotes the spill
        # to a plain eviction; the entry dies, nothing leaks
        except Exception:
            return False
        if nbytes > self.host_cache_bytes:
            return False
        if self._host_bytes + nbytes > self.host_cache_bytes:
            # One LRU scan per spill, dropping the oldest leaf entries until
            # the new blob fits.
            victims = sorted(
                (n for n in self._host.leaves() if n.payload is not None),
                key=lambda n: n.stamp,
            )
            for v in victims:
                if self._host_bytes + nbytes <= self.host_cache_bytes:
                    break
                self._host_bytes -= v.payload.nbytes
                self._spilled -= 1
                v.payload = None
                self._host_prune_chain(v)
            if self._host_bytes + nbytes > self.host_cache_bytes:
                return False
        node = self._host.extend(
            self._node_tokens(victim), self._node_root_key(victim)
        )[-1]
        if node.payload is not None:
            self._host_bytes -= node.payload.nbytes
            self._spilled -= 1
        node.payload = HostEntry(blob, nbytes)
        self._host_bytes += nbytes
        self._spilled += 1
        return True

    def _host_forget_node(self, node: TrieNode) -> None:
        """Drop one host entry's bytes (reloaded or superseded) and prune
        the chain that leaves dead."""
        if node.payload is not None:
            self._host_bytes -= node.payload.nbytes
            self._spilled -= 1
            node.payload = None
        self._host_prune_chain(node)

    def _host_prune_chain(self, node: TrieNode | None) -> None:
        """Walking up from `node`, drop childless payload-less host nodes
        until a live ancestor (or the root)."""
        while (
            node is not None and node.parent is not None
            and not node.children and node.payload is None
        ):
            parent = node.parent
            self._host.remove(node)
            node = parent

    def insert(self, tokens, pages: list[int], root_key: tuple = ()) -> int:
        """Index the full-page prefix of `tokens`, whose KV lives in
        `pages` (one per block, in order). Newly indexed pages get one
        cache-owned reference (`share`); blocks already present keep their
        page (the duplicate stays the caller's) and have their LRU
        refreshed. Stale host twins of newly indexed blocks are dropped.
        Returns the number of pages newly indexed."""
        n_full = min(len(tokens) // self.page_size, len(pages))
        if n_full <= 0:
            return 0
        head = np.asarray(tokens)[:n_full * self.page_size]
        path = self.trie.extend(head, root_key)
        new = 0
        for node, page in zip(path, pages):
            if node.payload is None:
                self.allocator.share([int(page)], owner="cache")
                node.payload = int(page)
                new += 1
        self._pages += new
        if new and self.spill_enabled:
            for dnode, hnode in zip(path, self._host.walk(head, root_key)):
                if hnode.payload is not None and dnode.payload is not None:
                    self._host_forget_node(hnode)
        self._gauges()
        return new

    def evict(self, need_pages: int, *, exclude=()) -> int:
        """Free at least `need_pages` pages only the cache holds, LRU
        leaves first; with the host tier armed each victim spills before
        its page returns. `exclude` pages are never evicted (the reload
        path passes the device prefix it is about to share). Returns the
        pages freed (fewer when entries are pinned)."""
        exclude = {int(p) for p in exclude}
        freed = 0
        while freed < need_pages:
            # One gather per round, oldest first; parents exposed as new
            # leaves join the next round only if still short.
            candidates = sorted(
                (
                    n for n in self.trie.leaves()
                    if n.payload not in exclude
                    and self.allocator.refcount(n.payload) == 1
                ),
                key=lambda n: n.stamp,
            )
            if not candidates:
                break
            for victim in candidates:
                if freed >= need_pages:
                    break
                self._spill(victim)
                self.allocator.release([victim.payload], owner="cache")
                self.trie.remove(victim)
                self._pages -= 1
                freed += 1
        if freed and self.metrics is not None:
            self.metrics.inc("prefix_cache_evicted_pages_total", freed)
        self._gauges()
        return freed

    def clear(self) -> None:
        """Drop every entry: the device references and the host tier."""
        for node in list(self.trie.nodes()):
            if node.payload is not None:
                self.allocator.release([node.payload], owner="cache")
        self.trie = TokenTrie(self.page_size)
        self._pages = 0
        self._host = TokenTrie(self.page_size)
        self._host_bytes = 0
        self._spilled = 0
        self._gauges()


class SessionPrefixCache:
    """Dense-cache plane: longest-prefix lookup over `PrefixCacheState`
    snapshots (serve/pipeline.py), so a fresh ChatSession over the same
    media + system prompt inherits a finished session's KV instead of
    cold-prefilling it.

    A state is reachable from EVERY node along its id stream's path - a new
    prompt diverges from a stored stream at its own question, so the useful
    hit is the deepest COMMON node, not the stored stream's end. `lookup`
    returns the state at that node; the pipeline's `_prefix_plan` then
    computes the exact longest common token prefix against it and
    re-prefills only the rest (an over-long candidate only ever shortens
    the reuse, never corrupts it). Dense caches cost device memory:
    capacity bounds the number of live states, LRU.
    """

    def __init__(self, block_size: int = 16, capacity: int = 4):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.trie = TokenTrie(block_size)
        self.capacity = capacity
        self._states: dict[int, Any] = {}  # id(state) -> state, LRU order

    @property
    def entries(self) -> int:
        return len(self._states)

    def lookup(self, flat_ids, media_key: tuple = ()):
        """The state stored at the deepest node along `flat_ids`' block
        path (LRU-refreshed), or None."""
        path = self.trie.walk(flat_ids, root_key=tuple(media_key))
        for node in reversed(path):
            if node.payload is not None:
                state = node.payload
                self._states.pop(id(state), None)
                self._states[id(state)] = state
                return state
        return None

    def insert(self, state) -> None:
        """Store `state` along its full block path (streams shorter than one
        block are not worth caching), evicting the least-recently-used
        stored state beyond capacity. States the overwrite leaves with no
        reachable node (the normal multi-turn case: each turn's stream
        extends the last, shadowing its whole path) are dropped at once: an
        unreachable state would pin a dense cache against capacity for no
        hit."""
        path = self.trie.extend(
            np.asarray(state.ids), root_key=tuple(state.media_key)
        )
        if not path:
            return
        displaced = {
            id(n.payload): n.payload for n in path
            if n.payload is not None and n.payload is not state
        }
        for node in path:
            node.payload = state
        self._states.pop(id(state), None)
        self._states[id(state)] = state
        if displaced:
            reachable = {
                id(n.payload) for n in self.trie.nodes()
                if n.payload is not None
            }
            for sid in displaced.keys() - reachable:
                self._states.pop(sid, None)
        while len(self._states) > self.capacity:
            _, victim = next(iter(self._states.items()))
            self._drop(victim)

    def _drop(self, state) -> None:
        self._states.pop(id(state), None)
        for node in list(self.trie.nodes()):
            if node.payload is state:
                node.payload = None
        # Prune now-useless branches (childless, payload-less).
        changed = True
        while changed:
            changed = False
            for leaf in self.trie.leaves():
                if leaf.payload is None:
                    self.trie.remove(leaf)
                    changed = True
