"""The port's prefix cache (serve/prefix_cache.py) and its wiring into
`ContinuousScheduler` against the JAX package, on the CPU.

The cache units replay the call sequences of tests/test_prefix_cache.py and
tests/test_spill.py against both packages' `TokenTrie` / `PagedPrefixCache`
over a toy device of page blobs; pages handed out, refcounts, match
lengths, spilled pages and host bytes must be equal. The engines (tiny
weights made input-sensitive, fp32, JAX matmuls at "highest" precision)
run with the prefix cache on, over a dense ("bf16") and an int8 pool, split
and ragged: replies, finish reasons, usage, admit/finish chunks and the
cached tokens of every request are equal, and the pool invariant (slots +
cache holders) holds after every case.
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.serve import prefix_cache as jpc  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.serve import prefix_cache as tpc  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

PACKAGES = [(jpk, jpc), (tpk, tpc)]

# ---------------------------------------------------------------------------
# Cache units: the same call sequences through both packages
# ---------------------------------------------------------------------------


class ToyDevice:
    """Per-page content a spill fetches and an upload writes back (fixed
    20-byte blobs), with failure arming."""

    def __init__(self):
        self.content = {}
        self.fail_uploads = 0

    def fetch(self, page):
        blob = self.content[page].ljust(20)[:20]
        return blob, len(blob)

    def upload(self, blob, page):
        if self.fail_uploads > 0:
            self.fail_uploads -= 1
            raise RuntimeError("toy upload failure")
        self.content[page] = blob


def _cache(pk, pc, num_pages=16, page_size=4, budget=1 << 20):
    alloc = pk.PageAllocator(num_pages, page_size)
    dev = ToyDevice()
    cache = pc.PagedPrefixCache(alloc, host_cache_bytes=budget,
                                spill_fetch=dev.fetch,
                                spill_upload=dev.upload)
    return alloc, dev, cache


def _seed(alloc, dev, cache, tokens):
    """A donation: pages a request computed, indexed by the cache (its own
    share), then released by the request."""
    pages = alloc.alloc(len(tokens) // cache.page_size, owner="req")
    for i, p in enumerate(pages):
        dev.content[p] = f"block{i}:{tokens[:4]}".encode()
    cache.insert(np.asarray(tokens), pages)
    alloc.free(pages, owner="req")
    return pages


def _state(alloc, cache):
    return (list(alloc._free), list(alloc._refs), cache.pages,
            cache.spilled_pages, cache.host_bytes,
            sorted(cache.held_pages()))


def sc_trie(pk, pc):
    t = pc.TokenTrie(4)
    out = [len(t.extend(np.arange(11)))]
    out += [len(t.walk(np.arange(n))) for n in (11, 7, 3)]
    div = np.concatenate([np.arange(4), [99, 98, 97, 96], np.arange(4)])
    out.append(len(t.walk(div)))
    out.append(len(t))
    return out


def sc_insert_lookup(pk, pc):
    alloc = pk.PageAllocator(8, 4)
    cache = pc.PagedPrefixCache(alloc)
    pages = alloc.alloc(3)
    out = [cache.insert(np.arange(13), pages),
           [alloc.refcount(p) for p in pages]]
    alloc.free(pages)
    out += [alloc.num_free, cache.lookup(np.arange(20))]
    dup = alloc.alloc(2)
    out.append(cache.insert(np.arange(8), dup))
    alloc.free(dup)
    alloc.check_invariant([cache.held_pages()])
    return out + [_state(alloc, cache)]


def sc_lru_skips_shared(pk, pc):
    alloc = pk.PageAllocator(8, 4)
    cache = pc.PagedPrefixCache(alloc)
    a = alloc.alloc(2)
    cache.insert(np.arange(8), a)
    b = alloc.alloc(2)
    cache.insert(np.arange(100, 108), b)
    alloc.free(a)
    out = [cache.evict(4), alloc.num_free, cache.lookup(np.arange(8)),
           cache.lookup(np.arange(100, 108))]
    a2 = alloc.alloc(2)
    cache.insert(np.arange(8), a2)
    alloc.free(a2)
    alloc.free(b)
    cache.lookup(np.arange(8))
    out += [cache.evict(1), cache.lookup(np.arange(8)), _state(alloc, cache)]
    cache.clear()
    alloc.check_invariant([])
    return out + [alloc.num_free]


def sc_spill_reload(pk, pc):
    alloc, dev, cache = _cache(pk, pc)
    tokens = list(range(12))
    pages = _seed(alloc, dev, cache, tokens)
    before = [dev.fetch(p)[0] for p in pages]
    out = [cache.evict(3), _state(alloc, cache)]
    for p in pages:
        del dev.content[p]
    m, dp, hn = cache.lookup_tiered(np.asarray(tokens))
    out.append((m, dp, len(hn)))
    reloaded = cache.reload(np.asarray(tokens), hn)
    out += [reloaded, [dev.content[p] for p in reloaded] == before,
            _state(alloc, cache)]
    m, dp, hn = cache.lookup_tiered(np.asarray(tokens))
    alloc.check_invariant([cache.held_pages()])
    return out + [(m, dp, len(hn))]


def sc_prereload_exclude(pk, pc):
    alloc, dev, cache = _cache(pk, pc, num_pages=3)
    a_pages = _seed(alloc, dev, cache, list(range(8)))
    _seed(alloc, dev, cache, list(range(100, 104)))
    out = [cache.evict(1, exclude=a_pages), _state(alloc, cache),
           cache.evict(2, exclude=a_pages)]
    m, pages, _ = cache.lookup_tiered(np.asarray(range(8)))
    out += [(m, pages), cache.evictable_pages(exclude=a_pages)]
    alloc.check_invariant([cache.held_pages()])
    return out + [_state(alloc, cache)]


def sc_failed_upload(pk, pc):
    alloc, dev, cache = _cache(pk, pc)
    tokens = np.asarray(range(12))
    _seed(alloc, dev, cache, list(tokens))
    cache.evict(3)
    dev.fail_uploads = 1
    _, _, hn = cache.lookup_tiered(tokens)
    out = [cache.reload(tokens, hn), _state(alloc, cache)]
    _, _, hn = cache.lookup_tiered(tokens)
    out.append(cache.reload(tokens, hn))
    alloc.check_invariant([cache.held_pages()])
    return out + [_state(alloc, cache)]


def sc_host_budget(pk, pc):
    alloc, dev, cache = _cache(pk, pc, budget=44)
    for base in (0, 100, 200):
        _seed(alloc, dev, cache, list(range(base, base + 4)))
    out = [cache.evict(3), _state(alloc, cache)]
    _, _, hn = cache.lookup_tiered(np.arange(200, 204))
    return out + [len(hn)]


def sc_oversized_and_clear(pk, pc):
    alloc, dev, cache = _cache(pk, pc, budget=4)
    _seed(alloc, dev, cache, list(range(4)))
    out = [cache.evict(1), _state(alloc, cache)]
    alloc, dev, cache = _cache(pk, pc)
    _seed(alloc, dev, cache, list(range(8)))
    cache.evict(2)
    out.append(_state(alloc, cache))
    cache.clear()
    return out + [_state(alloc, cache)]


def sc_reinsert_forgets_host_twin(pk, pc):
    alloc, dev, cache = _cache(pk, pc)
    tokens = list(range(8))
    _seed(alloc, dev, cache, tokens)
    cache.evict(2)
    out = [_state(alloc, cache)]
    _seed(alloc, dev, cache, tokens)
    return out + [_state(alloc, cache)]


def sc_spill_disabled(pk, pc):
    alloc = pk.PageAllocator(8, 4)
    cache = pc.PagedPrefixCache(alloc)
    pages = alloc.alloc(1, owner="req")
    cache.insert(np.asarray(range(4)), pages)
    alloc.free(pages, owner="req")
    out = [cache.spill_enabled, cache.evict(1), _state(alloc, cache)]
    m, p, h = cache.lookup_tiered(np.asarray(range(4)))
    return out + [(m, p, h)]


SCENARIOS = [sc_trie, sc_insert_lookup, sc_lru_skips_shared, sc_spill_reload,
             sc_prereload_exclude, sc_failed_upload, sc_host_budget,
             sc_oversized_and_clear, sc_reinsert_forgets_host_twin,
             sc_spill_disabled]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[3:])
def test_cache_call_sequences_equal(scenario):
    want, got = (scenario(pk, pc) for pk, pc in PACKAGES)
    assert got == want


def test_cache_counts_into_the_metrics_dict():
    """The cache's counters and gauges land in the engine's ServingMetrics
    with the JAX cache's values (the same call sequence on both)."""
    from oryx_tpu.utils.metrics import ServingMetrics as JaxMetrics
    from oryx_tpu_torch.utils.metrics import ServingMetrics

    names = ["prefix_cache_evicted_pages_total", "prefix_cache_entries",
             "prefix_cache_pages"]
    raw = ["oryx_cache_reload_hit_total", "oryx_cache_reload_upload_total",
           "oryx_cache_spilled_pages", "oryx_cache_host_bytes"]
    out = []
    for (pk, pc), metrics in zip(PACKAGES, (JaxMetrics(), ServingMetrics())):
        alloc = pk.PageAllocator(16, 4)
        dev = ToyDevice()
        cache = pc.PagedPrefixCache(alloc, metrics=metrics,
                                    host_cache_bytes=1 << 20,
                                    spill_fetch=dev.fetch,
                                    spill_upload=dev.upload)
        tokens = list(range(12))
        _seed(alloc, dev, cache, tokens)
        assert cache.evict(3) == 3
        cache.reload(np.asarray(tokens), cache.lookup_tiered(tokens)[2])
        out.append([metrics.get(n) for n in names]
                   + [metrics.registry.get(n, raw_name=True) for n in raw])
    assert out[1] == out[0]
    assert out[1][0] == 3 and out[1][3:5] == [1, 3]


# ---------------------------------------------------------------------------
# Engines with the prefix cache on: port vs JAX
# ---------------------------------------------------------------------------


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


@pytest.fixture(scope="module")
def pipes():
    cfg = jcfg.oryx_tiny()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * (20 if a.ndim >= 2 else 1),
        joryx.init_params(cfg, jax.random.key(0)),
    )
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    jp = OryxInference(
        CharTokenizer(), jax.tree_util.tree_map(jnp.asarray, tree), cfg
    )
    tp = Pipeline(CharTokenizer(), from_jax_params(tree, tc), tc,
                  device="cpu")
    return jp, tp


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)


SYS = "You are a careful assistant. Answer briefly and cite what you see. "
GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)


def _serve(sched, reqs):
    """Submit everything, then start (deterministic admission order)."""
    handles = [sched.submit({"question": q}, cap) for q, cap in reqs]
    sched.start()
    out = [h.result(timeout=600) for h in handles]
    sched.close()
    return handles, out


def _jax_cached(h):
    return h.debug["cost"]["cached_tokens"]


def _both(pipes, reqs, **kw):
    """Both engines on one request list, the prefix cache on: equal replies,
    reasons, usage, admit/finish chunks and cached tokens per request.
    Returns (port scheduler, JAX scheduler, port handles, results)."""
    jp, tp = pipes
    with jax.default_matmul_precision("highest"):
        jsched = JaxScheduler(jp, autostart=False, **kw)
        jh, want = _serve(jsched, reqs)
    sched = ContinuousScheduler(tp, autostart=False, **kw)
    th, got = _serve(sched, reqs)
    assert got == want
    assert [(h.debug["admit_chunk"], h.debug["finish_chunk"]) for h in th] \
        == [(h.debug["admit_chunk"], h.debug["finish_chunk"]) for h in jh]
    assert [h.debug["cached_tokens"] for h in th] == [_jax_cached(h)
                                                      for h in jh]
    sched.check_pool_invariant()
    jsched._check_pool_invariant()
    return sched, jsched, th, got


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engines_equal_shared_prefix(pipes, kv_dtype, ragged):
    """Look-alike prompts (a shared system text) and a repeated one: later
    admissions splice the donated pages; the repeat also hits its reply's
    pages donated at finish."""
    reqs = [(SYS + "what is shown?", 6), (SYS + "what happens next?", 5),
            (SYS + "what is shown?", 6), ("hello", 3)]
    kw = dict(GEOM, kv_dtype=kv_dtype, ragged=ragged,
              prefill_chunk=32 if ragged else None)
    sched, jsched, th, got = _both(pipes, reqs, **kw)
    assert got[0] == got[2]  # cold == cached
    assert th[2].debug["cached_tokens"] > 0
    m = sched.metrics
    assert m.get("prefix_cache_hit_tokens_total") == sum(
        h.debug["cached_tokens"] for h in th
    ) == jsched.metrics.get("prefix_cache_hit_tokens_total")
    assert m.get("prefix_cache_miss_tokens_total") == jsched.metrics.get(
        "prefix_cache_miss_tokens_total"
    )
    assert isinstance(sched.kv_pages["k"], tpk.QuantPages) == (
        kv_dtype == "int8"
    )


def test_engine_int8_cold_vs_cached_equal(pipes):
    """int8 pool, prefix chunks of 16: a prompt served cold, then again
    over its cached pages, gives the same reply as JAX's engine."""
    prompt = "cached prefix parity check " * 3
    kw = dict(num_slots=2, page_size=8, chunk=4, max_ctx=256,
              prefill_chunk=16, kv_dtype="int8")
    _, _, th, got = _both(pipes, [(prompt, 8), (prompt, 8)], **kw)
    assert got[0] == got[1]
    assert th[0].debug["cached_tokens"] == 0 < th[1].debug["cached_tokens"]


def _page_aligned(tp, base, extra, ps):
    """`base` padded with x's until prompt + `extra` tokens fill pages."""
    L = len(tp._prepare_request({"question": base})[0])
    q = base + "x" * ((-(L + extra)) % ps)
    L = len(tp._prepare_request({"question": q})[0])
    assert (L + extra) % ps == 0
    return q, L


def test_cow_splice_on_page_aligned_prompt(pipes):
    """A prompt the cache covers entirely keeps one token to prefill: that
    write lands mid-page in a shared page, so admission copies it (COW)."""
    q, L = _page_aligned(pipes[1], SYS + "describe it", 0, 16)
    sched, jsched, th, got = _both(pipes, [(q, 6), (q, 6)], **GEOM)
    assert got[0] == got[1]
    assert sched.metrics.get("prefix_cache_hit_tokens_total") == L - 1
    assert sched.engine_stats["prefix_cache_cow_pages_total"] == 1


def test_eviction_readmit_replay_with_shared_pages(pipes):
    """Page pressure while the cache holds shared pages: the younger slot is
    evicted, re-admits over the cached prefix and replays."""
    jp, tp = pipes
    q1, q2 = SYS + "first question here", SYS + "second question here"
    chunk, ps = 4, 16
    row1 = np.asarray(tp._prepare_request({"question": q1})[0])
    row2 = np.asarray(tp._prepare_request({"question": q2})[0])
    m = min(len(row1), len(row2))
    neq = row1[:m] != row2[:m]
    shared_full = (int(np.argmax(neq)) if neq.any() else m) // ps
    admit1 = math.ceil((len(row1) + chunk) / ps)
    admit2 = math.ceil((len(row2) + chunk) / ps)
    cap = (admit1 * ps - len(row1)) + ps  # one growth page per row
    kw = dict(GEOM, num_pages=admit1 + admit2 - shared_full + 1)
    sched, _, _, got = _both(pipes, [(q1, cap), (q2, cap)], **kw)
    assert sched.metrics.get("evicted") >= 1
    assert [u[1] for _, _, u in got] == [cap, cap]


def test_max_tokens_1_finish_donates_only_written_kv(pipes):
    """A max_tokens=1 request finishes at activation with its first token
    never fed back: only the prompt's full pages may be cached."""
    q, L = _page_aligned(pipes[1], SYS + "one token please", 1, 16)
    sched, jsched, _, got = _both(pipes, [(q, 1)], **GEOM)
    assert got[0][2][1] == 1
    assert sched.prefix_cache.pages == L // 16 == jsched.prefix_cache.pages


def _ask(sched, text, n=6):
    return sched.submit({"question": text}, n).result(timeout=300)


SPILL = dict(num_slots=2, page_size=8, chunk=4, max_ctx=256,
             prefill_chunk=16, host_cache_bytes=1 << 24)


def _quiesce(sched, timeout=30.0):
    """Wait until no slot is held and the queue is empty (the engine thread
    then only waits on its condition), so the test may touch the cache."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if all(r is None for r in sched.slots) and sched.queue_len() == 0:
            return
        time.sleep(0.02)
    raise TimeoutError("engine did not quiesce")


def _spill_loop(sched, prompt):
    """Serve `prompt` cold, evict every cached page to host, serve it again
    (a host-tier reload). Returns (cold, warm, spilled, host bytes, warm
    handle)."""
    try:
        cold = _ask(sched, prompt)
        _quiesce(sched)
        cache = sched.prefix_cache
        assert cache.pages > 0
        spilled = cache.evict(cache.evictable_pages())
        assert cache.spilled_pages == spilled > 0 and cache.pages == 0
        host_bytes = cache.host_bytes
        if isinstance(sched, ContinuousScheduler):
            # A freed page's bytes are up for grabs: the host copies must
            # not alias them.
            for plane in sched.kv_pages.values():
                for leaf in tpk._byte_leaves(plane):
                    leaf.zero_()
        h = sched.submit({"question": prompt}, 6)
        warm = h.result(timeout=300)
        _quiesce(sched)
        return cold, warm, spilled, host_bytes, h
    finally:
        sched.close()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_spill_reload_closed_loop(pipes, kv_dtype):
    """Evict the cached prefix to host, re-send the prompt: the reply is the
    cold one, the reload counters move and the request's cached tokens
    cover the reloaded prefix; all as in JAX's engine."""
    jp, tp = pipes
    prompt = "spill tier closed loop prompt " * 4
    jsched = JaxScheduler(jp, kv_dtype=kv_dtype, **SPILL)
    with jax.default_matmul_precision("highest"):
        jcold, jwarm, jspilled, jbytes, jh = _spill_loop(jsched, prompt)
    sched = ContinuousScheduler(tp, kv_dtype=kv_dtype, **SPILL)
    cold, warm, spilled, host_bytes, h = _spill_loop(sched, prompt)
    assert warm == cold == jcold == jwarm
    assert (spilled, host_bytes) == (jspilled, jbytes)
    reg = jsched.metrics.registry
    m = sched.metrics
    for name in ("oryx_cache_reload_hit_total",
                 "oryx_cache_reload_upload_total"):
        assert m.registry.get(name, raw_name=True) == reg.get(
            name, raw_name=True) > 0
    assert m.registry.get("oryx_cache_reload_hit_total", raw_name=True) == 1
    assert h.debug["cached_tokens"] == _jax_cached(jh) > 0
    sched.check_pool_invariant()
    jsched._check_pool_invariant()


def test_failed_reload_degrades_to_cold_recompute(pipes, monkeypatch):
    """A failed re-upload on the re-sent prompt: the same reply through a
    cold recompute, no leak, and the next send splices again."""
    _, tp = pipes
    sched = ContinuousScheduler(tp, kv_dtype="int8", **SPILL)
    try:
        prompt = "degraded reload prompt " * 4
        cold = _ask(sched, prompt)
        _quiesce(sched)
        cache = sched.prefix_cache
        cache.evict(cache.evictable_pages())
        assert cache.spilled_pages > 0
        upload = sched._spill_upload
        fails = []

        def fail_once(blob, page):
            if not fails:
                fails.append(page)
                raise RuntimeError("injected host-tier re-upload failure")
            upload(blob, page)

        monkeypatch.setattr(sched.prefix_cache, "spill_upload", fail_once)
        warm = sched.submit({"question": prompt}, 6)
        assert warm.result(timeout=300) == cold
        assert fails and sched.metrics.registry.get(
            "oryx_cache_reload_upload_total", raw_name=True) == 0
        _quiesce(sched)
        third = sched.submit({"question": prompt}, 6)
        assert third.result(timeout=300) == cold
        assert third.debug["cached_tokens"] > 0
        _quiesce(sched)
    finally:
        sched.close()
    sched.check_pool_invariant()
    held = len(sched.prefix_cache.held_pages())
    assert sched.allocator.num_free + held == sched.num_pages


def test_rejects_bad_cache_options(pipes):
    _, tp = pipes
    with pytest.raises(ValueError, match="kv_dtype must be"):
        ContinuousScheduler(tp, autostart=False, kv_dtype="fp8_e4m3")
    with pytest.raises(ValueError, match="host_cache_bytes"):
        ContinuousScheduler(tp, autostart=False, host_cache_bytes=-1)
    sched = ContinuousScheduler(tp, autostart=False, prefix_cache=False)
    assert sched.prefix_cache is None
    sched.close()
