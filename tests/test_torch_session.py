"""The port's multi-turn sessions and option scoring against the JAX
package, on the CPU (tiny fp32 config, the same weights on both sides):
`ChatSession` (`ask`, `ask_stream`, `reset`), `Pipeline.chat_cached` and
its `_prefix_plan` (cache growth across buckets, the prompt-extension
shortcut, the media-fingerprint guard), `PrefixCacheState`,
`SessionPrefixCache` and `Pipeline.score_options`.

Replies byte-equal: cached == uncached == JAX. Log-likelihoods atol 2e-4,
rtol 2e-3 (fp32 on both sides, sums in another order).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve import pipeline as jpipeline  # noqa: E402
from oryx_tpu.serve import prefix_cache as jprefix  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import oryx as toryx  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve import pipeline as tpipeline  # noqa: E402
from oryx_tpu_torch.serve import prefix_cache as tprefix  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
SYS = (
    "You are a meticulous multimodal assistant. Always answer with "
    "care, cite what you see, and keep replies short. "
)


class CharTokenizer:
    """Characters -> code points (capped at 500, below the tiny vocab)."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def pipes():
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    ct = tcfg.OryxConfig.from_dict(cfg.to_dict())
    return (
        jpipeline.OryxInference(
            CharTokenizer(), jax.tree_util.tree_map(jnp.asarray, tree), cfg),
        tpipeline.Pipeline(CharTokenizer(), from_jax_params(tree, ct), ct,
                           device="cpu"),
    )


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _img(seed, h, w):
    return np.random.default_rng(seed).integers(
        0, 255, size=(h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("media", ["text", "image"])
def test_session_cached_equals_uncached_and_jax(pipes, monkeypatch, media):
    """Three turns: the cached port session, the uncached one and JAX's
    cached session reply alike; the cached session encodes the image once
    (turns 2-3 prefill only their text suffix), its id stream and cache
    shape equal JAX's (cache values are held against JAX's in
    test_torch_stream.py), and reset() drops the cache."""
    jpipe, tpipe = pipes
    kw = {"images": [_img(7, 30, 44)]} if media == "image" else {}
    calls = []
    real = toryx.mm_embeds
    monkeypatch.setattr(
        toryx, "mm_embeds",
        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    plain = tpipeline.ChatSession(tpipe, cache=False, **kw)
    cached = tpipeline.ChatSession(tpipe, cache=True, **kw)
    ref = jpipeline.ChatSession(jpipe, cache=True, **kw)
    replies = []
    for q in ("what is this?", "why?", "are you sure about that?"):
        a = cached.ask(q, max_new_tokens=6)
        b = plain.ask(q, max_new_tokens=6)
        c = ref.ask(q, max_new_tokens=6)
        assert a == b == c, (q, a, b, c)
        replies.append(a)
    assert len(set(replies)) > 1
    if media == "image":
        # Turn 1 of the cached session; the uncached one encodes inside
        # chat_batch's mm_generate (3 more calls).
        assert len(calls) == 1 + 3
    st, jst = cached._cache_state, ref._cache_state
    np.testing.assert_array_equal(st.ids, jst.ids)
    np.testing.assert_array_equal(st.prompt_flat, jst.prompt_flat)
    assert st.cache_len == jst.cache_len and st.media_key == jst.media_key
    assert st.cache["k"].shape == jst.cache["k"].shape
    cached.reset()
    assert cached.history == [] and cached._cache_state.cache is None


def test_session_cache_grows_across_buckets(pipes):
    """A turn past the cache bucket moves the slots into a larger cache;
    replies still equal the uncached session's and JAX's."""
    jpipe, tpipe = pipes
    plain = tpipeline.ChatSession(tpipe, cache=False)
    cached = tpipeline.ChatSession(tpipe, cache=True)
    ref = jpipeline.ChatSession(jpipe, cache=True)
    lens = []
    for q in ("hi", "tell me a considerably longer question " * 3, "ok?"):
        a = cached.ask(q, max_new_tokens=5)
        assert a == plain.ask(q, max_new_tokens=5) == ref.ask(
            q, max_new_tokens=5)
        lens.append(cached._cache_state.cache_len)
    assert lens[-1] > lens[0] and lens == sorted(lens)
    assert lens[-1] == ref._cache_state.cache_len


def test_session_cache_shrinking_max_new(pipes):
    """A later turn with a much smaller max_new_tokens keeps the live
    cache's width (the turn-1 bucket)."""
    jpipe, tpipe = pipes
    plain = tpipeline.ChatSession(tpipe, cache=False)
    cached = tpipeline.ChatSession(tpipe, cache=True)
    ref = jpipeline.ChatSession(jpipe, cache=True)
    for q, mx in (("hello there", 200), ("and now?", 4), ("more?", 4)):
        a = cached.ask(q, max_new_tokens=mx)
        assert a == plain.ask(q, max_new_tokens=mx) == ref.ask(
            q, max_new_tokens=mx), q
    assert cached._cache_state.cache_len >= 256
    assert cached._cache_state.cache_len == ref._cache_state.cache_len


def test_ask_stream_uses_prefix_cache(pipes):
    """Streamed, plain, streamed turns in one image session: the cached
    port session's deltas equal the uncached session's and JAX's, and the
    stream keeps the KV state fresh for the next turn."""
    jpipe, tpipe = pipes
    img = _img(9, 26, 30)
    plain = tpipeline.ChatSession(tpipe, images=[img], cache=False)
    cached = tpipeline.ChatSession(tpipe, images=[img], cache=True)
    ref = jpipeline.ChatSession(jpipe, images=[img], cache=True)
    a1 = list(cached.ask_stream("what is this?", max_new_tokens=6))
    assert a1 == list(ref.ask_stream("what is this?", max_new_tokens=6))
    assert "".join(a1) == "".join(
        plain.ask_stream("what is this?", max_new_tokens=6))
    assert cached._cache_state.cache is not None
    ids_after_1 = len(cached._cache_state.ids)
    np.testing.assert_array_equal(cached._cache_state.ids,
                                  ref._cache_state.ids)
    a2 = cached.ask("why?", max_new_tokens=6)
    assert a2 == plain.ask("why?", max_new_tokens=6) == ref.ask(
        "why?", max_new_tokens=6)
    assert len(cached._cache_state.ids) > ids_after_1
    a3 = list(cached.ask_stream("sure?", max_new_tokens=6))
    assert a3 == list(ref.ask_stream("sure?", max_new_tokens=6))
    assert "".join(a3) == "".join(plain.ask_stream("sure?",
                                                   max_new_tokens=6))
    assert plain.history == cached.history == ref.history


def test_prefix_cache_rejects_swapped_images(pipes):
    """Same prompt, same-shape DIFFERENT image: the media fingerprint forces
    a fresh visual prefill, so the reply is the new image's (as JAX's)."""
    jpipe, tpipe = pipes
    img_a, img_b = _img(11, 28, 28), _img(12, 28, 28)
    q = "what is this?"
    r_a, st = tpipe.chat_cached(
        tpipeline.PrefixCacheState(), q, images=[img_a], max_new_tokens=6)
    r_b, st_b = tpipe.chat_cached(st, q, images=[img_b], max_new_tokens=6)
    assert r_b == tpipe.chat(q, images=[img_b], max_new_tokens=6)
    assert r_a == tpipe.chat(q, images=[img_a], max_new_tokens=6)
    assert st_b.media_key != st.media_key
    _, jst = jpipe.chat_cached(
        jpipeline.PrefixCacheState(), q, images=[img_a], max_new_tokens=6)
    assert (r_b, r_a) == (
        jpipe.chat_cached(jst, q, images=[img_b], max_new_tokens=6)[0],
        jpipe.chat(q, images=[img_a], max_new_tokens=6))
    assert tpipeline._media_fingerprint([img_a]) == \
        jpipeline._media_fingerprint([img_a])


def test_prompt_extension_reuses_the_stored_stream(pipes, monkeypatch):
    """A turn that extends the previous prompt skips the image packing:
    `_prefix_plan` builds the flat stream from the stored one, and the
    suffix starts where JAX's does."""
    jpipe, tpipe = pipes
    img = _img(13, 30, 30)
    q1, hist = "what is this?", [("what is this?", "a cat")]
    st = tpipe.chat_cached(tpipeline.PrefixCacheState(), q1, images=[img],
                           max_new_tokens=4)[1]
    jst = jpipe.chat_cached(jpipeline.PrefixCacheState(), q1, images=[img],
                            max_new_tokens=4)[1]
    packs = []
    real = tpipeline.packing.pack_raw_images
    monkeypatch.setattr(tpipeline.packing, "pack_raw_images",
                        lambda *a, **k: (packs.append(1), real(*a, **k))[1])
    args = tpipe._prepare_request(
        {"question": "and the colour?", "images": [img], "history": hist})
    flat, L, common, embeds, cache, cache_len, key = tpipe._prefix_plan(
        st, tpipe.cfg, *args, 4)
    assert packs == []
    jflat, jL, jcommon, _, _, jcache_len, _ = jpipe._prefix_plan(
        jst, jpipe.cfg, *jpipe._prepare_request(
            {"question": "and the colour?", "images": [img],
             "history": hist}), 4)
    np.testing.assert_array_equal(flat, jflat)
    assert (L, common, cache_len) == (jL, jcommon, jcache_len)
    assert 0 < common < L and embeds.shape[1] == 256


def _fake_state(mod, ids, key=()):
    return mod.PrefixCacheState(ids=np.asarray(ids, np.int64), media_key=key)


def test_session_prefix_cache_call_sequence_matches_jax():
    """The same inserts and lookups on both classes: the same states come
    back (deepest common node, LRU refresh), displaced unreachable states
    drop at once, capacity evicts the least recently used, and the media
    key roots the trie."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 400, 80)
    other = rng.integers(0, 400, 40)
    key = (((8, 8, 3), 123),)
    streams = [
        (base[:40], ()), (base[:64], ()), (other, ()), (base[:50], key),
        (np.concatenate([base[:32], other]), ()), (base[:8], ()),
    ]
    probes = [
        (base[:70], ()), (base[:33], ()), (other[:20], ()), (base, key),
        (base[:40], key), (np.concatenate([base[:32], other[:17]]), ()),
    ]
    seqs = []
    for mod, pmod in ((tprefix, tpipeline), (jprefix, jpipeline)):
        cache = mod.SessionPrefixCache(block_size=16, capacity=3)
        states = [_fake_state(pmod, s, k) for s, k in streams]
        log = []
        for i, st in enumerate(states):
            cache.insert(st)
            log.append(("entries", cache.entries))
            for ids, k in probes:
                got = cache.lookup(ids, k)
                log.append(None if got is None else
                               [x is got for x in states].index(True))
        seqs.append(log)
    assert seqs[0] == seqs[1]
    assert any(isinstance(x, int) for x in seqs[0])
    with pytest.raises(ValueError):
        tprefix.SessionPrefixCache(capacity=0)


def test_session_prefix_cache_cross_session_reuse(pipes):
    """Two fresh sessions through one shared index: the second seeds from
    the first's donated state and still answers like an uncached session
    and like JAX; a streamed session seeds too; capacity bounds entries;
    and a media key never reaches a text state."""
    jpipe, tpipe = pipes
    shared = tprefix.SessionPrefixCache(block_size=16, capacity=2)
    jshared = jprefix.SessionPrefixCache(block_size=16, capacity=2)
    q = SYS + "what do you see?"
    s1 = tpipeline.ChatSession(tpipe, shared=shared)
    r1 = s1.ask(q, max_new_tokens=6)
    assert r1 == jpipeline.ChatSession(jpipe, shared=jshared).ask(
        q, max_new_tokens=6)
    assert shared.entries == jshared.entries == 1
    ids = np.asarray(tpipe._prepare_request({"question": q})[0], np.int64)
    assert shared.lookup(ids) is not None
    assert shared.lookup(ids, media_key=(((64, 64, 3), 123),)) is None
    q2 = SYS + "anything else?"
    hit = []
    real = tpipe._prefix_plan

    def plan(state, *a):
        out = real(state, *a)
        hit.append(out[2])  # the reused prefix length
        return out

    tpipe._prefix_plan = plan
    try:
        r2 = tpipeline.ChatSession(tpipe, shared=shared).ask(
            q2, max_new_tokens=6)
    finally:
        del tpipe._prefix_plan
    assert hit[0] >= len(SYS)
    assert r2 == tpipeline.ChatSession(tpipe, cache=False).ask(
        q2, max_new_tokens=6)
    assert r2 == jpipeline.ChatSession(jpipe, shared=jshared).ask(
        q2, max_new_tokens=6)
    streamed = "".join(tpipeline.ChatSession(tpipe, shared=shared)
                       .ask_stream(q, max_new_tokens=6))
    assert streamed == r1
    tpipeline.ChatSession(tpipe, shared=shared).ask(
        "totally different " * 3, max_new_tokens=4)
    assert shared.entries <= 2
    # shared=True is the pipe's own index.
    s = tpipeline.ChatSession(tpipe, shared=True)
    assert s.shared is tpipe.session_prefix_cache()


def test_session_cache_drops_unreachable_displaced_states(pipes):
    """Each turn's stream extends the last: one state remains."""
    _, tpipe = pipes
    shared = tprefix.SessionPrefixCache(block_size=16, capacity=4)
    s = tpipeline.ChatSession(tpipe, shared=shared)
    s.ask(SYS + "turn one", max_new_tokens=4)
    assert shared.entries == 1
    s.ask("turn two", max_new_tokens=4)
    assert shared.entries == 1


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_score_options_matches_jax_and_full_forward(pipes, impl):
    """Prefill once + per-option teacher forcing: the port's scores equal
    JAX's and the log-probs of one dense forward over prompt + option."""
    jpipe, tpipe = pipes
    jp = jpipeline.OryxInference(
        CharTokenizer(), jpipe.params,
        dataclasses.replace(jpipe.cfg, attn_impl=impl))
    tp = tpipeline.Pipeline(
        CharTokenizer(), tpipe.params,
        dataclasses.replace(tpipe.cfg, attn_impl=impl), device="cpu")
    q, options = "pick one", ["cat", "dog", "bird", "x"]
    got = tp.score_options(q, options)
    assert got.shape == (4,) and got.dtype == np.float64
    np.testing.assert_allclose(got, jp.score_options(q, options),
                               atol=ATOL, rtol=RTOL)
    prompt = [min(ord(c), 500) for c in tp.build_prompt(q, 0)]
    llm, cfg = tp.params.llm, tp.cfg.llm
    for o, g in zip(options, got):
        o_ids = [min(ord(c), 500) for c in o]
        with torch.inference_mode():
            logits, _ = tqwen2.forward(
                llm, cfg, input_ids=torch.tensor([prompt + o_ids]))
        lp = torch.log_softmax(logits[0].double(), -1).numpy()
        want = sum(lp[len(prompt) - 1 + j, t] for j, t in enumerate(o_ids))
        np.testing.assert_allclose(g, want, atol=ATOL, rtol=RTOL)


def test_score_options_with_image_matches_jax(pipes):
    jpipe, tpipe = pipes
    img = _img(2, 30, 40)
    got = tpipe.score_options("what?", ["A", "BB"], images=[img])
    np.testing.assert_allclose(
        got, jpipe.score_options("what?", ["A", "BB"], images=[img]),
        atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError):
        tpipe.score_options("what?", ["A", ""])
