"""The port's prefix-reuse prefill, chunked decode loop and streaming
against the JAX package, on the CPU (tiny fp32 config, the same weights on
both sides): `generate(kv_cache=, start=, return_cache=)`, the chunked
`_decode_while`, `generate_stream`, `Pipeline.chat_stream` and
`Pipeline.chat_video`; and the sampler's capturable draw against
`torch.multinomial`.

Greedy tokens and text byte-equal; caches atol 2e-4, rtol 2e-3 (fp32 on
both sides, sums in another order). "xla" on both sides, and "pallas" (JAX
interpret mode against the port's plain twin) for the suffix prefill.
Seeded sampling is held by replaying the port against itself (the two
frameworks draw different numbers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import mm_utils as jmm  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import generate as jgen  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.data import mm_utils as tmm  # noqa: E402
from oryx_tpu_torch.models import generate as tgen  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3


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
def weights():
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, tcfg.OryxConfig.from_dict(cfg.to_dict())))


def _cfgs(impl="xla", **gen):
    cj = dataclasses.replace(jcfg.oryx_tiny(), attn_impl=impl)
    if gen:
        cj = dataclasses.replace(
            cj, generation=dataclasses.replace(cj.generation, **gen)
        )
    return cj, tcfg.OryxConfig.from_dict(cj.to_dict())


def _embeds(B, T, H, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (B, T, H)).astype(np.float32)


def _jax_generate(jp, cj, embeds, lengths, **kw):
    with jax.default_matmul_precision("highest"):
        out = jgen.generate(
            jp["llm"], cj.llm, cj.generation,
            inputs_embeds=jnp.asarray(embeds),
            lengths=jnp.asarray(lengths, jnp.int32),
            attn_impl=cj.attn_impl, **kw,
        )
    return [np.asarray(x) if not isinstance(x, dict) else
            {k: np.asarray(v) for k, v in x.items()} for x in out]


def _port_generate(tp, ct, embeds, lengths, **kw):
    out = tgen.generate(
        tp.llm, ct.llm, ct.generation,
        inputs_embeds=torch.from_numpy(embeds),
        lengths=torch.as_tensor(np.asarray(lengths, np.int32)),
        attn_impl=ct.attn_impl, **kw,
    )
    return [x.numpy() if not isinstance(x, dict) else
            {k: v.numpy() for k, v in x.items()} for x in out]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_generate_prefix_reuse_matches_jax(weights, impl):
    """A 45-token prefix is prefilled and decoded once (return_cache on
    both sides), then a 25-token suffix runs at start=45 (not a multiple of
    64) into the same cache: tokens and caches agree with JAX, and a cold
    prefill of the whole 70 tokens gives the same reply."""
    jp, tp = weights
    cj, ct = _cfgs(impl)
    H = cj.llm.hidden_size
    full = _embeds(1, 70, H, seed=1)
    cache_len, start, new = 256, 45, 6
    pre = full[:, :start]
    want = _jax_generate(jp, cj, pre, [start], max_new_tokens=new,
                         cache_len=cache_len, return_cache=True)
    got = _port_generate(tp, ct, pre, [start], max_new_tokens=new,
                         cache_len=cache_len, return_cache=True)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            got[3][name][:, :, :start + new - 1],
            want[3][name][:, :, :start + new - 1], atol=ATOL, rtol=RTOL)

    # The suffix, bucketed to 32 columns, against JAX's own cache.
    suffix = np.zeros((1, 32, H), np.float32)
    suffix[:, :25] = full[:, start:]
    kv = want[3]
    want2 = _jax_generate(
        jp, cj, suffix, [70], max_new_tokens=new, cache_len=cache_len,
        kv_cache={k: jnp.asarray(v) for k, v in kv.items()},
        start=jnp.asarray(start, jnp.int32), return_cache=True)
    kv_t = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    got2 = _port_generate(
        tp, ct, suffix, [70], max_new_tokens=new, cache_len=cache_len,
        kv_cache=kv_t, start=start, return_cache=True)
    for a, b in zip(got2[:3], want2[:3]):
        np.testing.assert_array_equal(a, b)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            got2[3][name][:, :, :70 + new - 1],
            want2[3][name][:, :, :70 + new - 1], atol=ATOL, rtol=RTOL)
        # The caller's cache is left as it was.
        np.testing.assert_array_equal(kv_t[name].numpy(), kv[name])
    cold = _port_generate(tp, ct, full, [70], max_new_tokens=new,
                          cache_len=cache_len)
    np.testing.assert_array_equal(cold[0], got2[0])


def _eos_case(tp, ct, embeds, lengths):
    """A generation config whose EOS is row 0's second greedy token, so
    row 0 finishes early and the other rows do not."""
    probe = _port_generate(tp, ct, embeds, lengths, max_new_tokens=4,
                           cache_len=256)[0]
    return int(probe[0, 1])


@pytest.mark.parametrize("max_new", [13, 16])
def test_chunked_decode_matches_jax(weights, monkeypatch, max_new):
    """The chunked loop (8 steps a chunk, the last one shorter when
    max_new % 8 != 0) gives JAX's tokens, num_generated and finished, with
    EOS/True in the slots after a row finished; no cache write lands past
    a cache_len of exactly T + max_new."""
    jp, tp = weights
    H = jcfg.oryx_tiny().llm.hidden_size
    embeds = _embeds(3, 16, H, seed=2)
    lengths = [16, 11, 7]
    _, ct0 = _cfgs()
    eos = _eos_case(tp, ct0, embeds, lengths)
    cj, ct = _cfgs(eos_token_id=eos)

    writes = []
    real = tqwen2._cache_write

    def checked(cache_layer, new, slots):
        writes.append(int(slots.max()) + new.shape[1])
        assert writes[-1] <= cache_layer.shape[1]
        return real(cache_layer, new, slots)

    monkeypatch.setattr(tqwen2, "_cache_write", checked)
    timings = {}
    kw = dict(max_new_tokens=max_new, cache_len=16 + max_new)
    got = _port_generate(tp, ct, embeds, lengths, timings=timings, **kw)
    want = _jax_generate(jp, cj, embeds, lengths, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    toks, num, fin = got
    assert fin[0] and not fin[1:].any()
    assert (toks[0, num[0]:] == eos).all()
    assert timings["decode_steps"] == max_new
    assert max(writes) <= 16 + max_new


def test_decode_stops_early_when_every_row_is_done(weights):
    """A one-row batch whose EOS lands at step 2 of a 40-step window stops
    after its first chunk; the unexecuted slots hold EOS and True, as in
    JAX's while loop."""
    jp, tp = weights
    H = jcfg.oryx_tiny().llm.hidden_size
    embeds = _embeds(1, 12, H, seed=3)
    _, ct0 = _cfgs()
    eos = _eos_case(tp, ct0, embeds, [12])
    cj, ct = _cfgs(eos_token_id=eos)
    timings = {}
    kw = dict(max_new_tokens=40, cache_len=256)
    got = _port_generate(tp, ct, embeds, [12], timings=timings, **kw)
    want = _jax_generate(jp, cj, embeds, [12], **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert timings["decode_steps"] == tgen.DECODE_CHUNK
    assert got[1][0] == 2 and (got[0][0, 2:] == eos).all()


def _jax_stream(jp, cj, embeds, lengths, **kw):
    with jax.default_matmul_precision("highest"):
        return [np.asarray(b) for b in jgen.generate_stream(
            jp["llm"], cj.llm, cj.generation,
            inputs_embeds=jnp.asarray(embeds),
            lengths=jnp.asarray(lengths, jnp.int32),
            attn_impl=cj.attn_impl, **kw)]


def _port_stream(tp, ct, embeds, lengths, **kw):
    return list(tgen.generate_stream(
        tp.llm, ct.llm, ct.generation,
        inputs_embeds=torch.from_numpy(embeds),
        lengths=torch.as_tensor(np.asarray(lengths, np.int32)),
        attn_impl=ct.attn_impl, **kw))


@pytest.mark.parametrize("chunk", [3, 4])
def test_generate_stream_matches_jax(weights, chunk):
    """Blocks of [B, <=chunk] int32 equal JAX's, whole chunks with the
    overshoot dropped (10 % chunk != 0)."""
    jp, tp = weights
    cj, ct = _cfgs()
    embeds = _embeds(2, 16, cj.llm.hidden_size, seed=4)
    kw = dict(max_new_tokens=10, cache_len=256, chunk=chunk)
    got = _port_stream(tp, ct, embeds, [16, 9], **kw)
    want = _jax_stream(jp, cj, embeds, [16, 9], **kw)
    assert [b.shape for b in got] == [b.shape for b in want]
    for a, b in zip(got, want):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_generate_stream_equals_generate_sampled(weights):
    """At temperature 0.7 with the same generator seed, the stream's blocks
    joined are generate's tokens (13 % 4 != 0), twice over; another seed
    draws another stream."""
    _, tp = weights
    _, ct = _cfgs(temperature=0.7)
    embeds = _embeds(2, 16, ct.llm.hidden_size, seed=5)

    def run(seed):
        kw = dict(max_new_tokens=13, cache_len=256)
        toks = _port_generate(
            tp, ct, embeds, [16, 10],
            generator=torch.Generator().manual_seed(seed), **kw)[0]
        blocks = _port_stream(
            tp, ct, embeds, [16, 10], chunk=4,
            generator=torch.Generator().manual_seed(seed), **kw)
        return toks, np.concatenate(blocks, axis=1)

    toks, streamed = run(7)
    np.testing.assert_array_equal(streamed, toks)
    again, _ = run(7)
    np.testing.assert_array_equal(again, toks)
    other, _ = run(8)
    assert (other != toks).any()


def test_generate_stream_yield_cache_matches_jax(weights):
    """With yield_cache the last cache holds the prompt and the decoded
    slots as JAX's does."""
    jp, tp = weights
    cj, ct = _cfgs()
    embeds = _embeds(1, 16, cj.llm.hidden_size, seed=6)
    kw = dict(max_new_tokens=8, cache_len=256, chunk=4, yield_cache=True)
    with jax.default_matmul_precision("highest"):
        want = [(np.asarray(b), {k: np.asarray(v) for k, v in c.items()})
                for b, c in jgen.generate_stream(
                    jp["llm"], cj.llm, cj.generation,
                    inputs_embeds=jnp.asarray(embeds),
                    lengths=jnp.asarray([16], jnp.int32), **kw)]
    got = _port_stream(tp, ct, embeds, [16], **kw)
    assert len(got) == len(want)
    for (bg, cg), (bw, cw) in zip(got, want):
        np.testing.assert_array_equal(bg, bw)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            got[-1][1][name].numpy()[:, :, :16 + 7],
            want[-1][1][name][:, :, :16 + 7], atol=ATOL, rtol=RTOL)


def _img(rng, h, w):
    return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)


def _pipes(weights, impl="xla"):
    jp, tp = weights
    cj, ct = _cfgs(impl)
    return (OryxInference(CharTokenizer(), jp, cj),
            Pipeline(CharTokenizer(), tp, ct, device="cpu"))


def _drain(gen):
    """(deltas, the generator's return value)."""
    deltas = []
    while True:
        try:
            deltas.append(next(gen))
        except StopIteration as s:
            return deltas, s.value


def test_chat_stream_matches_jax_and_chat(weights, monkeypatch):
    """Text and image requests at chunks 2 and 4 (6 % 4 != 0): the port's
    deltas and finish reason equal JAX's, and join to chat()'s reply."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    jpipe, tpipe = _pipes(weights)
    img = _img(np.random.default_rng(4), 30, 44)
    for kw in (dict(question="hello there"),
               dict(question="what is this?", images=[img])):
        ref = tpipe.chat(max_new_tokens=6, **kw)
        assert ref == jpipe.chat(max_new_tokens=6, **kw)
        for chunk in (2, 4):
            with jax.default_matmul_precision("highest"):
                want = _drain(jpipe.chat_stream(
                    max_new_tokens=6, chunk=chunk, **kw))
            got = _drain(tpipe.chat_stream(
                max_new_tokens=6, chunk=chunk, **kw))
            assert got == want
            assert "".join(got[0]) == ref


def test_chat_stream_stop_and_usage_match_jax(weights):
    """A request stop string ends the stream at the same delta as JAX's,
    and usage_out counts through the token that completed the stop, as
    chat_batch's counts do."""
    jpipe, tpipe = _pipes(weights)
    base = tpipe.chat("hello there", max_new_tokens=8)
    assert len(base) >= 2
    stop = base[1]
    replies, _, counts = tpipe.chat_batch(
        [{"question": "hello there"}], max_new_tokens=8, stop=[stop],
        return_finish_reasons=True, return_token_counts=True,
    )
    kw = dict(max_new_tokens=8, stop=[stop], chunk=4)
    usage_t, usage_j = {}, {}
    got = _drain(tpipe.chat_stream("hello there", usage_out=usage_t, **kw))
    with jax.default_matmul_precision("highest"):
        want = _drain(jpipe.chat_stream("hello there", usage_out=usage_j,
                                        **kw))
    assert got == want and got[1] == "stop"
    assert "".join(got[0]) == replies[0]
    assert usage_t == usage_j
    assert (usage_t["prompt_tokens"], usage_t["completion_tokens"]) == \
        tuple(counts[0])


def test_chat_stream_sampled_matches_chat(weights):
    """Seeded sampling: the stream equals chat() at temperature 0.9 for the
    same seed, at chunks that do and do not divide max_new_tokens."""
    _, tpipe = _pipes(weights)
    for seed in (0, 3):
        kw = dict(question="hello there", max_new_tokens=8, seed=seed,
                  temperature=0.9, top_p=0.95)
        ref = tpipe.chat(**kw)
        for chunk in (3, 4):
            assert "".join(tpipe.chat_stream(chunk=chunk, **kw)) == ref


@pytest.mark.parametrize("kw", [dict(top_p=1.0, top_k=0),
                                dict(top_p=0.9, top_k=50)])
def test_sample_token_draws_as_multinomial(kw):
    """The sampler's spelled-out draw (argmax of p / q, q ~ Exp(1), which
    runs under CUDA graph capture) gives torch.multinomial's tokens from
    the same generator state, and leaves the generator where it does."""
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 512)).astype(np.float32)) * 3
    for seed in range(4):
        g, ref = torch.Generator().manual_seed(seed), torch.Generator()
        ref.manual_seed(seed)
        got = tgen.sample_token(logits, g, temperature=0.7, **kw)
        l = logits / 0.7
        if kw["top_k"]:
            kth = torch.sort(l, dim=-1).values[:, -kw["top_k"]][:, None]
            l = torch.where(l < kth, -torch.inf, l)
        if kw["top_p"] < 1.0:
            srt = torch.sort(l, dim=-1, descending=True).values
            cum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
            idx = torch.sum(cum < kw["top_p"], dim=-1, keepdim=True)
            l = torch.where(l < torch.gather(srt, -1, idx), -torch.inf, l)
        want = torch.multinomial(torch.softmax(l, -1), 1, generator=ref)
        assert torch.equal(got, want[:, 0].to(torch.int32))
        assert torch.equal(g.get_state(), ref.get_state())


def test_sample_frames_matches_jax():
    for avail, want in ((7, 3), (256, 16), (5, 8), (100, 7)):
        np.testing.assert_array_equal(
            tmm.sample_frames(avail, want), jmm.sample_frames(avail, want))


def test_chat_video_matches_jax(weights, monkeypatch):
    """7 frames sampled down to 3, 16x-compressed video chat: the same
    reply as JAX's, and as chat() over the sampled frames."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    jpipe, tpipe = _pipes(weights)
    rng = np.random.default_rng(1)
    frames = [_img(rng, 30, 30) for _ in range(7)]
    got = tpipe.chat_video(frames, "describe", num_frames=3,
                           max_new_tokens=4)
    with jax.default_matmul_precision("highest"):
        want = jpipe.chat_video(frames, "describe", num_frames=3,
                                max_new_tokens=4)
    assert got == want
    idx = tmm.sample_frames(7, 3)
    assert got == tpipe.chat("describe", images=[frames[i] for i in idx],
                             is_video=True, max_new_tokens=4)
