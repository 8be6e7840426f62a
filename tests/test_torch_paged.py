"""The port's paged KV cache and paged generation against the JAX package,
on the CPU.

Inputs are made with numpy from a seed and handed to both sides; fp32
throughout, JAX matmuls at "highest" precision. Tolerance where the
arithmetic differs (the plain twins of the paged kernels against the Pallas
kernels in interpret mode and the JAX references): atol 2e-4, rtol 2e-3.
Exact where it does not: allocator state and block tables, pool bytes after
the page writers, gathers, sampling truncation masks, greedy tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.models import generate as jgen  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.ops.pallas import paged_attention as jppa  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import generate as tgen  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.ops.cuda import paged_attention as tpa  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Allocator and block tables
# ---------------------------------------------------------------------------


def _same(fn, *allocs):
    """Run fn on each allocator; results (or exception class names) and
    the allocators' state must agree."""
    outs = []
    for a in allocs:
        try:
            outs.append(("ok", fn(a)))
        except (ValueError, RuntimeError) as e:
            outs.append((type(e).__name__, None))
    assert outs[0] == outs[1], outs
    a, b = allocs
    assert a._free == b._free and a._refs == b._refs
    assert (a.num_free, a.min_free) == (b.num_free, b.min_free)
    return outs[0]


@pytest.mark.parametrize("seed", range(4))
def test_allocator_sequences_equal(seed):
    """Random alloc / share / free / bad-free sequences: same pages handed
    out, same free list (LIFO order), refcounts, low-water mark, and the
    same refusals."""
    rng = np.random.default_rng(seed)
    P = 12
    allocs = (jpk.PageAllocator(P, 16), tpk.PageAllocator(P, 16))
    held: list[list[int]] = []
    for step in range(80):
        op = int(rng.integers(0, 5))
        if op <= 1:
            n = int(rng.integers(0, 6))
            res = _same(lambda a: a.alloc(n, owner=f"r{step}"), *allocs)
            if res[0] == "ok" and res[1]:
                held.append(res[1])
        elif op == 2 and held:
            pages = held.pop(int(rng.integers(len(held))))
            _same(lambda a: a.free(pages, owner="x"), *allocs)
        elif op == 3 and held:
            pages = list(held[int(rng.integers(len(held)))])
            _same(lambda a: a.share(pages), *allocs)
            held.append(pages)
        else:
            bad = [int(rng.integers(0, P + 2))] * int(rng.integers(1, 4))
            live = sum((h.count(bad[0]) for h in held), 0)
            if len(bad) > live:  # a double free or out-of-pool page
                _same(lambda a: a.free(bad), *allocs)
        for a in allocs:
            a.check_invariant(held)
    assert _same(lambda a: a.pages_for(33), *allocs) == ("ok", 3)
    assert _same(lambda a: a.sentinel, *allocs) == ("ok", P)


def test_grow_block_tables_equal():
    """Growing, widening and narrowing block tables through the same
    allocator sequence gives byte-equal tables, and the same refusal when
    the pool cannot hold the total ask."""
    states = [
        mod.PagedState(
            kv_pages=None, block_tables=np.full((3, 2), 9, np.int32),
            allocator=pk.PageAllocator(9, 8),
        )
        for mod, pk in ((jgen, jpk), (tgen, tpk))
    ]
    for rows, width in (([3, 9, 0], 2), ([17, 9, 8], 4), ([17, 30, 8], 4),
                        ([5, 5, 5], 2), ([40, 40, 40], 6)):
        outs = []
        for mod, st in zip((jgen, tgen), states):
            try:
                outs.append(mod._grow_block_tables(st, rows, width).copy())
            except (jpk.OutOfPagesError, tpk.OutOfPagesError) as e:
                outs.append(type(e).__name__)
        if isinstance(outs[0], str):
            assert outs == ["OutOfPagesError"] * 2
        else:
            np.testing.assert_array_equal(outs[0], outs[1])
        assert states[0].allocator._free == states[1].allocator._free


# ---------------------------------------------------------------------------
# Page writers and gathers: equal pool bytes
# ---------------------------------------------------------------------------

P, PS, HK, D = 10, 4, 2, 8


def _pools(rng):
    """(numpy pool, the port's pool layer holding the same bytes)."""
    arr = rng.standard_normal((P, PS, HK, D)).astype(np.float32)
    layer = tpk.init_paged_pool(1, P, PS, HK, D, dtype=torch.float32,
                                device="cpu")[0]
    layer.copy_(_t(arr))
    return arr, layer


# Row 0 spills into a sentinel column, row 2 is masked, row 1 crosses
# pages; every slot lies inside the table's width.
BT = np.array([[3, 7, P, P], [1, 2, 5, 8], [0, P, P, P]], np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_write_pages_equal_pool_bytes(masked):
    rng = np.random.default_rng(0)
    arr, layer = _pools(rng)
    new = rng.standard_normal((3, 6, HK, D)).astype(np.float32)
    start = np.array([4, 5, 0], np.int32)
    wm = np.array([True, True, False]) if masked else None
    want = jpk.write_pages(
        jnp.asarray(arr), jnp.asarray(new), jnp.asarray(BT),
        jnp.asarray(start),
        write_mask=None if wm is None else jnp.asarray(wm),
    )
    got = tpk.write_pages(
        layer, _t(new), _t(BT), _t(start),
        write_mask=None if wm is None else _t(wm),
    )
    assert got is layer  # in place
    np.testing.assert_array_equal(layer.numpy(), np.asarray(want))
    assert not np.array_equal(layer.numpy(), arr)


def test_write_pages_packed_equal_pool_bytes():
    """Decode rows of two slots, prefill rows of a third, a segment past S
    (clamped), a masked row and a sentinel-routed row."""
    rng = np.random.default_rng(1)
    arr, layer = _pools(rng)
    seg = np.array([0, 1, 2, 2, 2, 7, 1, 0], np.int32)
    pos = np.array([5, 13, 0, 1, 2, 9, 3, 9], np.int32)
    wm = np.array([True, True, True, True, True, True, False, True])
    new = rng.standard_normal((8, HK, D)).astype(np.float32)
    want = jpk.write_pages_packed(
        jnp.asarray(arr), jnp.asarray(new), jnp.asarray(BT),
        jnp.asarray(seg), jnp.asarray(pos), write_mask=jnp.asarray(wm),
    )
    tpk.write_pages_packed(
        layer, _t(new), _t(BT), _t(seg), _t(pos), write_mask=_t(wm)
    )
    np.testing.assert_array_equal(layer.numpy(), np.asarray(want))


def test_writes_past_the_table_drop():
    """A slot past the block table's width has no page: the port drops the
    write (JAX's per-row writer lands it in page 0, which the row does not
    own; its packed writer clamps it into the row's last page)."""
    rng = np.random.default_rng(6)
    arr, layer = _pools(rng)
    bt = BT[1:2]  # pages 1, 2, 5, 8: logical slots 0..15
    new = rng.standard_normal((1, 3, HK, D)).astype(np.float32)
    tpk.write_pages(layer, _t(new), _t(bt), _t(np.array([16], np.int32)))
    tpk.write_pages_packed(
        layer, _t(new[0]), _t(bt), _t(np.zeros(3, np.int32)),
        _t(np.array([16, 17, 40], np.int32)),
    )
    np.testing.assert_array_equal(layer.numpy(), arr)
    # The same call one slot earlier lands in the row's own last page.
    tpk.write_pages(layer, _t(new), _t(bt), _t(np.array([13], np.int32)))
    np.testing.assert_array_equal(layer.numpy()[8, 1:], new[0])


def test_write_pages_need_the_sink_page():
    with pytest.raises(ValueError, match="init_paged_pool"):
        tpk.write_pages(
            torch.zeros((P, PS, HK, D)), torch.zeros((1, 1, HK, D)),
            _t(BT[:1]), torch.zeros(1, dtype=torch.int32),
        )


def test_gather_pages_clips_sentinels_equal():
    rng = np.random.default_rng(2)
    arr, layer = _pools(rng)
    want = jpk.gather_pages(jnp.asarray(arr), jnp.asarray(BT))
    got = tpk.gather_pages(layer, _t(BT))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stop_window_and_host_helpers_equal():
    rng = np.random.default_rng(3)
    recent = rng.integers(-2, 6, size=(5, 4)).astype(np.int32)
    stops = np.array([[-1, -1, 3, 4], [-1, 1, 2, 5], [-3, -3, -3, -3]],
                     np.int32)
    recent[1, 2:] = [3, 4]
    recent[3, 1:] = [1, 2, 5]
    want = jpk.stop_window_hit(jnp.asarray(recent), jnp.asarray(stops))
    got = tpk.stop_window_hit(_t(recent), _t(stops))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.tolist() == [False, True, False, True, False]
    assert not tpk.stop_window_hit(_t(recent), None).any()
    emb = rng.standard_normal((1, 7, 3)).astype(np.float32)
    for off, width in ((0, 4), (5, 4), (9, 2)):
        np.testing.assert_array_equal(
            tgen.pack_prefill_window(_t(emb), off, width).numpy(),
            jgen.pack_prefill_window(emb, off, width),
        )
    padded = tgen.pad_embeds_for_chunks(_t(emb), 4)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jgen.pad_embeds_for_chunks(emb, 4))
    )
    for start in (0, 3, 7):
        np.testing.assert_array_equal(
            tgen.slice_embeds(padded, start, width=4).numpy(),
            np.asarray(jgen.slice_embeds(jnp.asarray(padded.numpy()),
                                         start, width=4)),
        )
    toks = np.arange(12).reshape(3, 4)
    assert tgen.unpack_ragged_rows(toks, [0, 2]) == (
        jgen.unpack_ragged_rows(toks, [0, 2])
    )


def test_truncation_and_greedy_rows_equal():
    """Per-row temperature/top-k/top-p truncation keeps the same nucleus as
    JAX's; rows without a generator, or at temperature 0, are argmax."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 40)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.9], np.float32)
    top_p = np.array([1.0, 0.9, 0.5, 1.0, 0.95], np.float32)
    top_k = np.array([0, 0, 5, 40, 3], np.int32)
    want, wg = jgen.truncate_logits_rows(
        jnp.asarray(logits), temperature=jnp.asarray(temp),
        top_p=jnp.asarray(top_p), top_k=jnp.asarray(top_k),
    )
    got, gg = tgen.truncate_logits_rows(
        _t(logits), temperature=_t(temp), top_p=_t(top_p), top_k=_t(top_k)
    )
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6)
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))
    gens = [None, torch.Generator().manual_seed(1), None,
            torch.Generator().manual_seed(2), torch.Generator().manual_seed(3)]
    knobs = dict(temperature=_t(temp), top_p=_t(top_p), top_k=_t(top_k))
    toks = tgen.sample_token_rows(_t(logits), gens, **knobs)
    am = logits.argmax(-1)
    assert toks[0] == am[0] and toks[2] == am[2]
    for i in (1, 3, 4):  # a sample lies inside its row's nucleus
        assert fin[i, int(toks[i])]
    assert tgen.sample_token_rows(
        _t(logits), [None] * 5, **knobs
    ).tolist() == am.tolist()


# ---------------------------------------------------------------------------
# K3 / K4 plain twins against the Pallas kernels and the JAX references
# ---------------------------------------------------------------------------


def _attn_case(seed, ps, G, lengths, Hk=2, Dh=16):
    rng = np.random.default_rng(seed)
    need = sum(-(-n // ps) for n in lengths)
    Pn = need + 2
    maxp = max(-(-n // ps) for n in lengths) + 1
    perm = list(rng.permutation(Pn))
    bt = np.full((len(lengths), maxp), Pn, np.int32)
    for s, n in enumerate(lengths):
        for j in range(-(-n // ps)):
            bt[s, j] = perm.pop()
    kp = rng.standard_normal((Pn, ps, Hk, Dh)).astype(np.float32)
    vp = rng.standard_normal((Pn, ps, Hk, Dh)).astype(np.float32)
    return rng, bt, kp, vp, Hk * G, Dh


@pytest.mark.parametrize("ps,G", [(4, 1), (4, 2), (8, 7)])
def test_decode_twin_matches_pallas_and_reference(ps, G):
    lengths = [1, ps, ps + 1, 3 * ps - 1, 2 * ps]
    rng, bt, kp, vp, Hq, Dh = _attn_case(0, ps, G, lengths)
    q = rng.standard_normal((len(lengths), 1, Hq, Dh)).astype(np.float32)
    n = np.asarray(lengths, np.int32)
    jargs = [jnp.asarray(x) for x in (q, kp, vp, bt, n)]
    kern = np.asarray(jppa.ragged_decode_attention(*jargs, interpret=True))
    ref = np.asarray(jpk.ragged_decode_attention(*jargs))
    targs = [_t(x) for x in (q, kp, vp, bt, n)]
    got = tpk.ragged_decode_attention(*targs)
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    # The kernel wrapper on CPU tensors is the twin; [B, Hq, D] works too.
    wrap = tpa.ragged_decode_attention(targs[0][:, 0], *targs[1:])
    torch.testing.assert_close(wrap, got[:, 0], atol=0, rtol=0)


@pytest.mark.parametrize("ps,G", [(4, 1), (4, 2), (8, 7)])
def test_ragged_twin_matches_pallas_and_reference(ps, G):
    """Decode rows of every slot, prefill rows of one slot at consecutive
    positions, a segment past S (clamped); a row at position -1 sees no
    key and is left out of the comparison."""
    lengths = [1, ps, 2 * ps + 3, 3 * ps]
    rng, bt, kp, vp, Hq, Dh = _attn_case(1, ps, G, lengths)
    seg = np.array(
        [0, 1, 2, 3] + [2] * (2 * ps + 3) + [9, 0], np.int32
    )
    pos = np.array(
        [n - 1 for n in lengths] + list(range(2 * ps + 3)) + [ps, -1],
        np.int32,
    )
    q = rng.standard_normal((len(seg), Hq, Dh)).astype(np.float32)
    jargs = [jnp.asarray(x) for x in (q, kp, vp, bt, seg, pos)]
    kern = np.asarray(jppa.ragged_paged_attention(*jargs, interpret=True))
    ref = np.asarray(jpk.ragged_paged_attention(*jargs))
    targs = [_t(x) for x in (q, kp, vp, bt, seg, pos)]
    got = tpk.ragged_paged_attention(*targs).numpy()
    keep = pos >= 0
    np.testing.assert_allclose(got[keep], kern[keep], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got[keep], ref[keep], atol=ATOL, rtol=RTOL)
    wrap = tpa.ragged_paged_attention(*targs).numpy()
    np.testing.assert_array_equal(wrap, got)


# ---------------------------------------------------------------------------
# generate_paged: greedy tokens and written pool slots equal JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jcfg.oryx_tiny()
    tree = joryx.init_params(cfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * (20 if a.ndim >= 2 else 1),
        tree,
    )
    tm = from_jax_params(tree, tcfg.OryxConfig.from_dict(cfg.to_dict()))
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tm


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize(
    "ragged,prefill_chunk", [(False, None), (True, None), (False, 8)],
    ids=["split", "ragged", "split-chunked"],
)
def test_generate_paged_equal(weights, impl, ragged, prefill_chunk):
    cfg, jparams, tparams = weights
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 500, size=(3, 16))
    lengths = np.array([5, 16, 11], np.int32)
    emb = np.asarray(jparams["llm"]["embed"]["weight"])[ids]
    kw = dict(max_new_tokens=10, page_size=8, chunk=4, attn_impl=impl,
              ragged=ragged, prefill_chunk=prefill_chunk,
              return_state=True)
    with jax.default_matmul_precision("highest"):
        jt, jn, jf, jst = jgen.generate_paged(
            jparams["llm"], cfg.llm, cfg.generation,
            inputs_embeds=jnp.asarray(emb), lengths=jnp.asarray(lengths),
            **kw,
        )
    tt, tn, tf, tst = tgen.generate_paged(
        tparams.llm, tcfg.OryxConfig.from_dict(cfg.to_dict()).llm,
        tcfg.OryxConfig.from_dict(cfg.to_dict()).generation,
        inputs_embeds=_t(emb), lengths=_t(lengths), device="cpu", **kw,
    )
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert len({tuple(r) for r in tt.tolist()}) == 3  # rows really differ
    np.testing.assert_array_equal(tst.block_tables, jst.block_tables)
    # Every written slot (prompt + fed tokens) holds JAX's K and V.
    for b, n in enumerate(lengths + 9):
        pages = tst.block_tables[b, : -(-n // 8)]
        for name in ("k", "v"):
            got = tst.kv_pages[name][:, pages].reshape(
                cfg.llm.num_layers, -1, cfg.llm.num_kv_heads,
                cfg.llm.head_dim,
            )[:, :n]
            want = np.asarray(jst.kv_pages[name])[:, pages].reshape(
                got.shape[0], -1, *got.shape[2:]
            )[:, :n]
            np.testing.assert_allclose(
                got.numpy(), want, atol=ATOL, rtol=RTOL
            )


def test_generate_paged_seeded_sampling_replays(weights):
    """Sampling rows draw from per-row generators: the same seed replays
    the same tokens, in either engine layout; another seed differs."""
    cfg, jparams, tparams = weights
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    import dataclasses

    gen_cfg = dataclasses.replace(tc.generation, temperature=1.0, top_k=40)
    emb = tparams.llm.embed.weight[torch.arange(32).reshape(2, 16)]
    runs = [
        tgen.generate_paged(
            tparams.llm, tc.llm, gen_cfg, inputs_embeds=emb,
            lengths=[7, 16], max_new_tokens=8, page_size=8, chunk=4,
            seed=seed, ragged=ragged, device="cpu",
        )[0]
        for seed, ragged in ((1, False), (1, True), (2, False))
    ]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
