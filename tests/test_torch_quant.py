"""The port's quantized paged KV pool against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both sides. Exact where
the reference pins bytes: the quantizer's codes and scales (int8 and
fp8-e4m3), the pool writers, the copy-on-write / spill / reload page moves,
the dequantizing gather. atol 2e-4, rtol 2e-3 where the arithmetic differs:
the K3/K4 plain twins on quantized pools against the Pallas kernels in
interpret mode (their dequantizing branch). Greedy tokens of
`generate_paged(kv_dtype=...)` are equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.models import generate as jgen  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen2  # noqa: E402
from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.ops.pallas import paged_attention as jppa  # noqa: E402
from oryx_tpu.utils import quant as jquant  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import generate as tgen  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.ops.cuda import paged_attention as tpa  # noqa: E402
from oryx_tpu_torch.utils import quant as tquant  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
FMTS = ["int8", "fp8_e4m3"]
JAX_CODES = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}


def _t(a):
    return torch.from_numpy(np.array(a))


def _bytes(x) -> np.ndarray:
    """Raw bytes of a JAX array or a torch tensor (float8 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.asarray(x).view(np.uint8).reshape(-1)


def _rows(rng, n, Hk=2, D=8):
    """KV rows with the quantizer's edge cases: an all-zero row, exact .5
    ties after scaling, a row at qmax, magnitudes over four decades."""
    x = (rng.standard_normal((n, Hk, D))
         * 10.0 ** rng.uniform(-2, 2, (n, 1, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] = np.round(rng.uniform(-127, 127, (Hk, D))) / 2  # k + .5 codes
    x[1].flat[0] = 127.0  # amax 127: scale 1 (+ tiny)
    x[2] = 63.5
    x[3].flat[:3] = [448.0, -448.0, 1e-6]
    return x


# ---------------------------------------------------------------------------
# The quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
def test_quantizer_bytes_equal(fmt):
    rng = np.random.default_rng(0)
    x = _rows(rng, 64)
    jc, js = jquant.quantize_kv_rows(jnp.asarray(x), fmt)
    tc, ts = tquant.quantize_kv_rows(_t(x), fmt)
    assert tc.dtype == tquant.kv_storage_dtype(fmt)[0]
    np.testing.assert_array_equal(_bytes(tc), _bytes(jc))
    np.testing.assert_array_equal(_bytes(ts), _bytes(js))
    np.testing.assert_array_equal(
        tquant.dequantize_kv_rows(tc, ts).numpy(),
        np.asarray(jquant.dequantize_kv_rows(jc, js)),
    )
    want = jquant.roundtrip_error_stats(jnp.asarray(x[:, 0]), fmt=fmt)
    got = tquant.roundtrip_error_stats(_t(x[:, 0]), fmt=fmt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-12), k
    pages = x[:32].reshape(4, 8, 2, 8)
    jp = jquant.page_roundtrip_error(jnp.asarray(pages), fmt=fmt)
    tp = tquant.page_roundtrip_error(_t(pages), fmt=fmt)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-12)
    with pytest.raises(ValueError, match="unknown KV storage dtype"):
        tquant.kv_storage_dtype("int4")


# ---------------------------------------------------------------------------
# Pool writers, gathers and page moves: equal bytes
# ---------------------------------------------------------------------------

P, PS, HK, D = 10, 4, 2, 8
# Row 0 spills into a sentinel column, row 2 is masked, row 1 crosses pages;
# every slot lies inside the table's width (past it the JAX per-row writer
# lands in page 0, see tests/test_torch_paged.py).
BT = np.array([[3, 7, P, P], [1, 2, 5, 8], [0, P, P, P]], np.int32)


def _quant_pools(rng, fmt, dequant=torch.float32):
    """(JAX QuantPages layer, the port's layer holding the same bytes)."""
    codes, scale = jquant.quantize_kv_rows(
        jnp.asarray(rng.standard_normal((P * PS, HK, D)).astype(np.float32)),
        fmt,
    )
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dequant]
    jl = jpk.QuantPages(codes.reshape(P, PS, HK, D), scale.reshape(P, PS),
                        dequant_dtype=jdt)
    tl = tpk.init_quant_pages(1, P, PS, HK, D, fmt=fmt,
                              dequant_dtype=dequant, device="cpu")[0]
    tl.q.view(torch.uint8).copy_(_t(_bytes(jl.q)).view(P, PS, HK, D))
    tl.scale.copy_(_t(np.asarray(jl.scale)))
    return jl, tl


def _same_planes(tl, jl):
    np.testing.assert_array_equal(_bytes(tl.q), _bytes(jl.q))
    np.testing.assert_array_equal(_bytes(tl.scale), _bytes(jl.scale))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fmt", FMTS)
def test_write_pages_quant_bytes_equal(fmt, masked):
    rng = np.random.default_rng(1)
    jl, tl = _quant_pools(rng, fmt)
    before = _bytes(tl.q).copy()
    new = (rng.standard_normal((3, 6, HK, D)) * 3).astype(np.float32)
    start = np.array([4, 5, 0], np.int32)
    wm = np.array([True, True, False]) if masked else None
    want = jpk.write_pages(
        jl, jnp.asarray(new), jnp.asarray(BT), jnp.asarray(start),
        write_mask=None if wm is None else jnp.asarray(wm),
    )
    got = tpk.write_pages(tl, _t(new), _t(BT), _t(start),
                          write_mask=None if wm is None else _t(wm))
    assert got is tl  # in place
    _same_planes(tl, want)
    assert not np.array_equal(_bytes(tl.q), before)


@pytest.mark.parametrize("fmt", FMTS)
def test_write_pages_packed_quant_bytes_equal(fmt):
    """Decode rows of two slots, prefill rows of a third, a segment past S
    (clamped), a masked row and a sentinel-routed row."""
    rng = np.random.default_rng(2)
    jl, tl = _quant_pools(rng, fmt)
    seg = np.array([0, 1, 2, 2, 2, 7, 1, 0], np.int32)
    pos = np.array([5, 13, 0, 1, 2, 9, 3, 9], np.int32)
    wm = np.array([True, True, True, True, True, True, False, True])
    new = rng.standard_normal((8, HK, D)).astype(np.float32)
    want = jpk.write_pages_packed(
        jl, jnp.asarray(new), jnp.asarray(BT), jnp.asarray(seg),
        jnp.asarray(pos), write_mask=jnp.asarray(wm),
    )
    tpk.write_pages_packed(tl, _t(new), _t(BT), _t(seg), _t(pos),
                           write_mask=_t(wm))
    _same_planes(tl, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantization_is_chunk_grouping_independent(fmt):
    """Per-row scales: the same 10 tokens written in one shot, 2 + 8, 5 + 5
    or 1 + 1 + 8 land identical codes and scales."""
    rng = np.random.default_rng(3)
    bt = _t(np.array([[0, 1, 2, 3]], np.int32))
    new = _t(rng.standard_normal((1, 10, HK, D)).astype(np.float32))

    def write(*spans):
        layer = tpk.init_quant_pages(1, 8, PS, HK, D, fmt=fmt, device="cpu")[0]
        off = 0
        for n in spans:
            tpk.write_pages(layer, new[:, off:off + n], bt,
                            torch.tensor([off], dtype=torch.int32))
            off += n
        return layer

    one = write(10)
    for spans in ((2, 8), (5, 5), (1, 1, 8)):
        other = write(*spans)
        assert torch.equal(one.q.view(torch.uint8), other.q.view(torch.uint8))
        assert torch.equal(one.scale, other.scale)


@pytest.mark.parametrize("fmt", FMTS)
def test_masked_rows_drop_codes_and_scales_together(fmt):
    """A masked row and a sentinel-routed row leave codes and scales of
    every real page untouched: both land in the sink page."""
    bt = _t(np.array([[0, 1, 2, P]], np.int32))
    layer = tpk.init_quant_pages(1, P, PS, HK, D, fmt=fmt, device="cpu")[0]
    new = torch.full((1, 4, HK, D), 5.0)
    tpk.write_pages(layer, new, bt, torch.tensor([0], dtype=torch.int32),
                    write_mask=torch.tensor([False]))
    tpk.write_pages(layer, new, bt, torch.tensor([12], dtype=torch.int32))
    assert not layer.q.view(torch.uint8).any()
    assert not layer.scale.any()


@pytest.mark.parametrize("dequant", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("fmt", FMTS)
def test_gather_pages_dequant_equal(fmt, dequant):
    rng = np.random.default_rng(4)
    jl, tl = _quant_pools(rng, fmt, dequant)
    want = np.asarray(jpk.gather_pages(jl, jnp.asarray(BT)).astype(
        jnp.float32))
    got = tpk.gather_pages(tl, _t(BT))
    assert got.dtype == dequant
    np.testing.assert_array_equal(got.float().numpy(), want)


def _layered(fmt, rng, L=2):
    """A populated pool pytree ([L, P, ...] planes) in both packages, with
    the same bytes."""
    jpool, tpool = {}, {}
    for name in ("k", "v"):
        codes, scale = jquant.quantize_kv_rows(
            jnp.asarray(rng.standard_normal((L, P, PS, HK, D)), jnp.float32),
            fmt,
        )
        jpool[name] = jpk.QuantPages(codes, scale)
        t = tpk.init_quant_pages(L, P, PS, HK, D, fmt=fmt, device="cpu")
        t.q.view(torch.uint8).copy_(_t(_bytes(codes)).view(t.q.shape))
        t.scale.copy_(_t(np.asarray(scale)))
        tpool[name] = t
    return jpool, tpool


@pytest.mark.parametrize("fmt", FMTS)
def test_copy_fetch_upload_pages_bytes_equal(fmt):
    rng = np.random.default_rng(5)
    jpool, tpool = _layered(fmt, rng)
    jpool = jpk.copy_pages(jpool, jnp.asarray(1, jnp.int32),
                           jnp.asarray(6, jnp.int32))
    planes = dict(tpool)
    tpool = tpk.copy_pages(tpool, 1, 6)
    assert all(tpool[n] is planes[n] for n in planes)  # in place
    for name in ("k", "v"):
        _same_planes(tpool[name], jpool[name])
    # fetch -> upload: bitwise round trip, the blob's bytes are JAX's.
    jblob = jpk.fetch_page(jpool, 3)
    blob = tpk.fetch_page(tpool, 3)
    assert tpk.host_blob_bytes(blob) == jpk.host_blob_bytes(jblob)
    for name in ("k", "v"):
        codes, scale = blob[name]
        assert codes.device.type == "cpu"
        np.testing.assert_array_equal(_bytes(codes), _bytes(jblob[name].q))
        np.testing.assert_array_equal(_bytes(scale), _bytes(jblob[name].scale))
    jpool = jpk.upload_page(jpool, jnp.asarray(8, jnp.int32), jblob)
    tpool = tpk.upload_page(tpool, 8, blob)
    for name in ("k", "v"):
        _same_planes(tpool[name], jpool[name])
        assert torch.equal(tpool[name].q[:, 8].view(torch.uint8),
                           tpool[name].q[:, 3].view(torch.uint8))
        assert torch.equal(tpool[name].scale[:, 8], tpool[name].scale[:, 3])


def test_kv_pool_dtype_names_and_bytes():
    jc = jcfg.oryx_tiny().llm
    tc = tcfg.OryxConfig.from_dict(jcfg.oryx_tiny().to_dict()).llm
    dense = tqwen2.init_paged_kv_cache(tc, 4, 8, dtype=torch.float32,
                                       device="cpu")
    assert tpk.kv_pool_dtype(dense) == "float32"
    for fmt in FMTS:
        pool = tqwen2.init_paged_kv_cache(tc, 4, 8, dtype=torch.float32,
                                          device="cpu", kv_dtype=fmt)
        assert tpk.kv_pool_dtype(pool) == fmt == jpk.kv_pool_dtype(
            jqwen2.init_paged_kv_cache(jc, 4, 8, dtype=jnp.float32,
                                       kv_dtype=fmt))
        assert pool["k"].shape == dense["k"].shape
        assert pool["k"].storage_dtype == tquant.kv_storage_dtype(fmt)[0]
        assert pool["k"].dtype == torch.float32
    with pytest.raises(ValueError, match="unknown KV storage dtype"):
        tqwen2.init_paged_kv_cache(tc, 4, 8, device="cpu", kv_dtype="int4")

    def pool_bytes(kv_dtype):  # the P real pages of every plane
        pool = tqwen2.init_paged_kv_cache(tc, 8, 16, dtype=torch.bfloat16,
                                          device="cpu", kv_dtype=kv_dtype)
        leaves = [t for plane in pool.values() for t in (
            [plane.q, plane.scale] if isinstance(plane, tpk.QuantPages)
            else [plane])]
        return sum(t.numel() * t.element_size() for t in leaves)

    row = tc.num_kv_heads * tc.head_dim
    assert pool_bytes("int8") / pool_bytes(None) == pytest.approx(
        (row + 4) / (2 * row), rel=1e-9
    )


# ---------------------------------------------------------------------------
# K3 / K4 plain twins on quantized pools vs the Pallas dequantizing branch
# ---------------------------------------------------------------------------


def _written_pools(fmt, seed, ps, Hk=2, Dh=16, tokens=40):
    """One sequence of `tokens` rows written through the JAX writer into a
    quantized pool, and the port's pool holding the same bytes."""
    rng = np.random.default_rng(seed)
    Pn = 2 * (-(-tokens // ps)) + 2
    perm = rng.permutation(Pn)[: -(-tokens // ps)]
    bt = np.full((1, -(-tokens // ps) + 1), Pn, np.int32)
    bt[0, : len(perm)] = perm
    planes = []
    for _ in range(2):
        jl = jpk.QuantPages(
            jnp.zeros((Pn, ps, Hk, Dh), JAX_CODES[fmt]),
            jnp.zeros((Pn, ps), jnp.float32),
        )
        new = rng.standard_normal((1, tokens, Hk, Dh)).astype(np.float32)
        jl = jpk.write_pages(jl, jnp.asarray(new), jnp.asarray(bt),
                             jnp.asarray([0], jnp.int32))
        tl = tpk.init_quant_pages(1, Pn, ps, Hk, Dh, fmt=fmt, device="cpu")[0]
        tl.q.view(torch.uint8).copy_(_t(_bytes(jl.q)).view(tl.q.shape))
        tl.scale.copy_(_t(np.asarray(jl.scale)))
        planes.append((jl, tl))
    return rng, bt, planes


@pytest.mark.parametrize("ps,G", [(4, 2), (8, 7)])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_decode_twin_matches_pallas(fmt, ps, G):
    rng, bt, ((jk, tk), (jv, tv)) = _written_pools(fmt, 6, ps)
    q = rng.standard_normal((1, 2 * G, 16)).astype(np.float32)
    for n in (1, 7, 40):
        kl = np.array([n], np.int32)
        kern = np.asarray(jppa.ragged_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(kl),
            interpret=True,
        ))
        got = tpa.ragged_decode_attention(_t(q), tk, tv, _t(bt), _t(kl))
        np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)
        ref = tpk.ragged_decode_attention(_t(q), tk, tv, _t(bt), _t(kl))
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


@pytest.mark.parametrize("ps,G", [(4, 2), (8, 7)])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_ragged_twin_matches_pallas(fmt, ps, G):
    rng, bt, ((jk, tk), (jv, tv)) = _written_pools(fmt, 7, ps)
    seg = np.array([0] * 8 + [3], np.int32)  # a segment past S (clamped)
    pos = np.array([0, 3, 10, 17, 25, 33, 38, 39, 20], np.int32)
    q = rng.standard_normal((len(seg), 2 * G, 16)).astype(np.float32)
    kern = np.asarray(jppa.ragged_paged_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(seg),
        jnp.asarray(pos), interpret=True,
    ))
    got = tpa.ragged_paged_attention(_t(q), tk, tv, _t(bt), _t(seg), _t(pos))
    np.testing.assert_allclose(got.numpy(), kern, atol=ATOL, rtol=RTOL)


def test_mixed_quant_dense_pool_rejected():
    _, bt, ((_, tk), _) = _written_pools("int8", 8, 4)
    dense = torch.zeros(tk.shape)
    q = torch.zeros((2, 4, 16))
    seg, pos = torch.zeros(2, dtype=torch.int32), torch.tensor([1, 2])
    with pytest.raises(ValueError, match="both planes"):
        tpa.ragged_paged_attention(q, tk, dense, _t(bt), seg, pos)
    with pytest.raises(ValueError, match="both planes"):
        tpa.ragged_decode_attention(q[:1], dense, tk, _t(bt),
                                    torch.tensor([3]))


# ---------------------------------------------------------------------------
# generate_paged(kv_dtype=...): greedy tokens equal JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jcfg.oryx_tiny()
    tree = joryx.init_params(cfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * (20 if a.ndim >= 2 else 1),
        tree,
    )
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    return cfg, jax.tree_util.tree_map(jnp.asarray, tree), tc, (
        from_jax_params(tree, tc)
    )


@pytest.mark.parametrize(
    "ragged,prefill_chunk", [(False, None), (True, None), (False, 4)],
    ids=["split", "ragged", "split-chunked"],
)
@pytest.mark.parametrize("fmt", FMTS)
def test_generate_paged_quant_tokens_equal(weights, fmt, ragged,
                                           prefill_chunk):
    cfg, jparams, tc, tparams = weights
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 500, size=(2, 12))
    emb = np.asarray(jparams["llm"]["embed"]["weight"])[ids]
    lengths = np.array([12, 7], np.int32)
    kw = dict(max_new_tokens=8, page_size=8, chunk=4, kv_dtype=fmt,
              ragged=ragged, prefill_chunk=prefill_chunk, attn_impl="pallas")
    with jax.default_matmul_precision("highest"):
        jt, jn, _ = jgen.generate_paged(
            jparams["llm"], cfg.llm, cfg.generation,
            inputs_embeds=jnp.asarray(emb), lengths=jnp.asarray(lengths),
            compute_dtype=jnp.float32, **kw,
        )
    tt, tn, _, st = tgen.generate_paged(
        tparams.llm, tc.llm, tc.generation, inputs_embeds=_t(emb),
        lengths=_t(lengths), compute_dtype=torch.float32, device="cpu",
        return_state=True, **kw,
    )
    assert isinstance(st.kv_pages["k"], tpk.QuantPages)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert len({tuple(r) for r in tt.tolist()}) == 2  # rows really differ
