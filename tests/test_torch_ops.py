"""The port's tensor ops against the JAX package on the CPU: norms, rope,
plain attention, and the flash-attention wrapper (its plain twin behind the
shared layout step) against the Pallas kernel in interpret mode, in the
four call shapes of the main path.

Tolerance (fp32 everywhere): atol=2e-4, rtol=2e-3 (the tests/test_qwen2.py
bar); JAX matmuls at "highest" precision, torch without TF32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.ops import attention as jattn  # noqa: E402
from oryx_tpu.ops import norms as jnorms  # noqa: E402
from oryx_tpu.ops import packing as jpack  # noqa: E402
from oryx_tpu.ops import rope as jrope  # noqa: E402
from oryx_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from oryx_tpu.ops.pallas import segment_attention as jsa  # noqa: E402
from oryx_tpu_torch.ops import attention as tattn  # noqa: E402
from oryx_tpu_torch.ops import norms as tnorms  # noqa: E402
from oryx_tpu_torch.ops import rope as trope  # noqa: E402
from oryx_tpu_torch.ops.cuda import build  # noqa: E402
from oryx_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from oryx_tpu_torch.ops.cuda import segment_attention as tsa  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def full_precision():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def test_rms_norm_equal():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jnorms.rms_norm(_j(x), _j(w), 1e-6)),
        tnorms.rms_norm(_t(x), _t(w), 1e-6).numpy(), **TOL,
    )


def test_layer_norm_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((7, 48)).astype(np.float32) * 2 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jnorms.layer_norm(_j(x), _j(w), _j(b), 1e-6)),
        tnorms.layer_norm(_t(x), _t(w), _t(b), 1e-6).numpy(), **TOL,
    )


def test_rope_equal():
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 4000, size=(2, 9)).astype(np.int32)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    jc, js = jrope.rope_cos_sin(_j(pos), 16, 10000.0)
    tc, ts = trope.rope_cos_sin(_t(pos), 16, 10000.0)
    np.testing.assert_allclose(np.asarray(jc), tc.numpy(), **TOL)
    jq, jk = jrope.apply_rope(_j(q), _j(k), jc, js)
    tq, tk = trope.apply_rope(_t(q), _t(k), tc, ts)
    np.testing.assert_allclose(np.asarray(jq), tq.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(jk), tk.numpy(), **TOL)


def _qkv(seed, B, Tq, Tk, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, Tk, Hk, D)).astype(np.float32)
    return q, k, v


def _seg_ids(sizes, pad):
    ids = np.concatenate(
        [np.full(n, i + 1, np.int32) for i, n in enumerate(sizes)]
        + [np.zeros(pad, np.int32)]
    )
    return ids[None]


ATTN_CASES = {
    "causal_prefill": dict(shape=(2, 24, 24, 4, 2, 16), causal=True),
    "causal_positions_kv_mask": dict(shape=(2, 5, 40, 4, 1, 16), causal=True,
                                     positions=True, kv_mask=True),
    "segments": dict(shape=(1, 40, 40, 4, 4, 12), segments=True),
    "segments_cross": dict(shape=(1, 16, 40, 2, 2, 8), segments=True),
    "kv_mask_only": dict(shape=(3, 7, 11, 6, 3, 8), kv_mask=True),
}


def _attn_inputs(case):
    spec = ATTN_CASES[case]
    B, Tq, Tk, Hq, Hk, D = spec["shape"]
    q, k, v = _qkv(3, B, Tq, Tk, Hq, Hk, D)
    rng = np.random.default_rng(4)
    kw = {"causal": spec.get("causal", False)}
    if spec.get("positions"):
        kw["q_positions"] = rng.integers(3, Tk, size=(B, Tq)).astype(np.int32)
        kw["kv_positions"] = np.broadcast_to(
            np.arange(Tk, dtype=np.int32), (B, Tk)
        ).copy()
    if spec.get("segments"):
        kw["kv_segment_ids"] = _seg_ids([10, 20, 6], Tk - 36)
        kw["q_segment_ids"] = (
            kw["kv_segment_ids"] if Tq == Tk
            else rng.integers(0, 4, size=(1, Tq)).astype(np.int32)
        )
    if spec.get("kv_mask"):
        lens = rng.integers(Tk // 2, Tk + 1, size=B)
        kw["kv_mask"] = (np.arange(Tk)[None] < lens[:, None]).astype(np.int32)
    return q, k, v, kw


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_plain_attention_equal(case, chunked, monkeypatch):
    q, k, v, kw = _attn_inputs(case)
    if chunked:  # force the query-chunk loop on both sides
        monkeypatch.setattr(jattn, "MAX_LOGITS_ELEMS", 64)
        monkeypatch.setattr(tattn, "MAX_LOGITS_ELEMS", 64)
    want = jattn.attention(
        _j(q), _j(k), _j(v), **{n: _j(x) if n != "causal" else x
                                for n, x in kw.items()}
    )
    got = tattn.attention(
        _t(q), _t(k), _t(v), **{n: _t(x) if n != "causal" else x
                                for n, x in kw.items()}
    )
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def _flash_both(q, k, v, **kw):
    """(JAX Pallas flash in interpret mode, port's flash on CPU)."""
    conv = {n: x for n, x in kw.items() if n in ("causal", "slot_positions")}
    want = jfa.flash_attention(
        _j(q), _j(k), _j(v), **conv,
        **{n: _j(x) for n, x in kw.items() if n not in conv},
    )
    got = tfa.flash_attention(
        _t(q), _t(k), _t(v), **conv,
        **{n: _t(x) for n, x in kw.items() if n not in conv},
    )
    return np.asarray(want), got.numpy()


def test_flash_dense_cache_prefill_ragged_mask():
    """Decoder prefill over the dense cache: causal, GQA, explicit q
    positions, arange kv slots, ragged kv_mask."""
    B, T, S, Hq, Hk, D = 2, 24, 64, 4, 2, 16
    q, k, v = _qkv(5, B, T, S, Hq, Hk, D)
    lens = np.asarray([24, 13])
    want, got = _flash_both(
        q, k, v, causal=True,
        q_positions=np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)),
        kv_mask=(np.arange(S)[None] < lens[:, None]).astype(np.int32),
    )
    keep = np.arange(T)[None] < lens[:, None]
    np.testing.assert_allclose(want[keep], got[keep], **TOL)


def test_flash_no_cache_prefill_slot_positions():
    """The no-cache right-padded prefill layout (slot_positions=True)."""
    B, T, Hq, Hk, D = 2, 40, 4, 2, 16
    q, k, v = _qkv(6, B, T, T, Hq, Hk, D)
    lens = np.asarray([40, 17])
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    want, got = _flash_both(
        q, k, v, causal=True, q_positions=pos, kv_positions=pos,
        kv_mask=mask, slot_positions=True,
    )
    keep = mask.astype(bool)
    np.testing.assert_allclose(want[keep], got[keep], **TOL)


@pytest.mark.parametrize("G", [1, 2, 7])
def test_flash_decode_single_query(G):
    """Tq=1 decode steps over the dense cache with a kv mask."""
    B, S, Hk, D = 3, 64, 2, 16
    q, k, v = _qkv(7, B, 1, S, Hk * G, Hk, D)
    pos = np.asarray([[20], [5], [40]], np.int32)
    want, got = _flash_both(
        q, k, v, causal=True, q_positions=pos,
        kv_mask=(np.arange(S)[None] <= pos).astype(np.int32),
    )
    np.testing.assert_allclose(want, got, **TOL)


@pytest.mark.parametrize("D", [12, 72])
def test_segment_attention_vit(D):
    """ViT: packed images, segment mask, pad segment 0, D not a power of
    two."""
    P, H = 96, 4
    q, k, v = _qkv(8, 1, P, P, H, H, D)
    seg = _seg_ids([30, 40, 10], 16)
    want = np.asarray(jsa.segment_attention(
        _j(q), _j(k), _j(v), _j(seg), _j(seg)
    ))
    got = tsa.segment_attention(_t(q), _t(k), _t(v), _t(seg), _t(seg)).numpy()
    keep = seg > 0
    np.testing.assert_allclose(want[keep], got[keep], **TOL)


def test_segment_attention_compressor_regions():
    """Compressor: queries vs patches with the region ids of a real pack at
    side factor 2 (non-contiguous regions, pad 0)."""
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in ((56, 70), (42, 42))]
    packed = jpack.pack_images(
        [i.astype(np.float32) for i in imgs],
        patch_size=14, base_grid=8, side_factors=2,
    )
    reg, qreg = packed.region_ids[None], packed.q_region_ids[None]
    P, Q, H, D = reg.shape[1], qreg.shape[1], 4, 12
    rng = np.random.default_rng(10)
    q = rng.standard_normal((1, Q, H, D)).astype(np.float32)
    k = rng.standard_normal((1, P, H, D)).astype(np.float32)
    v = rng.standard_normal((1, P, H, D)).astype(np.float32)
    want = np.asarray(jsa.segment_attention(
        _j(q), _j(k), _j(v), _j(qreg), _j(reg)
    ))
    got = tsa.segment_attention(_t(q), _t(k), _t(v), _t(qreg), _t(reg)).numpy()
    keep = qreg > 0
    assert keep.sum() == packed.num_queries > 0
    np.testing.assert_allclose(want[keep], got[keep], **TOL)


def test_flash_twin_matches_plain_attention():
    """The kernel's plain twin and the "xla" path compute one function."""
    q, k, v, kw = _attn_inputs("causal_positions_kv_mask")
    kw = {n: x if n == "causal" else _t(x) for n, x in kw.items()}
    a = tfa.flash_attention(_t(q), _t(k), _t(v), **kw)
    b = tattn.attention(_t(q), _t(k), _t(v), **kw)
    torch.testing.assert_close(a, b, **TOL)


def test_kernel_launch_refuses_cpu_tensors():
    q, k, v = (_t(x) for x in _qkv(11, 1, 4, 4, 2, 2, 8))
    args, flags = tfa._prepare(q, k, v, None, None, None, None, None, True,
                               None)
    with pytest.raises(ValueError, match="CUDA"):
        tfa._mha_forward(*args, **flags)
    with pytest.raises(ValueError, match="device"):
        tfa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def test_prepare_layouts():
    """The shared layout step: [B, H, T, D] views, int32 [B, T] arrays,
    defaults (arange positions, zero segments, all-valid kv)."""
    q, k, v = (_t(x) for x in _qkv(12, 2, 3, 5, 4, 2, 8))
    args, flags = tfa._prepare(
        q, k, v, None, None, None, None, torch.tensor([[1, 1, 0, 1, 0]]),
        True, None, slot_positions=False,
    )
    qt, kt, vt, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    assert qt.shape == (2, 4, 3, 8) and kt.shape == (2, 2, 5, 8)
    assert qt.data_ptr() == q.data_ptr()  # a view, no copy
    for x in (q_pos, kv_pos, q_seg, kv_seg, kv_valid):
        assert x.dtype == torch.int32 and x.is_contiguous()
    assert q_pos.tolist() == [[0, 1, 2]] * 2
    assert kv_valid.tolist() == [[1, 1, 0, 1, 0]] * 2
    assert not flags["has_segments"] and flags["kv_arange"]
    assert flags["scale"] == pytest.approx(8**-0.5)


def test_build_without_nvcc_raises(monkeypatch):
    """No silent fallback: a missing compiler is an error that says so."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(
        build, "library_path", lambda name: build.BUILD_DIR / "absent.so"
    )
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("flash_attention")


def test_library_named_after_source_hash():
    p = build.library_path("flash_attention")
    assert p.parent == build.BUILD_DIR
    assert p.name.startswith("flash_attention-") and p.suffix == ".so"
