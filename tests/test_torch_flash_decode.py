"""K1's split-KV decode route and the bf16 kernels' padding step, on the CPU.

* `_decode_splits` cuts a row's kv tiles into contiguous ranges that cover
  every tile, and every tile the causal clip leaves, exactly once.
* A plain PyTorch model of the decode kernel's split-and-merge (the plain
  twin run on each split's kv range, the partials merged in split order,
  an empty partial for a range with no visible key) equals the JAX
  `flash_attention` in Pallas interpret mode at Tq = 1, as
  tests/test_torch_ops.py::test_flash_decode_single_query runs it.
* `_tma_operand` copies a head dim of 12 packed in one projection (a layout
  TMA cannot read) into zero-padded rows; the backward twin fed those
  operands equals `jax.grad` of the Pallas kernel in interpret mode.

The same numpy inputs from a seed go to both packages. Tolerance (fp32):
atol 2e-4, rtol 2e-3 (tests/test_qwen2.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from oryx_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def full_precision():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = prev


# ---- _decode_splits ----------------------------------------------------------


def _ranges(splits, tps, nk, lim=None):
    """Split s's kv tiles [t0, t1), clipped at `lim` as the kernel does."""
    lim = nk if lim is None else lim
    return [(s * tps, min(s * tps + tps, lim)) for s in range(splits)]


@pytest.mark.parametrize("B,groups,Tk,sms", [
    (4, 4, 4096, 132),   # the chat_batch decode step on an H100
    (1, 1, 64, 132),     # one tile
    (1, 2, 65, 132),     # a ragged last tile
    (2, 8, 32768, 132),  # a long cache: several tiles a split
    (64, 8, 4096, 132),  # many rows: the card is full without splitting
    (3, 2, 1000, 7),     # a small card
])
def test_decode_splits_cover_every_tile_once(B, groups, Tk, sms):
    splits, tps = tfa._decode_splits(B, groups, Tk, sms)
    nk = -(-Tk // 64)
    assert 1 <= splits <= nk and tps >= 1 and splits * tps >= nk
    assert (splits - 1) * tps < nk  # no split starts past the last tile
    for lim in sorted({0, 1, nk // 2, nk - 1, nk}):
        seen = [t for t0, t1 in _ranges(splits, tps, nk, lim)
                for t in range(t0, t1)]
        assert seen == list(range(lim))
    # Enough blocks to fill the card whenever the row has the tiles.
    want = tfa.DECODE_BLOCKS_PER_SM * sms
    assert B * groups * splits >= min(want, B * groups * nk) or tps > 1


# ---- the split-and-merge model against the Pallas kernel --------------------


def split_merge_model(q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid, *,
                      causal, has_segments, kv_arange, scale, splits, tps):
    """The decode kernel's arithmetic in plain PyTorch, for q [B, Hq, 1, D]:
    each split's kv range (clipped at the causal end with arange kv
    positions) through the plain twin, giving its partial (o_s, lse_s), or
    an empty partial when no key of the range is visible; then the
    partials merged in split order, o = sum o_s e^(lse_s - M) / sum
    e^(lse_s - M) (the kernel's sum acc_s e^(m_s - m) / sum l_s e^(m_s -
    m)). Returns (o, lse), lse FLT_MAX where nothing is visible."""
    B, Hq, _, D = q.shape
    o = torch.zeros_like(q)
    lse = torch.full((B, Hq, 1), tfa.FLT_MAX)
    nk = -(-k.shape[2] // 64)
    flags = dict(causal=causal, has_segments=has_segments,
                 kv_arange=kv_arange, scale=scale)
    for b in range(B):
        lim = nk
        if causal and kv_arange:
            lim = 0 if q_pos[b, 0] < 0 else min(nk, int(q_pos[b, 0]) // 64 + 1)
        parts = []
        for t0, t1 in _ranges(splits, tps, nk, lim):
            if t0 >= t1:
                continue
            sl = slice(64 * t0, 64 * t1)
            ints = (q_pos[b:b + 1], kv_pos[b:b + 1, sl], q_seg[b:b + 1],
                    kv_seg[b:b + 1, sl], kv_valid[b:b + 1, sl])
            if not tfa._mask(0, *ints, causal, has_segments).any():
                continue  # an empty partial: m = NEG, l = 0
            parts.append(tfa._mha_forward_reference(
                q[b:b + 1], k[b:b + 1, :, sl], v[b:b + 1, :, sl], *ints,
                **flags, with_lse=True))
        if not parts:
            continue
        ls = torch.stack([p[1] for p in parts])  # [S, 1, Hq, 1]
        M = ls.max(0).values
        w = torch.exp(ls - M)
        o[b:b + 1] = sum(wi[..., None] * p[0] for wi, p in zip(w, parts)) / (
            w.sum(0)[..., None])
        lse[b:b + 1] = M + torch.log(w.sum(0))
    return o, lse


@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("D", [16, 128])
def test_split_merge_model_matches_pallas(G, D):
    """Rows whose visible keys cross split boundaries, a split whose range
    holds no visible key (a hole in the kv mask of row 2), splits past the
    causal end; one tile a split, as at the chat_batch decode step."""
    B, S, Hk = 3, 256, 2
    rng = np.random.default_rng(20 + G + D)
    q = rng.standard_normal((B, 1, Hk * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    pos = np.asarray([[200], [70], [130]], np.int32)
    kv_mask = (np.arange(S)[None] <= pos).astype(np.int32)
    kv_mask[2, 64:128] = 0
    want = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_positions=jnp.asarray(pos), kv_mask=jnp.asarray(kv_mask)))
    _, jlse = jfa._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        None, None, None, jnp.asarray(kv_mask), True, None, with_lse=True)
    args, flags = tfa._prepare(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(pos),
        None, None, None, torch.from_numpy(kv_mask), True, None)
    splits, tps = tfa._decode_splits(B, Hk, S, sm_count=132)
    assert (splits, tps) == (4, 1)
    o, lse = split_merge_model(*args, **flags, splits=splits, tps=tps)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), want, **TOL)
    np.testing.assert_allclose(lse.numpy()[..., 0],
                               np.asarray(jlse)[:, :, 0], **TOL)
    # The model is the twin's function: the merge changes no value.
    whole = tfa._mha_forward_reference(*args, **flags)
    np.testing.assert_allclose(o.numpy(), whole.numpy(), **TOL)


def test_split_merge_model_row_without_visible_key():
    """A row that sees no key gets zeros and lse FLT_MAX from the merge (the
    kernel's empty partials); the other rows are unaffected."""
    B, S, Hk, G, D = 2, 192, 1, 4, 16
    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, 1, Hk * G, D), (B, S, Hk, D), (B, S, Hk, D)))
    pos = torch.tensor([[150], [100]])
    kv_mask = (torch.arange(S)[None] <= pos).int()
    kv_mask[1] = 0
    args, flags = tfa._prepare(q, k, v, pos, None, None, None, kv_mask, True,
                               None)
    o, lse = split_merge_model(*args, **flags, splits=3, tps=1)
    assert torch.equal(o[1], torch.zeros_like(o[1]))
    assert (lse[1] == tfa.FLT_MAX).all()
    whole = tfa._mha_forward_reference(*args, **flags)
    torch.testing.assert_close(o[0], whole[0], **TOL)


# ---- the padding step of the bf16 kernels -------------------------------------


def _packed_views(x, H, D):
    """[B, T, 3 H D] -> three [B, T, H, D] views of one projection, as the
    ViT's q/k/v are: the head stride is D elements (24 bytes at D = 12)."""
    B, T, _ = x.shape
    return tuple(x[..., i * H * D:(i + 1) * H * D].reshape(B, T, H, D)
                 for i in range(3))


def test_tma_operand_pads_what_tma_cannot_read():
    x = torch.randn(2, 5, 3 * 4 * 12)
    q, _, _ = _packed_views(x, 4, 12)
    qh = q.transpose(1, 2)  # [B, H, T, D]
    assert not tfa._tma_ok(qh)
    p = tfa._tma_operand(qh)
    assert p.shape == qh.shape and torch.equal(p, qh)
    assert tfa._tma_ok(p) and p.stride(-1) == 1 and p.stride(1) == 16
    store = torch.as_strided(p, (2, 4, 5, 16), p.stride())
    assert torch.equal(store[..., 12:], torch.zeros(2, 4, 5, 4))
    # An operand TMA can read goes through as it is.
    assert tfa._tma_operand(store) is store
    # A shifted base is copied, at its own width.
    flat = torch.zeros(1 + 2 * 4 * 5 * 16, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 4, 5, 16)
    assert not tfa._tma_ok(shifted)
    assert tfa._tma_ok(tfa._tma_operand(shifted))


@pytest.mark.parametrize("wide", [False, True], ids=["D", "Dp"])
def test_padded_backward_matches_jax_grad(wide):
    """D = 12 q/k/v packed in one projection, through `_tma_operand` and the
    plain twins: forward and gradients equal jax.grad of the Pallas kernel
    in interpret mode. With `wide` the twins see the padded storage's 16
    columns (what a kernel reads), with the scale of the real D, and the
    outputs are cut back to 12: the zero columns change nothing."""
    B, T, H, D = 2, 70, 4, 12
    rng = np.random.default_rng(40)
    x = rng.standard_normal((B, T, 3 * H * D)).astype(np.float32)
    g = rng.standard_normal((B, T, H, D)).astype(np.float32)
    seg = np.zeros((B, T), np.int32)
    seg[0, :30], seg[0, 30:62] = 1, 2
    seg[1, :70] = 3
    live = seg > 0
    g *= live[:, :, None, None]
    jq, jk, jv = (jnp.asarray(a) for a in _packed_views(x, H, D))
    jkw = dict(causal=False, q_segment_ids=jnp.asarray(seg),
               kv_segment_ids=jnp.asarray(seg))

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, **jkw) * g)

    jo = np.asarray(jfa.flash_attention(jq, jk, jv, **jkw))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = _packed_views(torch.from_numpy(x), H, D)
    s = torch.from_numpy(seg)
    args, flags = tfa._prepare(tq, tk, tv, None, None, s, s, None, False,
                               None)
    assert flags["scale"] == D**-0.5
    qkv = [tfa._tma_operand(a) for a in args[:3]]
    assert not any(tfa._tma_ok(a) for a in args[:3])
    assert all(tfa._tma_ok(a) and a.stride(1) == 16 for a in qkv)
    if wide:
        qkv = [torch.as_strided(a, a.shape[:3] + (16,), a.stride())
               for a in qkv]
    o, lse = tfa._mha_forward_reference(*qkv, *args[3:], **flags,
                                        with_lse=True)
    do = torch.from_numpy(g).transpose(1, 2)
    if wide:
        do = torch.nn.functional.pad(do, (0, 4))
    delta = (do * o).sum(-1)
    grads = tfa._mha_backward_reference(*qkv, do, lse, delta, *args[3:],
                                        **flags)
    o = o[..., :D].transpose(1, 2).numpy()
    np.testing.assert_allclose(o[live], jo[live], **TOL)
    for name, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a[..., :D].transpose(1, 2).numpy(),
                                   np.asarray(b), **TOL,
                                   err_msg=f"d{name}")
