"""The port's flash-attention gradients (K5a/K5b's plain twins, through
`flash_attention` and autograd on CPU tensors) and K1's logsumexp against
`jax.grad` of the Pallas kernel in interpret mode, at the layouts of
tests/test_pallas_attention.py: causal multi-tile GQA with a padding mask,
padded prefill with slot_positions, segments shaped as the ViT (packed
images, pads attending pads) and as the compressor (pooled queries against
their regions), and the kv-mask decode layout.

The same numpy inputs from a seed go to both packages. The cotangent is
random and zero on pad rows (whose outputs callers discard), as the model's
cotangents are. Tolerance (fp32): atol 2e-4, rtol 2e-3 (tests/test_qwen2.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.ops.pallas import flash_attention as jfa  # noqa: E402
from oryx_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from oryx_tpu_torch.ops.cuda.segment_attention import (  # noqa: E402
    segment_attention,
)

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(autouse=True)
def small_tiles(monkeypatch):
    """Pallas tiles of 64 (the backward inherits them), so every case runs
    several q and kv tiles; full-precision JAX matmuls."""
    monkeypatch.setattr(jfa, "BLOCK_Q", 64)
    monkeypatch.setattr(jfa, "BLOCK_K", 64)
    monkeypatch.setattr(jfa, "BWD_BLOCK_Q", None)
    monkeypatch.setattr(jfa, "BWD_BLOCK_K", None)
    with jax.default_matmul_precision("highest"):
        yield


def _inputs(seed, B, Tq, Tk, Hq, Hk, D, live_q):
    """q, k, v, and a cotangent zero where live_q [B, Tq] is False."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, Hq, D), np.float32)
    k = rng.standard_normal((B, Tk, Hk, D), np.float32)
    v = rng.standard_normal((B, Tk, Hk, D), np.float32)
    g = rng.standard_normal((B, Tq, Hq, D), np.float32)
    g *= np.asarray(live_q, np.float32)[:, :, None, None]
    return q, k, v, g


def _check(q, k, v, g, live_q, **kw):
    """Outputs (live rows), lse (live rows) and dq/dk/dv of both packages;
    kw are flash_attention's keyword arguments (numpy int arrays)."""
    jkw = {x: (jnp.asarray(y) if isinstance(y, np.ndarray) else y)
           for x, y in kw.items()}
    tkw = {x: (torch.from_numpy(y) if isinstance(y, np.ndarray) else y)
           for x, y in kw.items()}

    def jloss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention(q_, k_, v_, **jkw) * g)

    jo = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), **jkw)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v))
    )
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, **tkw)
    tgrads = torch.autograd.grad((to * torch.from_numpy(g)).sum(),
                                 (tq, tk, tv))
    live = np.asarray(live_q, bool)
    np.testing.assert_allclose(to.detach().numpy()[live],
                               np.asarray(jo)[live], **TOL)
    for name, a, b in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=f"d{name}")

    # K1's logsumexp on the live rows, against the Pallas forward's.
    scale = kw.get("scale")
    causal = kw.get("causal", True)
    _, jlse = jfa._flash_attention_impl(
        *map(jnp.asarray, (q, k, v)), jkw.get("q_positions"),
        jkw.get("kv_positions"), jkw.get("q_segment_ids"),
        jkw.get("kv_segment_ids"), jkw.get("kv_mask"), causal,
        scale, with_lse=True, slot_positions=kw.get("slot_positions", False),
    )
    args, flags = tfa._prepare(
        *(torch.from_numpy(x) for x in (q, k, v)), tkw.get("q_positions"),
        tkw.get("kv_positions"), tkw.get("q_segment_ids"),
        tkw.get("kv_segment_ids"), tkw.get("kv_mask"), causal, scale,
        kw.get("slot_positions", False),
    )
    _, tlse = tfa._mha_forward_reference(*args, **flags, with_lse=True)
    jl = np.asarray(jlse)[:, :, : q.shape[1]].transpose(0, 2, 1)
    tl = tlse.numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(tl[live], jl[live], **TOL)


def test_causal_multitile_gqa_padding_mask():
    B, T = 2, 160
    lengths = np.array([160, 90])
    live = np.arange(T)[None] < lengths[:, None]
    q, k, v, g = _inputs(0, B, T, T, 4, 2, 16, live)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    _check(q, k, v, g, live, causal=True, q_positions=pos, kv_positions=pos,
           kv_mask=live.astype(np.int32))


def test_padded_prefill_slot_positions():
    """The decoder's training layout: per-row arange on real slots, 0 on
    pads, slot_positions (the causal tile skips) and a kv mask."""
    B, T = 2, 150
    lengths = np.array([150, 70])
    live = np.arange(T)[None] < lengths[:, None]
    q, k, v, g = _inputs(1, B, T, T, 4, 2, 16, live)
    pos = np.where(live, np.arange(T)[None], 0).astype(np.int32)
    _check(q, k, v, g, live, causal=True, q_positions=pos, kv_positions=pos,
           kv_mask=live.astype(np.int32), slot_positions=True)


@pytest.mark.parametrize("pad", [True, False])
def test_segments_vit_layout(pad):
    """Packed images, non-causal, segment ids 1..3 (0 = pad rows, which
    attend each other). With pad=False the buffer is full."""
    P = 140
    seg = np.zeros(P, np.int32)
    seg[:50], seg[50:110] = 1, 2
    seg[110:130 if pad else P] = 3
    live = (seg > 0)[None]
    q, k, v, g = _inputs(2, 1, P, P, 4, 4, 12, live)
    _check(q, k, v, g, live, causal=False, q_segment_ids=seg[None],
           kv_segment_ids=seg[None])


def test_segments_compressor_layout():
    """Pooled queries (q segment = region id, 0 = pad query) against the
    patches of their regions (kv segment = region id, 0 = pad patch)."""
    Q, P = 70, 150
    regions = np.zeros(P, np.int32)
    regions[:144] = np.repeat(np.arange(1, 37), 4)
    qreg = np.zeros(Q, np.int32)
    qreg[:36] = np.arange(1, 37)
    live = (qreg > 0)[None]
    q, k, v, g = _inputs(3, 1, Q, P, 4, 4, 12, live)
    _check(q, k, v, g, live, causal=False, q_segment_ids=qreg[None],
           kv_segment_ids=regions[None])


def test_kv_mask_decode_layout():
    """q at arbitrary positions late in a longer arange kv stream, with
    kv validity (the dense cache layout) across several kv tiles."""
    B, S = 2, 200
    cur = np.array([150, 61])
    qpos = (cur[:, None] + np.arange(8)[None]).astype(np.int32)
    kv_mask = (np.arange(S)[None] < cur[:, None] + 8).astype(np.int32)
    live = np.ones((B, 8), bool)
    q, k, v, g = _inputs(4, B, 8, S, 4, 2, 16, live)
    _check(q, k, v, g, live, causal=True, q_positions=qpos, kv_mask=kv_mask)


def test_segment_attention_front_end_gradients():
    """segment_attention (causal off, segments on) differentiates through
    the same op as flash_attention."""
    P = 64
    seg = np.repeat(np.array([1, 2, 0, 3], np.int32), 16)
    live = (seg > 0)[None]
    q, k, v, g = _inputs(5, 1, P, P, 4, 4, 12, live)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ts = torch.from_numpy(seg)[None]
    a = torch.autograd.grad(
        (segment_attention(tq, tk, tv, ts, ts) * torch.from_numpy(g)).sum(),
        (tq, tk, tv),
    )
    b = torch.autograd.grad(
        (tfa.flash_attention(tq, tk, tv, causal=False, q_segment_ids=ts,
                             kv_segment_ids=ts)
         * torch.from_numpy(g)).sum(),
        (tq, tk, tv),
    )
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_backward_twin_rounds_like_pallas():
    """The plain backward in bf16 rounds p to dO's dtype and ds to k's/q's
    before the products, as `_dq_kernel`/`_dkv_kernel` do: against the same
    arithmetic written out in fp32 with explicit casts."""
    rng = np.random.default_rng(6)
    B, T, Hq, Hk, D = 1, 40, 4, 2, 16
    qf, kf, vf, dof = (
        torch.from_numpy(rng.standard_normal(s, np.float32))
        for s in ((B, Hq, T, D), (B, Hk, T, D), (B, Hk, T, D), (B, Hq, T, D))
    )
    q, k, v, do = (x.to(torch.bfloat16) for x in (qf, kf, vf, dof))
    pos = torch.arange(T, dtype=torch.int32)[None]
    ints = (pos, pos, torch.zeros_like(pos), torch.zeros_like(pos),
            torch.ones_like(pos))
    flags = dict(causal=True, has_segments=False, kv_arange=True,
                 scale=D**-0.5)
    o, lse = tfa._mha_forward_reference(q, k, v, *ints, **flags,
                                        with_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = tfa._mha_backward_reference(q, k, v, do, lse, delta, *ints,
                                             **flags)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    G = Hq // Hk
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool))
    s = torch.where(mask, q.float() @ k.float().repeat_interleave(G, 1)
                    .transpose(-1, -2) * flags["scale"], tfa.NEG)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ v.float().repeat_interleave(G, 1).transpose(-1, -2)
    ds = p * (dp - delta[..., None]) * flags["scale"]
    want_dq = (ds.bfloat16().float()
               @ k.float().repeat_interleave(G, 1)).bfloat16()
    want_dv = (p.bfloat16().float().transpose(-1, -2) @ do.float())
    want_dk = (ds.bfloat16().float().transpose(-1, -2) @ q.float())
    want_dv = want_dv.reshape(B, Hk, G, T, D).sum(2).bfloat16()
    want_dk = want_dk.reshape(B, Hk, G, T, D).sum(2).bfloat16()
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
