"""Ring attention: sequence parallelism over the `sp` ranks (port of
`oryx_tpu.ops.ring_attention`).

The sequence is cut into one contiguous block a rank. Each rank keeps its
query block and the key/value blocks travel around the ring
(`parallel/tp.World.shift`, the port's `lax.ppermute`), each visiting
block merged into the rank's output, so every rank ends with exact
attention over the whole sequence while holding O(T / sp) of it.

Both impls are one `torch.autograd.Function` whose backward is a second
pass around the ring: dq accumulates at home, and each block's dk/dv
travel WITH the block and arrive home after the full circle.
  * "xla": each visiting block's fp32 logits in torch ops, merged with
    the online-softmax state (m, l, acc) as JAX's xla body does; its
    backward takes each block's gradients in torch ops against the global
    logsumexp.
  * "flash": K1 with the logsumexp (`flash_fwd_lse`) on each live block,
    the block outputs folded by their logsumexp (logaddexp and two
    weights, torch ops as JAX's XLA merge is), and the backward's K5a/K5b
    (`_mha_backward`) on each live block against the GLOBAL lse and
    Delta = rowsum(dO * O). On CPU tensors the kernels' plain twins run.

Causal liveness. A visiting block whose every kv position lies past
every local q position merges nothing (JAX skips it with a `lax.cond` on
min(kv_pos) <= max(q_pos)). Here the decision is made ONCE, from the
positions before the ring starts (the trainer reads them off the host
batch: `Ring.live`), never with a device sync per ring step; the shift
runs either way, as in JAX. A contiguous causal split leaves rank i i + 1
live blocks of sp: the split is JAX's, not rebalanced.
"""

from __future__ import annotations

import dataclasses

import torch

from oryx_tpu_torch.ops.cuda import flash_attention as fa

NEG = fa.NEG
FLT_MAX = fa.FLT_MAX


@dataclasses.dataclass
class Ring:
    """This rank's ring: the world, the ranks of its sp group in ring
    order and, for a causal ring, `live[s]` for each ring step s (the
    block that visits at step s comes from the rank s places before this
    one). A ring of one rank (world None) is plain attention."""

    world: object = None
    group: tuple = (0,)
    live: tuple | None = None

    @property
    def size(self) -> int:
        return len(self.group)

    @property
    def index(self) -> int:
        return 0 if self.world is None else self.group.index(self.world.rank)

    def shift(self, tensors):
        if self.size == 1:
            return list(tensors)
        return self.world.shift(tensors, self.group)


def live_table(positions, sp: int, index: int) -> tuple[bool, ...]:
    """live[s] of rank `index` of an sp ring over [B, T] positions (any
    array with .min/.max; T divides by sp): the block of rank index - s
    holds a kv position at or before this rank's largest q position."""
    T = positions.shape[-1]
    if T % sp:
        raise ValueError(f"sequence length {T} does not divide over sp={sp}")
    Tl = T // sp
    blocks = [positions[..., j * Tl:(j + 1) * Tl] for j in range(sp)]
    qmax = blocks[index].max()
    return tuple(bool(blocks[(index - s) % sp].min() <= qmax)
                 for s in range(sp))


def _steps(ring: Ring, causal: bool):
    """(step, live) of each ring step."""
    for s in range(ring.size):
        yield s, (not causal or ring.live is None or ring.live[s])


def _xla_logits(q, k, qpos, kpos, kvalid, causal, scale):
    """[B, Tl, Hk, G, D] x [B, Tc, Hk, D] -> masked fp32 logits
    [B, Hk, G, Tl, Tc]."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    mask = (kvalid > 0)[:, None, :]
    if causal:
        mask = mask & (qpos[:, :, None] >= kpos[:, None, :])
    return torch.where(mask[:, None, None], s, NEG)


def _forward_xla(ring, q, k, v, q_pos, kv_pos, kv_valid, causal, scale):
    """JAX's xla body: the online-softmax merge of each visiting block.
    Returns (out [B, Tl, Hq, D] in q's dtype, lse [B, Hq, Tl] fp32, NEG
    on rows that saw no key)."""
    B, Tl, Hq, D = q.shape
    Hk = k.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Tl, Hk, G, D)
    acc = torch.zeros((B, Hk, G, Tl, D), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Hk, G, Tl, 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    cur = [k, v, kv_pos, kv_valid]
    for s, live in _steps(ring, causal):
        if live:
            kc, vc, kp, kvd = cur
            logits = _xla_logits(qg, kc, q_pos, kp, kvd, causal, scale)
            m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(),
                              vc.float())
            acc = acc * alpha + pv
            m = m_new
        if s < ring.size - 1:
            cur = ring.shift(cur)
    out = acc / torch.where(l == 0.0, 1.0, l)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Tl, Hq, D).to(q.dtype)
    lse = torch.where(l == 0.0, NEG, m + torch.log(torch.where(
        l == 0.0, 1.0, l)))[..., 0].reshape(B, Hq, Tl)
    return out, lse


def _forward_flash(ring, q, k, v, q_pos, kv_pos, kv_valid, causal, scale):
    """K1 with the logsumexp on each live block, folded by logaddexp
    (JAX's `_ring_flash_forward`). Returns (out in q's dtype, global lse
    [B, Hq, Tl] fp32, NEG on rows that saw no key)."""
    B, Tl, Hq, D = q.shape
    out = torch.zeros((B, Tl, Hq, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, Hq, Tl), NEG, dtype=torch.float32, device=q.device)
    cur = [k, v, kv_pos, kv_valid]
    for s, live in _steps(ring, causal):
        if live:
            kc, vc, kp, kvd = cur
            args, flags = fa._prepare(q, kc, vc, q_pos, kp, None, None,
                                      kvd, causal, scale)
            o_i, lse_i = fa.flash_fwd_lse(*args, **flags)
            # The kernel marks rows with no visible key +FLT_MAX; they
            # merge with weight 0 as NEG.
            lse_i = torch.where(lse_i > -0.5 * NEG, NEG, lse_i)
            lse_new = torch.logaddexp(lse, lse_i)
            w_old = torch.exp(lse - lse_new).transpose(1, 2)[..., None]
            w_new = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
            out = out * w_old + o_i.float() * w_new
            lse = lse_new
        if s < ring.size - 1:
            cur = ring.shift(cur)
    return out.to(q.dtype), lse


def _block_grads_xla(q, kc, vc, do, lse, delta, q_pos, kp, kvd, causal,
                     scale):
    """One block's (dq, dk, dv) in fp32 from the global lse and Delta,
    torch ops."""
    B, Tl, Hq, D = q.shape
    Hk = kc.shape[2]
    G = Hq // Hk
    qg = q.reshape(B, Tl, Hk, G, D).float()
    dog = do.reshape(B, Tl, Hk, G, D).float()
    s = _xla_logits(qg, kc, q_pos, kp, kvd, causal, scale)
    lse_b = lse.reshape(B, Hk, G, Tl)[..., None]
    p = torch.exp(s - lse_b)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, vc.float())
    ds = p * (dp - delta.reshape(B, Hk, G, Tl)[..., None]) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kc.float())
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dq.reshape(B, Tl, Hq, D), dk, dv


def _block_grads_flash(q, kc, vc, do, lse, delta, q_pos, kp, kvd, causal,
                       scale):
    """One block's (dq, dk, dv) from K5a/K5b (their twins on the CPU)
    against the global lse and Delta, in q's dtype."""
    args, flags = fa._prepare(q, kc, vc, q_pos, kp, None, None, kvd, causal,
                              scale)
    qh, kh, vh, *ints = args
    backward = (fa._mha_backward if q.device.type == "cuda"
                else fa._mha_backward_reference)
    dq, dk, dv = backward(qh, kh, vh, do.transpose(1, 2), lse, delta,
                          *ints, **flags)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


class _RingAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, ring, causal, scale,
                impl):
        fwd = _forward_flash if impl == "flash" else _forward_xla
        out, lse = fwd(ring, q, k, v, q_pos, kv_pos, kv_valid, causal, scale)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.ring, ctx.causal, ctx.scale, ctx.impl = ring, causal, scale, impl
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_pos, kv_pos, kv_valid, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        # Rows that saw no key anywhere in the ring take the kernel's
        # empty-row mark (+FLT_MAX: p underflows to 0).
        lse = torch.where(lse <= 0.5 * NEG, FLT_MAX, lse).contiguous()
        delta = torch.einsum("bqhd,bqhd->bhq", do.float(),
                             out.float()).contiguous()
        grads = (_block_grads_flash if ctx.impl == "flash"
                 else _block_grads_xla)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        cur = [k, v, kv_pos, kv_valid]
        for s, live in _steps(ring, causal):
            if live:
                kc, vc, kp, kvd = cur
                dq_i, dk_i, dv_i = grads(q, kc, vc, do, lse, delta, q_pos,
                                         kp, kvd, causal, scale)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            # The last step carries only dk/dv: home after the circle.
            if s < ring.size - 1:
                cur[0], cur[1], cur[2], cur[3], dk, dv = ring.shift(
                    cur + [dk, dv])
            else:
                dk, dv = ring.shift([dk, dv])
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None, None)


def ring_attention_shard(q, k, v, q_pos, kv_pos, kv_valid, *, ring: Ring,
                         causal: bool = False, scale: float | None = None,
                         impl: str = "xla"):
    """Per-rank body. q/k/v: this rank's blocks [B, Tl, H*, D] (GQA:
    Hq % Hk == 0); q_pos/kv_pos: absolute positions [B, Tl]; kv_valid:
    [B, Tl] int. Returns [B, Tl, Hq, D] in q's dtype: exact attention over
    the ring's whole sequence. Differentiable in q, k and v."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"ring impl {impl!r}: 'xla' or 'flash'")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    ints = [x.to(device=q.device, dtype=torch.int32).contiguous()
            for x in (q_pos, kv_pos, kv_valid)]
    return _RingAttention.apply(q, k, v, *ints, ring, causal, float(scale),
                                impl)


def ring_attention(q, k, v, *, ring: Ring, causal: bool = False,
                   positions=None, kv_mask=None, scale: float | None = None,
                   impl: str = "xla"):
    """Global entry: every rank of the ring calls it with the WHOLE q/k/v
    [B, T, H*, D] (T divisible by the ring's size); each takes its block,
    runs the ring, and the blocks' outputs are gathered back to the whole
    [B, T, Hq, D] on every rank. The causal liveness comes from
    `positions` here (one host read a call)."""
    B, T = q.shape[:2]
    n = ring.size
    if T % n:
        raise ValueError(f"sequence length {T} does not divide over sp={n}")
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=q.device).expand(B, T)
    positions = positions.to(torch.int32)
    kv_valid = (torch.ones((B, T), dtype=torch.int32, device=q.device)
                if kv_mask is None
                else kv_mask.expand(B, T).to(torch.int32))
    i, Tl = ring.index, T // n
    if causal:
        ring = dataclasses.replace(
            ring, live=live_table(positions.cpu().numpy(), n, i))
    sl = slice(i * Tl, (i + 1) * Tl)
    out = ring_attention_shard(
        q[:, sl], k[:, sl], v[:, sl], positions[:, sl], positions[:, sl],
        kv_valid[:, sl], ring=ring, causal=causal, scale=scale, impl=impl)
    if n == 1:
        return out
    return _GatherSeq.apply(out, ring)


class _GatherSeq(torch.autograd.Function):
    """The ring's blocks concatenated along T on every rank; the backward
    keeps this rank's block of the gradient (every rank holds the whole
    upstream gradient)."""

    @staticmethod
    def forward(ctx, out, ring):
        ctx.ring, ctx.Tl = ring, out.shape[1]
        return ring.world.all_gather(out, ring.group, dim=1)

    @staticmethod
    def backward(ctx, g):
        i, Tl = ctx.ring.index, ctx.Tl
        return g[:, i * Tl:(i + 1) * Tl], None
