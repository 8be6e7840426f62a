"""Attention, plain PyTorch path (port of `oryx_tpu.ops.attention`).

Selected by `attn_impl="xla"` on any device; the hand-written CUDA kernel
(ops/cuda/flash_attention.py) is the `"pallas"` path with the same masking
model.

Conventions:
  q: [B, Tq, Hq, D]   k/v: [B, Tk, Hk, D]   with Hq % Hk == 0 (GQA).
  Logits and softmax are computed in float32 whatever the input dtype (q
  and k are upcast before the logit product); the probs are cast to the v
  dtype before probs.V.

Masking model (all optional, combined by logical AND):
  * causal        - query position i attends to key positions <= i.
  * segment ids   - token i attends to token j iff
                    q_segment_ids[b, i] == kv_segment_ids[b, j].
  * kv_mask       - explicit key validity [B, Tk].

Memory: the dense path materializes [B, Hq, Tq, Tk] fp32 logits. Above
MAX_LOGITS_ELEMS the query axis is processed in power-of-two chunks.
"""

from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min

# Cap on materialized fp32 logits elements (B * Hq * Tq_chunk * Tk).
MAX_LOGITS_ELEMS = 2**26


def _attention_dense(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    q_positions: torch.Tensor | None,
    kv_positions: torch.Tensor | None,
    q_segment_ids: torch.Tensor | None,
    kv_segment_ids: torch.Tensor | None,
    kv_mask: torch.Tensor | None,
    scale: float,
) -> torch.Tensor:
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    G = Hq // Hk

    # Grouped layout [B, Hk, G, Tq, D] x [B, Hk, 1, D, Tk]: k/v are never
    # repeated per q head.
    qg = q.float().reshape(B, Tq, Hk, G, D).permute(0, 2, 3, 1, 4)
    kg = k.float().permute(0, 2, 3, 1)[:, :, None]
    logits = torch.matmul(qg, kg) * scale  # [B, Hk, G, Tq, Tk] fp32

    mask = None  # [B, Tq, Tk] broadcastable
    if causal:
        mask = q_positions[:, :, None] >= kv_positions[:, None, :]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]
        mask = seg if mask is None else mask & seg
    if kv_mask is not None:
        valid = kv_mask[:, None, :].bool()
        mask = valid if mask is None else mask & valid
    if mask is not None:
        logits = torch.where(mask[:, None, None], logits, NEG_INF)

    # Rows that are fully masked give uniform probs over the masked slots;
    # their outputs are discarded by every caller.
    probs = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = probs / torch.sum(probs, dim=-1, keepdim=True)
    probs = probs.to(v.dtype)

    vg = v.permute(0, 2, 1, 3)[:, :, None]  # [B, Hk, 1, Tk, D]
    out = torch.matmul(probs, vg)  # [B, Hk, G, Tq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, Hq, D).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_positions: torch.Tensor | None = None,
    kv_positions: torch.Tensor | None = None,
    q_segment_ids: torch.Tensor | None = None,
    kv_segment_ids: torch.Tensor | None = None,
    kv_mask: torch.Tensor | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """General GQA attention. Returns [B, Tq, Hq, D] in q.dtype.

    For causal masking with a KV cache, pass `q_positions`/`kv_positions`
    (absolute token positions, int [B, T*]); without them, positions
    default to arange (pure prefill).
    """
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    if Hq % Hk:
        raise ValueError(f"GQA requires Hq % Hk == 0, got {Hq=} {Hk=}")
    if scale is None:
        scale = D**-0.5
    if causal:
        if q_positions is None:
            q_positions = torch.arange(Tq, device=q.device)[None, :]
        if kv_positions is None:
            kv_positions = torch.arange(Tk, device=q.device)[None, :]

    kwargs = dict(
        causal=causal, kv_positions=kv_positions,
        kv_segment_ids=kv_segment_ids, kv_mask=kv_mask, scale=scale,
    )

    # Largest power-of-two query chunk that keeps the logits buffer under
    # MAX_LOGITS_ELEMS and divides Tq; chunk >= Tq means one dense call.
    chunk = max(1, MAX_LOGITS_ELEMS // max(1, B * Hq * Tk))
    chunk = 2 ** int(math.floor(math.log2(chunk)))
    while Tq % chunk:
        chunk //= 2
    if chunk >= Tq:
        return _attention_dense(
            q, k, v, q_positions=q_positions,
            q_segment_ids=q_segment_ids, **kwargs,
        )

    def cut(x, lo):
        if x is None:
            return None
        return x[:, lo : lo + chunk] if x.shape[1] == Tq else x

    return torch.cat(
        [
            _attention_dense(
                q[:, lo : lo + chunk], k, v,
                q_positions=cut(q_positions, lo),
                q_segment_ids=cut(q_segment_ids, lo), **kwargs,
            )
            for lo in range(0, Tq, chunk)
        ],
        dim=1,
    )
