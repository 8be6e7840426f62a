"""Packed varlen attention over one flat buffer (port of
`oryx_tpu.ops.pallas.segment_attention`): many arbitrary-resolution images
packed into one bucketed sequence, each attending only within its own
segment. Thin front-end over the flash-attention kernel with causal masking
off and segment masking on."""

from __future__ import annotations

from oryx_tpu_torch.ops.cuda.flash_attention import flash_attention


def segment_attention(q, k, v, q_segment_ids, kv_segment_ids, scale=None):
    """q/k/v: [B, T, H, D]; segment ids [B, T] (0 = padding, which only
    attends to itself; callers discard pad rows)."""
    return flash_attention(
        q, k, v,
        causal=False,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        scale=scale,
    )
