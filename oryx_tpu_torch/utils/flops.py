"""Analytic model-FLOPs accounting (port of `oryx_tpu.utils.flops`, with
`batch_flops` of `oryx_tpu.train.telemetry`).

"Model FLOPs" are the standard 6 N FLOPs per token (forward 2 N, backward
4 N of matmul work) for the decoder and the ViT, plus the attention
matmuls (QK^T and PV, forward 2 + 2 flops an element, backward twice
that). Remat recompute is not counted: it is overhead, not useful work,
and counting it would let a worse remat policy inflate MFU. LoRA adds no
term, as in JAX: the adapters' products are counted in neither package.
"""

from __future__ import annotations

from typing import Any

import numpy as np

# Peak dense bf16 FLOP/s per card kind (public spec sheets), matched as a
# substring of the lowercased device name, the more specific tag first.
PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),  # H100 SXM
)


def chip_peak_flops(device_kind: str) -> float | None:
    """Peak dense bf16 FLOP/s for a device name
    (`torch.cuda.get_device_name`), None when unknown (the CPU): callers
    then skip MFU rather than fake it."""
    kl = (device_kind or "").lower()
    for tag, f in PEAK_FLOPS:
        if tag in kl:
            return f
    return None


def count_llm_params(c) -> int:
    """Parameter count of an LLMConfig-shaped decoder (embeddings
    included)."""
    h, i, v, d = c.hidden_size, c.intermediate_size, c.vocab_size, c.head_dim
    qo = h * c.num_heads * d * 2
    kv = h * c.num_kv_heads * d * 2
    bias = (c.num_heads + 2 * c.num_kv_heads) * d if c.attention_bias else 0
    mlp = 3 * h * i
    per_layer = qo + kv + bias + mlp + 2 * h
    embeds = v * h * (1 if c.tie_word_embeddings else 2)
    return c.num_layers * per_layer + embeds + h


def train_step_flops(
    cfg,
    n_llm_params: int,
    *,
    batch: int,
    seq_len: int,
    patch_tokens: int,
) -> float:
    """Model FLOPs for one SFT step over a [batch, seq_len] token batch
    with `patch_tokens` packed visual patches through the vision tower:
    6 N_dense a token for the decoder (the embedding gather excluded,
    lm_head included), 6 N_vit a patch for the tower, plus the quadratic
    attention matmuls of both."""
    lc, vc = cfg.llm, cfg.vision
    tok = float(batch * seq_len)
    n_dense = n_llm_params - lc.vocab_size * lc.hidden_size
    f = 6.0 * n_dense * tok
    # Decoder attention: per layer forward 4 T^2 heads d (QK + PV), x3 with
    # the backward.
    f += 12.0 * lc.num_layers * batch * seq_len * seq_len \
        * lc.num_heads * lc.head_dim
    P = float(patch_tokens)
    n_vit = vc.num_layers * (
        4 * vc.hidden_size * vc.num_heads * vc.head_dim
        + 2 * vc.hidden_size * vc.intermediate_size
    ) + (vc.patch_size**2 * 3) * vc.hidden_size
    f += 6.0 * n_vit * P
    f += 12.0 * vc.num_layers * P * P * vc.num_heads * vc.head_dim
    return f


def batch_flops(cfg, host_batch: dict[str, Any]) -> float:
    """Model FLOPs for one step over a host batch, at its padded shapes
    (the device computes the padding too). A 3-D token_ids is [accum, B, T]
    (data.collate_microbatches): each microbatch runs its own vision tower
    over its own packed buffer, so the per-microbatch FLOPs multiply by
    accum."""
    tok = np.asarray(host_batch["token_ids"]).shape
    if len(tok) >= 3:
        accum, batch, seq = int(tok[0]), int(np.prod(tok[1:-1])), int(tok[-1])
    else:
        accum, batch, seq = 1, int(np.prod(tok[:-1]) or 1), int(tok[-1])
    seg = host_batch.get("segment_ids")
    patch_tokens = int(np.asarray(seg).shape[-1]) if seg is not None else 0
    return accum * train_step_flops(
        cfg, count_llm_params(cfg.llm),
        batch=batch, seq_len=seq, patch_tokens=patch_tokens,
    )
