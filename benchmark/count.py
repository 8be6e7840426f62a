"""Operations and bytes of the work the traffic needs, and the chip's peaks.

The model-FLOPs rules are those of `oryx_tpu_torch/utils/flops.py` (6 N a
trained token, 2 N a served one, plus the attention matmuls over visible
pairs; remat recompute is not work), copied here so that the yardstick
stays put. A kernel's bound is max(flops / peak, bytes / bandwidth), each
input byte read once and each output byte written once, attention counted
over the (query, key) pairs that are visible. Configurations are the
`oryx` dicts of `configs/*.json` (llm / vision / compressor sizes)."""

from __future__ import annotations

import math
from typing import Iterable

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (data sheet)
PEAK_HBM_BYTES_S = 3.35e12  # H100 SXM HBM3
BF16 = 2
F32 = 4


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


# ---- parameters ---------------------------------------------------------

def llm_layer_params(llm: dict) -> int:
    h, i, d = llm["hidden_size"], llm["intermediate_size"], llm["head_dim"]
    qo = h * llm["num_heads"] * d * 2
    kv = h * llm["num_kv_heads"] * d * 2
    bias = ((llm["num_heads"] + 2 * llm["num_kv_heads"]) * d
            if llm.get("attention_bias", True) else 0)
    return qo + kv + bias + 3 * h * i + 2 * h


def llm_params(llm: dict) -> int:
    """Decoder parameters, embeddings included."""
    tied = llm.get("tie_word_embeddings", False)
    embeds = llm["vocab_size"] * llm["hidden_size"] * (1 if tied else 2)
    return llm["num_layers"] * llm_layer_params(llm) + embeds \
        + llm["hidden_size"]


def llm_dense_params(llm: dict) -> int:
    """Parameters a token's matmuls touch: all but the embedding table
    (the head is in)."""
    return llm_params(llm) - llm["vocab_size"] * llm["hidden_size"]


def vit_params(vision: dict) -> int:
    """Matmul parameters of the tower (the patch embedding included)."""
    hv, dv = vision["hidden_size"], vision["num_heads"] * vision["head_dim"]
    per_layer = 4 * hv * dv + 2 * hv * vision["intermediate_size"]
    return vision["num_layers"] * per_layer + \
        vision["patch_size"] ** 2 * 3 * hv


# ---- attention pairs ----------------------------------------------------

def causal_pairs(length: int, start: int = 0) -> int:
    """Visible (query, key) pairs of queries at positions start..length-1
    attending causally to keys 0..position."""
    return sum_range(start + 1, length + 1)


def sum_range(lo: int, hi: int) -> int:
    """lo + (lo + 1) + ... + (hi - 1)."""
    return (hi * (hi - 1) - lo * (lo - 1)) // 2 if hi > lo else 0


# ---- served work --------------------------------------------------------

def visual_flops(cfg: dict, grids: list[tuple[int, int]],
                 side_factors: list[int]) -> float:
    """ViT + compressor forward FLOPs of one request's images: 2 N_vit a
    patch, each image's attention within itself, the compressor's
    projections, its region cross-attention and its projector."""
    v, llm = cfg["vision"], cfg["llm"]
    hv, hl = v["hidden_size"], llm["hidden_size"]
    attn_w = v["num_heads"] * v["head_dim"]
    f = 0.0
    for (h, w), s in zip(grids, side_factors):
        n = h * w
        q = math.ceil(h / s) * math.ceil(w / s)
        f += 2.0 * vit_params(v) * n
        f += 4.0 * v["num_layers"] * attn_w * n * n
        f += 2.0 * 2 * hv * hv * n + 2.0 * 2 * hv * hv * q  # k,v / q,o
        f += 4.0 * hv * n  # each patch is one region's key: s*s per query
        f += 2.0 * (hv * hl + hl * hl) * q
    return f


def prefill_flops(llm: dict, length: int) -> float:
    """Decoder forward over a prompt of `length` positions, the head once
    (the first token's logits)."""
    layers = llm["num_layers"] * llm_layer_params(llm)
    f = 2.0 * layers * length
    f += 4.0 * llm["num_layers"] * llm["num_heads"] * llm["head_dim"] \
        * causal_pairs(length)
    return f + 2.0 * llm["hidden_size"] * llm["vocab_size"]


def decode_flops(llm: dict, context: int) -> float:
    """One decode token whose query sees `context` keys (itself
    included)."""
    f = 2.0 * llm_dense_params(llm)
    return f + 4.0 * llm["num_layers"] * llm["num_heads"] \
        * llm["head_dim"] * context


# ---- training work ------------------------------------------------------

def train_step_flops(cfg: dict, micro: list[dict]) -> float:
    """Model FLOPs of one optimizer step's real work, its microbatches
    given as {"rows": each row's real length, "images": each image's
    patches, "patches", "regions"}: 6 N a decoder position and 6 N_vit a
    patch, the compressor's products, attention over visible pairs
    (forward 4, backward 8 a pair and head dim). Padding and remat's
    second forward are not work."""
    llm, v = cfg["llm"], cfg["vision"]
    hv, hl = v["hidden_size"], llm["hidden_size"]
    dec_w = llm["num_heads"] * llm["head_dim"]
    vit_w = v["num_heads"] * v["head_dim"]
    f = 0.0
    for mb in micro:
        f += 6.0 * llm_dense_params(llm) * sum(mb["rows"])
        f += 12.0 * llm["num_layers"] * dec_w * sum(
            causal_pairs(n) for n in mb["rows"])
        f += 6.0 * vit_params(v) * mb["patches"]
        f += 12.0 * v["num_layers"] * vit_w * sum(n * n for n in mb["images"])
        f += 6.0 * (2 * hv * hv * mb["patches"]
                    + (2 * hv * hv + hv * hl + hl * hl) * mb["regions"])
        f += 12.0 * hv * mb["patches"]
    return f


def train_attention_bound_s(cfg: dict, micro: list[dict]) -> float:
    """Least time of a step's K1-lse + K5 work: the decoder's causal rows,
    the tower's images, the compressor's regions (each patch a key of one
    region's query)."""
    llm, v = cfg["llm"], cfg["vision"]
    heads = cfg["compressor"]["num_heads"]
    s = 0.0
    for mb in micro:
        rows = mb["rows"]
        s += llm["num_layers"] * attention_train_bound(
            llm["num_heads"], llm["num_kv_heads"], llm["head_dim"],
            sum(rows), sum(rows), sum(causal_pairs(n) for n in rows))
        s += v["num_layers"] * attention_train_bound(
            v["num_heads"], v["num_heads"], v["head_dim"], mb["patches"],
            mb["patches"], sum(n * n for n in mb["images"]))
        s += attention_train_bound(
            heads, heads, v["hidden_size"] // heads, mb["regions"],
            mb["patches"], mb["patches"])
    return s


# ---- kernel bounds --------------------------------------------------------

def attention_fwd_bound(heads: int, kv_heads: int, head_dim: int,
                        q_rows: int, kv_rows: int, pairs: int) -> float:
    """K1's least time for one masked call: 4 flops a visible pair and
    head dim per head; q, k, v read once and o written once (bf16)."""
    flops = 4.0 * heads * head_dim * pairs
    nbytes = BF16 * head_dim * (2 * q_rows * heads + 2 * kv_rows * kv_heads)
    return bound_s(flops, nbytes)


def attention_train_bound(heads: int, kv_heads: int, head_dim: int,
                          q_rows: int, kv_rows: int, pairs: int) -> float:
    """K1-lse + K5a + K5b's least time for one attention's forward and
    backward: 4 + 10 flops a visible pair and head dim per head (QK^T, PV;
    then QK^T again, dO V^T, P^T dO, dS K, dS^T Q); bytes: the forward
    reads q, k, v and writes o and the fp32 lse, the backward reads q, k,
    v, o, dO, lse and writes dq, dk, dv."""
    flops = 14.0 * heads * head_dim * pairs
    q_b = BF16 * head_dim * q_rows * heads
    kv_b = BF16 * head_dim * kv_rows * kv_heads
    lse_b = F32 * q_rows * heads
    fwd = 2 * q_b + 2 * kv_b + lse_b
    bwd = 3 * q_b + 2 * kv_b + lse_b + F32 * q_rows * heads + q_b + 2 * kv_b
    return bound_s(flops, fwd + bwd)


def segment_pairs(q_segments: Iterable[int], kv_segments: Iterable[int]
                  ) -> int:
    """Visible pairs of a segment-masked (non-causal) call: per segment id
    > 0, its query rows times its key rows."""
    from collections import Counter

    cq, ck = Counter(q_segments), Counter(kv_segments)
    return sum(n * ck.get(s, 0) for s, n in cq.items() if s > 0)
