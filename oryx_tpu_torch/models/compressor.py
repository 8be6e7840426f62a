"""Dynamic Compressor: on-demand visual token compression (port of
`oryx_tpu.models.compressor`).

Each image's (h, w) feature grid is downsampled by a per-modality side
factor s in {1, 2, 4} (area 1x/4x/16x): every downsampled token is the
average of its s x s source region, which then cross-attends to that
region's tokens, followed by an MLP projector into the LLM embedding space.
Over the packed buffers the pooling is one segment sum over `region_ids`
and the cross-attention is segment-masked attention with query segments =
region ids.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oryx_tpu_torch.config import CompressorConfig, LLMConfig, VisionConfig
from oryx_tpu_torch.models.params import (
    default_generator,
    materialize,
    resolve_device,
)
from oryx_tpu_torch.ops.attention import attention
from oryx_tpu_torch.ops.cuda.segment_attention import segment_attention
from oryx_tpu_torch.ops.norms import LayerNorm
from oryx_tpu_torch.utils.quant import column_input, linear, row_linear

EPS = 1e-6


class Projector(nn.Module):
    def __init__(self, din: int, dout: int, **factory) -> None:
        super().__init__()
        self.fc1 = nn.Linear(din, dout, **factory)
        self.fc2 = nn.Linear(dout, dout, **factory)


class Compressor(nn.Module):
    def __init__(self, vision_cfg: VisionConfig, llm_cfg: LLMConfig,
                 **factory) -> None:
        super().__init__()
        Hv, Hl = vision_cfg.hidden_size, llm_cfg.hidden_size
        self.norm_q = LayerNorm(Hv, EPS, **factory)
        self.norm_kv = LayerNorm(Hv, EPS, **factory)
        self.q_proj = nn.Linear(Hv, Hv, **factory)
        self.k_proj = nn.Linear(Hv, Hv, **factory)
        self.v_proj = nn.Linear(Hv, Hv, **factory)
        self.o_proj = nn.Linear(Hv, Hv, **factory)
        self.projector = Projector(Hv, Hl, **factory)


def init_params(
    cfg: CompressorConfig,
    vision_cfg: VisionConfig,
    llm_cfg: LLMConfig,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Compressor:
    del cfg  # the head count is a forward-time choice
    dev = resolve_device(device)
    model = Compressor(vision_cfg, llm_cfg, device="meta", dtype=dtype)
    return materialize(model, dev, generator or default_generator(dev))


def forward(
    params: Compressor,
    cfg: CompressorConfig,
    vision_cfg: VisionConfig,
    features: torch.Tensor,
    region_ids: torch.Tensor,
    q_region_ids: torch.Tensor,
    *,
    attn_impl: str = "xla",
    shard=None,
) -> torch.Tensor:
    """Compress packed ViT features into packed LLM-space embeddings.

    features:     [P, Hv] packed ViT output (pad rows garbage, region 0).
    region_ids:   [P] int - compressor region per patch (0 = pad).
    q_region_ids: [Q] int - region served by each query slot (0 = pad).
    shard: a training rank's `parallel/zero.VisualShard`, when the three
    are the rank's rows of the buffer and of the query slots: the region
    sums are summed over its group (a region's patches may lie on several
    ranks) before the rank's queries read them, and the queries attend to
    the whole buffer's keys and values, gathered over it.

    Returns [Q, H_llm]; pad rows (q_region_ids == 0) are zeros. Queries are
    image-major, row-major within each image's downsampled grid.
    """
    P, Hv = features.shape
    Q = q_region_ids.shape[0]
    feat32 = features.float()
    valid_p = (region_ids > 0).float()[:, None]
    rid = region_ids.long()

    # Region average pooling as one segment sum (region 0 collects pads).
    # index_put_ with accumulate sums duplicates in a fixed order on CUDA
    # (sort-based), where index_add_'s atomics would make the pooled
    # values, and so the replies, vary from run to run.
    # Region ids count over the whole buffer's query slots (a shard holds
    # an equal part of them).
    R = Q if shard is None else Q * len(shard.group)
    sums = torch.zeros((R + 1, Hv), dtype=torch.float32, device=features.device)
    sums.index_put_((rid,), feat32 * valid_p, accumulate=True)
    counts = torch.zeros((R + 1,), dtype=torch.float32, device=features.device)
    counts.index_put_((rid,), valid_p[:, 0], accumulate=True)
    if shard is not None:
        both = shard.sum(torch.cat([sums, counts[:, None]], 1))
        sums, counts = both[:, :Hv], both[:, Hv]
    qr = q_region_ids.long()
    pooled = sums[qr] / torch.clamp(counts[qr], min=1.0)[:, None]
    pooled = pooled.to(features.dtype)

    # Region cross-attention: query = pooled token, keys/values = its s x s
    # source region (segment mask on region equality).
    nq = params.norm_q(pooled)
    nkv = params.norm_kv(features)
    nh, hd = cfg.num_heads, Hv // cfg.num_heads
    q = linear(nq, params.q_proj).view(1, Q, nh, hd)
    k = linear(nkv, params.k_proj).view(1, P, nh, hd)
    v = linear(nkv, params.v_proj).view(1, P, nh, hd)
    kv_region = region_ids
    if shard is not None:
        k, v = shard.gather_kv(k, v)
        kv_region = shard.region_ids
    if attn_impl == "pallas":
        o = segment_attention(q, k, v, q_region_ids[None], kv_region[None])
    elif attn_impl == "xla":
        o = attention(
            q, k, v,
            q_segment_ids=q_region_ids[None],
            kv_segment_ids=kv_region[None],
        )
    else:
        raise ValueError(
            f"attn_impl {attn_impl!r}: the port has 'xla' and 'pallas'"
        )
    x = pooled + linear(o.reshape(Q, Hv), params.o_proj)

    # MLP projector into LLM embedding space (mlp2x_gelu-equivalent). A
    # tensor-parallel shard holds fc1's columns and fc2's rows of its own.
    tp = getattr(params, "tp", None)
    x = F.gelu(linear(column_input(x, tp), params.projector.fc1),
               approximate="tanh")
    x = row_linear(x, params.projector.fc2, tp)

    valid_q = (q_region_ids > 0)[:, None]
    return torch.where(valid_q, x, 0.0).to(features.dtype)
