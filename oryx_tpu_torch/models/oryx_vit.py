"""OryxViT: SigLIP-derived vision transformer at arbitrary resolution (port
of `oryx_tpu.models.oryx_vit`).

Many images are packed into one bucketed patch buffer (ops/packing.py) and
attention masks on segment-id equality. Per block: pre-LN -> MHA (biased
projections) -> residual; pre-LN -> MLP (gelu tanh) -> residual; final
post-LN. The learned position embedding lives at base_grid^2 and is
bilinearly resampled per patch from continuous coordinates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oryx_tpu_torch.config import VisionConfig
from oryx_tpu_torch.models.params import (
    default_generator,
    materialize,
    resolve_device,
)
from oryx_tpu_torch.ops.attention import attention
from oryx_tpu_torch.ops.cuda.segment_attention import segment_attention
from oryx_tpu_torch.ops.norms import LayerNorm
from oryx_tpu_torch.utils.quant import (
    column_input,
    linear,
    linear_group,
    row_linear,
)
from oryx_tpu_torch.parallel.zero import gathered
from oryx_tpu_torch.utils.remat import checkpointed


class VisionLayer(nn.Module):
    def __init__(self, cfg: VisionConfig, **factory) -> None:
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        D = cfg.num_heads * cfg.head_dim
        eps = cfg.layer_norm_eps
        self.norm1 = LayerNorm(H, eps, **factory)
        self.norm2 = LayerNorm(H, eps, **factory)
        self.q_proj = nn.Linear(H, D, **factory)
        self.k_proj = nn.Linear(H, D, **factory)
        self.v_proj = nn.Linear(H, D, **factory)
        self.o_proj = nn.Linear(D, H, **factory)
        self.fc1 = nn.Linear(H, I, **factory)
        self.fc2 = nn.Linear(I, H, **factory)


class OryxViT(nn.Module):
    def __init__(self, cfg: VisionConfig, **factory) -> None:
        super().__init__()
        H = cfg.hidden_size
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.num_channels
        self.patch_embed = nn.Linear(patch_dim, H, **factory)
        self.pos_embed = nn.Embedding(cfg.base_grid * cfg.base_grid, H,
                                      **factory)
        self.layers = nn.ModuleList(
            VisionLayer(cfg, **factory) for _ in range(cfg.num_layers)
        )
        self.post_norm = LayerNorm(H, cfg.layer_norm_eps, **factory)


def init_params(
    cfg: VisionConfig,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> OryxViT:
    dev = resolve_device(device)
    model = OryxViT(cfg, device="meta", dtype=dtype)
    return materialize(model, dev, generator or default_generator(dev))


def interp_pos_embed(
    table: torch.Tensor, coords: torch.Tensor, base_grid: int
) -> torch.Tensor:
    """Bilinearly sample the posemb table [G*G, H] at continuous
    coordinates [P, 2] (sy, sx; align_corners=False, edge clamped).
    Returns [P, H] float32."""
    G = base_grid
    grid = table.reshape(G, G, -1).float()
    sy, sx = coords[:, 0], coords[:, 1]
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    ly, lx = (sy - y0f)[:, None], (sx - x0f)[:, None]
    y0 = torch.clamp(y0f.long(), 0, G - 1)
    y1 = torch.clamp(y0f.long() + 1, 0, G - 1)
    x0 = torch.clamp(x0f.long(), 0, G - 1)
    x1 = torch.clamp(x0f.long() + 1, 0, G - 1)
    return (
        grid[y0, x0] * (1 - ly) * (1 - lx)
        + grid[y0, x1] * (1 - ly) * lx
        + grid[y1, x0] * ly * (1 - lx)
        + grid[y1, x1] * ly * lx
    )


def forward(
    params: OryxViT,
    cfg: VisionConfig,
    patches: torch.Tensor,
    segment_ids: torch.Tensor,
    pos_coords: torch.Tensor,
    *,
    remat: bool | str = False,
    attn_impl: str = "xla",
    compute_dtype: torch.dtype | None = None,
    shard=None,
) -> torch.Tensor:
    """Encode a packed patch buffer.

    patches: [P, patch_dim]; segment_ids: [P] (0 = pad); pos_coords: [P, 2].
    remat: the per-layer remat policy (utils/remat.py) of the training
    forward. shard: a training rank's `parallel/zero.VisualShard`, when the
    three arrays are the rank's rows of the buffer: each layer's keys and
    values are gathered over its group, and the rank's query rows attend
    to the whole buffer's.
    Returns features [P, hidden] in the compute dtype (pad rows are garbage;
    consumers mask on segment_ids).
    """
    # The patch embedding runs in fp32.
    emb = linear(patches.float(), params.patch_embed)
    emb = emb + interp_pos_embed(
        params.pos_embed.weight, pos_coords, cfg.base_grid
    )
    emb = emb.to(compute_dtype if compute_dtype is not None else patches.dtype)

    h = emb[None]  # [1, P, H]: the packed buffer is the batch
    seg = segment_ids[None]
    kv_seg = seg if shard is None else shard.segment_ids[None]
    if attn_impl == "pallas":
        def attend(q, k, v):
            return segment_attention(q, k, v, seg, kv_seg)
    elif attn_impl == "xla":
        def attend(q, k, v):
            return attention(q, k, v, q_segment_ids=seg,
                             kv_segment_ids=kv_seg)
    else:
        raise ValueError(
            f"attn_impl {attn_impl!r}: the port has 'xla' and 'pallas'"
        )

    def attn_fn(q, k, v):
        if shard is not None:
            k, v = shard.gather_kv(k, v)
        return attend(q, k, v)

    # A tensor-parallel shard holds its own heads and fc1 columns; its
    # o_proj and fc2 partial products are summed over the ranks.
    tp = getattr(params, "tp", None)

    def layer(h, lp):
        B, P, _ = h.shape
        x = column_input(lp.norm1(h), tp)
        q, k, v = (t.view(B, P, -1, cfg.head_dim)
                   for t in linear_group(x, (lp.q_proj, lp.k_proj,
                                             lp.v_proj)))
        o = attn_fn(q, k, v).reshape(B, P, -1)
        h = h + row_linear(o, lp.o_proj, tp)
        x = column_input(lp.norm2(h), tp)
        x = F.gelu(linear(x, lp.fc1), approximate="tanh")
        return h + row_linear(x, lp.fc2, tp)

    for lp in params.layers:
        h = checkpointed(remat, gathered(layer, lp), h, lp)

    return params.post_norm(h)[0]
