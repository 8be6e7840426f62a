"""Qwen2/Yi-class causal decoder (port of `oryx_tpu.models.qwen2`).

Parameters live in `nn.Module`s (`Qwen2`, one `DecoderLayer` per layer,
linear weights in PyTorch's [out, in] layout); `forward` is a plain function
over them with the JAX function's arguments. Attention paths ported: no
cache (right-padded prefill), the dense KV cache ([L, B, S, Hk, D]), and the
paged pool ([L, P, page_size, Hk, D] addressed through block tables, in
per-row and packed ragged form). Caches are updated IN PLACE where the JAX
package returns a new cache. Without a cache the forward is the training
forward too: differentiable in every parameter, each layer under the remat
policy of utils/remat.py. Quantized pools, ring attention, LoRA and
packed-training segment ids belong to later slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from oryx_tpu_torch.config import LLMConfig
from oryx_tpu_torch.models.params import (
    default_generator,
    materialize,
    resolve_device,
)
from oryx_tpu_torch.ops import paged_kv
from oryx_tpu_torch.ops.attention import attention
from oryx_tpu_torch.ops.cuda import paged_attention
from oryx_tpu_torch.ops.cuda.flash_attention import flash_attention
from oryx_tpu_torch.ops.norms import RMSNorm
from oryx_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from oryx_tpu_torch.utils.remat import checkpointed


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, **factory) -> None:
        super().__init__()
        H, I = cfg.hidden_size, cfg.intermediate_size
        Dq = cfg.num_heads * cfg.head_dim
        Dkv = cfg.num_kv_heads * cfg.head_dim
        bias = cfg.attention_bias
        self.input_norm = RMSNorm(H, cfg.rms_norm_eps, **factory)
        self.post_attn_norm = RMSNorm(H, cfg.rms_norm_eps, **factory)
        self.q_proj = nn.Linear(H, Dq, bias=bias, **factory)
        self.k_proj = nn.Linear(H, Dkv, bias=bias, **factory)
        self.v_proj = nn.Linear(H, Dkv, bias=bias, **factory)
        self.o_proj = nn.Linear(Dq, H, bias=False, **factory)
        self.gate_proj = nn.Linear(H, I, bias=False, **factory)
        self.up_proj = nn.Linear(H, I, bias=False, **factory)
        self.down_proj = nn.Linear(I, H, bias=False, **factory)


class Qwen2(nn.Module):
    def __init__(self, cfg: LLMConfig, **factory) -> None:
        super().__init__()
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **factory)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, **factory) for _ in range(cfg.num_layers)
        )
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **factory)
        self.lm_head = (
            None if cfg.tie_word_embeddings
            else nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                           **factory)
        )


def init_params(
    cfg: LLMConfig,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Qwen2:
    """Random-normal init (scale 0.02, zero biases, unit norms)."""
    dev = resolve_device(device)
    model = Qwen2(cfg, device="meta", dtype=dtype)
    return materialize(model, dev, generator or default_generator(dev))


def init_kv_cache(
    cfg: LLMConfig, batch: int, max_len: int,
    dtype: torch.dtype = torch.bfloat16, device="cuda",
) -> dict[str, torch.Tensor]:
    """Dense cache {"k", "v"}: [L, B, S, Hk, D] zeros."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def init_paged_kv_cache(
    cfg: LLMConfig, num_pages: int, page_size: int,
    dtype: torch.dtype = torch.bfloat16, device="cuda",
) -> dict[str, torch.Tensor]:
    """Page-pool cache {"k", "v"}: [L, P, page_size, Hk, D] zeros, dense in
    `dtype` (ops/paged_kv.init_paged_pool: each layer has a sink page
    behind it for dropped writes). Rows address it through the block
    tables passed to `forward`."""
    device = resolve_device(device)

    def pool():
        return paged_kv.init_paged_pool(
            cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
            cfg.head_dim, dtype=dtype, device=device,
        )

    return {"k": pool(), "v": pool()}


def _cache_write(cache_layer: torch.Tensor, new: torch.Tensor,
                 slots: torch.Tensor) -> None:
    """Write new [B, T, Hk, D] into cache [B, S, Hk, D] at per-row start
    slots [B], in place (contiguous slots from each start)."""
    B, T = new.shape[:2]
    rows = torch.arange(B, device=new.device)[:, None]
    cols = slots.long()[:, None] + torch.arange(T, device=new.device)[None, :]
    cache_layer[rows, cols] = new.to(cache_layer.dtype)


def _linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(x.dtype)
    return F.linear(x, lin.weight.to(x.dtype), bias)


def _attn_fn(attn_impl: str):
    if attn_impl == "pallas":
        def fn(q, k, v, **kw):
            return flash_attention(q, k, v, causal=True, **kw)
    elif attn_impl == "xla":
        def fn(q, k, v, slot_positions=False, **kw):
            return attention(q, k, v, causal=True, **kw)
    else:
        raise ValueError(
            f"attn_impl {attn_impl!r}: the port has 'xla' and 'pallas'"
        )
    return fn


def _block(
    cfg: LLMConfig,
    h: torch.Tensor,
    lp: DecoderLayer,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache_k: torch.Tensor | None,
    cache_v: torch.Tensor | None,
    write_slots: torch.Tensor | None,
    kv_mask: torch.Tensor | None,
    attn_fn,
    block_tables: torch.Tensor | None = None,
    write_index: torch.Tensor | None = None,
    kv_lengths: torch.Tensor | None = None,
    q_segments: torch.Tensor | None = None,
    attn_impl: str = "xla",
) -> torch.Tensor:
    """One decoder block. h: [B, T, H]; writes k/v into the cache layer
    views in place when given (a paged layer at `write_index`, the pool
    rows `forward` computed once for every layer)."""
    B, T, _ = h.shape
    x = lp.input_norm(h)
    q = _linear(x, lp.q_proj).view(B, T, cfg.num_heads, cfg.head_dim)
    k = _linear(x, lp.k_proj).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(x, lp.v_proj).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    if cache_k is not None and block_tables is not None:
        rows = (B * T, cfg.num_kv_heads, cfg.head_dim)
        paged_kv.scatter_rows(cache_k, write_index, k.reshape(rows))
        paged_kv.scatter_rows(cache_v, write_index, v.reshape(rows))
    if cache_k is not None and block_tables is not None and (
        q_segments is not None
    ):
        # Packed ragged mode: the T axis is one buffer of rows from many
        # sequences; each row reads through the table of its own segment,
        # causally at its own position.
        ragged = (
            paged_attention.ragged_paged_attention if attn_impl == "pallas"
            else paged_kv.ragged_paged_attention
        )
        attn_out = ragged(
            q[0], cache_k, cache_v, block_tables, q_segments[0], positions[0]
        )[None]
    elif cache_k is not None and block_tables is not None:
        if attn_impl == "pallas" and T == 1 and kv_lengths is not None:
            # Decode: pages read in place through the block table.
            attn_out = paged_attention.ragged_decode_attention(
                q, cache_k, cache_v, block_tables, kv_lengths
            )
        else:
            # Plain path and any T > 1 paged prefill: gather the logical
            # stream, then the cached-attention call of the dense cache.
            attn_out = attn_fn(
                q,
                paged_kv.gather_pages(cache_k, block_tables),
                paged_kv.gather_pages(cache_v, block_tables),
                q_positions=positions,
                kv_positions=None,
                kv_mask=kv_mask,
            )
    elif cache_k is not None:
        _cache_write(cache_k, k, write_slots)
        _cache_write(cache_v, v, write_slots)
        attn_out = attn_fn(
            q, cache_k, cache_v,
            q_positions=positions,
            kv_positions=None,  # arange over cache slots == absolute positions
            kv_mask=kv_mask,
        )
    else:
        # Right-padded prefill: every valid token's position equals its
        # slot index, which lets the kernel end its causal kv loop early.
        attn_out = attn_fn(
            q, k, v,
            q_positions=positions,
            kv_positions=positions,
            kv_mask=kv_mask,
            slot_positions=True,
        )
    h = h + _linear(attn_out.reshape(B, T, -1), lp.o_proj)

    x = lp.post_attn_norm(h)
    gate = F.silu(_linear(x, lp.gate_proj))
    return h + _linear(gate * _linear(x, lp.up_proj), lp.down_proj)


def logits_from_hidden(
    params: Qwen2, cfg: LLMConfig, h: torch.Tensor,
    logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Final hidden states [..., H] (after final_norm) -> vocab logits."""
    if cfg.tie_word_embeddings:
        w = params.embed.weight
    else:
        w = params.lm_head.weight
    return F.linear(h, w.to(h.dtype)).to(logits_dtype)


def forward(
    params: Qwen2,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor | None = None,
    inputs_embeds: torch.Tensor | None = None,
    positions: torch.Tensor | None = None,
    kv_cache: dict[str, torch.Tensor] | None = None,
    write_slots: torch.Tensor | None = None,
    kv_mask: torch.Tensor | None = None,
    block_tables: torch.Tensor | None = None,
    write_mask: torch.Tensor | None = None,
    kv_lengths: torch.Tensor | None = None,
    q_segments: torch.Tensor | None = None,
    remat: bool | str = False,
    attn_impl: str = "xla",
    compute_dtype: torch.dtype | None = None,
    logits_dtype: torch.dtype = torch.float32,
    return_hidden: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor] | None]:
    """Full decoder forward.

    Args:
      input_ids / inputs_embeds: exactly one; ids [B, T] or embeds [B, T, H].
      positions: [B, T] absolute positions (RoPE + causal mask); default
        arange. Without a cache every valid token's position must equal its
        slot index (right-padded rows, the build_mm_batch layout).
      kv_cache: from `init_kv_cache`; k/v are written at `write_slots` ([B]
        first-slot indices, default positions[:, 0]) and attention runs over
        the whole cache with `kv_mask` [B, S] validity.
      kv_mask: without a cache, [B, T] padding mask; with one, [B, S].
      block_tables: paged mode - kv_cache is from `init_paged_kv_cache` and
        row b's logical slots map through block_tables[b] ([B, max_pages],
        sentinel = P); kv_mask then spans the logical stream
        [B, max_pages * page_size]. write_mask [B] gates the rows' writes;
        kv_lengths [B] (valid kv count incl. the current token) sends a
        single-token step under attn_impl="pallas" to the paged decode
        kernel.
      q_segments: packed ragged mode ([1, T], needs block_tables): the T
        axis packs rows of many sequences, q_segments names each row's
        slot, `positions` its absolute position, block_tables is
        [num_slots, max_pages] and write_mask is per row [1, T]. Each row
        writes through its slot's table and attends its slot's pages
        causally at its own position (kv_mask/kv_lengths unused).
      remat: the per-layer remat policy (utils/remat.py) of the training
        forward; only without a cache.
      return_hidden: return the final-norm hidden states instead of logits
        (callers project only the rows they need, `logits_from_hidden`).

    Returns (logits [B, T, V] in logits_dtype or hidden [B, T, H], the
    kv_cache updated in place or None).
    """
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("pass exactly one of input_ids / inputs_embeds")
    if inputs_embeds is None:
        inputs_embeds = params.embed.weight[input_ids]
    h = inputs_embeds
    if compute_dtype is not None:
        h = h.to(compute_dtype)
    B, T, _ = h.shape

    if positions is None:
        positions = torch.arange(T, device=h.device).expand(B, T)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    if kv_cache is not None and write_slots is None:
        write_slots = positions[:, 0]
    if q_segments is not None:
        if block_tables is None or kv_cache is None:
            raise ValueError(
                "q_segments (packed ragged serving) requires a paged "
                "kv_cache with block_tables"
            )
        if B != 1:
            raise ValueError(
                f"q_segments packs many sequences into ONE row; got B={B}"
            )
    if kv_cache is not None and remat not in (False, None, "none"):
        raise ValueError("remat is for the training forward, without a cache")
    attn_fn = _attn_fn(attn_impl)
    index = None
    if kv_cache is not None and block_tables is not None:
        P, ps = kv_cache["k"].shape[1:3]
        if q_segments is not None:
            index = paged_kv.write_index_packed(
                P, ps, block_tables, q_segments[0], positions[0],
                write_mask=None if write_mask is None else write_mask[0],
            )
        else:
            index = paged_kv.write_index(
                P, ps, block_tables, write_slots, T, write_mask=write_mask
            )

    for i, lp in enumerate(params.layers):
        h = checkpointed(
            remat, _block, cfg, h, lp, cos, sin,
            positions=positions,
            cache_k=None if kv_cache is None else kv_cache["k"][i],
            cache_v=None if kv_cache is None else kv_cache["v"][i],
            write_slots=write_slots,
            kv_mask=kv_mask,
            attn_fn=attn_fn,
            block_tables=block_tables,
            write_index=index,
            kv_lengths=kv_lengths,
            q_segments=q_segments,
            attn_impl=attn_impl,
        )

    h = params.final_norm(h)
    if return_hidden:
        return h, kv_cache
    return logits_from_hidden(params, cfg, h, logits_dtype), kv_cache
