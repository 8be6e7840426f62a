"""Qwen2/Yi-class causal decoder (port of `oryx_tpu.models.qwen2`).

Parameters live in `nn.Module`s (`Qwen2`, one `DecoderLayer` per layer,
linear weights in PyTorch's [out, in] layout); `forward` is a plain function
over them with the JAX function's arguments. Two attention paths are
ported: no cache (right-padded prefill) and the dense KV cache
([L, B, S, Hk, D], updated IN PLACE, where the JAX package returns a new
cache). Paged and ragged caches, ring attention, LoRA and packed-training
segment ids belong to later slices.
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
from oryx_tpu_torch.ops.attention import attention
from oryx_tpu_torch.ops.cuda.flash_attention import flash_attention
from oryx_tpu_torch.ops.norms import RMSNorm
from oryx_tpu_torch.ops.rope import apply_rope, rope_cos_sin


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
) -> torch.Tensor:
    """One decoder block. h: [B, T, H]; writes k/v into the cache layer
    views in place when given."""
    B, T, _ = h.shape
    x = lp.input_norm(h)
    q = _linear(x, lp.q_proj).view(B, T, cfg.num_heads, cfg.head_dim)
    k = _linear(x, lp.k_proj).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    v = _linear(x, lp.v_proj).view(B, T, cfg.num_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    if cache_k is not None:
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
    attn_fn = _attn_fn(attn_impl)

    for i, lp in enumerate(params.layers):
        h = _block(
            cfg, h, lp, cos, sin,
            positions=positions,
            cache_k=None if kv_cache is None else kv_cache["k"][i],
            cache_v=None if kv_cache is None else kv_cache["v"][i],
            write_slots=write_slots,
            kv_mask=kv_mask,
            attn_fn=attn_fn,
        )

    h = params.final_norm(h)
    if return_hidden:
        return h, kv_cache
    return logits_from_hidden(params, cfg, h, logits_dtype), kv_cache
