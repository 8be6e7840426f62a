"""Qwen2/Yi-class causal decoder (port of `oryx_tpu.models.qwen2`).

Parameters live in `nn.Module`s (`Qwen2`, one `DecoderLayer` per layer,
linear weights in PyTorch's [out, in] layout); `forward` is a plain function
over them with the JAX function's arguments. Attention paths ported: no
cache (right-padded prefill), the dense KV cache ([L, B, S, Hk, D]), and the
paged pool ([L, P, page_size, Hk, D] addressed through block tables, in
per-row and packed ragged form). Caches are updated IN PLACE where the JAX
package returns a new cache. Without a cache the forward is the training
forward too: differentiable in every parameter, each layer under the remat
policy of utils/remat.py, with packed-training segment ids. LoRA adapters
(`add_lora_params`) are parameters of the projection modules themselves
(`lora_a` [in, r], `lora_b` [r, out], `lora_scale` [1, 1]), and every
product adds their residual (`utils/quant.linear`). Under attn_impl "ring"
/ "ring_flash" (sequence parallelism, training only) each layer's attention
runs around the ring the trainer attaches as `params.ring`
(ops/ring_attention.py; a ring of one rank when none is attached). On a
ZeRO-3 rank each layer's sharded leaves are gathered as the layer runs
(parallel/zero.gathered).
"""

from __future__ import annotations

import dataclasses

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
from oryx_tpu_torch.parallel.zero import gathered
from oryx_tpu_torch.utils.quant import (
    LORA_LEAVES,
    Q8Linear,
    column_input,
    embed_rows,
    linear,
    linear_group,
    row_linear,
)
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


def _projection(layer: DecoderLayer, name: str) -> nn.Module:
    mod = getattr(layer, name, None) if name.endswith("_proj") else None
    if not isinstance(mod, (nn.Linear, Q8Linear)):
        raise ValueError(f"unknown LoRA target {name!r}")
    return mod


@torch.no_grad()
def add_lora_params(
    params: Qwen2, cfg: LLMConfig, lora,
    generator: torch.Generator | None = None,
    dtype: torch.dtype = torch.float32,
) -> Qwen2:
    """Attach LoRA adapters to the decoder projections named by
    `lora.targets` (config.LoraConfig), in place: per target and layer
    A ~ N(0, 0.02) [in, r], B = 0 [r, out] and scale = lora.scaling [1, 1],
    so the adapted model is exactly the base model at step 0. A is drawn
    from `generator` (seed 0 on the parameters' device when None), one
    [L, in, r] draw per target: the port's own adapters (the JAX package
    draws them from jax.random; parity goes through convert.py or a PEFT
    directory). All three are frozen parameters of the projection module
    (the Trainer makes A and B trainable); `lora_scale` is a parameter
    because JAX's gradient norm covers it."""
    dev = params.final_norm.weight.device
    g = generator or default_generator(dev)
    for name in lora.targets:
        mods = [_projection(layer, name) for layer in params.layers]
        d_in, d_out = mods[0].in_features, mods[0].out_features
        a = torch.randn((len(mods), d_in, lora.r), generator=g,
                        device=g.device, dtype=torch.float32) * 0.02
        for i, mod in enumerate(mods):
            for leaf, t in zip(LORA_LEAVES, (
                a[i].to(dev, dtype),
                torch.zeros((lora.r, d_out), dtype=dtype, device=dev),
                torch.full((1, 1), lora.scaling, dtype=dtype, device=dev),
            )):
                mod.register_parameter(
                    leaf, nn.Parameter(t, requires_grad=False))
    return params


@torch.no_grad()
def merge_lora_params(params: Qwen2) -> Qwen2:
    """Fold trained adapters into the base weights, in place (for serving or
    export): W += scale B^T A^T in fp32, cast back to W's dtype; the adapter
    parameters are removed. The product is PEFT's B A on contiguous
    operands, as `import_hf.merge_lora` computes it from an exported
    adapter, so both merges give the same bits."""
    for layer in params.layers:
        for mod in layer.children():
            if "lora_a" not in mod._parameters:
                continue
            if not isinstance(mod, nn.Linear):
                raise ValueError(
                    f"cannot fold adapters into {type(mod).__name__} codes"
                )
            a, b, s = (mod._parameters.pop(k).float() for k in LORA_LEAVES)
            w = mod.weight
            delta = (b.T.contiguous() @ a.T.contiguous()) * s
            w.copy_((w.float() + delta).to(w.dtype))
    return params


def lora_shells(params: nn.Module, state) -> nn.Module:
    """Register empty adapter parameters (meta device) on each module that
    `state` ({name: tensor}) holds `lora_*` entries for, so that the state
    then loads into the model."""
    for key in state:
        owner, _, leaf = key.rpartition(".")
        if leaf in LORA_LEAVES:
            mod = params.get_submodule(owner)
            t = state[key]
            mod.register_parameter(leaf, nn.Parameter(
                torch.empty(t.shape, dtype=t.dtype, device="meta"),
                requires_grad=False))
    return params


def rank_cfg(params, cfg: LLMConfig) -> LLMConfig:
    """`cfg` at this rank's widths: a tensor-parallel shard (its `tp` the
    world of parallel/tp.py) holds num_heads / tp query heads,
    num_kv_heads / tp KV heads and intermediate_size / tp MLP columns, and
    its caches hold its KV heads. `cfg` itself off tp."""
    tp = getattr(params, "tp", None)
    if tp is None or tp.size == 1:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp.size,
        num_kv_heads=cfg.num_kv_heads // tp.size,
        intermediate_size=cfg.intermediate_size // tp.size,
    )


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
    kv_dtype: str | None = None,
) -> dict:
    """Page-pool cache {"k", "v"}: [L, P, page_size, Hk, D] zeros (each
    layer has a sink page behind it for dropped writes). Rows address it
    through the block tables passed to `forward`.

    kv_dtype: None / "bf16" / "fp" store pages densely in `dtype`;
    "int8" / "fp8_e4m3" store quantized planes (ops/paged_kv.QuantPages:
    codes plus one fp32 scale per token row, quantized on write,
    dequantized into `dtype` by the readers); any other name raises."""
    device = resolve_device(device)
    if kv_dtype in (None, "bf16", "fp"):
        def pool():
            return paged_kv.init_paged_pool(
                cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                cfg.head_dim, dtype=dtype, device=device,
            )
    else:
        def pool():
            return paged_kv.init_quant_pages(
                cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                cfg.head_dim, fmt=kv_dtype, dequant_dtype=dtype,
                device=device,
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


def _attn_fn(attn_impl: str, ring=None):
    if attn_impl in ("ring", "ring_flash"):
        from oryx_tpu_torch.ops import ring_attention as ring_lib

        ring = ring or ring_lib.Ring()
        impl = "flash" if attn_impl == "ring_flash" else "xla"

        def fn(q, k, v, *, q_positions, kv_positions, kv_mask,
               slot_positions=False):
            B, T = q.shape[:2]
            kv_valid = (torch.ones((B, T), dtype=torch.int32,
                                   device=q.device) if kv_mask is None
                        else kv_mask)
            return ring_lib.ring_attention_shard(
                q, k, v, q_positions, kv_positions, kv_valid, ring=ring,
                causal=True, impl=impl)
        return fn
    if attn_impl == "pallas":
        def fn(q, k, v, **kw):
            return flash_attention(q, k, v, causal=True, **kw)
    elif attn_impl == "xla":
        def fn(q, k, v, slot_positions=False, **kw):
            return attention(q, k, v, causal=True, **kw)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    return fn


def _block(
    cfg: LLMConfig,
    h: torch.Tensor,
    lp: DecoderLayer,
    cos: torch.Tensor,
    sin: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache_k,  # dense layer [.., Hk, D] or a QuantPages plane (paged)
    cache_v,
    write_slots: torch.Tensor | None,
    kv_mask: torch.Tensor | None,
    attn_fn,
    block_tables: torch.Tensor | None = None,
    write_index: torch.Tensor | None = None,
    kv_lengths: torch.Tensor | None = None,
    q_segments: torch.Tensor | None = None,
    attn_impl: str = "xla",
    tp=None,
) -> torch.Tensor:
    """One decoder block. h: [B, T, H]; writes k/v into the cache layer
    views in place when given (a paged layer at `write_index`, the pool
    rows `forward` computed once for every layer; a quantized page plane
    quantizes them on write, and a T > 1 prefill reads it through the
    dequantizing `gather_pages`). tp: a tensor-parallel shard's world: the
    layer holds its own heads and MLP columns (LoRA adapters whole), and
    the o_proj and down_proj partial products are summed over the
    ranks."""
    B, T, _ = h.shape
    x = column_input(lp.input_norm(h), tp)
    # Names for the "attn_qkv" / "attn_o" remat policies (utils/remat.py).
    q, k, v = linear_group(x, (lp.q_proj, lp.k_proj, lp.v_proj),
                           ("attn_q", "attn_k", "attn_v"), tp)
    # Head counts from the widths: a tensor-parallel shard holds its own.
    q = q.view(B, T, -1, cfg.head_dim)
    k = k.view(B, T, -1, cfg.head_dim)
    v = v.view(B, T, -1, cfg.head_dim)
    q, k = apply_rope(q, k, cos, sin)

    if cache_k is not None and block_tables is not None:
        rows = (B * T, -1, cfg.head_dim)
        paged_kv.scatter_rows(cache_k, write_index, k.reshape(rows), tp)
        paged_kv.scatter_rows(cache_v, write_index, v.reshape(rows), tp)
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
    h = h + row_linear(attn_out.reshape(B, T, -1), lp.o_proj, tp, "attn_o")

    x = column_input(lp.post_attn_norm(h), tp)
    gate, up = linear_group(x, (lp.gate_proj, lp.up_proj), None, tp)
    return h + row_linear(F.silu(gate) * up, lp.down_proj, tp)


def logits_from_hidden(
    params: Qwen2, cfg: LLMConfig, h: torch.Tensor,
    logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Final hidden states [..., H] (after final_norm) -> vocab logits."""
    head = params.embed if cfg.tie_word_embeddings else params.lm_head
    return linear(h, head).to(logits_dtype)


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
    segment_ids: torch.Tensor | None = None,
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
      segment_ids: [B, T] int SAMPLE ids for sequence-packed training (0 =
        pad): attention is causal in SLOT order and masked on segment
        equality, so samples packed into one row never attend each other,
        while `positions` (restarting per sample) still drive RoPE.
        Training only: no kv_cache.

    Returns (logits [B, T, V] in logits_dtype or hidden [B, T, H], the
    kv_cache updated in place or None).
    """
    if (input_ids is None) == (inputs_embeds is None):
        raise ValueError("pass exactly one of input_ids / inputs_embeds")
    if inputs_embeds is None:
        inputs_embeds = embed_rows(params.embed, input_ids)
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
    if segment_ids is not None and (
        kv_cache is not None or attn_impl not in ("xla", "pallas")
    ):
        raise ValueError(
            "segment_ids (packed training) requires attn_impl xla|pallas "
            "and no kv_cache"
        )
    if attn_impl in ("ring", "ring_flash") and kv_cache is not None:
        raise ValueError(f"attn_impl={attn_impl!r} needs no kv_cache")
    attn_fn = _attn_fn(attn_impl, getattr(params, "ring", None))
    # Packed rows: causal order is the SLOT order (within a sample the two
    # coincide; across samples the segment mask rules), which also keeps
    # the kernel's slot-position promise despite the restarting RoPE
    # positions.
    attn_positions = positions
    if segment_ids is not None:
        attn_positions = torch.arange(T, device=h.device).expand(B, T)
        base_attn_fn = attn_fn

        def attn_fn(q, k, v, **kw):
            return base_attn_fn(q, k, v, q_segment_ids=segment_ids,
                                kv_segment_ids=segment_ids, **kw)
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
            remat, gathered(_block, lp), cfg, h, lp, cos, sin,
            positions=attn_positions,
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
            tp=getattr(params, "tp", None),
        )

    h = params.final_norm(h)
    if return_hidden:
        return h, kv_cache
    return logits_from_hidden(params, cfg, h, logits_dtype), kv_cache
