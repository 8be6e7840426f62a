"""Oryx multimodal model: OryxViT + Dynamic Compressor + Qwen2 decoder
(port of `oryx_tpu.models.oryx`).

`OryxModel` holds the three parameter modules under the JAX tree's names
(`llm`, `vit`, `compressor`); the visual encode, splice, prefill and decode
are plain functions over them, on the packed buffers from ops/packing.py and
models/splice.py. `forward` is the training forward (visual encode, splice,
decoder; differentiable in every parameter).
"""

from __future__ import annotations

import time

import torch
from torch import nn

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import compressor as compressor_lib
from oryx_tpu_torch.models import generate as generate_lib
from oryx_tpu_torch.models import oryx_vit, qwen2, splice
from oryx_tpu_torch.models.params import default_generator, resolve_device
from oryx_tpu_torch.ops.packing import PackedVisual, round_up_bucket


class OryxModel(nn.Module):
    def __init__(self, llm: qwen2.Qwen2, vit: oryx_vit.OryxViT,
                 compressor: compressor_lib.Compressor) -> None:
        super().__init__()
        self.llm = llm
        self.vit = vit
        self.compressor = compressor


def init_params(
    cfg: OryxConfig,
    generator: torch.Generator | None = None,
    *,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> OryxModel:
    """Random init of all three parts from one generator (seed 0 when none
    is given), built directly on `device` in `dtype`, frozen (inference);
    `train.trainer.prepare_params` makes the leaves trainable."""
    dev = resolve_device(device)
    g = generator or default_generator(dev)
    return OryxModel(
        qwen2.init_params(cfg.llm, g, device=dev, dtype=dtype),
        oryx_vit.init_params(cfg.vision, g, device=dev, dtype=dtype),
        compressor_lib.init_params(
            cfg.compressor, cfg.vision, cfg.llm, g, device=dev, dtype=dtype
        ),
    )


def empty_model(cfg: OryxConfig,
                dtype: torch.dtype = torch.float32) -> OryxModel:
    """The model's modules on the meta device (no memory), for a loader to
    fill."""
    factory = dict(device="meta", dtype=dtype)
    return OryxModel(
        qwen2.Qwen2(cfg.llm, **factory),
        oryx_vit.OryxViT(cfg.vision, **factory),
        compressor_lib.Compressor(cfg.vision, cfg.llm, **factory),
    )


def compute_dtype(cfg: OryxConfig) -> torch.dtype:
    """cfg.dtype string -> torch dtype for matmuls/activations."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def enable_lora(params: OryxModel, cfg: OryxConfig,
                generator: torch.Generator | None = None) -> OryxModel:
    """Attach LoRA adapters (cfg.train.lora) to the decoder, in place."""
    qwen2.add_lora_params(params.llm, cfg.llm, cfg.train.lora, generator)
    return params


def merge_lora(params: OryxModel) -> OryxModel:
    """Fold trained adapters into the decoder weights for serving, in
    place."""
    qwen2.merge_lora_params(params.llm)
    return params


def encode_visual(
    params: OryxModel,
    cfg: OryxConfig,
    patches: torch.Tensor,
    segment_ids: torch.Tensor,
    pos_coords: torch.Tensor,
    region_ids: torch.Tensor,
    q_region_ids: torch.Tensor,
    *,
    remat: bool | str = False,
    compute_dtype: torch.dtype | None = None,
    shard=None,
) -> torch.Tensor:
    """Packed patches -> packed LLM-space visual embeddings [Q, H_llm]: one
    ViT pass over all images/frames of the batch, then the compressor.
    The ring impls are the decoder's sequence parallelism and mean nothing
    to the packed visual buffer: under "ring" the ViT takes its plain
    segment attention ("xla"), under "ring_flash" its kernel ("pallas":
    JAX runs XLA there because a pallas_call does not partition under
    GSPMD, and a port rank holds its shard outright), and the compressor
    takes its kernel only under "pallas", as JAX's encode_visual does.
    shard: a training rank's `parallel/zero.VisualShard` when the five
    arrays are the rank's 1/W of the buffer; the visual tokens of every
    rank are gathered, so the result is the whole [Q, H_llm]."""
    vit_impl = "pallas" if cfg.attn_impl in ("pallas", "ring_flash") else (
        "xla")
    feats = oryx_vit.forward(
        params.vit, cfg.vision, patches, segment_ids, pos_coords,
        remat=remat, attn_impl=vit_impl, compute_dtype=compute_dtype,
        shard=shard,
    )
    vis = compressor_lib.forward(
        params.compressor, cfg.compressor, cfg.vision,
        feats, region_ids, q_region_ids,
        attn_impl="pallas" if cfg.attn_impl == "pallas" else "xla",
        shard=shard,
    )
    return vis if shard is None else shard.gather(vis)


def forward(
    params: OryxModel,
    cfg: OryxConfig,
    *,
    patches: torch.Tensor,
    segment_ids: torch.Tensor,
    pos_coords: torch.Tensor,
    region_ids: torch.Tensor,
    q_region_ids: torch.Tensor,
    token_ids: torch.Tensor,
    visual_idx: torch.Tensor,
    is_visual: torch.Tensor,
    attn_mask: torch.Tensor,
    positions: torch.Tensor,
    remat: bool | str = False,
    compute_dtype: torch.dtype | None = None,
    return_hidden: bool = False,
    text_segment_ids: torch.Tensor | None = None,
    visual_shard=None,
) -> torch.Tensor:
    """Training forward: visual encode -> splice -> decoder fp32 logits
    [B, T, V] (or the final hidden states [B, T, H] with return_hidden, for the
    chunked loss). The arrays are the collated batch fields
    (train/data.collate) on the device. text_segment_ids: the decoder rows'
    sample ids of a sequence-packed text batch
    (train/data.collate_packed_text), distinct from the visual buffer's
    `segment_ids`. visual_shard: see `encode_visual`."""
    vis = encode_visual(
        params, cfg, patches, segment_ids, pos_coords, region_ids,
        q_region_ids, remat=remat, compute_dtype=compute_dtype,
        shard=visual_shard,
    )
    embeds = splice.embed_spliced(
        params.llm.embed, vis, token_ids, visual_idx, is_visual
    )
    out, _ = qwen2.forward(
        params.llm, cfg.llm,
        inputs_embeds=embeds, positions=positions, kv_mask=attn_mask,
        remat=remat, attn_impl=cfg.attn_impl, compute_dtype=compute_dtype,
        return_hidden=return_hidden, segment_ids=text_segment_ids,
    )
    return out


def stage_mm_arrays(packed: PackedVisual, batch: splice.MMBatch,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """Host packed/batch structs -> the device tensors mm_generate uses."""
    host = {
        "patches": packed.patches,
        "segment_ids": packed.segment_ids,
        "pos_coords": packed.pos_coords,
        "region_ids": packed.region_ids,
        "q_region_ids": packed.q_region_ids,
        "token_ids": batch.token_ids,
        "visual_idx": batch.visual_idx,
        "is_visual": batch.is_visual,
        "lengths": batch.lengths,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


@torch.inference_mode()
def mm_embeds(params: OryxModel, cfg: OryxConfig,
              arrays: dict[str, torch.Tensor]) -> torch.Tensor:
    """Visual encode + splice -> [B, T, H] decoder inputs."""
    vis = encode_visual(
        params, cfg,
        arrays["patches"], arrays["segment_ids"], arrays["pos_coords"],
        arrays["region_ids"], arrays["q_region_ids"],
        compute_dtype=compute_dtype(cfg),
    )
    return splice.embed_spliced(
        params.llm.embed, vis,
        arrays["token_ids"], arrays["visual_idx"], arrays["is_visual"],
    )


def mm_generate(
    params: OryxModel,
    cfg: OryxConfig,
    packed: PackedVisual,
    batch: splice.MMBatch,
    *,
    max_new_tokens: int | None = None,
    generator: torch.Generator | None = None,
    stop_sequences: torch.Tensor | None = None,
    device="cuda",
    timings: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """End-to-end multimodal generation from host-side packed inputs.

    Returns (tokens [B, max_new_tokens], num_generated [B], finished [B]
    bool - False means cut off by max_new_tokens). timings: when given,
    receives visual_s (encode + splice) and generate's prefill_s/decode_s.
    """
    dev = resolve_device(device)
    if max_new_tokens is None:
        max_new_tokens = cfg.generation.max_new_tokens
    T = batch.token_ids.shape[1]
    cache_len = round_up_bucket(T + max_new_tokens)
    arrays = stage_mm_arrays(packed, batch, dev)
    if timings is not None:
        generate_lib._sync(dev)
        t0 = time.perf_counter()
    embeds = mm_embeds(params, cfg, arrays)
    if timings is not None:
        generate_lib._sync(dev)
        timings["visual_s"] = time.perf_counter() - t0
    return generate_lib.generate(
        params.llm, cfg.llm, cfg.generation,
        inputs_embeds=embeds, lengths=arrays["lengths"],
        max_new_tokens=max_new_tokens, cache_len=cache_len,
        generator=generator, attn_impl=cfg.attn_impl,
        compute_dtype=compute_dtype(cfg), stop_sequences=stop_sequences,
        timings=timings,
    )
