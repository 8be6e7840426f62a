"""HF checkpoint <-> port weight conversion (port of
`oryx_tpu.models.import_hf`).

The interop path: import HF state dicts (Qwen2/Llama-family decoders and
SigLIP-family vision towers) into the port's modules, and export them back
under HF names for users of the reference checkpoints. An HF linear weight
is already the port's [out, in], so the names map onto the modules
directly; only SigLIP's Conv2d patch embedding is reshaped, into the
unfold-then-matmul layout of the host patch extraction (channel-last pixels
within a patch), the JAX package's element order stored as [out, in].

A state dict's values may be torch tensors (`utils/safetensors.py` reads
them memory-mapped) or numpy arrays; each is cast to `dtype` on `device`
one tensor at a time. PEFT LoRA adapters merge into a decoder
(`merge_lora`, `merge_lora_dir`) and trained in-model adapters export in
PEFT's layout (`export_lora`, `export_lora_dir`).
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Mapping

import torch

from oryx_tpu_torch.config import LLMConfig, VisionConfig
from oryx_tpu_torch.models import oryx_vit, qwen2
from oryx_tpu_torch.models.params import resolve_device
from oryx_tpu_torch.utils import safetensors as st
from oryx_tpu_torch.utils.safetensors import load_safetensors_dir

__all__ = [
    "export_lora", "export_lora_dir", "export_qwen2", "export_siglip",
    "import_qwen2", "import_siglip", "llm_hf_config", "load_safetensors_dir",
    "merge_lora", "merge_lora_dir", "save_hf_checkpoint",
]

StateDict = Mapping[str, Any]


def _get(sd: StateDict, key: str) -> torch.Tensor:
    if key not in sd:
        raise KeyError(f"missing weight {key!r}; have e.g. "
                       f"{sorted(sd)[:5]}...")
    return st.as_tensor(sd[key])


def _load(module: torch.nn.Module, state: dict[str, torch.Tensor],
          device, dtype: torch.dtype) -> torch.nn.Module:
    """Fill a meta-device module from `state` (every tensor cast to
    `dtype` on `device`), frozen."""
    dev = resolve_device(device)
    module.load_state_dict(
        {k: v.to(device=dev, dtype=dtype) for k, v in state.items()},
        strict=True, assign=True,
    )
    return module.requires_grad_(False)


# ---------------------------------------------------------------------------
# Qwen2 / Yi decoder
# ---------------------------------------------------------------------------

# The port's DecoderLayer names -> HF names under model.layers.{i}.
_QWEN2_LAYER = {
    "input_norm.weight": "input_layernorm.weight",
    "post_attn_norm.weight": "post_attention_layernorm.weight",
    "q_proj.weight": "self_attn.q_proj.weight",
    "k_proj.weight": "self_attn.k_proj.weight",
    "v_proj.weight": "self_attn.v_proj.weight",
    "o_proj.weight": "self_attn.o_proj.weight",
    "gate_proj.weight": "mlp.gate_proj.weight",
    "up_proj.weight": "mlp.up_proj.weight",
    "down_proj.weight": "mlp.down_proj.weight",
}
_QWEN2_BIAS = ("q_proj", "k_proj", "v_proj")


def _qwen2_names(cfg: LLMConfig, p: str) -> dict[str, str]:
    """{port name: HF name} of a decoder; p is the HF prefix ("model." or
    "")."""
    names = {"embed.weight": p + "embed_tokens.weight",
             "final_norm.weight": p + "norm.weight"}
    layer = dict(_QWEN2_LAYER)
    if cfg.attention_bias:
        for proj in _QWEN2_BIAS:
            layer[f"{proj}.bias"] = f"self_attn.{proj}.bias"
    for i in range(cfg.num_layers):
        for ours, hf in layer.items():
            names[f"layers.{i}.{ours}"] = f"{p}layers.{i}.{hf}"
    if not cfg.tie_word_embeddings:
        names["lm_head.weight"] = "lm_head.weight"
    return names


def import_qwen2(sd: StateDict, cfg: LLMConfig,
                 dtype: torch.dtype = torch.float32,
                 device="cuda") -> qwen2.Qwen2:
    """HF Qwen2/Llama-family state dict -> the port's Qwen2 module.

    Accepts `model.`-prefixed names (a full ForCausalLM dict) or the bare
    inner-model names; the bare form carries no `lm_head.weight`, so it
    needs `cfg.tie_word_embeddings` (a clear KeyError otherwise)."""
    p = "model." if any(k.startswith("model.") for k in sd) else ""
    state = {ours: _get(sd, hf) for ours, hf in _qwen2_names(cfg, p).items()}
    return _load(qwen2.Qwen2(cfg, device="meta", dtype=dtype), state,
                 device, dtype)


def export_qwen2(params: qwen2.Qwen2, cfg: LLMConfig) -> dict[str, torch.Tensor]:
    """The port's Qwen2 -> HF state-dict names (fp32, on the host)."""
    ours = params.state_dict()
    return {hf: ours[name].detach().float().cpu()
            for name, hf in _qwen2_names(cfg, "model.").items()}


# ---------------------------------------------------------------------------
# SigLIP-family vision tower (OryxViT)
# ---------------------------------------------------------------------------

_SIGLIP_LAYER = {
    "norm1": "layer_norm1", "norm2": "layer_norm2",
    "q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
    "v_proj": "self_attn.v_proj", "o_proj": "self_attn.out_proj",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def _siglip_names(cfg: VisionConfig, p: str) -> dict[str, str]:
    """{port name: HF name} of a vision tower, the patch embedding aside."""
    names = {
        "patch_embed.bias": p + "embeddings.patch_embedding.bias",
        "pos_embed.weight": p + "embeddings.position_embedding.weight",
        "post_norm.weight": p + "post_layernorm.weight",
        "post_norm.bias": p + "post_layernorm.bias",
    }
    for i in range(cfg.num_layers):
        for ours, hf in _SIGLIP_LAYER.items():
            for leaf in ("weight", "bias"):
                names[f"layers.{i}.{ours}.{leaf}"] = (
                    f"{p}encoder.layers.{i}.{hf}.{leaf}")
    return names


def import_siglip(sd: StateDict, cfg: VisionConfig,
                  dtype: torch.dtype = torch.float32,
                  device="cuda") -> oryx_vit.OryxViT:
    """HF `SiglipVisionModel`-layout state dict -> the port's OryxViT.
    Accepts an optional `vision_model.` (or `vision_tower.vision_model.`)
    prefix."""
    p = ""
    for cand in ("vision_model.", "vision_tower.vision_model.", ""):
        if any(k.startswith(cand + "encoder.layers.0.") for k in sd):
            p = cand
            break
    state = {ours: _get(sd, hf) for ours, hf in _siglip_names(cfg, p).items()}
    # Conv2d [H, C, ph, pw] -> [H, ph * pw * C]: column (i * pw + j) * C + c
    # is pixel (i, j), channel c of the patch.
    conv = _get(sd, p + "embeddings.patch_embedding.weight")
    state["patch_embed.weight"] = conv.permute(0, 2, 3, 1).reshape(
        conv.shape[0], -1)
    return _load(oryx_vit.OryxViT(cfg, device="meta", dtype=dtype), state,
                 device, dtype)


def export_siglip(params: oryx_vit.OryxViT,
                  cfg: VisionConfig) -> dict[str, torch.Tensor]:
    """The port's OryxViT -> HF SiglipVisionModel-layout state dict (fp32,
    `vision_model.`-prefixed, on the host): the inverse of import_siglip."""
    ours = params.state_dict()
    p = "vision_model."
    out = {hf: ours[name].detach().float().cpu()
           for name, hf in _siglip_names(cfg, p).items()}
    w = ours["patch_embed.weight"].detach().float().cpu()
    ph = pw = cfg.patch_size
    out[p + "embeddings.patch_embedding.weight"] = (
        w.reshape(w.shape[0], ph, pw, cfg.num_channels)
        .permute(0, 3, 1, 2).contiguous())
    return out


def llm_hf_config(cfg: LLMConfig) -> dict[str, Any]:
    """HF config.json dict for an exported checkpoint.

    Qwen2 geometry (qkv biases) exports as Qwen2ForCausalLM; bias-free
    (Yi/Llama-class) geometry as LlamaForCausalLM with attention_bias false:
    HF's Qwen2 always expects qkv biases, so declaring it for a bias-free
    model would make from_pretrained fabricate random biases."""
    if cfg.attention_bias:
        arch: dict[str, Any] = {
            "architectures": ["Qwen2ForCausalLM"],
            "model_type": "qwen2",
        }
    else:
        arch = {
            "architectures": ["LlamaForCausalLM"],
            "model_type": "llama",
            "attention_bias": False,
            "mlp_bias": False,
        }
    return {
        **arch,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "hidden_act": "silu",
        "torch_dtype": "float32",
    }


def save_hf_checkpoint(params, llm_cfg: LLMConfig, vision_cfg: VisionConfig,
                       directory: str) -> None:
    """Write a reference-layout checkpoint directory: the LLM as
    `model.safetensors` plus `config.json` (HF Qwen2/Llama names), the
    vision tower as `vision_tower.safetensors` (SigLIP names), and the
    compressor as the projector npz `mm_projector.npz`. Tokenizer files
    are not written (they belong to the source checkpoint). `params` is an
    OryxModel."""
    from oryx_tpu_torch.utils import checkpoint as ckpt_lib

    os.makedirs(directory, exist_ok=True)
    st.save_file(export_qwen2(params.llm, llm_cfg),
                 os.path.join(directory, "model.safetensors"))
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(llm_hf_config(llm_cfg), f, indent=2)
    st.save_file(export_siglip(params.vit, vision_cfg),
                 os.path.join(directory, "vision_tower.safetensors"))
    ckpt_lib.save_projector_only(os.path.join(directory, "mm_projector"),
                                 params)



# ---------------------------------------------------------------------------
# LoRA adapters (PEFT layout)
# ---------------------------------------------------------------------------

# PEFT module scope of each adaptable decoder projection.
_LORA_SCOPE = {
    "q_proj": "self_attn", "k_proj": "self_attn", "v_proj": "self_attn",
    "o_proj": "self_attn", "gate_proj": "mlp", "up_proj": "mlp",
    "down_proj": "mlp",
}
_LORA_KEY = re.compile(
    r"layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)\.lora_(A|B)\.weight$"
)


@torch.no_grad()
def merge_lora(params: qwen2.Qwen2, adapter_sd: StateDict, cfg: LLMConfig,
               *, scaling: float) -> qwen2.Qwen2:
    """Merge a PEFT LoRA adapter into the decoder's weights, in place:
    W += scaling * B A per adapted layer (A [r, in], B [out, r], torch
    layout, under keys like
    `base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight`), in
    fp32, cast back to W's dtype. Anything else in the adapter (embedding
    or lm_head LoRA, modules_to_save, DoRA magnitudes) is refused rather
    than skipped, as are out-of-range layers and incomplete pairs."""
    found: dict[tuple[str, int], dict[str, torch.Tensor]] = {}
    unhandled: list[str] = []
    for key in adapter_sd:
        m = _LORA_KEY.search(key)
        if not m:
            unhandled.append(key)
            continue
        layer, proj, ab = int(m.group(1)), m.group(2), m.group(3)
        if proj not in _LORA_SCOPE:
            raise ValueError(f"unsupported LoRA target {proj!r} in {key}")
        if not 0 <= layer < cfg.num_layers:
            raise ValueError(
                f"adapter layer {layer} out of range for a "
                f"{cfg.num_layers}-layer model ({key})"
            )
        found.setdefault((proj, layer), {})[ab] = _get(adapter_sd, key)
    if unhandled:
        raise ValueError(
            "unsupported adapter weights (only decoder-proj lora_A/B "
            f"supported): {sorted(unhandled)[:5]}"
            f"{'...' if len(unhandled) > 5 else ''}"
        )
    if not found:
        raise ValueError("no LoRA weights found in adapter state dict")
    for (proj, i), pair in found.items():
        if set(pair) != {"A", "B"}:
            raise ValueError(f"layer {i} {proj}: incomplete LoRA pair")
        w = getattr(params.layers[i], proj).weight
        delta = (pair["B"].float().to(w.device)
                 @ pair["A"].float().to(w.device)) * scaling
        w.copy_((w.float() + delta).to(w.dtype))
    return params


def _adapter_scaling(adapter_dir: str):
    from oryx_tpu_torch.config import LoraConfig

    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        acfg = json.load(f)
    r = int(acfg["r"])
    # The scaling formula (rsLoRA's alpha / sqrt(r) too) is LoraConfig's.
    return LoraConfig(
        r=r,
        alpha=float(acfg.get("lora_alpha", r)),
        use_rslora=bool(acfg.get("use_rslora")),
    ).scaling


def merge_lora_dir(params: qwen2.Qwen2, adapter_dir: str,
                   cfg: LLMConfig) -> qwen2.Qwen2:
    """Merge a PEFT adapter directory (adapter_config.json +
    adapter_model.safetensors) into the decoder, in place."""
    scaling = _adapter_scaling(adapter_dir)
    sd = st.load_file(os.path.join(adapter_dir, "adapter_model.safetensors"))
    return merge_lora(params, sd, cfg, scaling=scaling)


def export_lora(params: qwen2.Qwen2, lora) -> tuple[dict, dict]:
    """Trained in-model adapters -> PEFT layout (the reverse of
    merge_lora): per layer `base_model.model.model.layers.{i}.<scope>.
    <proj>.lora_A/lora_B.weight` as fp32 [r, in] / [out, r], plus the
    adapter_config.json dict. `lora` (config.LoraConfig) must be the
    config the adapters were made with: r and the scaling are checked
    against the parameters, so the recorded config cannot disagree with
    the weights."""
    sd: dict[str, torch.Tensor] = {}
    targets = []
    for name in _LORA_SCOPE:
        mods = [getattr(layer, name) for layer in params.layers]
        if "lora_a" not in mods[0]._parameters:
            continue
        targets.append(name)
        a0 = mods[0].lora_a
        if a0.shape[1] != lora.r:
            raise ValueError(
                f"{name}: adapter rank {a0.shape[1]} != lora.r {lora.r}"
            )
        scale = float(mods[0].lora_scale.float().flatten()[0])
        if abs(scale - lora.scaling) > 1e-6 * max(1.0, abs(scale)):
            raise ValueError(
                f"{name}: params lora_scale {scale} != config scaling "
                f"{lora.scaling} (r/alpha/use_rslora mismatch)"
            )
        scope = _LORA_SCOPE[name]
        for i, mod in enumerate(mods):
            base = f"base_model.model.model.layers.{i}.{scope}.{name}"
            sd[f"{base}.lora_A.weight"] = (
                mod.lora_a.detach().float().cpu().T.contiguous())
            sd[f"{base}.lora_B.weight"] = (
                mod.lora_b.detach().float().cpu().T.contiguous())
    if not sd:
        raise ValueError("params contain no LoRA adapters")
    adapter_cfg = {
        "peft_type": "LORA",
        "r": int(lora.r),
        "lora_alpha": float(lora.alpha),
        "use_rslora": bool(lora.use_rslora),
        "target_modules": sorted(targets),
        "bias": "none",
    }
    return sd, adapter_cfg


def export_lora_dir(params: qwen2.Qwen2, lora, out_dir: str) -> None:
    """Write a PEFT adapter directory (adapter_config.json +
    adapter_model.safetensors) loadable by merge_lora_dir and PEFT."""
    sd, acfg = export_lora(params, lora)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(acfg, f, indent=2)
    st.save_file(sd, os.path.join(out_dir, "adapter_model.safetensors"))
