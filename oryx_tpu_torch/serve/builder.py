"""Model builder: tokenizer, weights and config from a checkpoint directory
(port of `oryx_tpu.serve.builder`).

A checkpoint is either
  * the port's own directory: `oryx_config.json` (the config's JSON) and
    `model.safetensors` (the model's state dict under the port's names;
    shards with `model.safetensors.index.json` load too), written by
    `save_pretrained`; or
  * a pair of HF safetensors directories (LLM and vision tower), imported
    through models/import_hf.py with a fresh compressor or one merged from
    a projector npz (`load_from_hf`), as `export_hf` writes them.
The JAX package's native directory is an orbax checkpoint, which the port
neither reads nor writes: weights cross between the packages through the
HF route, which both read and write.

Files are read memory-mapped (utils/safetensors.py) and every tensor is
cast, or quantized, onto the target device one at a time: with
`quantize="int8"` the full float tree never lands on the card.

Not ported: sharded loading over a mesh (`mesh=`, `shard=`,
`sharding_mode=`, `serving_param_shardings`) waits for parallelism;
passing it raises NotImplementedError.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import compressor as compressor_lib
from oryx_tpu_torch.models import import_hf
from oryx_tpu_torch.models.oryx import OryxModel, empty_model
from oryx_tpu_torch.models.params import default_generator, resolve_device
from oryx_tpu_torch.models.qwen2 import lora_shells
from oryx_tpu_torch.utils import checkpoint as ckpt_lib
from oryx_tpu_torch.utils import safetensors as st
from oryx_tpu_torch.utils.quant import cast_params, q8_shells, quantize_params

CONFIG_NAME = "oryx_config.json"
WEIGHTS_NAME = "model.safetensors"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to oryx_tpu_torch yet (ROADMAP.md Queue 1, "
        f"{item})")


def _single_device(mesh=None, shard=None, sharding_mode=None) -> None:
    for name, value in (("mesh", mesh), ("shard", shard),
                        ("sharding_mode", sharding_mode)):
        if value is not None:
            raise _not_ported(f"{name}= (sharded serving)",
                              "item 4, parallelism")


def _model_of(state_or_params) -> OryxModel:
    """The OryxModel itself, or a training state's `.params`."""
    model = getattr(state_or_params, "params", state_or_params)
    if not isinstance(model, OryxModel):
        raise TypeError(f"expected an OryxModel or a state holding one, got "
                        f"{type(state_or_params).__name__}")
    return model


def save_pretrained(directory: str, cfg: OryxConfig, state_or_params: Any,
                    *, step: int = 0) -> None:
    """Write a directory `load_pretrained_model` reads: `oryx_config.json`
    and the model's tensors (an OryxModel, or a training state's
    `.params`; float or int8) as `model.safetensors`, with the step in its
    metadata."""
    model = _model_of(state_or_params)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, CONFIG_NAME), "w") as f:
        f.write(cfg.to_json())
    st.save_file(model.state_dict(), os.path.join(directory, WEIGHTS_NAME),
                 metadata={"format": "pt", "step": str(step)})


def load_tokenizer(model_path: str):
    """HF tokenizer from the checkpoint directory (tokenizer.json et al.)."""
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_path, use_fast=True)


def load_pretrained_model(
    model_path: str,
    *,
    tokenizer_path: str | None = None,
    tokenizer: Any | None = None,
    cfg: OryxConfig | None = None,
    dtype: torch.dtype = torch.float32,
    mesh=None,
    sharding_mode: str | None = None,
    quantize: str | None = None,
    device="cuda",
) -> tuple[Any, OryxModel, OryxConfig]:
    """Load (tokenizer, model, cfg) from a `save_pretrained` directory.

    tokenizer_path defaults to model_path; pass the HF backbone directory
    when the model directory has no tokenizer files, or pass `tokenizer`.
    dtype: the float leaves' dtype on `device` (fp32 by default, as the JAX
    package). quantize="int8": weight-only per-channel int8
    (utils/quant.py), each large weight quantized on `device` from its
    stored dtype, straight off the memory-mapped file, the other leaves
    cast to `dtype`."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r}: int8 or None")
    _single_device(mesh=mesh, sharding_mode=sharding_mode)
    dev = resolve_device(device)
    cfg_file = os.path.join(model_path, CONFIG_NAME)
    if cfg is None:
        if not os.path.exists(cfg_file):
            raise FileNotFoundError(
                f"{cfg_file} not found; pass cfg= explicitly or use "
                "load_from_hf() for raw HF checkpoints"
            )
        with open(cfg_file) as f:
            cfg = OryxConfig.from_json(f.read())
    try:
        state = st.load_safetensors_dir(model_path)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no safetensors checkpoint under {model_path}") from None

    model = lora_shells(q8_shells(empty_model(cfg), state), state)
    model.load_state_dict(state, strict=True, assign=True)
    model.requires_grad_(False)
    del state

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dev, dtype if t.is_floating_point() else None)

    if quantize == "int8":
        params = quantize_params(model, cast=cast, device=dev)
    else:
        params = cast_params(model, cast, device=dev)
    if tokenizer is None:
        tokenizer = load_tokenizer(tokenizer_path or model_path)
    return tokenizer, params, cfg


def load_from_hf(
    llm_path: str,
    vision_path: str,
    cfg: OryxConfig,
    *,
    projector_path: str | None = None,
    lora_path: str | None = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    tokenizer: Any | None = None,
    device="cuda",
) -> tuple[Any, OryxModel, OryxConfig]:
    """Assemble the model from HF safetensors checkpoints: a Qwen2/Yi LLM
    (with the PEFT adapter directory `lora_path` merged into it when
    given), a SigLIP-family tower and a compressor, merged from a projector
    npz when `projector_path` is given, else initialized from a
    torch.Generator seeded with `seed` (the port's own weights: the JAX
    package draws them from jax.random)."""
    dev = resolve_device(device)
    llm = import_hf.import_qwen2(st.load_safetensors_dir(llm_path), cfg.llm,
                                 dtype, dev)
    if lora_path is not None:
        import_hf.merge_lora_dir(llm, lora_path, cfg.llm)
    model = OryxModel(
        llm,
        import_hf.import_siglip(st.load_safetensors_dir(vision_path),
                                cfg.vision, dtype, dev),
        compressor_lib.init_params(
            cfg.compressor, cfg.vision, cfg.llm,
            default_generator(dev, seed), device=dev, dtype=dtype),
    )
    if projector_path is not None:
        ckpt_lib.load_projector_only(projector_path, model)
    if tokenizer is None:
        tokenizer = load_tokenizer(llm_path)
    return tokenizer, model, cfg


def load_pipeline(
    model_path: str,
    *,
    tokenizer_path: str | None = None,
    tokenizer: Any | None = None,
    shard: str | None = None,
    mesh=None,
    sharding_mode: str | None = None,
    template: str = "qwen",
    quantize: str | None = None,
    device="cuda",
):
    """One-call serving setup: (optionally int8-quantized) model load, then
    the port's `Pipeline` on `device`."""
    from oryx_tpu_torch.serve.pipeline import Pipeline

    _single_device(mesh=mesh, shard=shard, sharding_mode=sharding_mode)
    tokenizer, params, cfg = load_pretrained_model(
        model_path, tokenizer_path=tokenizer_path, tokenizer=tokenizer,
        quantize=quantize, device=device,
    )
    return Pipeline(tokenizer, params, cfg, template=template, device=device)


def export_hf(directory: str, cfg: OryxConfig, params: Any) -> None:
    """Write a reference-layout checkpoint (LLM and vision safetensors, the
    projector npz) for users of the reference stack."""
    import_hf.save_hf_checkpoint(_model_of(params), cfg.llm, cfg.vision,
                                 directory)
