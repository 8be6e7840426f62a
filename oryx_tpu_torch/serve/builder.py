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

Sharded loading (`mesh=` / `shard="tp=N"` or `"fsdp=N"`): every rank cuts
its own slices off the memory-mapped file
(parallel/sharding.CheckpointParams), so no rank holds the whole tree.
int8 weights with a mesh raise, as in the JAX package.
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


def shard_pipeline(model_path: str, shard: str | None, *, tokenizer_path=None,
                   tokenizer=None, template: str = "qwen",
                   quantize: str | None = None, device="cuda"):
    """The entry points' pipeline: `--shard` parsed as JAX parses it (a
    malformed value raises ValueError), then `load_pipeline`. With tp=N or
    fsdp=N this process becomes rank 0 of N ranks it starts itself, rank r on cuda:(r % device_count) (or the CPU
    with device="cpu"; "cuda" without a card raises); the backend is
    printed at start-up."""
    from oryx_tpu_torch.parallel.mesh import parse_shard_arg

    if shard is not None and quantize:
        raise ValueError("--quantize is single-chip serving; drop --shard")
    mesh, mode = parse_shard_arg(shard, device=device)
    return load_pipeline(model_path, tokenizer_path=tokenizer_path,
                         tokenizer=tokenizer, template=template,
                         quantize=quantize, device=device, mesh=mesh,
                         sharding_mode=mode if mesh is not None else None)


def serving_param_shardings(mesh, params_like, mode: str = "tp"):
    """Inference-time placement over a mesh: {parameter name: this rank's
    `sharding.Placement`}. "tp" splits weights over attention heads / MLP
    columns (the zero2 rules: embeddings and norms whole); "fsdp" splits
    the decoder's and the ViT's layer leaves on their embed axis, each
    layer gathered as it runs (`sharding.serving_shardings`).
    params_like may be a meta-device model (`oryx.empty_model(cfg)`)."""
    from oryx_tpu_torch.parallel import sharding as sharding_lib

    return sharding_lib.serving_shardings(mesh, params_like, mode)


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
    cast to `dtype`.

    mesh: a serving mesh (parallel/mesh.py, tp or fsdp). The weights come back
    as `sharding.CheckpointParams`, which `Pipeline(mesh=)` resolves on
    every rank to that rank's slices, each read off the memory-mapped
    file: no rank ever holds the whole tree. Mutually exclusive with
    quantize."""
    if quantize not in (None, "int8"):
        raise ValueError(f"quantize={quantize!r}: int8 or None")
    if quantize and mesh is not None:
        raise ValueError(
            "quantize='int8' is single-chip serving; drop --shard "
            "(sharded serving splits the float weights instead)"
        )
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
    if mesh is not None:
        from oryx_tpu_torch.parallel import sharding as sharding_lib

        serving_param_shardings(mesh, empty_model(cfg),
                                sharding_mode or "tp")
        if tokenizer is None:
            tokenizer = load_tokenizer(tokenizer_path or model_path)
        return tokenizer, sharding_lib.CheckpointParams(
            model_path, dtype), cfg
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
    the port's `Pipeline` on `device`. shard ("tp=N", as `--shard`) or
    mesh: tensor-parallel serving over N ranks (parallel/), this process
    rank 0 on the world's first device, which must be of `device`'s type
    ("cuda" without a card raises)."""
    from oryx_tpu_torch.parallel.mesh import parse_shard_arg
    from oryx_tpu_torch.serve.pipeline import Pipeline

    if shard is not None:
        if mesh is not None:
            raise ValueError("pass shard= or mesh=, not both")
        mesh, sharding_mode = parse_shard_arg(shard, device=device)
    if mesh is not None:
        from oryx_tpu_torch.parallel import tp as tp_lib

        world = tp_lib.current()
        if resolve_device(device).type != world.device.type:
            raise ValueError(
                f"device={str(device)!r}, but the tp ranks run on "
                f"{world.device.type}")
        device = world.device
    tokenizer, params, cfg = load_pretrained_model(
        model_path, tokenizer_path=tokenizer_path, tokenizer=tokenizer,
        quantize=quantize, device=device, mesh=mesh,
        sharding_mode=sharding_mode,
    )
    return Pipeline(tokenizer, params, cfg, template=template, device=device,
                    mesh=mesh, sharding_mode=sharding_mode or "tp")


def export_hf(directory: str, cfg: OryxConfig, params: Any) -> None:
    """Write a reference-layout checkpoint (LLM and vision safetensors, the
    projector npz) for users of the reference stack."""
    import_hf.save_hf_checkpoint(_model_of(params), cfg.llm, cfg.vision,
                                 directory)
