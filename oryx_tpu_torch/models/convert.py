"""Convert between the JAX package's parameter tree and the port's modules.

`from_jax_params` takes the tree `oryx_tpu.models.oryx.init_params` builds
(`{"llm", "vit", "compressor"}`, decoder and encoder leaves layer-stacked
`[L, ...]`, linear kernels `[in, out]`) as numpy arrays, and returns an
`OryxModel` on the CPU that computes the same function. `to_jax_layout` is
the way back, for the model's parameters or any tensors named like them
(gradients, Adam moments). numpy only: it never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import compressor as compressor_lib
from oryx_tpu_torch.models import oryx_vit, qwen2
from oryx_tpu_torch.models.oryx import OryxModel
from oryx_tpu_torch.models.params import materialize


def _tensor(arr) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind not in "fiub":  # e.g. ml_dtypes bfloat16
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable, contiguous copy


def _flatten(node: dict, prefix: str, index: int | None,
             out: dict[str, torch.Tensor]) -> None:
    """Tree node -> state-dict entries. A node with a "kernel" is a linear
    layer (transposed to [out, in]); one with a "weight" is a norm or table;
    "layers" holds leaves stacked on a leading layer axis."""
    def take(a):
        return a if index is None else np.asarray(a)[index]

    if "kernel" in node:
        out[f"{prefix}.weight"] = _tensor(np.asarray(take(node["kernel"])).T)
    elif "weight" in node:
        out[f"{prefix}.weight"] = _tensor(take(node["weight"]))
    if "bias" in node:
        out[f"{prefix}.bias"] = _tensor(take(node["bias"]))
    if "kernel" in node or "weight" in node:
        return
    for name, child in node.items():
        sub = f"{prefix}.{name}" if prefix else name
        if name == "layers":
            leaf = child
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            for i in range(np.asarray(leaf).shape[0]):
                _flatten(child, f"{sub}.{i}", i, out)
        else:
            _flatten(child, sub, index, out)


def from_jax_params(tree: dict, cfg: OryxConfig) -> OryxModel:
    """The port's OryxModel (CPU, the arrays' dtype) holding `tree`."""
    state: dict[str, torch.Tensor] = {}
    _flatten(tree, "", None, state)
    dtype = state["llm.embed.weight"].dtype
    factory = dict(device="meta", dtype=dtype)
    model = OryxModel(
        qwen2.Qwen2(cfg.llm, **factory),
        oryx_vit.OryxViT(cfg.vision, **factory),
        compressor_lib.Compressor(cfg.vision, cfg.llm, **factory),
    )
    model = materialize(model, torch.device("cpu"), None)
    model.load_state_dict(state, strict=True)
    return model


def to_jax_layout(model: nn.Module,
                  values: dict[str, torch.Tensor] | None = None) -> dict:
    """The JAX tree layout of `values` ({parameter name: tensor}, default
    the model's parameters) as float32 numpy: linear weights transposed to
    `kernel` [in, out], norms and tables as `weight`, and the leaves under
    each "layers" list stacked on a leading layer axis."""
    if values is None:
        values = dict(model.named_parameters())
    tree: dict = {}
    for mod_name, mod in model.named_modules():
        leaves = {}
        for pname, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{pname}" if mod_name else pname
            if full not in values:
                continue
            a = values[full].detach().float().cpu().numpy()
            if isinstance(mod, nn.Linear) and pname == "weight":
                leaves["kernel"] = a.T
            else:
                leaves[pname] = a
        if not leaves:
            continue
        node = tree
        parts = mod_name.split(".")
        for i, part in enumerate(parts):
            if part.isdigit():
                continue
            if i + 1 < len(parts) and parts[i + 1].isdigit():
                # A layer of a stack: collect per layer, stacked below.
                layers = node.setdefault(part, {})
                for leaf_name, a in leaves.items():
                    sub = layers
                    for r in parts[i + 2:]:
                        sub = sub.setdefault(r, {})
                    sub.setdefault(leaf_name, []).append(a)
                break
            node = node.setdefault(part, {})
        else:
            node.update(leaves)
    return _stack(tree)


def _stack(node):
    if isinstance(node, dict):
        return {k: _stack(v) for k, v in node.items()}
    if isinstance(node, list):
        return np.stack(node)
    return node
