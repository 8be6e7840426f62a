"""Device selection and parameter materialization shared by the models.

Modules are built on the meta device (no memory), then allocated on the
target device in the target dtype and filled with the JAX package's random
init scheme: normal(0, 0.02) for linear and embedding weights, zeros for
biases, ones for norm weights.
"""

from __future__ import annotations

import torch
from torch import nn

from oryx_tpu_torch.ops.norms import LayerNorm, RMSNorm


def resolve_device(device) -> torch.device:
    """The torch.device for `device`. A CUDA device without a card raises:
    entry points never carry on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


def init_draws(module: nn.Module, device: torch.device,
               generator: torch.Generator):
    """The random init of `module` (its shapes; it may sit on the meta
    device), in draw order: (module path, leaf name, the whole fp32
    tensor on `device`). `materialize` copies each into place; a
    tensor-parallel rank keeps its slice of each (parallel/sharding)."""
    for path, m in module.named_modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            yield path, "weight", torch.randn(
                m.weight.shape, generator=generator, device=device,
                dtype=torch.float32,
            ).mul_(0.02)
            if getattr(m, "bias", None) is not None:
                yield path, "bias", torch.zeros(m.bias.shape, device=device)
        elif isinstance(m, (RMSNorm, LayerNorm)):
            yield path, "weight", torch.ones(m.weight.shape, device=device)
            if isinstance(m, LayerNorm):
                yield path, "bias", torch.zeros(m.bias.shape, device=device)


@torch.no_grad()
def materialize(
    module: nn.Module,
    device: torch.device,
    generator: torch.Generator | None,
) -> nn.Module:
    """Allocate a meta-device module on `device` (frozen: inference only).
    With a generator, fill it with the random init (`init_draws`);
    without one, leave the values for the caller to load."""
    module = module.to_empty(device=device).requires_grad_(False)
    if generator is None:
        return module
    for path, leaf, full in init_draws(module, device, generator):
        getattr(module.get_submodule(path), leaf).copy_(full)
    return module


def default_generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
