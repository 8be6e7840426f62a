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


@torch.no_grad()
def materialize(
    module: nn.Module,
    device: torch.device,
    generator: torch.Generator | None,
) -> nn.Module:
    """Allocate a meta-device module on `device` (frozen: inference only).
    With a generator, fill it with the random init; without one, leave the
    values for the caller to load."""
    module = module.to_empty(device=device).requires_grad_(False)
    if generator is None:
        return module
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            w = torch.randn(
                m.weight.shape, generator=generator, device=device,
                dtype=torch.float32,
            )
            m.weight.copy_(w * 0.02)
            if getattr(m, "bias", None) is not None:
                m.bias.zero_()
        elif isinstance(m, (RMSNorm, LayerNorm)):
            m.weight.fill_(1.0)
            if isinstance(m, LayerNorm):
                m.bias.zero_()
    return module


def default_generator(device: torch.device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
