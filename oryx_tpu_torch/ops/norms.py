"""Normalization ops with fp32 internals (port of `oryx_tpu.ops.norms`).

The statistics are always computed in float32 whatever the input dtype,
then cast back. The modules only hold the parameters; their forward calls
the functions.
"""

from __future__ import annotations

import torch
from torch import nn


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as in Qwen2/Llama: variance over the last dim in fp32, the
    normalized activations cast back to the input dtype BEFORE the weight
    multiply (HF `Qwen2RMSNorm`)."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * (1.0 / torch.sqrt(var + eps))
    return (weight * xf.to(dtype)).to(dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm (SigLIP / ViT blocks): mean-subtracted, fp32 statistics."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    xf = (xf - mean) * (1.0 / torch.sqrt(var + eps))
    return (xf * weight.float() + bias.float()).to(dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **factory) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **factory) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, **factory))
        self.bias = nn.Parameter(torch.empty(dim, **factory))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
