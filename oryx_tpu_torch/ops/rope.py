"""Rotary position embeddings (port of `oryx_tpu.ops.rope`): HF Qwen2
half-rotation layout, angles and rotation in float32."""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """inv_freq vector, shape [head_dim // 2], float32."""
    exponents = (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim
    )
    return 1.0 / (theta**exponents)


def rope_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions [...] -> each [..., head_dim]
    float32, angles repeated as concat([freqs, freqs]) on the last dim."""
    inv_freq = rope_frequencies(head_dim, theta, device=positions.device)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,
    k: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """q: [B, T, Hq, D], k: [B, T, Hk, D]; cos/sin: [B, T, D]. Rotation in
    fp32, output in the input dtype."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]

    def rot(x):
        xf = x.float()
        return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)
