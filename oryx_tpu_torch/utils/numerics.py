"""Numerics sentinels: tensor-stat probes for serving and training (port of
`oryx_tpu.utils.numerics`).

  * In-dispatch logit probes (`init_logit_stats` / `accumulate_logit_stats`
    / `finalize_logit_stats`): a [6] float32 accumulator that rides inside
    an existing engine step (models/generate.paged_decode_chunk /
    paged_ragged_step / paged_fused_steps under `numerics=True`): finite
    fraction, absmax, rms, softmax entropy and top-1 margin over the
    step's live decode rows. It reads the logits the sampler already has,
    so the token streams are those of the unarmed step, and it adds no
    dispatch; on the card the armed step is a CUDA graph of its own.
  * Tree probes for the trainer (`tree_absmax`, `layer_absmax`, and
    `stacked_layer_absmax` for a stacked tree): whole-tree and per-layer
    absmax of gradients, parameters or activations, reduced on the
    leaves' device (train/step.py under `numerics=True`).

Both feed the raw-named ``oryx_numerics_*`` families and the
utils/anomaly.py sentinels (`entropy_collapse`, `absmax_explosion`).
The reductions are plain PyTorch: the JAX package computes them in XLA,
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

# The scalar slots of the [6] accumulator and of the finalized dict.
# `finite_frac` is a fraction in [0, 1]; `absmax` a max over every
# observed row; the rest are per-row means.
NUMERICS_STAT_KEYS = (
    "rows", "finite_frac", "absmax", "rms", "entropy", "top1_margin",
)

# The raw-named gauge families the probes feed.
NUMERICS_GAUGES = (
    "oryx_numerics_logits_finite_frac",
    "oryx_numerics_logits_absmax",
    "oryx_numerics_logits_rms",
    "oryx_numerics_logits_entropy",
    "oryx_numerics_logits_top1_margin",
)


def init_logit_stats(device=None) -> torch.Tensor:
    """A fresh accumulator [rows, finite_sum, absmax, rms_sum,
    entropy_sum, margin_sum] in float32 (sums over rows; the finalizer
    divides)."""
    return torch.zeros((len(NUMERICS_STAT_KEYS),), dtype=torch.float32,
                       device=device)


def accumulate_logit_stats(
    acc: torch.Tensor,  # [6] float32 (init_logit_stats)
    logits: torch.Tensor,  # [S, V]
    live: torch.Tensor,  # [S] bool: rows that really decoded this step
) -> torch.Tensor:
    """Fold one step's live-row logit stats into the accumulator, on the
    logits' device with no host read. Dead rows contribute nothing (their
    logits are frozen filler). Non-finite values are zeroed inside each
    reduction, so a NaN row shows as finite_frac < 1 instead of turning
    the accumulator into NaN."""
    x = logits.to(torch.float32)
    finite = torch.isfinite(x)
    safe = torch.where(finite, x, torch.zeros((), device=x.device))
    w = live.to(torch.float32)  # [S]
    finite_frac = finite.to(torch.float32).mean(dim=-1)  # [S]
    absmax_row = safe.abs().amax(dim=-1)  # [S]
    rms_row = torch.sqrt((safe * safe).mean(dim=-1))  # [S]
    # Entropy and margin of the zeroed logits: a NaN row's softmax means
    # nothing either way, and finite_frac flags it.
    p = torch.softmax(safe, dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    ent_row = -(p * torch.log(p.clamp_min(tiny))).sum(dim=-1)
    top2 = torch.topk(safe, 2, dim=-1).values  # [S, 2]
    margin_row = top2[:, 0] - top2[:, 1]
    row_max = torch.where(live, absmax_row, torch.zeros_like(absmax_row))
    return acc + torch.stack([
        w.sum(),
        (w * finite_frac).sum(),
        # absmax is a max, not a sum: the slot gains (new max - old).
        torch.maximum(row_max.max(), acc[2]) - acc[2],
        (w * rms_row).sum(),
        (w * ent_row).sum(),
        (w * margin_row).sum(),
    ])


def finalize_logit_stats(acc: Any) -> dict[str, float] | None:
    """Host side: the accumulator (a tensor or numpy) -> a dict keyed by
    NUMERICS_STAT_KEYS; None when no live row was observed."""
    if isinstance(acc, torch.Tensor):
        acc = acc.detach().cpu().numpy()
    a = np.asarray(acc, np.float64)
    rows = float(a[0])
    if rows <= 0:
        return None
    return {
        "rows": rows,
        "finite_frac": float(a[1] / rows),
        "absmax": float(a[2]),
        "rms": float(a[3] / rows),
        "entropy": float(a[4] / rows),
        "top1_margin": float(a[5] / rows),
    }


# ---------------------------------------------------------------------------
# Tree probes (trainer grads / activations)
# ---------------------------------------------------------------------------


def _leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a module (its parameters), a tensor, or a nested
    dict / list / tuple of them."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def tree_absmax(tree: Any) -> torch.Tensor:
    """Scalar float32 absmax over every floating leaf of a tree (0 when it
    has none), reduced on the first leaf's device: no host sync."""
    maxes = [
        leaf.detach().abs().amax().to(torch.float32)
        for leaf in _leaves(tree)
        if leaf.is_floating_point() and leaf.numel()
    ]
    if not maxes:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([m.to(maxes[0].device) for m in maxes]).amax()


def layer_absmax(layers: list[Any]) -> torch.Tensor:
    """Per-layer absmax [L] float32 over a list of per-layer trees, each
    over its floating leaves of rank >= 1: `stacked_layer_absmax` of the
    JAX layout, where the decoder's layers are stacked on a leading axis
    and its rank >= 2 rule skips what is a scalar a layer."""
    return torch.stack([
        torch.stack([leaf.detach().abs().amax().to(torch.float32)
                     for leaf in _leaves(layer)
                     if leaf.is_floating_point() and leaf.dim() >= 1]).amax()
        for layer in layers
    ])


def stacked_layer_absmax(layers: Any) -> torch.Tensor | None:
    """Per-layer absmax [L] float32 over a stacked-layer subtree: every
    floating leaf of rank >= 2 carries the leading [L] axis (leaves on
    another leading size are skipped). None when there is nothing to
    reduce."""
    per_leaf = []
    L = None
    for leaf in _leaves(layers):
        if not (leaf.is_floating_point() and leaf.dim() >= 2):
            continue
        if L is None:
            L = leaf.shape[0]
        if leaf.shape[0] != L:
            continue
        x = leaf.detach().abs().to(torch.float32).reshape(L, -1)
        per_leaf.append(x.amax(dim=-1))
    if not per_leaf:
        return None
    return torch.stack([x.to(per_leaf[0].device) for x in per_leaf]
                       ).amax(dim=0)


def is_finite(value: Any) -> bool:
    try:
        return math.isfinite(float(value))
    except (TypeError, ValueError):
        return False
