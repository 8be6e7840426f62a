"""Masked causal-LM loss (port of `oryx_tpu.train.loss`).

Labels arrive pre-shifted from splice.build_mm_batch (labels[t] is the
target of the prediction at t), so this is a masked softmax cross-entropy
with fp32 accumulation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from oryx_tpu_torch.constants import IGNORE_INDEX


def _stats(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of token losses, supervised count, correct count) of fp32
    logits [..., V] against labels [...]."""
    mask = labels != IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    correct = ((torch.argmax(logits, dim=-1) == safe) & mask).sum()
    return ((logz - gold) * mask).sum(), mask.sum(), correct


def _metrics(tot, n, correct):
    num = torch.clamp(n, min=1)
    loss = tot / num
    return loss, {
        "loss": loss,
        "num_tokens": n.to(torch.int32),
        "accuracy": correct / num,
    }


def causal_lm_loss(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """logits [B, T, V] (any float dtype; promoted to fp32), labels [B, T]
    int with IGNORE_INDEX where unsupervised. Returns (mean CE over the
    supervised tokens, metrics)."""
    return _metrics(*_stats(logits.float(), labels))


def _chunk_stats(hc: torch.Tensor, weight: torch.Tensor,
                 lc: torch.Tensor):
    logits = F.linear(hc, weight.to(hc.dtype)).float()
    return _stats(logits, lc)


def chunked_causal_lm_loss(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Masked CE without materializing [B, T, V] logits.

    hidden [B, T, H] final decoder states; weight [V, H] (lm_head, or the
    embedding table when tied); labels [B, T]. Each sequence chunk projects
    to the vocab and reduces to (loss sum, count, correct) under a
    checkpoint, so one [B, chunk, V] fp32 block lives at a time in the
    forward and in the backward. The dense loss when chunk <= 0, T <= chunk
    or T % chunk (as JAX)."""
    return _metrics(*chunked_causal_lm_sums(hidden, weight, labels,
                                            chunk=chunk))


def chunked_causal_lm_sums(
    hidden: torch.Tensor,
    weight: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk: int = 128,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sum of token losses, supervised count, correct count) of
    `chunked_causal_lm_loss`: what a data- or sequence-parallel rank adds
    to the global mean (parallel/zero.py)."""
    B, T, _ = hidden.shape
    if chunk <= 0 or T <= chunk or T % chunk:
        return _stats(F.linear(hidden, weight.to(hidden.dtype)).float(),
                      labels)
    tot = hidden.new_zeros((), dtype=torch.float32)
    n = torch.zeros((), dtype=torch.int64, device=hidden.device)
    correct = torch.zeros_like(n)
    for lo in range(0, T, chunk):
        hc, lc = hidden[:, lo:lo + chunk], labels[:, lo:lo + chunk]
        if torch.is_grad_enabled():
            dl, dn, dc = ckpt.checkpoint(
                _chunk_stats, hc, weight, lc, use_reentrant=False,
                preserve_rng_state=False,
            )
        else:
            dl, dn, dc = _chunk_stats(hc, weight, lc)
        tot, n, correct = tot + dl, n + dn, correct + dc
    return tot, n, correct
