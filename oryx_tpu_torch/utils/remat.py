"""Rematerialization (gradient-checkpointing) policies (port of
`oryx_tpu.utils.remat`).

`checkpointed(remat, fn, *args)` runs one block (a decoder or ViT layer)
under the policy:
  * "none"  - no checkpointing: every intermediate is kept for the backward.
  * "block" - `torch.utils.checkpoint` (non-reentrant) of the whole block:
    only its inputs survive the forward; the backward recomputes it.
  * "attn"  - "block", but the flash-attention forward is kept: its output
    and logsumexp (the custom op `oryx_torch::flash_fwd_lse`, the JAX
    "flash_out"/"flash_lse" names) are saved by selective checkpointing, so
    the recompute does not run the attention forward again. The plain
    attention path has no such op and recomputes everything, as "block".
Remat changes no number: the recompute runs the same deterministic ops.
"dots", "attn_qkv" and "attn_o" are not ported yet and raise.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as ckpt

POLICIES = ("none", "block", "attn")
NOT_PORTED = ("dots", "attn_qkv", "attn_o")


def check_policy(remat: bool | str) -> str:
    """The policy name for a TrainConfig-style value (False/None = "none",
    True = "block"); raises on a policy the port does not have."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "block"):
        return "block"
    if remat == "attn":
        return "attn"
    if remat in NOT_PORTED:
        raise ValueError(
            f"remat policy {remat!r} is not ported to PyTorch yet; the port "
            f"has {POLICIES}"
        )
    raise ValueError(f"unknown remat policy {remat!r}; have {POLICIES}")


def _keep_flash_forward(ctx, op, *args, **kwargs):
    if op is torch.ops.oryx_torch.flash_fwd_lse.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def checkpointed(remat: bool | str, fn, *args, **kwargs):
    """fn(*args, **kwargs) under the remat policy (see the module
    docstring). Without grad mode, or under "none", a plain call."""
    policy = check_policy(remat)
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {}
    if policy == "attn":
        # Import order: the op is registered by ops/cuda/flash_attention.
        from oryx_tpu_torch.ops.cuda import flash_attention  # noqa: F401

        extra["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _keep_flash_forward
        )
    # No block draws random numbers, so no RNG state is stashed.
    return ckpt.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **extra,
        **kwargs,
    )
