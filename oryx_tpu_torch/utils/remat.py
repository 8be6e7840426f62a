"""Rematerialization (gradient-checkpointing) policies (port of
`oryx_tpu.utils.remat`).

`checkpointed(remat, fn, *args)` runs one block (a decoder or ViT layer)
under the policy:
  * "none"     - no checkpointing: every intermediate is kept for the
    backward.
  * "block"    - `torch.utils.checkpoint` (non-reentrant) of the whole block:
    only its inputs survive the forward; the backward recomputes it.
  * "dots"     - "block", but the outputs of the dense products (aten mm,
    addmm, bmm, baddbmm) are saved by selective checkpointing, so the
    recompute runs only the elementwise work. The flash op is not a dot,
    as in JAX; the int8 product has no backward, so nothing of it is saved.
  * "attn"     - "block", but the flash-attention forward is kept: its
    output and logsumexp (the custom op `oryx_torch::flash_fwd_lse`, the
    JAX "flash_out"/"flash_lse" names) are saved, so the recompute does not
    run the attention forward again. The plain attention path has no such
    op and recomputes everything, as "block".
  * "attn_qkv" - "attn" plus the q/k/v projections (`models/qwen2.py`
    computes them under the names "attn_q"/"attn_k"/"attn_v").
  * "attn_o"   - "attn_qkv" plus the o projection ("attn_o").

Selective checkpointing picks by op, and a saved op's output spares the
recompute only that op: the Python code of the block runs again and every
op feeding a saved one still runs. So a name does not ride on an identity
op after the value (rope would still run its projection again); it rides
on the product itself. The model computes a projection's product inside
`named(name)`, and the policy saves the dense products made under a name
it keeps. JAX's names sit after the rope: here the product before the rope
(and before a LoRA residual and the bias) is saved, the same bytes, and
the recompute runs only the rope, the LoRA residual's two thin products
and the adds, which XLA recomputes too. Remat changes no number: the
recompute runs the same deterministic ops, and saved products are the
forward's own.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils import checkpoint as ckpt

POLICIES = ("none", "block", "dots", "attn", "attn_qkv", "attn_o")

# The names each policy saves besides the flash forward.
_SAVED_NAMES = {
    "attn": frozenset(),
    "attn_qkv": frozenset(("attn_q", "attn_k", "attn_v")),
    "attn_o": frozenset(("attn_q", "attn_k", "attn_v", "attn_o")),
}


class _Names(threading.local):
    # The names the running block's policy saves (empty: naming is off) and
    # the name of the product being computed. Thread-local: the recompute
    # runs the block again on the thread that runs the backward.
    saved: frozenset = frozenset()
    current: str | None = None


_NAMES = _Names()


def check_policy(remat: bool | str) -> str:
    """The policy name for a TrainConfig-style value (False/None = "none",
    True = "block"); raises on an unknown policy."""
    if remat in (False, None, "none"):
        return "none"
    if remat in (True, "block"):
        return "block"
    if remat in POLICIES:
        return remat
    raise ValueError(f"unknown remat policy {remat!r}; have {POLICIES}")


def naming() -> bool:
    """Whether the running block's policy saves named products."""
    return bool(_NAMES.saved)


@contextlib.contextmanager
def named(name: str):
    """The dense products computed inside are `name`'s (see the module
    docstring). Callers enter it only when `naming()`."""
    outer, _NAMES.current = _NAMES.current, name
    try:
        yield
    finally:
        _NAMES.current = outer


def _dense_ops():
    aten = torch.ops.aten
    return frozenset((aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default))


@functools.lru_cache(maxsize=None)
def _policy(policy: str):
    """The selective-checkpoint policy function of `policy`."""
    dense = _dense_ops()
    saved = _SAVED_NAMES.get(policy, frozenset())
    # Import order: the op is registered by ops/cuda/flash_attention.
    from oryx_tpu_torch.ops.cuda import flash_attention  # noqa: F401

    flash = torch.ops.oryx_torch.flash_fwd_lse.default

    def fn(ctx, op, *args, **kwargs):
        if policy == "dots":
            keep = op in dense
        else:
            keep = op is flash or (op in dense and _NAMES.current in saved)
        return (ckpt.CheckpointPolicy.MUST_SAVE if keep
                else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)

    return fn


def _naming(fn, saved: frozenset):
    """fn run with `saved` as the names its products may carry; the
    checkpoint's recompute calls this wrapper too."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        outer, _NAMES.saved = _NAMES.saved, saved
        try:
            return fn(*args, **kwargs)
        finally:
            _NAMES.saved = outer

    return run


def checkpointed(remat: bool | str, fn, *args, **kwargs):
    """fn(*args, **kwargs) under the remat policy (see the module
    docstring). Without grad mode, or under "none", a plain call."""
    policy = check_policy(remat)
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {}
    if policy != "block":
        extra["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _policy(policy)
        )
    if _SAVED_NAMES.get(policy):
        fn = _naming(fn, _SAVED_NAMES[policy])
    # No block draws random numbers, so no RNG state is stashed.
    return ckpt.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False, **extra,
        **kwargs,
    )
