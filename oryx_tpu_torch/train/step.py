"""Training state and the SFT step (port of `oryx_tpu.train.step`).

One step: for each of the `accum` microbatches, the training forward (ViT ->
compressor -> splice -> decoder, `models/oryx.forward`), the chunked masked
CE, and the gradient of every parameter; then AdamW (train/optimizer.py) on
the trainable ones. As in JAX:
  * compute runs in cfg.dtype: every parameter is read through a cast to
    the compute dtype (`cast_params_for_compute`). Trainable leaves keep an
    fp32 master and the cast sits in the graph, so their gradients arrive in
    fp32. Frozen leaves may be held in the compute dtype already (the
    Trainer does so), since JAX only ever reads them through that cast;
    their gradients then come in that dtype, with the values JAX's fp32
    gradients hold;
  * `grad_norm` is the global norm over EVERY leaf, frozen ones included
    (optax.global_norm of the whole gradient tree), so the backward runs
    through the whole model even when only the projector trains;
  * accumulation is a loop over the leading [accum, ...] axis with the
    gradients summed in fp32 and divided by accum (with accum == 1 the
    gradients are used as they come, JAX's no-scan path);
  * skip_nonfinite_steps keeps the old params and optimizer state when the
    loss or the norm is not finite. The decision reads both on the host
    (one sync before the update); the step counter advances either way.
The numerics probes wait for a later slice.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from oryx_tpu_torch.config import OryxConfig
from oryx_tpu_torch.models import oryx
from oryx_tpu_torch.models.oryx import OryxModel
from oryx_tpu_torch.train.loss import chunked_causal_lm_loss
from oryx_tpu_torch.train.optimizer import AdamW, global_norm

# The collated batch fields (train/data.py); "text_segment_ids" only in a
# sequence-packed text batch (collate_packed_text).
BATCH_FIELDS = (
    "patches", "segment_ids", "pos_coords", "region_ids", "q_region_ids",
    "token_ids", "visual_idx", "is_visual", "attn_mask", "positions",
    "labels", "text_segment_ids",
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: OryxModel
    opt_state: dict[str, Any]


def init_state(model: OryxModel, tx: AdamW) -> TrainState:
    return TrainState(step=0, params=model, opt_state=tx.init(model))


@contextlib.contextmanager
def compute_params(model: torch.nn.Module, dtype: torch.dtype):
    """Within the block, every floating parameter not already in `dtype` is
    replaced on its module by its (differentiable) cast to `dtype`, so the
    model reads the compute copy and the gradients flow back to the
    parameter. The backward must run inside the block too: the remat
    recompute reads the same attributes."""
    swapped = []
    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None and p.is_floating_point() and p.dtype != dtype:
                del mod._parameters[name]
                setattr(mod, name, p.to(dtype))
                swapped.append((mod, name, p))
    try:
        yield
    finally:
        for mod, name, p in swapped:
            delattr(mod, name)
            mod.register_parameter(name, p)


def microbatch_loss(
    params: OryxModel, cfg: OryxConfig, mb: dict[str, torch.Tensor],
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean CE of one microbatch (the collated fields on the device) and its
    metrics. The caller puts the parameters in the compute dtype
    (`compute_params`)."""
    hidden = oryx.forward(
        params, cfg,
        **{k: mb[k] for k in BATCH_FIELDS if k != "labels" and k in mb},
        remat=cfg.train.remat_policy if cfg.train.remat else "none",
        compute_dtype=oryx.compute_dtype(cfg),
        return_hidden=True,
    )
    llm = params.llm
    w = llm.embed.weight if cfg.llm.tie_word_embeddings else llm.lm_head.weight
    return chunked_causal_lm_loss(hidden, w, mb["labels"],
                                  chunk=cfg.train.loss_chunk)


def _grad(loss: torch.Tensor, leaves: list[torch.Tensor]):
    # A leaf the batch does not reach gets zeros, as under jax.grad.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def gradients(
    params: OryxModel, cfg: OryxConfig, batch: dict[str, torch.Tensor],
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(gradient of the mean loss for every parameter in
    `named_parameters` order, loss, supervised token count) over the
    [accum, ...] microbatches of `batch`."""
    leaves = [p for _, p in params.named_parameters()]
    accum = batch["token_ids"].shape[0]
    with compute_params(params, oryx.compute_dtype(cfg)):
        if accum == 1:
            loss, metrics = microbatch_loss(
                params, cfg, {k: v[0] for k, v in batch.items()}
            )
            grads = list(_grad(loss, leaves))
            return grads, loss.detach(), metrics["num_tokens"]
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), device=leaves[0].device)
        ntok = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        for i in range(accum):
            loss, metrics = microbatch_loss(
                params, cfg, {k: v[i] for k, v in batch.items()}
            )
            for acc, g in zip(grads, _grad(loss, leaves)):
                acc += g.float()
            loss_sum = loss_sum + loss.detach()
            ntok = ntok + metrics["num_tokens"]
        return [g / accum for g in grads], loss_sum / accum, ntok


def train_step(
    state: TrainState, batch: dict[str, torch.Tensor], cfg: OryxConfig,
    tx: AdamW,
    mark=None,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimizer step over the `accum` microbatches of `batch` (each
    field [accum, ...] on the parameters' device). Updates the parameters
    IN PLACE (the module of `state.params`) and returns the new state with
    the metrics as device tensors: loss, grad_norm, num_tokens (and
    skipped with skip_nonfinite_steps). `mark(name)`, when given, is
    called after the gradients ("grads") and after the update
    ("update")."""
    params = state.params
    names = [n for n, _ in params.named_parameters()]
    grads, loss, ntok = gradients(params, cfg, batch)
    if mark is not None:
        mark("grads")
    gnorm = global_norm(grads)
    by_name = dict(zip(names, grads))
    metrics = {"loss": loss, "grad_norm": gnorm, "num_tokens": ntok}
    ok = True
    if cfg.train.skip_nonfinite_steps:
        ok = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics["skipped"] = torch.tensor(int(not ok), dtype=torch.int32)
    opt_state = state.opt_state
    if ok:
        current = dict(params.named_parameters())
        updates, opt_state = tx.update(by_name, opt_state, current)
        with torch.no_grad():
            for n, u in updates.items():
                p = current[n]
                p.copy_((p + u).to(p.dtype))
    if mark is not None:
        mark("update")
    return TrainState(state.step + 1, params, opt_state), metrics
