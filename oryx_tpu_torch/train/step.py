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
    (one sync before the update); the step counter advances either way;
  * numerics=True adds the utils/numerics.py probes to the metrics:
    `act_absmax` (the final hidden state, the max over the microbatches),
    `grad_absmax` (the fp32 gradient tree), `param_absmax` (the params
    before the update) and `grad_layer_absmax` ([L] over the decoder
    layers' gradients). They only read values the step computed, as
    device reductions queued before the in-place update, so the update,
    the loss and the norm are the bits of numerics=False, and they add no
    host sync.
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
from oryx_tpu_torch.utils import numerics as numerics_lib

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
    recompute reads the same attributes. On a ZeRO-3 rank
    (parallel/zero.py) the model's sharded leaves are gathered instead:
    those of the decoder and ViT layers as each layer runs."""
    zero = getattr(model, "zero", None)
    if zero is not None:
        with zero.compute(model, dtype):
            yield
        return
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
    numerics: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean CE of one microbatch (the collated fields on the device) and its
    metrics, with `act_absmax` (the final hidden state's absmax) when
    `numerics`. The caller puts the parameters in the compute dtype
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
    loss, metrics = chunked_causal_lm_loss(hidden, w, mb["labels"],
                                           chunk=cfg.train.loss_chunk)
    if numerics:
        metrics = dict(metrics, act_absmax=numerics_lib.tree_absmax(hidden))
    return loss, metrics


def _grad(loss: torch.Tensor, leaves: list[torch.Tensor]):
    # A leaf the batch does not reach gets zeros, as under jax.grad.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def gradients(
    params: OryxModel, cfg: OryxConfig, batch: dict[str, torch.Tensor],
    *, probes: dict[str, torch.Tensor] | None = None,
) -> tuple[list[torch.Tensor], torch.Tensor, torch.Tensor]:
    """(gradient of the mean loss for every parameter in
    `named_parameters` order, loss, supervised token count) over the
    [accum, ...] microbatches of `batch`. A `probes` dict receives
    `act_absmax`, the max over the microbatches."""
    leaves = [p for _, p in params.named_parameters()]
    accum = batch["token_ids"].shape[0]
    numerics = probes is not None
    acts = []
    with compute_params(params, oryx.compute_dtype(cfg)):
        if accum == 1:
            loss, metrics = microbatch_loss(
                params, cfg, {k: v[0] for k, v in batch.items()}, numerics
            )
            grads = list(_grad(loss, leaves))
            if numerics:
                probes["act_absmax"] = metrics["act_absmax"]
            return grads, loss.detach(), metrics["num_tokens"]
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        loss_sum = torch.zeros((), device=leaves[0].device)
        ntok = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
        for i in range(accum):
            loss, metrics = microbatch_loss(
                params, cfg, {k: v[i] for k, v in batch.items()}, numerics
            )
            for acc, g in zip(grads, _grad(loss, leaves)):
                acc += g.float()
            loss_sum = loss_sum + loss.detach()
            ntok = ntok + metrics["num_tokens"]
            if numerics:
                acts.append(metrics["act_absmax"])
        if numerics:
            probes["act_absmax"] = torch.stack(acts).amax()
        return [g / accum for g in grads], loss_sum / accum, ntok


def _layer_grads(names: list[str], grads: list[torch.Tensor],
                 num_layers: int) -> list[list[torch.Tensor]]:
    """The gradients of each decoder layer (`llm.layers.<i>.`), by layer."""
    out: list[list[torch.Tensor]] = [[] for _ in range(num_layers)]
    for n, g in zip(names, grads):
        if n.startswith("llm.layers."):
            out[int(n.split(".", 3)[2])].append(g)
    return out


def train_step(
    state: TrainState, batch: dict[str, torch.Tensor], cfg: OryxConfig,
    tx: AdamW,
    mark=None,
    numerics: bool = False,
) -> tuple[TrainState, dict[str, torch.Tensor]]:
    """One optimizer step over the `accum` microbatches of `batch` (each
    field [accum, ...] on the parameters' device). Updates the parameters
    IN PLACE (the module of `state.params`) and returns the new state with
    the metrics as device tensors: loss, grad_norm, num_tokens (and
    skipped with skip_nonfinite_steps; with `numerics`, the probes of the
    module docstring). `mark(name)`, when given, is called after the
    gradients ("grads") and after the update ("update")."""
    params = state.params
    names = [n for n, _ in params.named_parameters()]
    probes = {} if numerics else None
    grads, loss, ntok = gradients(params, cfg, batch, probes=probes)
    if mark is not None:
        mark("grads")
    gnorm = global_norm(grads)
    by_name = dict(zip(names, grads))
    metrics = {"loss": loss, "grad_norm": gnorm, "num_tokens": ntok}
    if numerics:
        # Queued before the in-place update below: param_absmax reads the
        # params the step started from.
        metrics["act_absmax"] = probes["act_absmax"]
        metrics["grad_absmax"] = numerics_lib.tree_absmax(grads)
        metrics["param_absmax"] = numerics_lib.tree_absmax(params)
        metrics["grad_layer_absmax"] = numerics_lib.layer_absmax(
            _layer_grads(names, grads, cfg.llm.num_layers))
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
