"""AdamW with per-group schedules, per-group clipping and freeze masks (port
of `oryx_tpu.train.optimizer`, in optax's semantics).

The JAX optimizer is `optax.multi_transform` over the groups "llm",
"projector" (the compressor) and "vision" (the ViT), each group the chain
clip_by_global_norm -> scale_by_adam -> add_decayed_weights (ndim >= 2) ->
scale_by_learning_rate, wrapped in `optax.masked` by the trainable mask.
This module computes the same updates on named tensors:
  * the clip norm is taken per group, over that group's trainable leaves;
  * Adam's first moment is kept in `moment_dtype`, the second in fp32, eps
    outside the square root, bias correction with the count incremented
    first;
  * each group's schedule has its own count, starting at 0, so the first
    update has lr(0) (0 under warmup);
  * frozen leaves get no update and no moments;
  * weight decay goes to the leaves of ndim >= 2 IN THE JAX LAYOUT, where
    the leaves of a layer stack carry a leading layer axis: a decoder or
    ViT layer's norm weights and biases are decayed, the final norms and
    the compressor's biases are not.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from oryx_tpu_torch.config import TrainConfig

GROUPS = ("llm", "projector", "vision")
TUNES = ("full", "projector_only", "no_vision")


def group_of(name: str) -> str:
    """The optimizer group of a parameter name ("compressor.q_proj.weight"
    -> "projector")."""
    top = name.split(".", 1)[0]
    if top == "compressor":
        return "projector"
    if top == "vit":
        return "vision"
    return "llm"


def param_groups(model: nn.Module) -> dict[str, str]:
    """Label every parameter 'llm' / 'projector' / 'vision'."""
    return {name: group_of(name) for name, _ in model.named_parameters()}


def trainable_mask(model: nn.Module, tune: str) -> dict[str, bool]:
    """tune: 'full' | 'projector_only' | 'no_vision' (full fine-tuning,
    stage-1 projector pretraining, frozen vision tower). 'lora' waits for
    LoRA in the port's decoder."""
    if tune == "lora":
        raise ValueError("tune='lora' is not ported to PyTorch yet")
    allowed = {
        "full": {"llm", "projector", "vision"},
        "projector_only": {"projector"},
        "no_vision": {"llm", "projector"},
    }
    if tune not in allowed:
        raise ValueError(f"unknown tune {tune!r}; have {TUNES}")
    return {
        name: group in allowed[tune]
        for name, group in param_groups(model).items()
    }


def _jax_ndim(name: str, p: torch.Tensor) -> int:
    """ndim of the leaf in the JAX tree (layer-stacked under "layers")."""
    return p.dim() + (".layers." in f".{name}")


def _linear(init: float, end: float, steps: int):
    def fn(count: int) -> float:
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end

    return fn


def _cosine(init: float, decay_steps: int, alpha: float):
    def fn(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c
                                                         / decay_steps))
                       + alpha)

    return fn


def _join(schedules, boundaries):
    def fn(count: int) -> float:
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return fn


def make_schedule(cfg: TrainConfig, base_lr: float):
    """count -> learning rate, optax's warmup_cosine_decay / linear /
    constant schedules as `oryx_tpu.train.optimizer.make_schedule` builds
    them."""
    warmup = max(1, int(cfg.warmup_ratio * cfg.num_train_steps))
    if cfg.lr_schedule == "cosine":
        decay_steps = max(cfg.num_train_steps, warmup + 1)
        return _join(
            [_linear(0.0, base_lr, warmup),
             _cosine(base_lr, decay_steps - warmup, 0.0)],
            [warmup],
        )
    if cfg.lr_schedule == "linear":
        return _join(
            [_linear(0.0, base_lr, warmup),
             _linear(base_lr, 0.0, max(cfg.num_train_steps - warmup, 1))],
            [warmup],
        )
    if cfg.lr_schedule == "constant":
        return _join([_linear(0.0, base_lr, warmup), lambda c: base_lr],
                     [warmup])
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32 (optax
    global_norm)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    sq = [torch.linalg.vector_norm(t, dtype=torch.float32) ** 2
          for t in tensors]
    return torch.sqrt(torch.stack(sq).sum())


class AdamW:
    """The optimizer of `make_optimizer`. State: per group the Adam count and
    the schedule count (Python ints, as many as optax keeps), per trainable
    leaf `mu` (moment_dtype) and `nu` (fp32)."""

    def __init__(self, cfg: TrainConfig, model: nn.Module) -> None:
        self.cfg = cfg
        self.mask = trainable_mask(model, cfg.tune)
        self.groups = param_groups(model)
        lrs = {
            "llm": cfg.learning_rate,
            "projector": cfg.projector_lr or cfg.learning_rate,
            "vision": cfg.vision_lr or cfg.learning_rate,
        }
        self.schedules = {g: make_schedule(cfg, lr) for g, lr in lrs.items()}
        self.mu_dtype = {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[cfg.moment_dtype]

    def trainable(self) -> list[str]:
        return [n for n, m in self.mask.items() if m]

    def init(self, model: nn.Module) -> dict:
        params = dict(model.named_parameters())
        return {
            "count": {g: 0 for g in GROUPS},
            "lr_count": {g: 0 for g in GROUPS},
            "mu": {n: torch.zeros_like(params[n], dtype=self.mu_dtype)
                   for n in self.trainable()},
            "nu": {n: torch.zeros_like(params[n], dtype=torch.float32)
                   for n in self.trainable()},
        }

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]):
        """(updates {name: tensor} for the trainable leaves, new state).
        `grads` holds at least the trainable leaves' fp32 gradients; the
        old state is left untouched."""
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        new = {"count": dict(state["count"]),
               "lr_count": dict(state["lr_count"]),
               "mu": dict(state["mu"]), "nu": dict(state["nu"])}
        updates: dict[str, torch.Tensor] = {}
        for group in GROUPS:
            names = [n for n in self.trainable() if self.groups[n] == group]
            # The groups' chains run whatever their leaves (optax keeps the
            # counts of an empty group too).
            count = new["count"][group] = state["count"][group] + 1
            lr = self.schedules[group](state["lr_count"][group])
            new["lr_count"][group] = state["lr_count"][group] + 1
            if not names:
                continue
            gs = {n: grads[n].float() for n in names}
            g_norm = global_norm(gs.values())
            clip = g_norm >= cfg.max_grad_norm
            bc1 = 1 - b1**count
            bc2 = 1 - b2**count
            for n in names:
                g = torch.where(clip, (gs[n] / g_norm) * cfg.max_grad_norm,
                                gs[n])
                mu = (1 - b1) * g + b1 * state["mu"][n].float()
                nu = (1 - b2) * (g * g) + b2 * state["nu"][n]
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
                if cfg.weight_decay and _jax_ndim(n, params[n]) >= 2:
                    u = u + cfg.weight_decay * params[n].float()
                updates[n] = -lr * u
                new["mu"][n] = mu.to(self.mu_dtype)
                new["nu"][n] = nu
        return updates, new


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, model)
