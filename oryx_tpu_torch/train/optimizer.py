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
TUNES = ("full", "projector_only", "no_vision", "lora")


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
    """tune: 'full' | 'projector_only' | 'no_vision' | 'lora' (full
    fine-tuning, stage-1 projector pretraining, frozen vision tower, LoRA
    adapters A/B and the projector with the base model frozen: each
    adapter's `lora_scale` stays frozen)."""
    if tune == "lora":
        return {
            name: name.rsplit(".", 1)[-1] in ("lora_a", "lora_b")
            or name.split(".", 1)[0] == "compressor"
            for name, _ in model.named_parameters()
        }
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
    """ndim of the leaf in the JAX tree (layer-stacked under "layers"): a
    decoder layer's lora_a [in, r] is the JAX [L, in, r], rank 3."""
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
        # {name: gradient} -> a group's clip norm; a ZeRO rank sets its
        # own, which counts each chunk of a sharded gradient once
        # (parallel/zero.RankTrainer.global_norm).
        self.norm_fn = None

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
        new = {"count": dict(state["count"]),
               "lr_count": dict(state["lr_count"]),
               "mu": {n: t.clone() for n, t in state["mu"].items()},
               "nu": {n: t.clone() for n, t in state["nu"].items()}}
        updates: dict[str, torch.Tensor] = {}

        def put(name, sl, u):
            updates[name] = u

        self._walk(grads, new, params, put, None)
        return updates, new

    @torch.no_grad()
    def update_(self, grads: dict[str, torch.Tensor], state: dict,
                params: dict[str, torch.Tensor], after=None,
                elems: int = 1 << 26) -> None:
        """`update` applied in place: the moments in `state` and each
        parameter in `params` (a view may stand for it) are overwritten,
        leaf by leaf in slices of about `elems` elements along the leading
        dim, so no second copy of the state and no tree of updates ever
        lives (the bits are `update`'s, then `p + u`). `after(name)` runs
        once a leaf is done."""
        def put(name, sl, u):
            p = params[name]
            p[sl].copy_((p[sl] + u).to(p.dtype))

        self._walk(grads, state, params, put, elems, after)

    def _walk(self, grads, state, params, put, elems, after=None) -> None:
        """The optimizer step over `state` in place: per group the counts,
        the clip norm, then each trainable leaf's new moments written into
        the state and its update handed to put(name, rows, u), in slices
        of about `elems` elements (None: whole leaves)."""
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        for group in GROUPS:
            names = [n for n in self.trainable() if self.groups[n] == group]
            # The groups' chains run whatever their leaves (optax keeps the
            # counts of an empty group too).
            count = state["count"][group] = state["count"][group] + 1
            lr = self.schedules[group](state["lr_count"][group])
            state["lr_count"][group] += 1
            if not names:
                continue
            gs = {n: grads[n].float() for n in names}
            g_norm = (global_norm(gs.values()) if self.norm_fn is None
                      else self.norm_fn(gs))
            clip = g_norm >= cfg.max_grad_norm
            bc1 = 1 - b1**count
            bc2 = 1 - b2**count
            for n in names:
                p, mu_s, nu_s, g = (params[n], state["mu"][n],
                                    state["nu"][n], gs.pop(n))
                rows = (p.shape[0] if elems is None
                        else max(1, elems // max(1, p[0].numel())))
                for a in range(0, p.shape[0], rows):
                    sl = slice(a, a + rows)
                    u, mu, nu = self._leaf(n, g[sl], g_norm, clip, mu_s[sl],
                                           nu_s[sl], p[sl], bc1, bc2, lr)
                    mu_s[sl].copy_(mu)
                    nu_s[sl].copy_(nu)
                    put(n, sl, u)
                if after is not None:
                    after(n)

    def _leaf(self, name, g, g_norm, clip, mu_old, nu_old, p, bc1, bc2, lr):
        """(the update -lr u, the new mu in moment_dtype, the new nu) of one
        leaf, or of any slice of one: every op is elementwise."""
        cfg = self.cfg
        b1, b2 = cfg.adam_b1, cfg.adam_b2
        g = torch.where(clip, (g / g_norm) * cfg.max_grad_norm, g)
        mu = (1 - b1) * g + b1 * mu_old.float()
        nu = (1 - b2) * (g * g) + b2 * nu_old
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_eps)
        if cfg.weight_decay and _jax_ndim(name, p) >= 2:
            u = u + cfg.weight_decay * p.float()
        return -lr * u, mu.to(self.mu_dtype), nu


def make_optimizer(cfg: TrainConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, model)
