"""Checkpoints of a training run over `torch.save` files (the port's
counterpart of `oryx_tpu.utils.checkpoint.CheckpointManager`; the orbax
format is not read or written).

A checkpoint holds what a run changes: the step, the TRAINABLE parameters
and the whole optimizer state (counts included), so a run resumed from it
continues bit for bit. Frozen parameters never change during training, so
they are not written: a resume rebuilds them from the weights the run
started from (the Trainer's `params`), which at full width spares writing
the frozen ~16 GB of a projector-only run at every save.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")
MAX_TO_KEEP = 3  # the newest checkpoints kept (the JAX manager's default)


class CheckpointManager:
    def __init__(self, directory: str) -> None:
        self.directory = os.path.abspath(directory)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(m.group(1)) for f in os.listdir(self.directory)
            if (m := _NAME.match(f))
        )

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, trainable: list[str], *,
             force: bool = False) -> bool:
        """Write the state at `step` (atomically: a temp file, then a
        rename). `trainable` names the parameters to keep. Returns False
        when a checkpoint of this step exists and not `force`."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            return False
        os.makedirs(self.directory, exist_ok=True)
        params = dict(state.params.named_parameters())
        blob = {
            "step": state.step,
            "params": {n: params[n].detach().cpu() for n in trainable},
            "opt_state": _to_cpu(state.opt_state),
        }
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))
        return True

    def restore(self, state, step: int | None = None):
        """`state` with the saved step, trainable parameters (copied into
        its modules in place) and optimizer state, on its device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        blob = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        params = dict(state.params.named_parameters())
        dev = next(iter(params.values())).device
        with torch.no_grad():
            for n, t in blob["params"].items():
                params[n].copy_(t)
        state.step = int(blob["step"])
        state.opt_state = _to_device(blob["opt_state"], dev)
        return state

    def wait(self) -> None:
        """Saves are synchronous; nothing is pending."""


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    return tree
