"""Checkpoints of a training run over `torch.save` files (the port's
counterpart of `oryx_tpu.utils.checkpoint.CheckpointManager`; the orbax
format is not read or written).

A checkpoint holds what a run changes: the step, the TRAINABLE parameters
and the whole optimizer state (counts included), so a run resumed from it
continues bit for bit. Frozen parameters never change during training, so
they are not written: a resume rebuilds them from the weights the run
started from (the Trainer's `params`), which at full width spares writing
the frozen ~16 GB of a projector-only run at every save.

Saves retry transient failures under a bounded backoff policy
(utils/retry.py), and the fault sites `checkpoint_save` (before each
attempt) and `checkpoint_restore` sit where the reference plants them.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable

import torch

from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils.retry import BackoffPolicy, retry_call

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """step_<N>.pt files under `directory`, the newest `max_to_keep` kept.
    save_retry: the backoff policy of a failed save (default 3 retries,
    0.5 s doubling to at most 10 s); `save_retries` counts the recoveries.
    `sleep` is injectable so tests pin the schedule without waiting."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_retry: BackoffPolicy | None = None,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._save_retry = save_retry or BackoffPolicy(
            retries=3, base_s=0.5, factor=2.0, max_s=10.0
        )
        self._sleep = sleep
        self.save_retries = 0

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
        rename), retrying transient failures per `save_retry`; the fault
        site `checkpoint_save` fires before each attempt. `trainable` names
        the parameters to keep. Returns False when a checkpoint of this
        step exists and not `force`."""
        path = self._path(step)
        if os.path.exists(path) and not force:
            return False
        params = dict(state.params.named_parameters())
        blob = {
            "step": state.step,
            "params": {n: params[n].detach().cpu() for n in trainable},
            "opt_state": _to_cpu(state.opt_state),
        }

        def attempt() -> bool:
            faults.fault_point("checkpoint_save")
            os.makedirs(self.directory, exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            torch.save(blob, tmp)
            os.replace(tmp, path)
            return True

        def count(_attempt, _exc, _delay) -> None:
            self.save_retries += 1

        retry_call(
            attempt, policy=self._save_retry, retry_on=(Exception,),
            sleep=self._sleep, on_retry=count,
            describe=f"checkpoint save (step {step})",
        )
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state, step: int | None = None):
        """`state` with the saved step, trainable parameters (copied into
        its modules in place) and optimizer state, on its device."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        faults.fault_point("checkpoint_restore")
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


# ---------------------------------------------------------------------------
# Projector-only npz (the JAX package's format, both ways)
# ---------------------------------------------------------------------------


def _npz_path(path: str) -> str:
    """np.savez appends '.npz' when missing but np.load does not; normalize
    so save/load round-trip on the same argument."""
    return path if path.endswith(".npz") else path + ".npz"


def _compressor_leaves(model) -> dict[str, torch.Tensor]:
    """The compressor's parameters under the JAX tree's '/'-joined keys
    ('q_proj/kernel' [in, out], 'norm_q/weight', 'projector/fc1/bias', ...)."""
    from torch import nn

    from oryx_tpu_torch.utils.quant import Q8Embedding, Q8Linear

    comp = getattr(model, "params", model).compressor
    out = {}
    for mod_name, mod in comp.named_modules():
        if isinstance(mod, (Q8Linear, Q8Embedding)):
            raise ValueError(
                f"compressor.{mod_name} is int8: the projector npz holds the "
                "float model's weights")
        for pname, p in mod.named_parameters(recurse=False):
            leaf = "kernel" if isinstance(mod, nn.Linear) and \
                pname == "weight" else pname
            key = "/".join([*mod_name.split("."), leaf] if mod_name
                           else [leaf])
            out[key] = p
    return out


def save_projector_only(path: str, params) -> None:
    """Write the compressor's weights alone as a flat npz (the reference's
    `mm_projector.bin` analog; `oryx_tpu.utils.checkpoint
    .save_projector_only`'s keys, shapes and [in, out] kernels). bf16
    leaves are written as fp32 (exact). Atomic: a temp sibling, then
    os.replace, so a crash never leaves a torn file at `path`."""
    import numpy as np

    arrays = {}
    for key, p in _compressor_leaves(params).items():
        a = p.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.numpy()
        arrays[key] = a.T if key.endswith("kernel") else a
    final = _npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(final)), exist_ok=True)
    tmp = final + ".tmp"
    try:
        np.savez(tmp, **arrays)
        written = tmp if os.path.exists(tmp) else _npz_path(tmp)
        os.replace(written, final)
    finally:
        for leftover in (tmp, _npz_path(tmp)):
            if os.path.exists(leftover):
                os.remove(leftover)


def load_projector_only(path: str, params):
    """Copy a projector-only npz into the model's compressor, in place
    (keys the file lacks keep their values), each array cast to its
    parameter's dtype; raw 2-byte arrays (bf16 written by the JAX package)
    are read as bf16. Returns the model."""
    import numpy as np

    leaves = _compressor_leaves(params)
    with np.load(_npz_path(path)) as data, torch.no_grad():
        for key, p in leaves.items():
            if key not in data:
                continue
            a = data[key]
            t = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
                 if a.dtype.kind == "V" and a.dtype.itemsize == 2
                 else torch.from_numpy(np.array(a)))
            if key.endswith("kernel"):
                t = t.T
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}: npz shape {tuple(t.shape)} vs "
                                 f"parameter {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return params
