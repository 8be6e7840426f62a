"""Debug posture: NaN checks, eager execution and numeric assertions.

The JAX package's utils/debug.py for the port: `nan_checks` arms torch's
anomaly mode with its NaN check (a backward that produces a NaN raises,
naming the forward op that made it), `disable_jit` runs the port's eager
route where a CUDA graph would replay (the dense decode loop and the
engine's pure-decode step), so a bad launch can be bisected op by op, and
`assert_finite_tree` names the non-finite leaves of a parameter or
gradient tree.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator

import torch

from oryx_tpu_torch.ops.cuda import graphs


def enable_nan_checks(enable: bool = True) -> None:
    """Raise at the first NaN a backward produces (torch's anomaly mode
    with its NaN check). Costs a check per autograd node: debug runs
    only."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


@contextlib.contextmanager
def debug_mode(*, nan_checks: bool = True, disable_jit: bool = False
               ) -> Iterator[None]:
    """Scoped debug posture: NaN checks, and with `disable_jit` the eager
    route in place of every CUDA graph. Both are restored on exit."""
    prev_nans = torch.is_anomaly_enabled()
    prev_check = torch.is_anomaly_check_nan_enabled()
    torch.autograd.set_detect_anomaly(nan_checks, check_nan=True)
    try:
        with graphs.routes(not disable_jit):
            yield
    finally:
        torch.autograd.set_detect_anomaly(prev_nans, check_nan=prev_check)


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) over dicts, lists and tuples, the path written as
    jax.tree_util.keystr writes it (`['b']['c']`, `[0]`); a module's
    parameters and buffers by their dotted names."""
    if isinstance(tree, torch.nn.Module):
        for name, t in tree.state_dict(keep_vars=True).items():
            yield name, t
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite_tree(tree, name: str = "tree") -> None:
    """Check that every floating leaf of a tree (tensors or numpy arrays
    in dicts, lists and tuples, or a module) is finite, as after a
    suspect step. Raises FloatingPointError naming the offending leaves;
    integer leaves are skipped."""
    bad = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite leaves in {name}: {bad}")
