"""The check that nothing a run loads is JAX or the JAX package.

Names are compared by their top-level part (before the first dot) whole:
`oryx_tpu_torch` is the system under test and begins with `oryx_tpu`."""

from __future__ import annotations

import sys

BANNED = frozenset({"jax", "jaxlib", "flax", "oryx_tpu"})
# What the reference may not load either: the program itself.
PROGRAM = "oryx_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def banned_loaded(modules=None, banned=BANNED) -> list[str]:
    """Sorted top-level names of `modules` (sys.modules by default) that
    are banned."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & set(banned))
