"""Seeded weights made on the device in one large draw.

The layout (leaf names and shapes) is given by the caller; every weight
matrix and embedding table is a view into one flat buffer drawn with a
single `torch.randn` call on a generator of the card and scaled by 0.02,
biases are zeros and norm scales ones (the published init scheme). The same
dict of tensors goes to the program and to the reference."""

from __future__ import annotations

import math

import torch

INIT_STD = 0.02


def init_kind(name: str) -> str:
    """"zeros" for biases, "ones" for norm scales, else "normal"."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias":
        return "zeros"
    owner = name.rsplit(".", 2)[-2] if name.count(".") >= 1 else ""
    if "norm" in owner:
        return "ones"
    return "normal"


def make_weights(layout: list[tuple[str, tuple[int, ...]]], seed: int,
                 dtype: torch.dtype, device) -> dict[str, torch.Tensor]:
    """{name: tensor} for `layout` ([(name, shape)], in any order: leaves
    are laid out by name). One normal draw of every "normal" leaf's
    elements, from `seed`."""
    layout = sorted(layout)
    normal = [(n, s) for n, s in layout if init_kind(n) == "normal"]
    total = sum(math.prod(s) for _, s in normal)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    flat.mul_(INIT_STD)
    out: dict[str, torch.Tensor] = {}
    off = 0
    for name, shape in normal:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    for name, shape in layout:
        kind = init_kind(name)
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out
