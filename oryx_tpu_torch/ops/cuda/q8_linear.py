"""The int8-weight product: the hand-written Hopper kernels and their plain twin.

`q8_linear(x, q, scale, bias)` computes x . deq(q, scale)^T (+ bias) in x's
dtype, with deq = q.to(dt) * scale.to(dt): the JAX package's
`x @ Q8Weight.astype(x.dtype)` (`oryx_tpu/utils/quant.py:68`), which XLA
fuses into the matmul's operand read. The scale is one per output channel
([N], a linear layer) or, with `column_scale=True`, one per input column
([K]: the tied head, whose weight is the int8 embedding table).
`q8_linear_group(x, members)` computes several such products of one x in
one launch (q/k/v, gate/up), each output with the bits of its own call.
No Pallas kernel computes it; the CUDA source is
`oryx_tpu_torch/csrc/q8_linear.cu` (see its header for what bounds it and
how each route is laid out). Routes:
  * CPU tensors -> `q8_linear_reference` (dequantize, then `F.linear`);
  * CUDA tensors -> a kernel, for every row count, or a raise:
    bf16 with at most SMALL_ROWS rows the byte-bound route (a cp.async ring
    of code tiles, mma.sync, split-K merged inside the launch through a
    thread-block cluster), bf16 with more the wgmma routes (128 x 128 tiles
    dequantized in shared memory; past WIDE_ROWS rows with fewer splits),
    fp32 the SIMT routes (a warp a channel up to SMALL_ROWS rows,
    shared-memory tiles above).
A row's bits do not depend on M, the group or the other rows within a
route; the routes sum in different orders.
`plan` picks the route and its tiling from M, K and the dtype;
`plan_blocks` lists what each block of a launch computes, as the kernels
do. The operands of a (group of) weight(s) are checked and laid out once,
at their first product (`_prepare`), and reused while the tensors live.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from oryx_tpu_torch.ops.cuda import build, launches

# Kernel launches, keyed by (M, N, K, dtype name), N summed over a grouped
# launch's members. Only `_launch` adds to it, once per launch.
LAUNCHES: collections.Counter = collections.Counter()

SMALL_ROWS = 64  # the most rows the small (byte-bound) routes take
WIDE_ROWS = 256  # past this many rows the bf16 wgmma route splits less
KB = 64  # columns of a k block (csrc/q8_linear.cu)
MAXG = 4  # products of one grouped launch
SMALL_TILE = 64  # channels of a bf16 small-route tile
LARGE_TILE = 128  # rows and channels of a bf16 wgmma-route tile
F32_TILE = 64  # rows and channels of an fp32 large-route tile
MAX_SPLITS = 8  # k ranges of a tile: blocks of one thread-block cluster
# Routes (csrc/q8_linear.cu): bf16 up to SMALL_ROWS rows, up to WIDE_ROWS
# and past it (one kernel, two split plans), fp32 up to / past SMALL_ROWS.
BF16_SMALL, BF16_LARGE, F32_SMALL, F32_LARGE, BF16_WIDE = range(5)
# k blocks a split takes at least, by bf16 route: on an H100 the decode
# shapes stream fastest in 8 splits of K = 3584 (7 k blocks each); past
# WIDE_ROWS rows the row tiles fill the card, and a split costs its merge.
MIN_KB_PER_SPLIT = {BF16_SMALL: 4, BF16_LARGE: 8, BF16_WIDE: 128}

_DT = {torch.bfloat16: "bf16", torch.float32: "f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_fn = None


class Plan(NamedTuple):
    """How one (grouped) product is cut into blocks.

    route: BF16_SMALL, BF16_LARGE, BF16_WIDE, F32_SMALL or F32_LARGE.
    rows: the small routes' row bucket (the x rows a block holds, M at
        most); 0 on the large routes, whose tiles hold LARGE_TILE or
        F32_TILE rows.
    tile: output channels a block (a warp on F32_SMALL) owns.
    splits, kps: the ceil(K / KB) k blocks are cut into `splits` ranges
        of `kps` blocks (the last one shorter), merged in split order."""

    route: int
    rows: int
    tile: int
    splits: int
    kps: int


def split_plan(K: int, route: int) -> tuple[int, int]:
    """(splits, k blocks a split) of a bf16 route, from K and the route
    alone: the most of 1, 2, 4, 8 ranges that keep the route's
    MIN_KB_PER_SPLIT k blocks each. So a product's sums run in the same
    order whatever its M within the route and whatever its group."""
    nkb, least = -(-K // KB), MIN_KB_PER_SPLIT[route]
    splits = 1
    while splits < MAX_SPLITS and nkb // (2 * splits) >= least:
        splits *= 2
    return splits, -(-nkb // splits)


def route_of(M: int, bf16: bool) -> int:
    """The route of a product of M rows (constant boundaries)."""
    if M <= SMALL_ROWS:
        return BF16_SMALL if bf16 else F32_SMALL
    if not bf16:
        return F32_LARGE
    return BF16_LARGE if M <= WIDE_ROWS else BF16_WIDE


def route_rows(route: int) -> tuple[int, int | None]:
    """The row counts [lo, hi] a route takes (hi None: no limit)."""
    if route in (BF16_SMALL, F32_SMALL):
        return 1, SMALL_ROWS
    if route == BF16_LARGE:
        return SMALL_ROWS + 1, WIDE_ROWS
    return (WIDE_ROWS if route == BF16_WIDE else SMALL_ROWS) + 1, None


@functools.lru_cache(maxsize=None)
def _plan(K: int, route: int, rows: int) -> Plan:
    if route == F32_SMALL:
        return Plan(route, rows, 1, 1, -(-K // KB))
    if route == F32_LARGE:
        return Plan(route, 0, F32_TILE, 1, -(-K // KB))
    tile = SMALL_TILE if route == BF16_SMALL else LARGE_TILE
    return Plan(route, rows, tile, *split_plan(K, route))


def plan(K: int, M: int, bf16: bool) -> Plan:
    """The plan of a (grouped) product of M rows of width K: the route
    (`route_of`), on the small routes the row bucket (the least of 8, 16,
    32, 64 (bf16) or 4, 16, 64 (fp32) that holds M), the tile and the split
    plan. The output widths do not enter it, so a member's bits are those
    of its own launch."""
    route = route_of(M, bf16)
    rows = 0
    if M <= SMALL_ROWS:
        rows = next(r for r in ((8, 16, 32, 64) if bf16 else (4, 16, 64))
                    if M <= r)
    return _plan(K, route, rows)


def plan_blocks(p: Plan, Ns, K: int, M: int):
    """What each block of the launch computes: (member, channels [n0, n1),
    rows [m0, m1), k blocks [kb0, kb1)), clipped to the member's N, to M
    and to ceil(K / KB) as the kernels clip them; the splits of one tile
    in split order."""
    nkb = -(-K // KB)
    row_tile = {BF16_LARGE: LARGE_TILE, BF16_WIDE: LARGE_TILE,
                F32_LARGE: F32_TILE}.get(p.route, M)
    for i, N in enumerate(Ns):
        for n0 in range(0, N, p.tile):
            for m0 in range(0, M, row_tile):
                for s in range(p.splits):
                    kb0 = s * p.kps
                    yield (i, n0, min(N, n0 + p.tile), m0,
                           min(M, m0 + row_tile), kb0,
                           min(nkb, kb0 + p.kps))


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = build.load("q8_linear").oryx_q8_linear
        # weights x y; M route rows tile splits kps vec; stream
        fn.argtypes = [_P] * 3 + [_I] * 7 + [_P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


class _Weights(ctypes.Structure):
    """csrc/q8_linear.cu's OryxQ8Weights."""

    _fields_ = [("q", _P * MAXG), ("scale", _P * MAXG), ("bias", _P * MAXG),
                ("n", _I * MAXG), ("count", _I), ("K", _I), ("col", _I),
                ("aligned", _I)]


class _Prepared:
    """A weight group's operands, checked once: its output widths, the
    kernel's operand struct per x dtype (the bias cast to it) and the
    plans taken so far, keyed by (M up to SMALL_ROWS, else -1 up to
    WIDE_ROWS, else -2; dtype)."""

    def __init__(self, members, column_scale: bool) -> None:
        q0 = members[0][0]
        dev, K = q0.device, q0.shape[-1] if q0.dim() == 2 else -1
        if not 1 <= len(members) <= MAXG:
            raise ValueError(f"q8_linear: 1 to {MAXG} products a launch, got "
                             f"{len(members)}")
        for q, scale, bias in members:
            if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != K
                    or not q.is_contiguous() or q.device != dev):
                raise ValueError(
                    f"q8_linear: q must be contiguous int8 [N, {K}] on {dev}, "
                    f"got {q.dtype} {tuple(q.shape)} on {q.device}")
            S = K if column_scale else q.shape[0]
            if (scale.dtype != torch.float32 or tuple(scale.shape) != (S,)
                    or not scale.is_contiguous() or scale.device != dev):
                raise ValueError(
                    f"q8_linear: scale must be contiguous fp32 [{S}] on {dev}"
                    f", got {scale.dtype} {tuple(scale.shape)} on "
                    f"{scale.device}")
            if bias is not None and (tuple(bias.shape) != (q.shape[0],)
                                     or bias.device != dev):
                raise ValueError(
                    f"q8_linear: bias must be [{q.shape[0]}] on {dev}")
        # Weak references: an entry must not keep a model's weights alive.
        self.refs = tuple(weakref.ref(t) for m in members for t in m
                          if t is not None)
        self.has_bias = tuple(b is not None for _, _, b in members)
        self.column_scale = column_scale
        self.device, self.index, self.K = dev, dev.index, K
        self.Ns = tuple(q.shape[0] for q, _, _ in members)
        self.N = sum(self.Ns)
        self.aligned = int(K % 16 == 0 and all(
            q.data_ptr() % 16 == 0
            and (not column_scale or s.data_ptr() % 16 == 0)
            for q, s, _ in members))
        self.structs: dict[torch.dtype, int] = {}
        self.keep: list = []  # the structs and cast biases they point at
        self.plans: dict[tuple, tuple] = {}

    def struct(self, dtype: torch.dtype) -> int:
        """The address of the operand struct for x of `dtype` (built at
        the first product in that dtype)."""
        addr = self.structs.get(dtype)
        if addr is None:
            w = _Weights()
            it = iter(r() for r in self.refs)
            for i, has_bias in enumerate(self.has_bias):
                q, scale = next(it), next(it)
                b = next(it).to(dtype).contiguous() if has_bias else None
                self.keep += [b]
                w.q[i], w.scale[i] = q.data_ptr(), scale.data_ptr()
                w.bias[i] = 0 if b is None else b.data_ptr()
                w.n[i] = q.shape[0]
            w.count, w.K = len(self.Ns), self.K
            w.col, w.aligned = int(self.column_scale), self.aligned
            self.keep.append(w)
            addr = self.structs[dtype] = ctypes.addressof(w)
        return addr


# (column_scale, id of each tensor) -> _Prepared; an entry goes with its
# first codes tensor. The tensors are taken as they are: one replaced in
# place by another storage (`.data =`, `set_`) would keep a stale address.
_PREPARED: dict[tuple, _Prepared] = {}


def _prepare(members, column_scale: bool) -> _Prepared:
    key = (column_scale, *[id(t) for m in members for t in m])
    prep = _PREPARED.get(key)
    if prep is not None and all(
            r() is t for r, t in zip(prep.refs, [
                t for m in members for t in m if t is not None])):
        return prep
    prep = _Prepared(members, column_scale)
    _PREPARED[key] = prep
    weakref.finalize(members[0][0], _PREPARED.pop, key, None)
    return prep


def _launch(prep: _Prepared, x: torch.Tensor) -> list[torch.Tensor]:
    """The kernel over CUDA x [..., K]: one launch for all of prep's
    members; raises on what it does not take or a failed launch."""
    K, idx = prep.K, prep.index
    dt = _DT.get(x.dtype)
    if dt is None or x.get_device() != idx or x.shape[-1] != K:
        raise ValueError(
            f"q8_linear: x must be bf16 or fp32 [..., {K}] on {prep.device},"
            f" got {x.dtype} {tuple(x.shape)} on {x.device}")
    M = x.numel() // K
    lead = x.shape[:-1]
    if M == 0:
        return [x.new_empty((*lead, n)) for n in prep.Ns]
    x2 = x if x.dim() == 2 else x.reshape(M, K)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    key = (M if M <= SMALL_ROWS else -1 if M <= WIDE_ROWS else -2, dt)
    args = prep.plans.get(key)
    if args is None:
        p = plan(K, M, dt == "bf16")
        args = prep.plans[key] = (p.route, p.rows, p.tile, p.splits, p.kps)
    addr = prep.structs.get(x.dtype) or prep.struct(x.dtype)
    single = len(prep.Ns) == 1
    y = torch.empty((*lead, prep.N) if single else (M * prep.N,),
                    dtype=x.dtype, device=prep.device)
    xp = x2.data_ptr()
    fn = _fn or _kernel_fn()
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if torch._C._cuda_getDevice() == idx:
        err = fn(addr, xp, y.data_ptr(), M, *args, xp % 16 == 0, stream)
    else:
        with torch.cuda.device(idx):
            err = fn(addr, xp, y.data_ptr(), M, *args, xp % 16 == 0, stream)
    if err != 0:
        raise RuntimeError(
            f"q8_linear launch failed: CUDA error {err} (M={M}, N={prep.Ns}, "
            f"K={K}, plan {args}, column_scale={prep.column_scale})")
    launches.count(LAUNCHES, (M, prep.N, K, dt))
    if single:
        return [y]
    return [t.view(*lead, n) for t, n in zip(
        y.split([M * n for n in prep.Ns]), prep.Ns)]


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype,
                      column_scale: bool = False) -> torch.Tensor:
    """deq(q [N, K], scale [N], or [K] with column_scale) in `dtype`:
    q.to(dtype) * scale.to(dtype)."""
    s = scale.to(dtype)
    return q.to(dtype) * (s[None, :] if column_scale else s[:, None])


def q8_linear_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor | None = None, *,
                        column_scale: bool = False) -> torch.Tensor:
    """The plain twin: dequantize in x's dtype, then F.linear."""
    return F.linear(x, dequantize_weight(q, scale, x.dtype, column_scale),
                    None if bias is None else bias.to(x.dtype))


def q8_linear(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
              bias: torch.Tensor | None = None, *,
              column_scale: bool = False) -> torch.Tensor:
    """x [..., K] . deq(q [N, K], scale [N] or, with column_scale, [K])^T
    (+ bias [N]) -> [..., N] in x's dtype: the twin for a CPU x, else a
    kernel (see the module docstring for the routes)."""
    if x.device.type != "cuda":
        return q8_linear_reference(x, q, scale, bias,
                                   column_scale=column_scale)
    return _launch(_prepare(((q, scale, bias),), column_scale), x)[0]


def q8_linear_group(x: torch.Tensor, members, *,
                    column_scale: bool = False) -> list[torch.Tensor]:
    """[q8_linear(x, q, scale, bias) for (q, scale, bias) in members], the
    members sharing K: on the card one launch for all of them (at most
    MAXG), each output with the bits of its own call."""
    if x.device.type != "cuda":
        return [q8_linear_reference(x, q, s, b, column_scale=column_scale)
                for q, s, b in members]
    return _launch(_prepare(members, column_scale), x)
