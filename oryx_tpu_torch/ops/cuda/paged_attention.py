"""Paged attention: the hand-written Hopper kernels K3/K4 and their plain
twins.

Port of the Pallas TPU kernels `oryx_tpu.ops.pallas.paged_attention`
(`ragged_decode_attention` -> `_paged_decode`, K3; `ragged_paged_attention`
-> `_ragged_paged`, K4). The CUDA source is
`oryx_tpu_torch/csrc/paged_attention.cu`; see its header for the layout and
what bounds it. K3 is a front end over K4's kernel (segment = row, length =
kv_lengths). A bf16 call is split-KV: `_row_tile` and `_paged_plan` pick,
from host numbers only (never a row length, so a call needs no device sync),
the packed rows a block takes and the fixed 64-slot ranges of the table its
splits own; the wrapper allocates the fp32 partials and the kernel's second
launch merges them in split order.

The wrappers have the Pallas wrappers' signatures. Like them, they take a
quantized pool (`paged_kv.QuantPages` planes, both K and V: int8 or
fp8-e4m3 codes plus per-row fp32 scales), which the kernel dequantizes in
its page walk. Only the innermost call depends on the device:
  * CUDA tensors -> the kernel (bf16 or fp32 compute, dense or coded
    pages), or a raise;
  * CPU tensors  -> the plain twins in `ops/paged_kv.py` (gather the pages,
    plain attention).
The TPU grid table (`heads_per_block` and its autotuner) is VMEM tuning
and has no counterpart here.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from oryx_tpu_torch.ops import paged_kv
from oryx_tpu_torch.ops.cuda import build
from oryx_tpu_torch.ops.cuda.flash_attention import _call, _sm_count

# Kernel launches, keyed by (kernel, R, Hk, G, D, P, page_size, max_pages);
# the kernel name carries the code dtype of a quantized pool
# ("paged_decode_int8", "ragged_paged_fp8_e4m3"). Only `_launch` adds to it,
# once per wrapper call (a bf16 call is the split kernel and its merge).
LAUNCHES: collections.Counter = collections.Counter()

GMAX = 16  # q heads per kv head one kernel tile holds
TILE = 64  # kv slots of a tile of the bf16 kernel
A_ROWS = 64  # (row, q head) pairs of a row tile: four m16 tiles
# Blocks per SM the splits aim for (a few waves of blocks at a decode step),
# and the most splits the kernel's merge takes.
BLOCKS_PER_SM = 4
MAX_SPLITS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
# C argument lists: q, k, v, k scales, v scales, o, q row stride, block
# tables, the int [R] operands, the shape ints, scale, bf16, code, the
# partials' scratch, splits, tiles per split, row tile, leading one-row
# tiles, stream.
_ARGTYPES = {
    "paged_decode": [_P] * 6 + [ctypes.c_longlong] + [_P] * 2 + [_I] * 7
    + [ctypes.c_float, _I, _I, _P] + [_I] * 4 + [_P],
    "ragged_paged": [_P] * 6 + [ctypes.c_longlong] + [_P] * 3 + [_I] * 8
    + [ctypes.c_float, _I, _I, _P] + [_I] * 4 + [_P],
}
# Code dtypes of a quantized pool -> the kernel's `code` argument.
_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_fns: dict[str, object] = {}


def _kernel_fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.load("paged_attention"), f"oryx_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _row_tile(R: int, S: int, G: int, decode: bool) -> int:
    """Packed rows a block of the bf16 kernel takes: one for K3 and for a K4
    dispatch of at most S rows (decode rows only, each its own segment),
    else floor(64 / G), so the prefill lanes of one slot packed behind the
    decode rows share one walk of their pages per tile. With row tiles the
    first S rows (the engine's decode rows) still take one a tile
    (`plan_of`'s "lead"): a tile of S segments would walk S times."""
    return 1 if decode or R <= S else A_ROWS // G


def _paged_plan(S: int, Hk: int, maxp: int, ps: int, sm_count: int):
    """(splits, tiles per split) of the bf16 kernel: the ceil(maxp * ps /
    64) slot tiles of the table are cut into `splits` fixed ranges of `tps`
    tiles (the last one shorter), split s owning tiles [s * tps, min((s + 1)
    * tps, ceil(maxp * ps / 64))). The count aims at BLOCKS_PER_SM blocks
    per SM over the Hk * S (table row, kv head) pairs, at least one tile a
    split. Host numbers of the table only: the kernel clips each range at
    its rows' visible ends, so splits past every row's end exit at once
    with an empty partial; and not the dispatch's R or row tile, so every
    dispatch over one table cuts it alike and a row's output bits do not
    depend on the rows it is packed with (the ragged engine's replies stay
    the same whichever dispatch a token rides in)."""
    nk = -(-maxp * ps // TILE)
    want = -(-BLOCKS_PER_SM * sm_count // (Hk * S))
    splits = max(1, min(nk, want, MAX_SPLITS))
    tps = -(-nk // splits)
    return -(-nk // tps), tps


def plan_of(name: str, R: int, S: int, Hk: int, G: int, maxp: int, ps: int,
            sm_count: int) -> dict:
    """The bf16 kernel's plan of a call of `name` ("paged_decode" or
    "ragged_paged") over R packed rows and an [S, maxp] table: splits,
    tiles per split, row tile, the leading rows that take one a tile, and
    the number of row tiles."""
    rt = _row_tile(R, S, G, name == "paged_decode")
    lead = S if rt > 1 else 0
    splits, tps = _paged_plan(S, Hk, maxp, ps, sm_count)
    return {"splits": splits, "tps": tps, "row_tile": rt, "lead": lead,
            "row_tiles": lead + -(-(R - lead) // rt)}


def _check_ints(name: str, x: torch.Tensor, shape: tuple, dev) -> None:
    if (
        x.dtype != torch.int32 or tuple(x.shape) != shape
        or not x.is_contiguous() or x.device != dev
    ):
        raise ValueError(
            f"{name}: need contiguous int32 {list(shape)} on {dev}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _split_quant(k_pages, v_pages):
    """(k codes, k scales, v codes, v scales, format name) of a quantized
    pool pair, or None for a dense pair. Both planes must be quantized
    together: a mixed pool would misread one side's bytes."""
    kq, vq = (isinstance(x, paged_kv.QuantPages) for x in (k_pages, v_pages))
    if kq != vq:
        raise ValueError(
            "quantized and dense pages mixed: the pool must quantize both "
            "planes (qwen2.init_paged_kv_cache kv_dtype=)"
        )
    if not kq:
        return None
    if k_pages.storage_dtype != v_pages.storage_dtype:
        raise ValueError(
            f"K codes {k_pages.storage_dtype} and V codes "
            f"{v_pages.storage_dtype}: both planes need one code dtype"
        )
    return (k_pages.q, k_pages.scale, v_pages.q, v_pages.scale,
            paged_kv.kv_pool_dtype(k_pages))


def _launch(name, q, k_pages, v_pages, block_tables, ints, scale):
    """Launch `name` ("paged_decode" or "ragged_paged") on q [R, Hq, D].
    `ints` are the kernel's int32 [R] operands: (kv_lengths,) or
    (q_segments, q_positions). The pages are dense tensors or QuantPages
    planes. Returns o [R, Hq, D] in q's dtype."""
    quant = _split_quant(k_pages, v_pages)
    R, Hq, D = q.shape
    P, ps, Hk, _ = k_pages.shape
    S, maxp = block_tables.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.bfloat16, torch.float32) or any(
        x.dtype != q.dtype for x in (k_pages, v_pages)
    ):
        raise ValueError(
            f"q/k/v dtypes {q.dtype}/{k_pages.dtype}/{v_pages.dtype}: need "
            "all bf16 or all fp32 (the dequant dtype of a quantized pool)"
        )
    if tuple(v_pages.shape) != (P, ps, Hk, D) or k_pages.shape[3] != D:
        raise ValueError(
            f"pages k {tuple(k_pages.shape)} v {tuple(v_pages.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if Hq % Hk or Hq // Hk > GMAX or D > 128:
        raise ValueError(
            f"Hq={Hq} Hk={Hk} D={D}: need Hq % Hk == 0, Hq // Hk <= {GMAX} "
            "and D <= 128"
        )
    bf16 = q.dtype == torch.bfloat16
    code, scales, kernel = 0, (None, None), name
    if quant is not None:
        k_codes, k_scale, v_codes, v_scale, fmt = quant
        code = _CODES.get(k_codes.dtype, 0)
        if not code:
            raise ValueError(
                f"code dtype {k_codes.dtype}: the kernel reads int8 or "
                "float8_e4m3fn codes"
            )
        for nm, x in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (x.dtype != torch.float32 or tuple(x.shape) != (P, ps)
                    or not x.is_contiguous() or x.device != dev):
                raise ValueError(
                    f"{nm}: need contiguous fp32 [{P}, {ps}] on {dev}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}"
                )
        k_pages, v_pages = k_codes, v_codes
        scales = (k_scale.data_ptr(), v_scale.data_ptr())
        kernel = f"{name}_{fmt}"
    # The bf16 kernel reads pages in 16-byte chunks (8 values or 16 codes).
    for nm, x in (("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{nm}: need a contiguous tensor on {dev}")
        if bf16 and x.data_ptr() % 16:
            raise ValueError(f"{nm}: the bf16 kernel needs 16-byte alignment")
    if bf16 and D % (16 if code else 8):
        raise ValueError(
            f"D={D}: the bf16 kernel needs D % 8 == 0 (D % 16 for codes)"
        )
    if q.stride(2) != 1 or q.stride(1) != D:
        raise ValueError("q: heads and features must be contiguous")
    if bf16 and (q.data_ptr() % 16 or q.stride(0) % 8):
        # The bf16 kernel reads q rows in 16-byte chunks.
        q = q.clone(memory_format=torch.contiguous_format)
    _check_ints("block_tables", block_tables, (S, maxp), dev)
    for i, x in enumerate(ints):
        _check_ints(f"int operand {i}", x, (R,), dev)
    if name == "paged_decode" and S != R:
        raise ValueError(f"block_tables has {S} rows for {R} queries")

    o = torch.empty((R, Hq, D), dtype=q.dtype, device=dev)
    G = Hq // Hk
    extra = (S,) if name == "ragged_paged" else ()
    part, plan = None, (0, 0, 0, 0)
    if bf16:  # the split plan and its fp32 partials: (m, l) and acc[D]
        pl = plan_of(name, R, S, Hk, G, maxp, ps, _sm_count(dev))
        part = torch.empty(
            Hk * pl["row_tiles"] * pl["splits"] * pl["row_tile"] * G
            * (2 + D), dtype=torch.float32, device=dev)
        plan = (pl["splits"], pl["tps"], pl["row_tile"], pl["lead"])
    err = _call(
        _kernel_fn(name), dev,
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
        o.data_ptr(), q.stride(0), block_tables.data_ptr(),
        *(x.data_ptr() for x in ints),
        R, Hk, G, D, P, ps, *extra, maxp, float(scale), int(bf16), code,
        None if part is None else part.data_ptr(), *plan,
    )
    if err != 0:
        raise RuntimeError(
            f"{kernel} kernel launch failed: CUDA error {err} (q "
            f"{tuple(q.shape)} {q.dtype}, pages {tuple(k_pages.shape)} "
            f"{k_pages.dtype})"
        )
    LAUNCHES[(kernel, R, Hk, G, D, P, ps, maxp)] += 1
    return o


def _i32(x: torch.Tensor, dev) -> torch.Tensor:
    return x.to(device=dev, dtype=torch.int32).contiguous()


def ragged_decode_attention(
    q,  # [B, 1, Hq, D] or [B, Hq, D]
    k_pages,  # [P, page_size, Hk, D]
    v_pages,
    block_tables,  # [B, max_pages] int (sentinel >= P for unallocated)
    kv_lengths,  # [B] valid kv count INCLUDING the current token
    *,
    scale: float | None = None,
):
    """K3: drop-in for ops.paged_kv.ragged_decode_attention; pages (dense
    or QuantPages planes) are read in place through the block table."""
    squeezed = q.dim() == 3
    _split_quant(k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_kv.ragged_decode_attention(
            q, k_pages, v_pages, block_tables, kv_lengths, scale=scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode_attention: unsupported {q.device}")
    q3 = q if squeezed else q[:, 0]
    if not squeezed and q.shape[1] != 1:
        raise ValueError(f"paged decode is single-token (got Tq={q.shape[1]})")
    D = q3.shape[-1]
    out = _launch(
        "paged_decode", q3, k_pages, v_pages, _i32(block_tables, q.device),
        (_i32(kv_lengths, q.device),), D**-0.5 if scale is None else scale,
    )
    return out if squeezed else out[:, None]


def ragged_paged_attention(
    q,  # [R, Hq, D] packed query rows
    k_pages,  # [P, page_size, Hk, D]
    v_pages,
    block_tables,  # [S, max_pages] int (sentinel >= P for unallocated)
    q_segments,  # [R] owning slot per packed row
    q_positions,  # [R] absolute position per packed row
    *,
    scale: float | None = None,
):
    """K4: drop-in for ops.paged_kv.ragged_paged_attention: R packed rows
    with mixed query lengths, each reading its own sequence's pages (dense
    or QuantPages planes) in place through the block table."""
    _split_quant(k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_kv.ragged_paged_attention(
            q, k_pages, v_pages, block_tables, q_segments, q_positions,
            scale=scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported {q.device}")
    dev = q.device
    return _launch(
        "ragged_paged", q, k_pages, v_pages, _i32(block_tables, dev),
        (_i32(q_segments, dev), _i32(q_positions, dev)),
        q.shape[-1] ** -0.5 if scale is None else scale,
    )
