"""Flash attention: the hand-written Hopper kernels and their plain twins.

Port of the Pallas TPU kernels of `oryx_tpu.ops.pallas.flash_attention`:
the forward K1 (`csrc/flash_attention.cu`, with or without the per-row
logsumexp the backward needs) and the backward K5a/K5b
(`csrc/flash_attention_bwd.cu`: dq, and dk/dv). See the sources' headers for
what bounds them and how they are laid out. K1 has three routes: a bf16
call with one query row (the dense-cache decode step) runs the split-KV
decode kernel and its merge (`_decode_splits` picks the splits); any other
bf16 call the wgmma/TMA body over the per-call cell map (`_tile_flags`,
built on the card by `_tile_flags_cuda`); fp32 the FMA kernel.

`flash_attention` has the JAX wrapper's signature and masking model. Its
layout step (`_prepare`: [B, T, H, D] -> [B, H, T, D] views, the int32
[B, T] position/segment/validity arrays) is shared by both devices; only
the innermost call differs:
  * CUDA tensors -> `_mha_forward` / `_mha_backward`, which launch the
    kernels (bf16 or fp32) or raise;
  * CPU tensors  -> `_mha_forward_reference` / `_mha_backward_reference`,
    plain PyTorch functions with the kernels' argument lists and
    arithmetic.

When q, k or v require grad, the forward runs as the custom op
`oryx_torch::flash_fwd_lse` (K1 with the logsumexp), whose autograd formula
is the counterpart of the JAX `_flash_vjp`: Delta = rowsum(dO * O) in fp32
from the rounded output, then K5a and K5b. Being one dispatcher op, the
forward is what the "attn" remat policy (utils/remat.py) keeps instead of
recomputing it.

Rows past the sequence ends need no padding in memory: the kernel treats kv
rows past Tk as invalid (the Pallas pad convention: kv segment -2, invalid)
and never stores q rows past Tq. The bf16 kernels read with TMA or
16-byte `cp.async`, which need 16-byte aligned bases and strides; an
operand that has neither (a head dim of 12 packed in one projection, a
shifted base) is copied first into storage whose rows are padded to a
multiple of 8 elements (`_tma_operand`), so every head dim the JAX
reference takes runs.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from oryx_tpu_torch.ops.cuda import build, launches

FLT_MAX = torch.finfo(torch.float32).max
NEG = -0.7 * FLT_MAX

# Kernel launches, keyed by call shape (causal, has_segments, B, Hq, Hk, Tq,
# Tk, D), one counter per kernel: K1 (inference), K1 writing the logsumexp,
# K5a (dq) and K5b (dk/dv). Only the launchers add to them, once per wrapper
# call (K1's decode route is two CUDA launches, its other bf16 route three
# with the cell map: one count). LAUNCHES_DECODE counts the K1 calls, with
# or without the logsumexp, that took the split-KV decode route.
LAUNCHES: collections.Counter = collections.Counter()
LAUNCHES_DECODE: collections.Counter = collections.Counter()
LAUNCHES_LSE: collections.Counter = collections.Counter()
LAUNCHES_DQ: collections.Counter = collections.Counter()
LAUNCHES_DKV: collections.Counter = collections.Counter()

_DT = {torch.bfloat16: "bf16", torch.float32: "f32"}
_fns: dict[str, object] = {}


_I, _P = ctypes.c_int, ctypes.c_void_p
# Argument types of each entry point after its leading pointers.
_ARGTYPES = {
    # q k v o lse strides, 5 ints, scratch; B Hq Hk Tq Tk D; scale;
    # causal has_segments kv_arange splits tps wgs; stream
    "oryx_flash_fwd_bf16": [_P] * 12 + [_I] * 6 + [ctypes.c_float]
    + [_I] * 6 + [_P],
    # q k v o lse strides, 5 ints; B Hq Hk Tq Tk D; scale; causal
    # has_segments kv_arange vec; stream
    "oryx_flash_fwd_f32": [_P] * 11 + [_I] * 6 + [ctypes.c_float]
    + [_I] * 4 + [_P],
    "oryx_flash_bwd_tiles": [_P] * 6 + [_I] * 5 + [_P],
}
for _k in ("dq", "dkv"):
    for _d in ("bf16", "f32"):
        # q k v do lse delta dq dk dv strides, 5 ints, tiles; B Hq Hk Tq Tk
        # D; scale; causal has_segments kv_arange nqt nkt; stream
        _ARGTYPES[f"oryx_flash_bwd_{_k}_{_d}"] = (
            [_P] * 16 + [_I] * 6 + [ctypes.c_float] + [_I] * 5 + [_P])


def _kernel_fn(entry: str):
    """The ctypes function `entry` ("oryx_flash_fwd_bf16", ...) of the
    library that defines it, built on first use."""
    fn = _fns.get(entry)
    if fn is None:
        fwd = entry.startswith("oryx_flash_fwd")
        lib = build.load("flash_attention" if fwd else "flash_attention_bwd")
        fn = getattr(lib, entry)
        fn.argtypes = _ARGTYPES[entry]
        fn.restype = ctypes.c_int
        _fns[entry] = fn
    return fn


def _check_ints(name: str, x: torch.Tensor, B: int, T: int, device) -> None:
    if (
        x.dtype != torch.int32 or tuple(x.shape) != (B, T)
        or not x.is_contiguous() or x.device != device
    ):
        raise ValueError(
            f"{name}: need contiguous int32 [{B}, {T}] on {device}, got "
            f"{x.dtype} {tuple(x.shape)} on {x.device}"
        )


def _check_operands(q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
                    extra=()) -> None:
    """Raise on anything the kernels do not take: CUDA tensors, q/k/v (and
    `extra`, (name, tensor) pairs shaped like q) all bf16 or all fp32 with a
    contiguous feature dim, Hq % Hk == 0, D <= 128, contiguous int32 ints."""
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the flash kernels need CUDA tensors, got {dev}")
    named = (("q", q), ("k", k), ("v", v), *extra)
    if q.dtype not in _DT or any(x.dtype != q.dtype for _, x in named):
        raise ValueError(
            "dtypes " + "/".join(f"{n} {x.dtype}" for n, x in named)
            + ": need all bf16 or all fp32"
        )
    if (
        tuple(k.shape) != (B, Hk, Tk, D) or tuple(v.shape) != (B, Hk, Tk, D)
        or any(tuple(x.shape) != tuple(q.shape) for _, x in extra)
        or Hq % Hk or D > 128
    ):
        raise ValueError(
            f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
            f"{tuple(v.shape)}: need Hq % Hk == 0 and D <= 128"
        )
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, q on {dev}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: feature dim must be contiguous")
    _check_ints("q_pos", q_pos, B, Tq, dev)
    _check_ints("q_seg", q_seg, B, Tq, dev)
    for name, x in (("kv_pos", kv_pos), ("kv_seg", kv_seg),
                    ("kv_valid", kv_valid)):
        _check_ints(name, x, B, Tk, dev)


def _raise_on(err: int, entry: str, q, k) -> None:
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: CUDA error {err} "
            f"(q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)})"
        )


def _call(fn, dev, *args):
    """fn(*args, stream) on `dev`'s current stream, making `dev` the current
    device only when it is not (entering torch.cuda.device costs several
    microseconds a call, and the decode step calls K1 once a layer)."""
    cur = torch.cuda.current_device()
    idx = cur if dev.index is None else dev.index
    # The raw handle, without building a torch.cuda.Stream object.
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == cur:
        return fn(*args, stream)
    with torch.cuda.device(idx):
        return fn(*args, stream)


def _strides(views):
    strides = [s for x in views for s in x.stride()[:3]]
    return strides, (ctypes.c_longlong * len(strides))(*strides)


# Rows of a K1/K5 cell: a 64-row q or kv tile.
TILE = 64
# Blocks per SM the decode route's splits aim for (a few waves of live
# blocks at a decode step's lengths).
DECODE_BLOCKS_PER_SM = 4
_SMS: dict[int, int] = {}


def _sm_count(dev) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _decode_splits(B: int, groups: int, Tk: int, sm_count: int):
    """(splits, tiles per split) of the split-KV decode: the ceil(Tk / 64)
    kv tiles of a row are cut into `splits` contiguous ranges of `tiles per
    split` tiles (the last one shorter), split s taking tiles
    [s * tps, min((s + 1) * tps, ceil(Tk / 64))). `groups` is the number of
    (kv head, 16-head chunk) blocks of a row. The count aims at
    DECODE_BLOCKS_PER_SM blocks per SM over the B * groups (row, group)
    pairs, at least one tile a split. The kernel clips each range at the
    causal end of its row, so splits past a short row exit at once."""
    nk = -(-Tk // TILE)
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // max(1, B * groups))
    splits = max(1, min(nk, want, 65535))
    tps = -(-nk // splits)
    return -(-nk // tps), tps


def _fwd_warpgroups(B: int, Hq: int, Tq: int, sm_count: int) -> int:
    """Consumer warpgroups of a block of K1's wgmma body (64 q rows each):
    two, unless a grid of 128-row blocks would not fill the card four times
    over (the compressor's few hundred queries); then one, at two blocks an
    SM and twice the blocks."""
    return 2 if B * Hq * -(-Tq // 128) >= 4 * sm_count else 1


def _tma_ok(x: torch.Tensor) -> bool:
    """Whether the bf16 kernels' TMA (and 16-byte `cp.async`) can read the
    [B, H, T, D] view x: a 16-byte aligned base and (batch, head, token)
    strides of a multiple of 8 elements, 16 bytes of bf16 (dims of extent 1
    excepted)."""
    return x.data_ptr() % 16 == 0 and all(
        n == 1 or st % 8 == 0 for n, st in zip(x.shape[:3], x.stride()[:3])
    )


def _tma_operand(x: torch.Tensor) -> torch.Tensor:
    """x, or, when TMA cannot read it (`_tma_ok`), its values in fresh
    [B, T, H, Dp] storage, Dp = D rounded up to a multiple of 8, the
    columns past D zero; returned as the [B, H, T, D] view of that storage.
    The kernels read the columns past D of a row as zero in any case (TMA's
    fill, zero chunks of `cp.async`), and zero columns change neither q.k
    nor the kept columns of any output; the softmax scale stays D^-0.5 of
    the caller's D (`_prepare` computes it and passes it on)."""
    if _tma_ok(x):
        return x
    B, H, T, D = x.shape
    store = x.new_zeros((B, T, H, D + (-D % 8)))
    store[..., :D].copy_(x.transpose(1, 2))
    return store.transpose(1, 2)[..., :D]


def _check_tma(named) -> None:
    """Internal check after `_tma_operand`: every bf16 operand is one TMA
    can read."""
    for name, x in named:
        if not _tma_ok(x):
            raise RuntimeError(
                f"{name}: strides {x.stride()} at base offset "
                f"{x.data_ptr() % 16} mod 16 reached a TMA kernel unpadded"
            )


def _mha_forward(
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
    with_lse: bool = False,
):
    """Launch the kernel. q [B, Hq, Tq, D]; k/v [B, Hk, Tk, D] (any strides
    with a contiguous feature dim); int arrays contiguous int32 [B, T*].
    Returns o [B, Hq, Tq, D] in q's dtype (a view of a [B, Tq, Hq, D]
    buffer), and with `with_lse` also the fp32 logsumexp [B, Hq, Tq]: m +
    log l, FLT_MAX where l == 0. Raises on anything the kernel does not
    take."""
    ints = (q_pos, kv_pos, q_seg, kv_seg, kv_valid)
    _check_operands(q, k, v, *ints)
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    dev = q.device
    o = torch.empty((B, Tq, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    lse = (
        torch.empty((B, Hq, Tq), dtype=torch.float32, device=dev)
        if with_lse else None
    )
    key = (causal, has_segments, B, Hq, Hk, Tq, Tk, D)
    lse_ptr = None if lse is None else lse.data_ptr()
    ints_ptrs = tuple(x.data_ptr() for x in ints)
    flag_ints = (int(causal), int(has_segments), int(kv_arange))
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_operand(x) for x in (q, k, v))
        _check_tma((("q", q), ("k", k), ("v", v)))
        splits = tps = wgs = 0
        if Tq == 1:  # the split-KV decode route: fp32 partials
            G = Hq // Hk
            ng = -(-G // 16)
            splits, tps = _decode_splits(B, Hk * ng, Tk, _sm_count(dev))
            nbytes = 4 * B * Hk * ng * splits * min(G, 16) * (2 + D)
        else:  # the wgmma body: the cell map, built by the same call
            nq, nk = -(-Tq // TILE), -(-Tk // TILE)
            nbytes = B * (nq + nk) * 7 * 4 + B * nq * nk
            wgs = _fwd_warpgroups(B, Hq, Tq, _sm_count(dev))
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        _, stride_arr = _strides((q, k, v, o))
        entry = "oryx_flash_fwd_bf16"
        err = _call(
            _kernel_fn(entry), dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            ctypes.addressof(stride_arr), *ints_ptrs, scratch.data_ptr(),
            B, Hq, Hk, Tq, Tk, D, float(scale), *flag_ints, splits, tps, wgs,
        )
        if Tq == 1 and err == 0:
            launches.count(LAUNCHES_DECODE, key)
    else:
        strides, stride_arr = _strides((q, k, v, o))
        # 16-byte vector loads need 16-byte aligned rows.
        per16 = 16 // q.element_size()
        vec = int(
            D % per16 == 0
            and all(s % per16 == 0 for s in strides)
            and all(x.data_ptr() % 16 == 0 for x in (q, k, v, o))
        )
        entry = "oryx_flash_fwd_f32"
        err = _call(
            _kernel_fn(entry), dev,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse_ptr,
            ctypes.addressof(stride_arr), *ints_ptrs,
            B, Hq, Hk, Tq, Tk, D, float(scale), *flag_ints, vec,
        )
    _raise_on(err, entry, q, k)
    if with_lse:
        launches.count(LAUNCHES_LSE, key)
        return o, lse
    launches.count(LAUNCHES, key)
    return o


def _mha_backward(q, k, v, do, lse, delta, *ints, **flags):
    """K5a then K5b: dq [B, Hq, Tq, D] and dk, dv [B, Hk, Tk, D]."""
    dq = _mha_backward_dq(q, k, v, do, lse, delta, *ints, **flags)
    return (dq,) + _mha_backward_dkv(q, k, v, do, lse, delta, *ints, **flags)


def _mha_backward_dq(q, k, v, do, lse, delta, *ints, **flags):
    """Launch K5a: dq [B, Hq, Tq, D] in q's dtype (a view of a
    [B, Tq, Hq, D] buffer). Arguments as `_bwd_launch`."""
    return _bwd_launch("dq", q, k, v, do, lse, delta, *ints, **flags)[0]


def _mha_backward_dkv(q, k, v, do, lse, delta, *ints, **flags):
    """Launch K5b: (dk, dv), each [B, Hk, Tk, D] in q's dtype (views of
    [B, Tk, Hk, D] buffers). Arguments as `_bwd_launch`."""
    return _bwd_launch("dkv", q, k, v, do, lse, delta, *ints, **flags)[1:]


_IMAX = torch.iinfo(torch.int32).max
_IMIN = torch.iinfo(torch.int32).min


def _tile_stats(pos, seg, live):
    """Per 64-row tile of [B, T] int32 positions/segments and a bool live
    mask: (any live, all live, position min, max, segment min, the smallest
    segment above that min, segment max over the live rows), each
    [B, ceil(T / 64)]; rows past T are not live. A tile's segments lie in
    {min} and [second, max], so pads (one id, 0) beside real segments do not
    widen the range to every segment between."""
    B, T = pos.shape
    pad = -T % TILE

    def tiles(x, fill):
        return torch.nn.functional.pad(x, (0, pad), value=fill).view(
            B, -1, TILE)

    live = tiles(live, False)
    pos, seg = tiles(pos, 0), tiles(seg, 0)

    def lo(x):
        return torch.where(live, x, _IMAX).amin(-1)

    def hi(x):
        return torch.where(live, x, _IMIN).amax(-1)

    smin = lo(seg)
    smin2 = torch.where(live & (seg > smin[..., None]), seg, _IMAX).amin(-1)
    return (live.any(-1), live.all(-1), lo(pos), hi(pos), smin, smin2,
            hi(seg))


def _tile_flags(q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal,
                has_segments):
    """The bf16 kernels' skip rules (K1 with Tq > 1, K5a, K5b): int8
    [B, nq, nk] over 64 x 64 (q, kv) cells, 0 where no pair of the cell is
    visible (the kernels never load or visit it), 2 where every pair is
    (they skip the per-element mask), 1 otherwise. A cell meets when both tiles have a live row, the
    causal ranges overlap (the smallest kv position is at most the largest
    q position) and the segment sets can meet (each tile's segments lie in
    {min} and [second smallest, max]); it is full when every row of both
    tiles is live, every kv position is at most every q position and both
    tiles hold one and the same segment. With arange or slot
    positions the causal rule is the index clamp: a kv tile whose first
    valid slot lies past a q tile's last row is dead for it. The CUDA
    wrapper computes the same map on the card once per call
    (`_tile_flags_cuda`), so the kernels need no per-tile sync."""
    qa, qall, qpmin, qpmax, qsmin, qsmin2, qsmax = _tile_stats(
        q_pos, q_seg, torch.ones_like(q_pos, dtype=torch.bool))
    ka, kall, kpmin, kpmax, ksmin, ksmin2, ksmax = _tile_stats(
        kv_pos, kv_seg, kv_valid > 0)

    def qc(x):
        return x[:, :, None]

    def kc(x):
        return x[:, None, :]

    meet = qc(qa) & kc(ka)
    full = qc(qall) & kc(kall)
    if causal:
        meet = meet & (kc(kpmin) <= qc(qpmax))
        full = full & (kc(kpmax) <= qc(qpmin))
    if has_segments:
        # {a} + [a2, A] meets {b} + [b2, B] (an empty interval when a2 > A).
        def within(x, lo, hi):
            return (x >= lo) & (x <= hi)

        a, a2, A = qc(qsmin), qc(qsmin2), qc(qsmax)
        b, b2, B = kc(ksmin), kc(ksmin2), kc(ksmax)
        meet = meet & (
            (a == b) | within(a, b2, B) | within(b, a2, A)
            | ((a2 <= B) & (b2 <= A) & (a2 <= A) & (b2 <= B))
        )
        full = full & (a == A) & (b == B) & (a == b)
    return (meet.to(torch.int8) + (meet & full).to(torch.int8)).contiguous()


def _tile_flags_cuda(q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal,
                     has_segments):
    """`_tile_flags` computed on the card for K5a/K5b (two small launches,
    one call into the backward's library): the same int8 [B, nq, nk] map,
    a view into a scratch buffer that also holds the per-tile stats. K1's
    entry point builds the same map (csrc/tile_map.cuh) itself, in the call
    that launches it."""
    B, Tq = q_pos.shape
    Tk = kv_pos.shape[1]
    nq, nk = -(-Tq // TILE), -(-Tk // TILE)
    nstat = B * (nq + nk) * 7 * 4
    dev = q_pos.device
    buf = torch.empty(nstat + B * nq * nk, dtype=torch.int8, device=dev)
    entry = "oryx_flash_bwd_tiles"
    err = _call(
        _kernel_fn(entry), dev,
        q_pos.data_ptr(), kv_pos.data_ptr(), q_seg.data_ptr(),
        kv_seg.data_ptr(), kv_valid.data_ptr(), buf.data_ptr(), B, Tq, Tk,
        int(causal), int(has_segments),
    )
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return buf[nstat:].view(B, nq, nk)


def _bwd_launch(
    which, q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
):
    """Launch K5a (which="dq") or K5b ("dkv"). Layouts as `_mha_forward`,
    plus do [B, Hq, Tq, D] (any strides with a contiguous feature dim; a
    bf16 operand TMA cannot read is copied by `_tma_operand`) and the fp32
    lse / delta [B, Hq, Tq]; returns (dq, dk, dv) with None for what this
    kernel does not write.
    Raises on anything the kernels do not take."""
    ints = (q_pos, kv_pos, q_seg, kv_seg, kv_valid)
    _check_operands(q, k, v, *ints, extra=(("do", do),))
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    dev = q.device
    for name, x in (("lse", lse), ("delta", delta)):
        if (
            x.dtype != torch.float32 or tuple(x.shape) != (B, Hq, Tq)
            or not x.is_contiguous() or x.device != dev
        ):
            raise ValueError(
                f"{name}: need contiguous fp32 [{B}, {Hq}, {Tq}] on {dev}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_operand(x) for x in (q, k, v, do))
        _check_tma((("q", q), ("k", k), ("v", v), ("do", do)))
        tiles = _tile_flags_cuda(*ints, causal, has_segments)
        tiles_ptr, nqt, nkt = tiles.data_ptr(), *tiles.shape[1:]
    else:  # the fp32 kernels skip by their own per-tile stats
        tiles_ptr, nqt, nkt = None, 0, 0

    def out(T, H):
        return torch.empty((B, T, H, D), dtype=q.dtype,
                           device=dev).transpose(1, 2)

    if which == "dq":
        dq, dk, dv = out(Tq, Hq), None, None
        outs = (dq, q, q)  # the unused pointers are never written
    else:
        dq, dk, dv = None, out(Tk, Hk), out(Tk, Hk)
        outs = (do, dk, dv)
    _, stride_arr = _strides((q, k, v, do, *outs))
    entry = f"oryx_flash_bwd_{which}_{_DT[q.dtype]}"
    err = _call(
        _kernel_fn(entry), dev,
        *(x.data_ptr() for x in (q, k, v, do, lse, delta, *outs)),
        ctypes.addressof(stride_arr),
        *(x.data_ptr() for x in ints), tiles_ptr,
        B, Hq, Hk, Tq, Tk, D, float(scale), int(causal),
        int(has_segments), int(kv_arange), nqt, nkt,
    )
    _raise_on(err, entry, q, k)
    counts = LAUNCHES_DQ if which == "dq" else LAUNCHES_DKV
    launches.count(counts, (causal, has_segments, B, Hq, Hk, Tq, Tk, D))
    return dq, dk, dv


def _mha_forward_reference(
    q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
    with_lse: bool = False,
):
    """Plain PyTorch twin of `_mha_forward` (same arguments, same result):
    fp32 logits from the input operands, masked entries set to NEG,
    unnormalized p = exp(s - rowmax) rounded to v's dtype for p.V with an
    fp32 sum, then divided by l (1 where l == 0); with `with_lse` also
    m + log l (FLT_MAX where l == 0). Rows are processed one (batch, kv
    head) group at a time to bound memory. `kv_arange` only selects tile
    skipping in the kernel, which changes no valid row."""
    del kv_arange
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    G = Hq // Hk
    out = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Tq), dtype=torch.float32, device=q.device)
    for b in range(B):
        mask = _mask(b, q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal,
                     has_segments)
        for hk in range(Hk):
            qh = q[b, hk * G : (hk + 1) * G].float()  # [G, Tq, D]
            kh = k[b, hk].float()  # [Tk, D]
            s = torch.matmul(qh, kh.T) * scale  # [G, Tq, Tk]
            s = torch.where(mask, s, NEG)
            m = torch.amax(s, dim=-1, keepdim=True)
            p = torch.exp(s - m)
            l = torch.sum(p, dim=-1, keepdim=True)
            acc = torch.matmul(p.to(v.dtype).float(), v[b, hk].float())
            out[b, hk * G : (hk + 1) * G] = (
                acc / torch.where(l == 0.0, 1.0, l)
            ).to(q.dtype)
            lse[b, hk * G : (hk + 1) * G] = torch.where(
                l == 0.0, FLT_MAX, m + torch.log(torch.where(l == 0.0, 1.0, l))
            )[..., 0]
    return (out, lse) if with_lse else out


def _mask(b, q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal, has_segments):
    """[Tq, Tk] (or [1, Tk]) visibility of batch row b: kv validity AND
    causal on positions AND segment equality."""
    mask = kv_valid[b][None, :] > 0
    if causal:
        mask = mask & (q_pos[b][:, None] >= kv_pos[b][None, :])
    if has_segments:
        mask = mask & (q_seg[b][:, None] == kv_seg[b][None, :])
    return mask


def _mha_backward_reference(
    q, k, v, do, lse, delta, q_pos, kv_pos, q_seg, kv_seg, kv_valid,
    *,
    causal: bool,
    has_segments: bool,
    kv_arange: bool,
    scale: float,
):
    """Plain PyTorch twin of `_mha_backward` (same arguments, same result),
    in the Pallas kernels' arithmetic: p = exp(masked s - lse); dv = sum of
    p (rounded to do's dtype)^T . do; dp = do . v^T; ds = p (dp - delta)
    scale; dq = ds (rounded to k's dtype) . k; dk = sum of ds (rounded to
    q's dtype)^T . q, the sums over the G q heads of a kv head in fp32. One
    (batch, kv head) group at a time."""
    del kv_arange
    B, Hq, Tq, D = q.shape
    _, Hk, Tk, _ = k.shape
    G = Hq // Hk
    dq = torch.empty((B, Hq, Tq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hk, Tk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    for b in range(B):
        mask = _mask(b, q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal,
                     has_segments)
        for hk in range(Hk):
            hs = slice(hk * G, (hk + 1) * G)
            qh, doh = q[b, hs].float(), do[b, hs].float()  # [G, Tq, D]
            kh, vh = k[b, hk].float(), v[b, hk].float()  # [Tk, D]
            s = torch.where(mask, torch.matmul(qh, kh.T) * scale, NEG)
            p = torch.exp(s - lse[b, hs][..., None])  # [G, Tq, Tk]
            dv[b, hk] = torch.matmul(
                p.to(do.dtype).float().transpose(1, 2), doh
            ).sum(0).to(dv.dtype)
            dp = torch.matmul(doh, vh.T)
            ds = p * (dp - delta[b, hs][..., None]) * scale
            dq[b, hs] = torch.matmul(ds.to(k.dtype).float(), kh).to(dq.dtype)
            dk[b, hk] = torch.matmul(
                ds.to(q.dtype).float().transpose(1, 2), qh
            ).sum(0).to(dk.dtype)
    return dq, dk, dv


@torch.library.custom_op("oryx_torch::flash_fwd_lse", mutates_args=())
def flash_fwd_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    q_pos: torch.Tensor, kv_pos: torch.Tensor, q_seg: torch.Tensor,
    kv_seg: torch.Tensor, kv_valid: torch.Tensor,
    causal: bool, has_segments: bool, kv_arange: bool, scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: K1 with the logsumexp on CUDA tensors, its
    plain twin on CPU ones. Kernel layouts as `_mha_forward`; returns o
    [B, Tq, Hq, D] (the caller's layout) and the fp32 lse [B, Hq, Tq]."""
    flags = dict(causal=causal, has_segments=has_segments,
                 kv_arange=kv_arange, scale=scale)
    args = (q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid)
    if q.device.type == "cuda":
        o, lse = _mha_forward(*args, **flags, with_lse=True)
    elif q.device.type == "cpu":
        o, lse = _mha_forward_reference(*args, **flags, with_lse=True)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return o.transpose(1, 2).contiguous(), lse


@flash_fwd_lse.register_fake
def _(q, k, v, q_pos, kv_pos, q_seg, kv_seg, kv_valid, causal,
      has_segments, kv_arange, scale):
    B, Hq, Tq, D = q.shape
    return (q.new_empty((B, Tq, Hq, D)),
            q.new_empty((B, Hq, Tq), dtype=torch.float32))


def _setup_context(ctx, inputs, output) -> None:
    q, k, v, *ints = inputs[:8]
    o, lse = output
    ctx.save_for_backward(q, k, v, o, lse, *ints)
    ctx.flags = dict(zip(("causal", "has_segments", "kv_arange", "scale"),
                         inputs[8:]))


def _flash_backward(ctx, do, _dlse):
    """Counterpart of the JAX `_bwd`: Delta = rowsum(dO * O) in fp32 from
    the rounded output, then K5a/K5b (CUDA) or their twins (CPU)."""
    q, k, v, o, lse, *ints = ctx.saved_tensors
    delta = torch.einsum(
        "bqhd,bqhd->bhq", do.float(), o.float()
    ).contiguous()
    if do.stride(-1) != 1:
        do = do.contiguous()
    do = do.transpose(1, 2)  # [B, Hq, Tq, D]
    backward = (
        _mha_backward if q.device.type == "cuda" else _mha_backward_reference
    )
    dq, dk, dv = backward(q, k, v, do, lse, delta, *ints, **ctx.flags)
    return (dq, dk, dv) + (None,) * 9


flash_fwd_lse.register_autograd(_flash_backward, setup_context=_setup_context)


def _prepare(q, k, v, q_positions, kv_positions, q_segment_ids,
             kv_segment_ids, kv_mask, causal, scale, slot_positions=False):
    """Kernel layouts for both devices: [B, H, T, D] views of q/k/v and
    contiguous int32 [B, T] arrays, plus the static flags."""
    B, Tq, Hq, D = q.shape
    _, Tk, Hk, _ = k.shape
    dev = q.device

    def ints(x, T, default):
        if x is None:
            return default(T)
        return x.to(device=dev, dtype=torch.int32).expand(B, T).contiguous()

    def arange(T):
        return torch.arange(T, dtype=torch.int32, device=dev).expand(
            B, T
        ).contiguous()

    def zeros(T):
        return torch.zeros((B, T), dtype=torch.int32, device=dev)

    def ones(T):
        return torch.ones((B, T), dtype=torch.int32, device=dev)

    has_segments = q_segment_ids is not None
    if has_segments and kv_segment_ids is None:
        raise ValueError("q_segment_ids given without kv_segment_ids")
    args = (
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        ints(q_positions, Tq, arange),
        ints(kv_positions, Tk, arange),
        ints(q_segment_ids, Tq, zeros),
        ints(kv_segment_ids if has_segments else None, Tk, zeros),
        ints(kv_mask, Tk, ones),
    )
    flags = dict(
        causal=bool(causal), has_segments=has_segments,
        kv_arange=kv_positions is None or bool(slot_positions),
        scale=float(D**-0.5 if scale is None else scale),
    )
    return args, flags


def flash_attention(
    q, k, v,
    *,
    causal: bool = True,
    q_positions=None,
    kv_positions=None,
    q_segment_ids=None,
    kv_segment_ids=None,
    kv_mask=None,
    scale: float | None = None,
    slot_positions: bool = False,
):
    """Drop-in for ops.attention.attention with the same masking model.

    q: [B, Tq, Hq, D]; k/v: [B, Tk, Hk, D]. Returns [B, Tq, Hq, D].

    slot_positions: caller promise that every VALID token's position equals
    its slot index (right-padded prefill), which lets the kernel end its kv
    loop at the largest q position of a tile.
    """
    args, flags = _prepare(
        q, k, v, q_positions, kv_positions, q_segment_ids, kv_segment_ids,
        kv_mask, causal, scale, slot_positions,
    )
    if torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad
    ):
        return flash_fwd_lse(*args, **flags)[0]
    if q.device.type == "cuda":
        out = _mha_forward(*args, **flags)
    elif q.device.type == "cpu":
        out = _mha_forward_reference(*args, **flags)
    else:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return out.transpose(1, 2)
