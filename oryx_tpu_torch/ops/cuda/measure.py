"""Timing on the card and synthetic K1/K3/K4/K5/q8 call shapes, shared by
`chip_smoke.py` and the kernel check scripts (`scripts/torch_*_check.py`).
Nothing on a model's path imports this module; every function here needs an
NVIDIA GPU."""

from __future__ import annotations

import subprocess
from typing import NamedTuple

import numpy as np
import torch

PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class DeviceTime(NamedTuple):
    """Kernel milliseconds per call (None: not measured), the complete
    passes out of those taken, and the complete passes' spread ((max -
    min) / median)."""

    ms: float | None
    kept: int
    passes: int
    spread: float

    def __str__(self) -> str:
        if self.ms is None:
            return (f"not measured ({self.kept}/{self.passes} passes "
                    "recorded every kernel)")
        return (f"{self.ms:.4f} ms, {self.kept}/{self.passes} passes, "
                f"spread {self.spread:.1%}")


def device_ms(fn, iters: int = 10, want: int = 3,
              most: int = 10) -> DeviceTime:
    """Summed kernel durations per fn() call, from torch.profiler passes
    (CUDA activity) of `iters` calls each, each after one warm-up call.

    A kernel counts when its record carries the correlation id of a kernel
    launch the pass recorded, so no other thread's work and no record left
    from an earlier profile is summed. A pass counts only when every launch
    it recorded has its kernel record: the profiler can drop records
    (after a long traced run, passes have lost a third to all of their
    kernels while keeping every launch). Passes are taken until `want`
    are complete or `most` were run; the result is the median of the
    complete ones, and None when fewer than two are."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    totals, taken = [], 0
    while len(totals) < want and taken < most:
        taken += 1
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        launches = {e.correlation_id() for e in events
                    if e.device_type() != cuda and "LaunchKernel" in e.name()}
        kernels = {e.correlation_id(): e.duration_ns() for e in events
                   if e.device_type() == cuda
                   and e.correlation_id() in launches}
        if launches and len(kernels) == len(launches):
            totals.append(sum(kernels.values()) / iters / 1e6)
    if len(totals) < 2:
        return DeviceTime(None, len(totals), taken, 0.0)
    mid = float(np.median(totals))
    return DeviceTime(mid, len(totals), taken,
                      (max(totals) - min(totals)) / mid)


def images_regions(P: int, grids=((44, 44),) * 4):
    """ViT segment ids over P slots and the compressor's region ids (4 x 4
    patches, row-major patches inside each image) plus one query per
    region."""
    seg, reg = np.zeros(P, np.int32), np.zeros(P, np.int32)
    at, base = 0, 0
    for i, (h, w) in enumerate(grids):
        n = h * w
        seg[at:at + n] = i + 1
        r = ((np.arange(h)[:, None] // 4) * (-(-w // 4))
             + np.arange(w)[None] // 4).reshape(-1) + 1 + base
        reg[at:at + n] = r
        base = int(r.max())
        at += n
    return seg, reg, np.arange(1, base + 1, dtype=np.int32)


def flash_case(name: str, gen: torch.Generator) -> dict:
    """flash_attention kwargs (random bf16 q/k/v on the card) at one of the
    main path's K1/K5 call shapes, with synthetic packing:

      decode      B=4, Tq=1, 28 q / 4 kv heads, D=128, a 4,096-slot cache,
                  rows seeing 1,169/674/440/157 slots;
      prefill     B=4, T=2048 against the 4,096-slot cache, rows of
                  1,153/658/424/141 tokens;
      vit         8,192 patch slots, 16 heads, D=72, four 44 x 44-patch
                  images (7,744 real patches, pads attending pads);
      compressor  2,048 pooled queries (484 real, one per 4 x 4-patch
                  region of the same images) against the 8,192 patches;
      train_compressor  the same with 512 queries (the training batch);
      decoder     the training decoder: B=4, T=2048, slot positions, rows
                  of 2048/1800/1500/1153 real tokens.
    """
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    slots = np.arange(4096)[None]
    if name == "decode":
        pos = np.array([[1169], [674], [440], [157]], np.int32)
        return dict(q=rnd(4, 1, 28, 128), k=rnd(4, 4096, 4, 128),
                    v=rnd(4, 4096, 4, 128), causal=True, q_positions=t(pos),
                    kv_mask=t((slots <= pos).astype(np.int32)))
    if name == "prefill":
        lens = np.array([[1153], [658], [424], [141]])
        return dict(q=rnd(4, 2048, 28, 128), k=rnd(4, 4096, 4, 128),
                    v=rnd(4, 4096, 4, 128), causal=True,
                    q_positions=t(np.broadcast_to(
                        np.arange(2048, dtype=np.int32), (4, 2048))),
                    kv_mask=t((slots < lens).astype(np.int32)))
    if name == "decoder":
        lens = np.array([2048, 1800, 1500, 1153])
        live = np.arange(2048)[None] < lens[:, None]
        pos = np.where(live, np.arange(2048)[None], 0).astype(np.int32)
        return dict(q=rnd(4, 2048, 28, 128), k=rnd(4, 2048, 4, 128),
                    v=rnd(4, 2048, 4, 128), causal=True, q_positions=t(pos),
                    kv_positions=t(pos), kv_mask=t(live.astype(np.int32)),
                    slot_positions=True)
    seg, reg, qreg = images_regions(8192)
    if name == "vit":
        s = t(seg)[None]
        return dict(q=rnd(1, 8192, 16, 72), k=rnd(1, 8192, 16, 72),
                    v=rnd(1, 8192, 16, 72), causal=False, q_segment_ids=s,
                    kv_segment_ids=s)
    if name in ("compressor", "train_compressor"):
        Q = 2048 if name == "compressor" else 512
        qr = np.zeros(Q, np.int32)
        qr[:min(Q, len(qreg))] = qreg[:Q]
        return dict(q=rnd(1, Q, 16, 72), k=rnd(1, 8192, 16, 72),
                    v=rnd(1, 8192, 16, 72), causal=False,
                    q_segment_ids=t(qr)[None], kv_segment_ids=t(reg)[None])
    raise ValueError(f"unknown shape {name}")


# The serving engine's page pool (num_slots 4 x max_ctx 4,096 / page_size
# 64) at oryx_7b's widths: 4 kv heads of 28 q heads (G = 7), D = 128.
PAGED_POOL = (256, 64, 4, 128)
PAGED_SLOTS = 4
PAGED_LENGTHS = (1169, 1100, 1145, 1200)  # kv slots each slot holds
PAGED_LANES = 64  # prefill lanes of a ragged dispatch (512 / 8-step chunk)


def paged_pool_layer(pool_shape, gen, fmt=None):
    """One random bf16 pool layer, or (fmt "int8" / "fp8_e4m3") a QuantPages
    layer holding random values quantized on write, dequantized to bf16."""
    from oryx_tpu_torch.ops import paged_kv

    P, ps, Hk, D = pool_shape
    dev = torch.device("cuda")
    rows = torch.randn((P * ps, Hk, D), generator=gen, device=dev)
    if fmt is None:
        layer = paged_kv.init_paged_pool(1, P, ps, Hk, D,
                                         dtype=torch.bfloat16, device=dev)[0]
        layer.copy_(rows.view(P, ps, Hk, D))
        return layer
    layer = paged_kv.init_quant_pages(1, P, ps, Hk, D, fmt=fmt,
                                      dequant_dtype=torch.bfloat16,
                                      device=dev)[0]
    paged_kv.scatter_rows(layer, torch.arange(P * ps, device=dev), rows)
    return layer


def paged_case(name: str, gen: torch.Generator, fmt=None) -> dict:
    """A paged-kernel call at the serving engine's shapes (PAGED_POOL), with
    random q and pages (bf16, or an int8 / fp8_e4m3 pool) and synthetic
    block tables: each slot holds distinct random pages for its
    PAGED_LENGTHS slots and the sentinel P past them.

      decode          K3, R = 4, kv_lengths PAGED_LENGTHS;
      ragged_decode   K4, the 4 decode rows (segment = slot);
      ragged_prefill  K4, R = 68: the 4 decode rows, then 64 prefill lanes
                      of slot 3 at consecutive positions p0 .. p0 + 63
                      (`models/generate.py::paged_ragged_step`), p0 = 1,136,
                      the slot's decode row at p0 - 1.

    Returns dict(kind ("paged_decode" / "ragged_paged"), q, k, v, bt, ints
    (the int32 [R] operands), segments and visible counts per row)."""
    P, ps, Hk, D = PAGED_POOL
    dev = torch.device("cuda")
    maxp = 4096 // ps
    S = PAGED_SLOTS
    lens = list(PAGED_LENGTHS)
    p0 = 1136
    if name == "ragged_prefill":
        lens[3] = p0 + PAGED_LANES
    perm = torch.randperm(P, generator=gen, device=dev).tolist()
    bt = torch.full((S, maxp), P, dtype=torch.int32)
    for s_, n in enumerate(lens):
        for j in range(-(-n // ps)):
            bt[s_, j] = perm.pop()
    bt = bt.to(dev)
    k = paged_pool_layer(PAGED_POOL, gen, fmt)
    v = paged_pool_layer(PAGED_POOL, gen, fmt)
    if name in ("decode", "ragged_decode"):
        seg, vis = list(range(S)), lens
    elif name == "ragged_prefill":
        seg = list(range(S)) + [3] * PAGED_LANES
        vis = lens[:3] + [p0] + [p0 + 1 + i for i in range(PAGED_LANES)]
    else:
        raise ValueError(f"unknown paged shape {name}")
    R = len(seg)
    q = torch.randn((R, Hk * 7, D), generator=gen, device=dev).to(
        torch.bfloat16)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
    ints = ((i32(vis),) if name == "decode"
            else (i32(seg), i32([n - 1 for n in vis])))
    return dict(kind="paged_decode" if name == "decode" else "ragged_paged",
                q=q, k=k, v=v, bt=bt, ints=ints, segments=seg, visible=vis)


def paged_bound(q_numel: int, Hq: int, D: int, Hk: int, bt_numel: int,
                segments, visible, n_ints: int, fmt=None):
    """The least time (ms) the card could take for one paged-attention call,
    what bounds it ("bytes" or "operations"), and the kv rows, flops and
    bytes it counts: q and o once (bf16), the table and the n_ints int32
    [R] operands once, and each kv row some query sees once (a segment's
    visible prefix is its longest row's): 2 bytes a value, or 1 a code plus
    one 4-byte scale a row (shared by the Hk heads); against 4 * D flops
    per visible (q head, slot) pair, at the H100's bf16 peak."""
    longest: dict[int, int] = {}
    for s_, n in zip(segments, visible):
        longest[s_] = max(longest.get(s_, 0), max(0, n))
    kv_rows = sum(longest.values())
    row_bytes = Hk * D * 2 if fmt is None else Hk * D + 4
    nbytes = (2 * q_numel * 2 + bt_numel * 4 + n_ints * len(visible) * 4
              + 2 * kv_rows * row_bytes)
    flops = 4.0 * D * Hq * sum(max(0, n) for n in visible)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else
            "bytes", kv_rows, flops, nbytes)


def q8_shapes(llm) -> dict[str, tuple[int, tuple[int, ...], bool]]:
    """{product: (K, output widths of its launch, has bias)} of every int8
    launch of a decoder step: q/k/v and gate/up are grouped launches."""
    H, Dq = llm.hidden_size, llm.num_heads * llm.head_dim
    Dkv = llm.num_kv_heads * llm.head_dim
    I = llm.intermediate_size
    return {
        "qkv": (H, (Dq, Dkv, Dkv), llm.attention_bias),
        "o": (Dq, (H,), False),
        "gate_up": (H, (I, I), False),
        "down": (I, (H,), False),
        "lm_head": (H, (llm.vocab_size,), False),
    }


def q8_vision_shapes(cfg) -> dict[str, tuple[int, tuple[int, ...], str]]:
    """{product: (K, output widths, x dtype name)} of the int8 launches of
    the ViT (patch embedding in fp32, grouped q/k/v), the compressor and
    the projector: what `quantize_params` quantizes outside the decoder."""
    v, H = cfg.vision, cfg.llm.hidden_size
    Hv, P = v.hidden_size, v.num_channels * v.patch_size ** 2
    return {
        "patch_embed": (P, (Hv,), "f32"),
        "vit_qkv": (Hv, (Hv, Hv, Hv), "bf16"),
        "vit_o/compressor": (Hv, (Hv,), "bf16"),
        "vit_fc1": (Hv, (v.intermediate_size,), "bf16"),
        "vit_fc2": (v.intermediate_size, (Hv,), "bf16"),
        "projector_fc1": (Hv, (H,), "bf16"),
    }


def q8_case(K: int, Ns, M: int, bias: bool, gen: torch.Generator,
            dtype=torch.bfloat16, column_scale: bool = False) -> dict:
    """An int8 product (a grouped one for several widths) on the card:
    x [M, K] in `dtype`, for each width N of Ns a random [N, K] weight
    (normal 0.02, as the model's init) quantized per output channel
    (`utils.quant.quantize_array`) or, with column_scale, per input column
    (a tied head: the embedding table's scales), and a bias."""
    from oryx_tpu_torch.utils.quant import quantize_array

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    members = []
    for N in ((Ns,) if isinstance(Ns, int) else tuple(Ns)):
        w = (randn(N, K) * 0.02).to(dtype)
        q, scale = quantize_array(w, dim=-2 if column_scale else -1)
        members.append((q, scale.reshape(-1).contiguous(),
                        (randn(N) * 0.02).to(dtype) if bias else None))
    return dict(x=randn(M, K).to(dtype), members=members,
                column_scale=column_scale)


PEAK_F32 = 67e12  # H100 SXM fp32 outside the tensor cores


def q8_bound(M: int, Ns, K: int, xbytes: int = 2) -> tuple[float, str]:
    """The least time (ms) the card could take for one (grouped) int8
    product of output widths Ns, and what bounds it: the codes, the fp32
    scales, x and y once (K N + 4 N + xbytes (M K + M N) bytes, N summed
    over Ns) over 3.35 TB/s against 2 M N K flops over the bf16 peak (the
    fp32 peak for fp32 x)."""
    N = Ns if isinstance(Ns, int) else sum(Ns)
    nbytes = K * N + 4 * N + xbytes * (M * K + M * N)
    peak = PEAK_F32 if xbytes == 4 else PEAK_FLOPS
    t_ops = 2.0 * M * N * K / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def q8_calls(kw: dict):
    """(kernel, plain twin, library) callables of one `q8_case`: the
    kernel is the grouped wrapper (one launch), the twin dequantizes and
    runs F.linear per member, the library call is one F.linear on the
    members' dequantized weights stacked (the port never calls it)."""
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    x, members = kw["x"], kw["members"]
    col = kw.get("column_scale", False)
    w = torch.cat([q8.dequantize_weight(q, s, x.dtype, col)
                   for q, s, _ in members])
    b = (None if members[0][2] is None
         else torch.cat([bb.to(x.dtype) for _, _, bb in members]))
    return (lambda: q8.q8_linear_group(x, members, column_scale=col),
            lambda: [q8.q8_linear_reference(x, q, s, bb, column_scale=col)
                     for q, s, bb in members],
            lambda: torch.nn.functional.linear(x, w, b))


def q8_compare(kw: dict, atol: float = 1e-2, rtol: float = 1e-2) -> dict:
    """The q8 kernel against its plain twin on one case (`q8_case`), over
    all members of the launch: the largest error and whether it is within
    atol + rtol |twin|; each one's relative L2 error against an fp32
    witness (the exact fp32 product of the same x and dequantized weight);
    whether a second launch gives the same bits; whether each row's bits
    do not depend on the other rows inside the route (calls on the first
    lo, lo + 3 and 2 lo - 1 rows and on the last lo rows, lo the route's
    fewest rows, where that stays below M); whether a grouped launch gives
    each member the bits of its own launch; and, past SMALL_ROWS rows,
    whether the first SMALL_ROWS rows get the same bits on the small route
    (`cross_route`, None below: reported, not required)."""
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    x, members = kw["x"], kw["members"]
    col = kw.get("column_scale", False)
    M = x.shape[0]

    def kernel(rows):
        return torch.cat(q8.q8_linear_group(rows, members,
                                            column_scale=col), dim=-1)

    out = kernel(x)
    twin = torch.cat([q8.q8_linear_reference(x, q, s, b, column_scale=col)
                      for q, s, b in members], dim=-1)
    witness = torch.cat([torch.nn.functional.linear(
        x.float(), q8.dequantize_weight(q, s, x.dtype, col).float(),
        None if b is None else b.float()) for q, s, b in members], dim=-1)
    again = kernel(x)
    lo, _ = q8.route_rows(q8.route_of(M, x.dtype == torch.bfloat16))
    views = [slice(0, m) for m in sorted({lo, lo + 3, 2 * lo - 1}) if m < M]
    views += [slice(M - lo, M)] if M > lo else []
    rows = all(torch.equal(kernel(x[v]), out[v]) for v in views)
    alone = torch.cat([q8.q8_linear(x, q, s, b, column_scale=col)
                       for q, s, b in members], dim=-1)
    cross = None
    if M > q8.SMALL_ROWS:
        cross = torch.equal(kernel(x[:q8.SMALL_ROWS]), out[:q8.SMALL_ROWS])
    torch.cuda.synchronize()
    err = (out.float() - twin.float()).abs()

    def rel(a):
        return float((a.float() - witness).norm() / witness.norm())

    return dict(
        max_abs_err=float(err.max()),
        within=bool((err <= atol + rtol * twin.float().abs()).all()),
        rel_kernel=rel(out), rel_twin=rel(twin),
        same_bits=torch.equal(out, again), rows_independent=rows,
        grouped_equal=torch.equal(out, alone), cross_route=cross,
        finite=bool(torch.isfinite(out).all()),
    )
