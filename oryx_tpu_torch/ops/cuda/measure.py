"""Timing on the card and synthetic K1/K5 call shapes, shared by
`chip_smoke.py` and the kernel check scripts (`scripts/torch_flash_*_check.py`).
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
