#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. The card (nvidia-smi name and power limit, torch/CUDA versions) and the
     build of every kernel from `oryx_tpu_torch/csrc` (one nvcc per source,
     in parallel), with each kernel's registers and spills from ptxas.
  2. The main path's host side at full width (`config.oryx_7b()`, a
     four-request image/multi-image/video/text mix), then each kernel call
     shape of that path (ViT segments, compressor regions, decoder prefill:
     K1's wgmma/TMA body over the cell map; decode: its split-KV route) run
     through the kernel and through its plain PyTorch twin on the same bf16
     inputs, held to atol = rtol = 1e-2 on the rows callers keep, and
     against an fp32 witness (the twin on the same inputs upcast): the
     kernel's relative L2 error at most NOISE_RATIO times the bf16 twin's.
     Median wrapper time from CUDA events ("ms") beside the kernels'
     device time per call from torch.profiler ("device_ms": the summed
     kernel durations, the cell map's or the decode merge's launches
     included, copies left out: `measure.device_ms`, the median of up to
     three passes that kept a record of every kernel they launched, with
     their spread; null when fewer than two did), the twin's time, SDPA
     with a boolean mask as a yardstick, and the least time the card could
     take (bytes / 3.35 TB/s vs flops / 989 TFLOP/s).
  3. `Pipeline.chat_batch` on the mix, greedy, 32 new tokens, random bf16
     weights from torch.Generator("cuda") seeded 0, three times: the tokens
     must be identical, the kernel must have launched for every call
     shape in the first run, and every decode call must have taken K1's
     split-KV decode route.
  4. The same mix with attn_impl="xla" (plain attention); greedy token
     agreement with the kernel path is printed, not asserted. Prefill
     last-token logits of both bf16 paths are held against an fp32 witness
     (plain attention, the same bf16 weights upcast in every product): per
     row, the kernel path's relative L2 error may be at most NOISE_RATIO
     times the plain path's, so the kernel adds no error beyond bf16
     rounding noise.
  5. One more chat_batch under torch.profiler (CUDA activity only, so the
     host is barely slowed): device time by kernel family, the top
     kernels, K1's share of the device time, and the device's idle share
     inside the trace (1 - union of kernel intervals / the call's wall).
  7. The serving engine, `ContinuousScheduler`, at full width on the
     phase-1 weights: 4 slots, 64-token pages, 8-step chunks, max_ctx
     4096, the default 256-page pool, greedy, the prefix cache on (the
     engine's default; each request's cached tokens are printed); the
     four requests above at
     32 new tokens plus four text requests at 8/16/24/48 (8 requests on
     4 slots). The split engine (paged prefill through the flash kernel,
     decode through the paged-decode kernel K3) and the ragged engine
     (prefill_chunk 512: every step one packed dispatch through the
     ragged-paged kernel K4), twice each: every request finishes with its
     usage, the two runs of an engine give identical tokens, and K3 (split)
     or K4 (ragged) launched. Walls, TTFTs, tokens/s, dispatches by kind,
     peak memory. The first run of each engine records the paged kernels'
     call operands (one call per forward, on layer 0's pool). A fifth,
     split-engine run under torch.profiler, as in phase 5.
  6. (Runs after 7.) Each paged kernel at the largest call phase 7
     recorded - K3 on a split decode step, K4 on a ragged step with
     prefill lanes and on a pure decode step - and the flash kernel at the
     split engine's largest paged prefill, with random bf16 q and pages,
     against its plain twin (atol = rtol = 1e-2, every row sees a key).
     The paged kernels are called through the public wrappers the model
     calls (`ragged_decode_attention`, `ragged_paged_attention`), on q in
     the recorded layout and the int operands as recorded. Each call's
     split plan and row tile are printed (more than one split; where
     prefill lanes ride behind the decode rows, row tiles of 64 / G rows
     behind one-row tiles of the decode rows), and two calls must give
     the same bits. Wrapper and
     twin times, gather_pages + SDPA with an explicit mask as a two-call
     yardstick, and the least time the card could take.
  8. The tiny fp32 config through both engines on the card (kernel path)
     and on the CPU (plain twins), over a bf16 and an int8 pool with the
     prefix cache on: replies, finish reasons and usage equal.
  9. The training kernels at three call shapes of phase 10's steps (the
     ViT's segments over the packed patches and the decoder's B x T with
     slot positions on the image batch, the compressor's 4 x 4-patch
     regions on the video batch): K1 with its logsumexp, K5a (dq) and K5b
     (dk/dv) on random bf16 q/k/v and a cotangent zero on fully masked
     rows, against their plain twins. K1: atol = rtol = 1e-2 on the
     output, the lse to 1e-3; K5: the relative L2 error of each of dq,
     dk, dv against an fp32 witness (the twins on the same inputs upcast)
     at most NOISE_RATIO times the bf16 twin's. Times (event and device)
     as phase 2; the yardstick is SDPA forward (K1) and forward + backward
     (K5) with an explicit boolean mask.
 10. `Trainer.fit` under scripts/configs/oryx_7b_pretrain.json (stage-1
     projector pretraining, remat "attn", bf16) at full oryx_7b width and
     depth on phase 2's bf16 weights (frozen; the compressor gets fp32
     masters): `grouped_batch_iterator` over 8 synthetic records (4 images
     of 616x616, 4 videos of 8 frames of 224x224, 8,192-patch ViT
     buffers), the byte tokenizer, the plain template, batch 4, 4 steps
     (global batch 256 -> 4, steps 2000 -> 4). Losses finite, frozen leaves
     bitwise unchanged, compressor changed, K1-lse/K5a/K5b launched at
     every phase-9 shape, and a second fit from the same init gives the
     same losses. Per step: wall, tokens/s, fwd+bwd vs optimizer device
     time, peak memory; then one step under torch.profiler and K5a +
     K5b's share of it.
 11. The tiny fp32 config, tune full, 3 steps of Trainer.fit on the card
     (kernels) and on the CPU (plain twins): losses and params agree.

 12. (Runs after 8.) The serving engine over an int8 pool (kv_dtype="int8") with a 256 MiB
     host tier, split and ragged, twice each, on the phase-2 weights:
     phase 7's eight requests; round A, five text requests sharing a
     1,536-byte context (24 pages), the last page-aligned; round B, the
     same five again (each splices its own cached prompt pages; the
     page-aligned one copies its last page on write); then every cached
     page is evicted, spilling to host RAM; round C, the first four again
     (reloaded from host). Every request finishes with its usage, the two
     runs give identical tokens, K3q (split) or K4q (ragged) launched, the
     cache hit, copied on write, spilled and reloaded, round C's replies
     equal round B's (the same cached bytes, the same suffix prefill) and
     the pool invariant holds. Cold-vs-cached and int8-vs-bf16 agreement
     are printed. Then generate_paged(kv_dtype="fp8_e4m3") on round A's
     prompts, split and ragged (the engine takes no fp8 pool).
 13. (Runs after 12.) K3q at phase 12's largest split decode step, K4q at
     its largest ragged step with prefill lanes and its largest pure decode
     step, each on random int8 and fp8 pools through the public wrappers,
     against the plain twins (dequantizing gather, atol = rtol = 1e-2), timed
     as in phase 6 (the yardstick: dequantizing gather_pages + SDPA).

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

TOL = 1e-2  # kernel vs plain twin, bf16 outputs (atol = rtol)
NOISE_RATIO = 1.5  # kernel path vs plain path, error against the fp32 witness
MAX_NEW = 32
EOS = 151645


class ByteTokenizer:
    """Stand-in byte-level tokenizer: encodes text as its UTF-8 bytes, and
    decodes losslessly (ASCII as itself, any other id - random weights emit
    them - as "<id>"), so equal replies mean equal tokens. Keeps the ids of
    every decode call, so a run's tokens can be compared."""

    def __init__(self) -> None:
        self.decoded: list[list[int]] = []

    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids]
        self.decoded.append(ids)
        return "".join(
            chr(i) if i < 128 else f"<{i}>" for i in ids
            if not (skip_special_tokens and i == EOS)
        )


def requests():
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    return [
        {"question": "Describe this image.", "images": [img(448, 448)]},
        {"question": "What differs between the two images?",
         "images": [img(448, 448), img(448, 448)]},
        {"question": "What happens in this video?",
         "images": [img(448, 448) for _ in range(8)], "is_video": True},
        {"question": "Write a short poem about the sea."},
    ]


def print_ptxas(log: str) -> None:
    """Each kernel's registers and spills from nvcc's -Xptxas -v lines (the
    entry's name, then its usage), and any wgmma serialization warning."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "wgmma" in line:
            print(f"  ptxas: {line.strip()}")
        elif "spill" in line and entry:
            print(f"  ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
        elif "registers" in line and entry:
            print(f"  ptxas: {entry}: {line.split(':', 1)[-1].strip()}")


def attention_cases(pipe, reqs, gen):
    """The four flash-attention call shapes of the main path, with the
    packing metadata and lengths of the real request mix and random bf16
    q/k/v. Each case: (name, kwargs for flash_attention, [B, Tq] bool of
    the rows callers keep)."""
    from oryx_tpu_torch.ops.packing import round_up_bucket

    cfg = pipe.cfg
    _, packed, batch = pipe.pack_requests(reqs)
    dev = pipe.device
    B, T = batch.token_ids.shape
    S = round_up_bucket(T + MAX_NEW)
    lengths = torch.from_numpy(batch.lengths).to(dev).long()
    P, Q = packed.segment_ids.shape[0], packed.q_region_ids.shape[0]
    hv, dv = cfg.vision.num_heads, cfg.vision.head_dim
    hq, hk, d = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    print(f"  main-path shapes: {packed.num_patches} patches in a {P} "
          f"bucket, {packed.num_queries} queries in a {Q} bucket, rows "
          f"{batch.lengths.tolist()} in a {T} bucket, cache {S} slots")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    seg = torch.from_numpy(packed.segment_ids).to(dev)[None]
    reg = torch.from_numpy(packed.region_ids).to(dev)[None]
    qreg = torch.from_numpy(packed.q_region_ids).to(dev)[None]
    slots = torch.arange(S, device=dev)[None]
    dec_pos = lengths[:, None] + MAX_NEW // 2
    return [
        ("vit", dict(q=rnd(1, P, hv, dv), k=rnd(1, P, hv, dv),
                     v=rnd(1, P, hv, dv), causal=False,
                     q_segment_ids=seg, kv_segment_ids=seg), seg > 0),
        ("compressor", dict(q=rnd(1, Q, hv, dv), k=rnd(1, P, hv, dv),
                            v=rnd(1, P, hv, dv), causal=False,
                            q_segment_ids=qreg, kv_segment_ids=reg),
         qreg > 0),
        ("prefill", dict(q=rnd(B, T, hq, d), k=rnd(B, S, hk, d),
                         v=rnd(B, S, hk, d), causal=True,
                         q_positions=torch.arange(T, device=dev).expand(B, T),
                         kv_mask=(slots < lengths[:, None]).int()),
         torch.arange(T, device=dev)[None] < lengths[:, None]),
        ("decode", dict(q=rnd(B, 1, hq, d), k=rnd(B, S, hk, d),
                        v=rnd(B, S, hk, d), causal=True,
                        q_positions=dec_pos,
                        kv_mask=(slots <= dec_pos).int()),
         torch.ones((B, 1), dtype=torch.bool, device=dev)),
    ]


def check_kernel_case(name, kw, keep):
    """Kernel vs plain twin on one call shape; returns the table row."""
    from oryx_tpu_torch.ops.cuda.measure import (
        PEAK_BYTES, PEAK_FLOPS, cuda_time_ms, device_ms,
    )
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    args, flags = fa._prepare(
        q, k, v, rest.get("q_positions"), None, rest.get("q_segment_ids"),
        rest.get("kv_segment_ids"), rest.get("kv_mask"), rest["causal"],
        None,
    )
    decode = sum(fa.LAUNCHES_DECODE.values())
    got = fa.flash_attention(q, k, v, **rest)
    route = ("split-KV decode" if sum(fa.LAUNCHES_DECODE.values()) > decode
             else "wgmma/TMA body over the cell map")
    ref = fa._mha_forward_reference(*args, **flags).transpose(1, 2)
    wit = fa._mha_forward_reference(*(x.float() for x in args[:3]),
                                    *args[3:], **flags).transpose(1, 2)
    torch.cuda.synchronize()
    g, r, w = got[keep].float(), ref[keep].float(), wit[keep]
    err = (g - r).abs()
    max_err = float(err.max())
    ek, ep = _rel(g, w), _rel(r, w)
    ok = bool((err <= TOL + TOL * r.abs()).all()) and bool(
        torch.isfinite(g).all()
    )
    print(f"  {name} [{route}]: q {tuple(q.shape)} k {tuple(k.shape)} "
          f"max_abs_err={max_err:.3e} ok={ok}; rel L2 vs fp32 witness "
          f"kernel {ek:.3e} plain {ep:.3e} (ratio {ek / ep:.3f}, limit "
          f"{NOISE_RATIO})")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain twin on {name}")
    if ek > NOISE_RATIO * ep:
        raise SystemExit(f"K1 on {name} is further from the fp32 witness "
                         "than bf16 noise allows")

    ms = cuda_time_ms(lambda: fa._mha_forward(*args, **flags), iters=20)
    dev_t = device_ms(lambda: fa._mha_forward(*args, **flags))
    plain_ms = cuda_time_ms(
        lambda: fa._mha_forward_reference(*args, **flags), iters=3, warmup=1
    )
    # SDPA yardstick: the same masked function with an explicit boolean
    # mask, k/v repeated to the q heads outside the timed call.
    qp, kp, vp, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    B, Hq, Tq, D = qp.shape
    G = Hq // kp.shape[1]
    mask = kv_valid[:, None, :] > 0
    if flags["causal"]:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        mask = mask & (q_seg[:, :, None] == kv_seg[:, None, :])
    kr = kp.repeat_interleave(G, dim=1)
    vr = vp.repeat_interleave(G, dim=1)
    m4 = mask[:, None]
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kr, vr, attn_mask=m4, scale=flags["scale"]
        ),
        iters=10,
    )
    # Least time: what this run's data needs - q, o and the int arrays once,
    # k and v only at kv rows some query can see - vs 4 * D flops per
    # unmasked (q, kv) pair per q head.
    pairs = int(mask.sum())
    flops = 4.0 * D * Hq * pairs
    kv_rows = int(mask.any(dim=1).sum())  # over batch rows
    nbytes = (
        2 * qp.numel() * qp.element_size()
        + 2 * kv_rows * kp.shape[1] * D * kp.element_size()
        + sum(x.numel() * 4 for x in (q_pos, kv_pos, q_seg, kv_seg, kv_valid))
    )
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"    kernel {ms:.4f} ms (device {dev_t}) | plain "
          f"{plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound "
          f"{max(t_ops, t_bytes):.4f} ms (unmasked pairs {pairs}, "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    key = (flags["causal"], flags["has_segments"], B, Hq, kp.shape[1], Tq,
           kp.shape[2], D)
    return key, {
        "name": f"flash_fwd[{name}]",
        "route": "cuda",
        "source": "oryx_tpu_torch/csrc/flash_attention.cu",
        "replaces": "oryx_tpu/ops/pallas/flash_attention.py:206",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev_t.ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def run_main_path(pipe, reqs, tok):
    """One chat_batch on the mix; returns (replies, counts, timings,
    tokens, launches, seconds, peak bytes, decode-route launches)."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    tok.decoded.clear()
    fa.LAUNCHES.clear()
    fa.LAUNCHES_DECODE.clear()
    t0 = time.perf_counter()
    replies, counts = pipe.chat_batch(
        reqs, max_new_tokens=MAX_NEW, return_token_counts=True,
        timings=timings,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    return (replies, counts, timings, [list(t) for t in tok.decoded],
            launches, wall, torch.cuda.max_memory_allocated(),
            dict(fa.LAUNCHES_DECODE))


def prefill_logits(pipe, reqs):
    """Last-token logits [B, V] of the mix's prefill, through the same
    encode, splice and prefill functions chat_batch runs."""
    from oryx_tpu_torch.models import generate, oryx
    from oryx_tpu_torch.ops.packing import round_up_bucket

    _, packed, batch = pipe.pack_requests(reqs)
    cfg = pipe.cfg
    T = batch.token_ids.shape[1]
    with torch.inference_mode():
        arrays = oryx.stage_mm_arrays(packed, batch, pipe.device)
        embeds = oryx.mm_embeds(pipe.params, cfg, arrays)
        logits, _ = generate.prefill(
            pipe.params.llm, cfg.llm, embeds, arrays["lengths"],
            cache_len=round_up_bucket(T + MAX_NEW), attn_impl=cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(cfg),
        )
    return logits.float()


def kernel_family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n or "flash_decode" in n:
        return "flash_fwd K1 (hand-written attention forward)"
    if "tile_map" in n:
        return "tile_map (K1/K5 cell map)"
    if "flash_bwd" in n:
        return "flash_bwd K5a/K5b (hand-written attention backward)"
    if any(s in n for s in ("paged_split", "paged_merge", "paged_f32")):
        return "paged attention K3/K4 (hand-written)"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                            "sm90_", "sm80_")):
        return "GEMM/GEMV (cuBLAS: F.linear, torch.matmul)"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "reduce" in n:
        return "reductions"
    if "index" in n or "gather" in n or "scatter" in n:
        return "indexing"
    return "other"


def profile_call(fn):
    """fn() under torch.profiler, CUDA activity only: device time by kernel
    family, the top kernels, and the device's idle share inside the trace.
    Raises when the trace holds no device time. Returns (device us by
    family, the call's wall us)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    by_family: collections.Counter = collections.Counter()
    by_name: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[kernel_family(e.name)] += us
        by_name[e.name] += us
        count[e.name] += 1
        spans.append((e.time_range.start, e.time_range.end))
    # Busy time: the union of the kernel intervals (streams may overlap).
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    dev_us = sum(by_family.values())
    print(f"  profiled wall {wall_us / 1e3:.1f} ms; {len(kernels)} kernel "
          f"launches, kernel time {dev_us / 1e3:.1f} ms, busy (union) "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.1%} of the wall: idle "
          f"share {1 - busy / wall_us:.1%}")
    print("  device time by family:")
    for fam, us in by_family.most_common():
        print(f"    {fam:44s} {us / 1e3:10.2f} ms  {us / dev_us:6.1%}")
    print("  top kernels by device time:")
    for name, us in by_name.most_common(12):
        print(f"    {us / 1e3:10.2f} ms  x{count[name]:<6d} {name[:90]}")
    return by_family, wall_us


# ---- serving engine (phases 6-8) -------------------------------------------

SERVE = dict(num_slots=4, page_size=64, chunk=8, max_ctx=4096)
PREFILL_CHUNK = 512  # ragged engine: pf_width = 512 / 8 = 64 lanes


def serve_requests():
    """(request, max_new) x 8: the chat_batch mix at MAX_NEW tokens plus
    four text requests of other lengths, so slots free and admit at chunk
    boundaries."""
    texts = [("Name three colours.", 8), ("Count to ten.", 16),
             ("What is a paged KV cache?", 24),
             ("Tell me a long story about a lighthouse keeper.", 48)]
    return [(r, MAX_NEW) for r in requests()] + [
        ({"question": q}, n) for q, n in texts
    ]


def _plane_ptr(plane) -> int:
    """Address of a pool plane's values or codes (dense or QuantPages)."""
    return getattr(plane, "q", plane).data_ptr()


class PagedCallRecorder:
    """While active, keeps q's layout (shape and strides) and the int
    operands, as given, of every paged-kernel call made on layer 0 of
    `sched`'s pool (one call per forward), cloned on the device without a
    sync, for phase 6 to replay through the same wrappers."""

    def __init__(self, sched):
        self.layer0 = _plane_ptr(sched.kv_pages["k"][0])
        self.calls: dict[str, list] = {"paged_decode": [], "ragged_paged": []}

    def __enter__(self):
        from oryx_tpu_torch.ops.cuda import paged_attention as pa

        self._orig = (pa.ragged_decode_attention, pa.ragged_paged_attention)
        dec, rag = self._orig

        def rec_dec(q, k, v, bt, lens, **kw):
            if _plane_ptr(k) == self.layer0:
                self.calls["paged_decode"].append(
                    ((tuple(q.shape), q.stride()), bt.clone(), lens.clone())
                )
            return dec(q, k, v, bt, lens, **kw)

        def rec_rag(q, k, v, bt, seg, pos, **kw):
            if _plane_ptr(k) == self.layer0:
                self.calls["ragged_paged"].append(
                    ((tuple(q.shape), q.stride()), bt.clone(), seg.clone(),
                     pos.clone())
                )
            return rag(q, k, v, bt, seg, pos, **kw)

        pa.ragged_decode_attention = rec_dec
        pa.ragged_paged_attention = rec_rag
        return self

    def __exit__(self, *exc):
        from oryx_tpu_torch.ops.cuda import paged_attention as pa

        pa.ragged_decode_attention, pa.ragged_paged_attention = self._orig
        return False


def run_scheduler(pipe, ragged: bool, record: bool):
    """One scheduler run over serve_requests(); returns a dict of what it
    served, what it cost and which kernels it launched (counts zeroed just
    before the run and read just after)."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(
        pipe, autostart=False, ragged=ragged,
        prefill_chunk=PREFILL_CHUNK if ragged else None, **SERVE,
    )
    reqs = serve_requests()
    recorder = PagedCallRecorder(sched) if record else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        handles = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.close()
    sched.check_pool_invariant()
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    return {
        "results": results, "caps": [n for _, n in reqs], "wall": wall,
        "ttft": [h.debug["ttft_s"] for h in handles],
        "cached": [h.debug["cached_tokens"] for h in handles],
        "metrics": sched.metrics, "peak": torch.cuda.max_memory_allocated(),
        "flash": dict(fa.LAUNCHES), "paged": dict(paged),
        "paged_keys": dict(pa.LAUNCHES), "recorder": recorder,
    }


def check_serving_run(mode: str, i: int, run: dict, code: str = "") -> None:
    """Print one phase-7 (or phase-12) run and fail on a request without its
    usage or a missing kernel launch; `code` is the kernel name suffix of a
    quantized pool ("_int8")."""
    m = run["metrics"]
    gen = sum(u[1] for _, _, u in run["results"])
    print(f"  {mode} run {i}: wall {run['wall']:.3f} s | {gen} tokens, "
          f"{gen / run['wall']:.1f} tok/s | dispatches "
          f"{dict(m['dispatches_total'])} | evicted {m['evicted']} | peak "
          f"{run['peak'] / 1e9:.2f} GB | paged launches {run['paged']} | "
          f"flash launches {sum(run['flash'].values())}")
    print(f"    TTFT s: {[round(t, 4) for t in run['ttft']]}")
    print(f"    cached tokens: {run['cached']} (prefix cache hits "
          f"{m['prefix_cache_hit_tokens_total']}, misses "
          f"{m['prefix_cache_miss_tokens_total']})")
    for r, ((reply, reason, (pt, gt)), cap) in enumerate(
        zip(run["results"], run["caps"])
    ):
        print(f"    request {r}: prompt {pt}, generated {gt}/{cap} "
              f"({reason}), reply {reply[:32]!r}")
        if pt < 1 or not (
            gt == cap if reason == "length" else 1 <= gt <= cap
        ):
            raise SystemExit(f"{mode}: request {r} has usage {(pt, gt)}")
    want = ("ragged_paged" if mode == "ragged" else "paged_decode") + code
    other = ("paged_decode" if mode == "ragged" else "ragged_paged") + code
    if not run["paged"].get(want) or run["paged"].get(other):
        raise SystemExit(f"{mode}: paged kernel launches {run['paged']}")
    if not run["flash"]:
        raise SystemExit(f"{mode}: the flash kernel never launched")


def _pick(calls, work):
    """The recorded call with the most work (host reads after the run)."""
    if not calls:
        raise SystemExit("phase 7 recorded no call of this kind")
    return max(calls, key=work)


def paged_kernel_case(name, kind, call, pool_shape, gen, fmt=None):
    """Kernel vs plain twin at one recorded call, both through the public
    functions the model calls, on q in the recorded layout and the int
    operands as the model passed them, over a bf16 pool or (fmt) an int8 /
    fp8 one; returns the table row."""
    from oryx_tpu_torch.ops.cuda.measure import (
        cuda_time_ms, device_ms, paged_bound, paged_pool_layer,
    )
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    P, ps, Hk, D = pool_shape
    (q_shape, q_stride), bt = call[0], call[1]
    R, Hq = q_shape[0], q_shape[-2]
    dev = bt.device
    kp = paged_pool_layer(pool_shape, gen, fmt)
    vp = paged_pool_layer(pool_shape, gen, fmt)
    q = torch.empty_strided(q_shape, q_stride, dtype=torch.bfloat16,
                            device=dev)
    q.copy_(torch.randn(q_shape, generator=gen, device=dev))
    S, maxp = bt.shape
    if kind == "paged_decode":
        lens = call[2]
        seg = torch.arange(R, device=dev)
        visible = lens.long()
        kernel = lambda: pa.ragged_decode_attention(  # noqa: E731
            q, kp, vp, bt, lens)
        plain = lambda: paged_kv.ragged_decode_attention(  # noqa: E731
            q, kp, vp, bt, lens)
    else:
        seg, pos = call[2], call[3]
        visible = pos.long() + 1
        kernel = lambda: pa.ragged_paged_attention(  # noqa: E731
            q, kp, vp, bt, seg, pos)
        plain = lambda: paged_kv.ragged_paged_attention(  # noqa: E731
            q, kp, vp, bt, seg, pos)
    before = sum(pa.LAUNCHES.values())
    got, ref = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    if sum(pa.LAUNCHES.values()) != before + 2:
        raise SystemExit(f"{name}: the wrapper did not launch the kernel")
    if not torch.equal(got, again):
        raise SystemExit(f"{name}: two calls gave different bits")
    # The split plan: more than one split, and row tiles of 64 / G rows
    # where prefill lanes are packed behind the decode rows.
    G = Hq // Hk
    plan = pa.plan_of(kind, R, S, Hk, G, maxp, ps,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    want_rt = 1 if kind == "paged_decode" or R <= S else pa.A_ROWS // G
    if plan["row_tile"] != want_rt or plan["splits"] < 2:
        raise SystemExit(f"{name}: plan {plan}, want row tile {want_rt} "
                         "and more than one split")
    if got.shape != q.shape or got.dtype != q.dtype:
        raise SystemExit(f"{name}: output {tuple(got.shape)} {got.dtype}")
    got, ref = got.reshape(R, Hq, D), ref.reshape(R, Hq, D)
    keep = visible > 0
    g, r = got[keep].float(), ref[keep].float()
    err = (g - r).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL + TOL * r.abs()).all()) and bool(
        torch.isfinite(g).all()
    )
    print(f"  {name}: q {tuple(q.shape)} stride {q_stride} pool "
          f"{tuple(kp.shape)} {fmt or 'bf16'} table {tuple(bt.shape)} "
          f"{bt.dtype}, ints "
          f"{(call[2].dtype)}, visible slots per row "
          f"{visible.min().item()}..{visible.max().item()} "
          f"max_abs_err={max_err:.3e} ok={ok}; plan: {plan['splits']} "
          f"splits of {plan['tps']} 64-slot tiles, row tile "
          f"{plan['row_tile']} rows after {plan['lead']} one-row tiles; two "
          "calls bitwise equal")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain twin")
    ms = cuda_time_ms(kernel, iters=50)
    dev_t = device_ms(kernel)
    plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
    # Yardstick, two PyTorch calls: gather the rows' pages, then SDPA with
    # an explicit boolean mask (GQA without repeating k/v).
    K = maxp * ps
    mask = (
        torch.arange(K, device=dev)[None, :] < visible[:, None]
    )[:, None, None, :]
    segl = seg.long().clamp(0, S - 1)

    def library():
        k = paged_kv.gather_pages(kp, bt)[segl].transpose(1, 2)
        v = paged_kv.gather_pages(vp, bt)[segl].transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(R, Hq, 1, D), k, v, attn_mask=mask, enable_gqa=True,
        )

    library_ms = cuda_time_ms(library, iters=10)
    bound, bound_by, kv_rows, flops, nbytes = paged_bound(
        q.numel(), Hq, D, Hk, bt.numel(), segl.tolist(), visible.tolist(),
        1 if kind == "paged_decode" else 2, fmt)
    print(f"    kernel {ms:.4f} ms (device {dev_t}) | plain "
          f"{plain_ms:.4f} ms | gather+sdpa "
          f"{library_ms:.4f} ms | bound {bound:.4f} ms "
          f"({kv_rows} kv rows read, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    if fmt is None:
        line = 144 if kind == "paged_decode" else 528
    else:  # the dequantizing branch of the page walk
        line = 106 if kind == "paged_decode" else 480
    return {
        "name": name,
        "route": "cuda",
        "source": "oryx_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"oryx_tpu/ops/pallas/paged_attention.py:{line}",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev_t.ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def paged_prefill_case(pipe, prompt_len: int, gen):
    """The split engine's flash-kernel call for its longest prompt: the
    bucketed prompt against the gathered max_ctx-wide stream, kv-masked at
    the prompt length (the gather itself is random bf16)."""
    from oryx_tpu_torch.ops.packing import round_up_bucket

    cfg = pipe.cfg.llm
    dev = pipe.device
    T, K = round_up_bucket(prompt_len), SERVE["max_ctx"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    slots = torch.arange(K, device=dev)[None]
    return ("paged_prefill", dict(
        q=rnd(1, T, cfg.num_heads, cfg.head_dim),
        k=rnd(1, K, cfg.num_kv_heads, cfg.head_dim),
        v=rnd(1, K, cfg.num_kv_heads, cfg.head_dim), causal=True,
        q_positions=torch.arange(T, device=dev)[None],
        kv_mask=(slots < prompt_len).int(),
    ), torch.arange(T, device=dev)[None] < prompt_len)


def tiny_engines_on_card() -> None:
    """Phase 8: the tiny fp32 config (input-sensitive weights) through the
    split and ragged engines on the card and on the CPU: equal replies."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    reqs = [
        ({"question": "hi there"}, 9),
        ({"question": "what is this?", "images": [img(40, 56)]}, 6),
        ({"question": "compare", "images": [img(60, 30), img(28, 28)]}, 7),
        ({"question": "what happens?", "images": [img(42, 42)] * 4,
          "is_video": True}, 5),
    ]
    # Two look-alike text prompts: the second splices the first's pages.
    reqs += [({"question": "hi there, and what else?"}, 6)]
    geom = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
    for kv_dtype, ragged in itertools.product(("bf16", "int8"), (False, True)):
        out = []
        pa.LAUNCHES.clear()
        for device in ("cpu", "cuda"):
            sched = ContinuousScheduler(
                Pipeline(ByteTokenizer(), params, cfg, device=device),
                autostart=False, ragged=ragged,
                prefill_chunk=32 if ragged else None, kv_dtype=kv_dtype,
                **geom,
            )
            hs = [sched.submit(r, n) for r, n in reqs]
            sched.start()
            out.append([h.result(timeout=600) for h in hs])
            cached = [h.debug["cached_tokens"] for h in hs]
            sched.close()
            sched.check_pool_invariant()
        mode = f"{'ragged' if ragged else 'split'} {kv_dtype}"
        print(f"  {mode}: card == cpu: {out[0] == out[1]}; paged launches "
              f"on the card {dict(collections.Counter(k[0] for k in pa.LAUNCHES.elements()))}; "
              f"cached tokens {cached}; replies {[r[0][:12] for r in out[1]]}")
        if out[0] != out[1] or not pa.LAUNCHES:
            raise SystemExit(f"tiny {mode} engine on the card differs from "
                             f"the CPU: {out[1]} vs {out[0]}")


# ---- the int8 engine and the prefix cache (phases 12-13) -------------------

HOST_CACHE = 256 << 20  # host tier of phase 12's engines


def shared_context() -> str:
    """1,536 bytes of a harbour log: the context phase 12's text requests
    share (24 pages of 64 byte-tokens with the template's head)."""
    lines, i = [], 0
    while sum(map(len, lines)) < 1536:
        lines.append(f"Harbour log {i:03d}: wind west at {i % 7 + 3} "
                     f"knots, {i % 5 + 1} boats out, calm grey water. ")
        i += 1
    return "".join(lines)[:1536]


def shared_requests(pipe) -> list[str]:
    """Five questions over the shared context. The first four are padded
    until their prompt ends 1..31 tokens into a page, so a reply of up to
    32 tokens donates no page past the prompt's last partial one: served
    again from the device cache or reloaded from host, each prefills the
    same suffix over the same cached bytes. The fifth ends on a page
    boundary: served again, its whole prompt is cached and the splice
    copies its last page on write."""
    ctx = shared_context()
    asks = ["How strong was the wind?", "How many boats went out?",
            "What colour was the water?", "Summarise the log.",
            "Which entry is the last?"]
    out = []
    for i, ask in enumerate(asks):
        q = ctx + ask
        while True:
            n = len(pipe._prepare_request({"question": q})[0]) % 64
            if (n == 0) if i == 4 else (1 <= n <= 31):
                break
            q += "?"
        out.append(q)
    return out


def quiesce(sched, timeout=60.0) -> None:
    """Wait until the engine holds no slot and no queued request."""
    deadline = time.monotonic() + timeout
    while any(r is not None for r in sched.slots) or sched.queue_len():
        if time.monotonic() > deadline:
            raise SystemExit("the engine did not go idle")
        time.sleep(0.01)


def run_int8_engine(pipe, ragged: bool, record: bool, shared: list[str]):
    """One phase-12 run (see the module docstring); counts zeroed just
    before, read just after. Returns a dict of what it served and cost."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(
        pipe, autostart=False, ragged=ragged,
        prefill_chunk=PREFILL_CHUNK if ragged else None, kv_dtype="int8",
        host_cache_bytes=HOST_CACHE, **SERVE,
    )
    recorder = PagedCallRecorder(sched) if record else None
    rounds: dict[str, list] = {}
    walls: dict[str, float] = {}

    def serve(label, reqs):
        t = time.perf_counter()
        hs = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        res = [h.result(timeout=600) for h in hs]
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        quiesce(sched)
        rounds[label] = list(zip(hs, res, [n for _, n in reqs]))

    texts = [({"question": q}, MAX_NEW) for q in shared]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        serve("phase 7 mix", serve_requests())
        serve("round A", texts)
        serve("round B", texts)
        cache = sched.prefix_cache
        t = time.perf_counter()
        spilled = cache.evict(cache.evictable_pages())
        spill_s = time.perf_counter() - t
        host_bytes = cache.host_bytes
        serve("round C", texts[:4])
    wall = time.perf_counter() - t0
    sched.close()
    sched.check_pool_invariant()
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    flat = [x for label in rounds for x in rounds[label]]
    return {
        "rounds": rounds, "walls": walls, "wall": wall,
        "results": [res for _, res, _ in flat],
        "caps": [n for _, _, n in flat],
        "ttft": [h.debug["ttft_s"] for h, _, _ in flat],
        "cached": [h.debug["cached_tokens"] for h, _, _ in flat],
        "metrics": sched.metrics, "peak": torch.cuda.max_memory_allocated(),
        "flash": dict(fa.LAUNCHES), "paged": dict(paged),
        "paged_keys": dict(pa.LAUNCHES), "recorder": recorder,
        "spilled": spilled, "spill_s": spill_s, "host_bytes": host_bytes,
        "pool_bytes": sum(
            t.numel() * t.element_size() for plane in sched.kv_pages.values()
            for t in (plane.q, plane.scale)
        ),
    }


def check_int8_run(mode: str, i: int, run: dict) -> None:
    """Print one phase-12 run; fail unless the cache hit, copied on write,
    spilled and reloaded, and round C's replies equal round B's."""
    check_serving_run(mode, i, run, code="_int8")
    m = run["metrics"]
    replies = {k: [res[0] for _, res, _ in v]
               for k, v in run["rounds"].items()}
    print(f"    walls s: { {k: round(v, 3) for k, v in run['walls'].items()} }"
          f"; evict of {run['spilled']} pages to host "
          f"{run['spill_s'] * 1e3:.1f} ms ({run['host_bytes'] / 1e6:.1f} MB)")
    print(f"    cache: hits {m['prefix_cache_hit_tokens_total']} tokens, "
          f"copy-on-write {m['prefix_cache_cow_pages_total']}, evicted "
          f"{m['prefix_cache_evicted_pages_total']} pages, reloads "
          f"{m['oryx_cache_reload_hit_total']} ({m['oryx_cache_reload_upload_total']}"
          f" pages uploaded); int8 pool {run['pool_bytes'] / 1e9:.3f} GB")
    same = sum(a == b for a, b in zip(replies["round A"], replies["round B"]))
    print(f"    cold/first-splice (round A) vs cached (round B) replies "
          f"equal (not asserted): {same}/5")
    if not (m["prefix_cache_hit_tokens_total"] > 0
            and m["prefix_cache_cow_pages_total"] >= 1 and run["spilled"] > 0
            and m["oryx_cache_reload_upload_total"] > 0):
        raise SystemExit(f"{mode}: the prefix cache did not hit, copy on "
                         f"write, spill and reload: {m}")
    if replies["round C"] != replies["round B"][:4]:
        raise SystemExit(f"{mode}: reloaded replies differ from the "
                         f"device-cached ones: {replies['round C']} vs "
                         f"{replies['round B'][:4]}")
    print("    reloaded (round C) replies equal the device-cached ones "
          "(round B)")


def generate_fp8(pipe, shared: list[str], ragged: bool):
    """generate_paged(kv_dtype="fp8_e4m3") over the first four shared
    prompts at full width; launch counts zeroed just before, read just
    after. Returns (tokens, launches by kernel name, wall)."""
    from oryx_tpu_torch.models import generate
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    ids = [pipe._prepare_request({"question": q})[0] for q in shared[:4]]
    T = max(map(len, ids))
    emb = pipe.params.llm.embed.weight
    dev = pipe.device
    x = torch.zeros((len(ids), T, emb.shape[1]), dtype=emb.dtype, device=dev)
    for b, row in enumerate(ids):
        x[b, :len(row)] = emb[torch.tensor(row, device=dev)]
    cfg = pipe.cfg
    torch.cuda.synchronize()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    toks, num, _ = generate.generate_paged(
        pipe.params.llm, cfg.llm, cfg.generation, inputs_embeds=x,
        lengths=[len(r) for r in ids], max_new_tokens=MAX_NEW,
        page_size=SERVE["page_size"], chunk=SERVE["chunk"],
        attn_impl="pallas", compute_dtype=emb.dtype,
        kv_dtype="fp8_e4m3", ragged=ragged, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        launches[key[0]] += n
    return toks, dict(launches), wall


# ---- training (phases 9-11) ------------------------------------------------

TRAIN_STEPS = 4
TRAIN_BATCH = 4
TRAIN_CONFIG = "scripts/configs/oryx_7b_pretrain.json"
TRAIN_CKPT = "checkpoints/chip_smoke"


def train_records():
    """8 pretraining records: 4 single images of 616x616 (44 x 44 = 1,936
    patches, 1x compression) and 4 videos of 8 frames of 224x224 (256
    patches a frame, 16x compression); each caption is supervised."""
    recs = []
    for i in range(4):
        recs.append({"id": f"img{i}", "image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"A photo of {i + 2} boats on a calm "
                                     "grey sea under a low sky."},
        ]})
        recs.append({"id": f"vid{i}", "video": f"vid{i}.mp4", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"A clip of {i + 2} gulls circling a "
                                     "harbour at dusk."},
        ]})
    return recs


def train_media(rec):
    """Random uint8 pixels seeded by the record id."""
    rng = np.random.default_rng(sum(map(ord, rec["id"])))
    if rec.get("video"):
        return [rng.integers(0, 256, (224, 224, 3), np.uint8)
                for _ in range(8)]
    return [rng.integers(0, 256, (616, 616, 3), np.uint8)]


def train_config():
    """oryx_7b_pretrain.json with its checkpoints inside the checkout
    (listed in .gitignore, removed after the phase)."""
    from oryx_tpu_torch import config

    with open(TRAIN_CONFIG) as f:
        cfg = config.OryxConfig.from_json(f.read())
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_dir=TRAIN_CKPT,
    ))


def train_batches(cfg, records=None, media=train_media, batch=TRAIN_BATCH,
                  **collate):
    """grouped_batch_iterator over the records (endless epochs)."""
    from oryx_tpu_torch.train import data

    ds = data.SupervisedDataset(
        records or train_records(), ByteTokenizer(), template="plain",
        max_patches_per_image=cfg.vision.max_patches_per_image,
        media_loader=media,
    )
    kw = dict(patch_size=cfg.vision.patch_size,
              base_grid=cfg.vision.base_grid, max_len=cfg.train.max_seq_len)
    kw.update(collate)
    return data.grouped_batch_iterator(ds, batch, seed=cfg.train.seed, **kw)


def training_attention_cases(cfg, host, host_vid, gen):
    """Three flash-attention call shapes of the training steps, with the
    packing metadata of the collated batches and random bf16 q/k/v: the
    ViT and the decoder of the image batch `host`, the compressor of the
    video batch `host_vid` (4 x 4-patch regions; on the image batch each
    region is one patch and the call has the ViT's launch key). Returns
    (name, flash_attention kwargs with q, k, v)."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    seg = t(host["segment_ids"])[None]
    reg, qreg = (t(host_vid[k])[None] for k in ("region_ids", "q_region_ids"))
    P, Q, Pc = seg.shape[1], qreg.shape[1], reg.shape[1]
    B, T = host["token_ids"].shape
    pos, amask = t(host["positions"]), t(host["attn_mask"])
    hv, dv = cfg.vision.num_heads, cfg.vision.head_dim
    hc = cfg.compressor.num_heads
    dc = cfg.vision.hidden_size // hc
    hq, hk, d = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    print(f"  training shapes: ViT {P} patches ({int((seg > 0).sum())} "
          f"real), compressor {Q} queries ({int((qreg > 0).sum())} real) "
          f"vs {Pc} patches, decoder {B} x {T} (rows "
          f"{amask.sum(1).tolist()})")
    return [
        ("vit", dict(q=rnd(1, P, hv, dv), k=rnd(1, P, hv, dv),
                     v=rnd(1, P, hv, dv), causal=False, q_segment_ids=seg,
                     kv_segment_ids=seg)),
        ("compressor", dict(q=rnd(1, Q, hc, dc), k=rnd(1, Pc, hc, dc),
                            v=rnd(1, Pc, hc, dc), causal=False,
                            q_segment_ids=qreg, kv_segment_ids=reg)),
        ("decoder", dict(q=rnd(B, T, hq, d), k=rnd(B, T, hk, d),
                         v=rnd(B, T, hk, d), causal=True, q_positions=pos,
                         kv_positions=pos, kv_mask=amask,
                         slot_positions=True)),
    ]


def _visibility(args, flags):
    """[B, Tq, Tk] bool: which keys each query sees."""
    _, _, _, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    vis = (kv_valid[:, None, :] > 0).expand(-1, q_pos.shape[1], -1)
    if flags["causal"]:
        vis = vis & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        vis = vis & (q_seg[:, :, None] == kv_seg[:, None, :])
    return vis


def _rel(a, w):
    return float((a.float() - w).norm() / w.norm())


def check_backward_case(name, kw, gen):
    """K1 with lse, K5a and K5b vs their plain twins at one call shape;
    returns (launch key, [three table rows])."""
    from oryx_tpu_torch.ops.cuda.measure import (
        PEAK_BYTES, PEAK_FLOPS, cuda_time_ms, device_ms,
    )
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    args, flags = fa._prepare(
        q, k, v, rest.get("q_positions"), rest.get("kv_positions"),
        rest.get("q_segment_ids"), rest.get("kv_segment_ids"),
        rest.get("kv_mask"), rest["causal"], None,
        rest.get("slot_positions", False),
    )
    mask = _visibility(args, flags)
    keep = mask.any(-1)  # [B, Tq]
    do = (torch.randn(q.shape, generator=gen, device=q.device)
          * keep[:, :, None, None]).to(torch.bfloat16)
    dot = do.transpose(1, 2)
    qkv, ints = args[:3], args[3:]

    def delta_of(o, g):
        return torch.einsum("bhqd,bhqd->bhq", g.float(), o.float()).contiguous()

    # The kernels, the bf16 twins, and the fp32 witness on the same inputs.
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    delta = delta_of(o, dot)
    dq = fa._mha_backward_dq(*qkv, dot, lse, delta, *ints, **flags)
    dk, dv = fa._mha_backward_dkv(*qkv, dot, lse, delta, *ints, **flags)
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    plain = fa._mha_backward_reference(*qkv, dot, rlse, delta_of(ro, dot),
                                       *ints, **flags)
    f32 = [x.float() for x in qkv]
    fo, flse = fa._mha_forward_reference(*f32, *ints, **flags, with_lse=True)
    witness = fa._mha_backward_reference(*f32, dot.float(), flse,
                                         delta_of(fo, dot), *ints, **flags)
    torch.cuda.synchronize()
    g, r = o.transpose(1, 2)[keep].float(), ro.transpose(1, 2)[keep].float()
    err = (g - r).abs()
    kl = keep[:, None, :].expand(lse.shape)
    lse_err = float((lse[kl] - rlse[kl]).abs().max())
    ok = (bool((err <= TOL + TOL * r.abs()).all())
          and bool(torch.isfinite(g).all()) and lse_err <= 1e-3)
    print(f"  {name}: q {tuple(q.shape)} k {tuple(k.shape)}, rows with a "
          f"visible key {int(keep.sum())}/{keep.numel()}")
    print(f"    K1+lse: out max_abs_err={float(err.max()):.3e}, lse "
          f"max_abs_err={lse_err:.3e} ok={ok}")
    if not ok:
        raise SystemExit(f"K1 with lse disagrees with its twin on {name}")
    errs, ulps = {}, {}
    for gname, a, p_, w in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                               witness):
        ek, ep = _rel(a, w), _rel(p_, w)
        mabs = float((a.float() - p_.float()).abs().max())
        # In bf16 ulps of the reference's largest magnitude (8 mantissa
        # bits: one ulp at magnitude m is 2^(floor(log2 m) - 7)).
        mag = float(p_.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 1.0
        errs[gname], ulps[gname] = mabs, mabs / ulp
        good = (ek <= NOISE_RATIO * ep and bool(torch.isfinite(a).all())
                and a.dtype == q.dtype)
        print(f"    {gname}: rel L2 vs fp32 witness kernel {ek:.3e}, plain "
              f"{ep:.3e} (limit {NOISE_RATIO}x); max abs err vs plain "
              f"{mabs:.3e} = {mabs / ulp:.2f} bf16 ulps of max |plain| "
              f"{mag:.3e}; ok={good}")
        if not good:
            raise SystemExit(f"K5 {gname} on {name} is further from the fp32 "
                             "witness than bf16 noise allows")

    def k1():
        return fa._mha_forward(*args, **flags, with_lse=True)

    def k5a():
        return fa._mha_backward_dq(*qkv, dot, lse, delta, *ints, **flags)

    def k5b():
        return fa._mha_backward_dkv(*qkv, dot, lse, delta, *ints, **flags)

    ms_fwd, ms_dq, ms_dkv = (cuda_time_ms(f, iters=10) for f in (k1, k5a, k5b))
    dev = {kind: device_ms(f) for kind, f in
           (("fwd", k1), ("dq", k5a), ("dkv", k5b))}
    plain_fwd = cuda_time_ms(lambda: fa._mha_forward_reference(
        *args, **flags, with_lse=True), iters=3, warmup=1)
    plain_bwd = cuda_time_ms(lambda: fa._mha_backward_reference(
        *qkv, dot, rlse, delta, *ints, **flags), iters=3, warmup=1)
    # Yardsticks: SDPA with an explicit boolean mask, k/v repeated to the q
    # heads outside the timed calls; forward, and forward + backward.
    qp, kp, vp = qkv
    B, Hq, Tq, D = qp.shape
    Hk, Tk = kp.shape[1], kp.shape[2]
    G = Hq // Hk
    m4 = mask[:, None]
    kr = kp.repeat_interleave(G, dim=1)
    vr = vp.repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_time_ms(lambda: sdpa(qp, kr, vr, attn_mask=m4,
                                        scale=flags["scale"]), iters=10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qp, kr, vr))

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, attn_mask=m4, scale=flags["scale"])
        return torch.autograd.grad(out, (qg, kg, vg), dot)

    lib_bwd = cuda_time_ms(sdpa_fwd_bwd, iters=5)
    # Least time, from this run's data: per visible (q head, kv) pair 4 D
    # flops forward, 6 D for dq (s, dp, dq), 8 D for dk/dv (s, dp, dv, dk);
    # bytes: the q-side tensors once, k/v rows some query sees once, the
    # int operands once, dk/dv written whole.
    pairs = int(mask.sum())
    kv_rows = int(mask.any(1).sum())
    ints_b = sum(x.numel() * 4 for x in ints)
    qside = qp.numel() * 2
    rows_b = B * Hq * Tq * 4  # one fp32 per q row and head (lse or delta)
    kv_b = kv_rows * Hk * D * 2
    work = {
        "fwd": (4.0 * D * Hq * pairs, 2 * qside + 2 * kv_b + rows_b + ints_b),
        "dq": (6.0 * D * Hq * pairs,
               3 * qside + 2 * rows_b + 2 * kv_b + ints_b),
        "dkv": (8.0 * D * Hq * pairs,
                2 * qside + 2 * rows_b + 2 * kv_b + 2 * B * Tk * Hk * D * 2
                + ints_b),
    }
    key = (flags["causal"], flags["has_segments"], B, Hq, Hk, Tq, Tk, D)
    rows = []
    for kind, label, ms, plain_ms, lib_ms, mabs, replaces, src in (
        ("fwd", "flash_fwd_lse", ms_fwd, plain_fwd, lib_fwd,
         float(err.max()), "oryx_tpu/ops/pallas/flash_attention.py:206",
         "flash_attention.cu"),
        ("dq", "flash_bwd_dq", ms_dq, plain_bwd, lib_bwd, errs["dq"],
         "oryx_tpu/ops/pallas/flash_attention.py:508",
         "flash_attention_bwd.cu"),
        ("dkv", "flash_bwd_dkv", ms_dkv, plain_bwd, lib_bwd,
         max(errs["dk"], errs["dv"]),
         "oryx_tpu/ops/pallas/flash_attention.py:553",
         "flash_attention_bwd.cu"),
    ):
        flops, nbytes = work[kind]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"    {label}: kernel {ms:.4f} ms (device {dev[kind]}) "
              f"| plain {plain_ms:.4f} ms | "
              f"sdpa {'fwd' if kind == 'fwd' else 'fwd+bwd'} {lib_ms:.4f} ms"
              f" | bound {bound:.4f} ms ({flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.2f} MB)")
        if kind != "fwd":
            worst = max(("dk", "dv") if kind == "dkv" else ("dq",),
                        key=lambda x: errs[x])
            print(f"      {flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of "
                  f"its bound; sdpa backward alone (fwd+bwd - fwd) "
                  f"{lib_bwd - lib_fwd:.4f} ms; max abs err "
                  f"{ulps[worst]:.2f} bf16 ulps ({worst})")
        rows.append({
            "name": f"{label}[{name}]",
            "route": "cuda",
            "source": f"oryx_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": mabs,
            "ms": ms,
            "device_ms": dev[kind].ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
    print(f"    K5a + K5b {ms_dq + ms_dkv:.4f} ms vs sdpa backward alone "
          f"{lib_bwd - lib_fwd:.4f} ms")
    return key, rows


def _flash_counters():
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    return {"fwd": fa.LAUNCHES, "flash_fwd_lse": fa.LAUNCHES_LSE,
            "flash_bwd_dq": fa.LAUNCHES_DQ, "flash_bwd_dkv": fa.LAUNCHES_DKV}


def fit_once(cfg_t, params):
    """One Trainer.fit of TRAIN_STEPS steps; launch counts zeroed just
    before and read just after. Returns (trainer, launches, wall)."""
    from oryx_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg_t, params=params, device="cuda")
    counters = _flash_counters()
    for c in counters.values():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(train_batches(cfg_t), num_steps=TRAIN_STEPS, resume=False,
                prefetch=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(c) for k, c in counters.items()}
    for i, h in enumerate(trainer.history):
        print(f"    step {i + 1}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} | wall {h['wall_s']:.3f} s, "
              f"{h['tokens'] / h['wall_s']:.0f} tokens/s "
              f"({h['tokens']} tokens), {h['num_tokens'] / h['wall_s']:.0f} "
              f"supervised/s ({int(h['num_tokens'])}) | device fwd+bwd "
              f"{h['fwd_bwd_ms']:.1f} ms, optimizer {h['optimizer_ms']:.2f}"
              f" ms | data {h['data_s']:.3f} s, h2d {h['h2d_s']:.3f} s | "
              f"peak {h['peak_bytes'] / 1e9:.2f} GB")
    return trainer, launches, wall


def train_full_size(cfg_t, params, host_img, train_rows, card) -> None:
    """Phase 10 (see the module docstring); fills the launches of
    train_rows from the first fit."""
    import shutil

    from oryx_tpu_torch.train import step as step_lib

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    names = [n for n, _ in params.named_parameters()]
    comp = [n for n in names if n.startswith("compressor.")]
    frozen = [n for n in names if not n.startswith("compressor.")]
    t0 = time.perf_counter()
    snap = {n: p.detach().cpu() for n, p in params.named_parameters()
            if n in frozen}
    init = {n: p.detach().float().clone() for n, p in
            params.named_parameters() if n in comp}
    print(f"  host snapshot of {len(frozen)} frozen leaves "
          f"({sum(x.numel() for x in snap.values()) / 1e9:.2f} B params) in "
          f"{time.perf_counter() - t0:.1f} s; {len(comp)} compressor leaves "
          f"train ({sum(x.numel() for x in init.values()) / 1e6:.1f} M)")
    fits = []
    for run in range(2):
        if run:
            with torch.no_grad():
                for n, p in params.named_parameters():
                    if n in init:
                        p.copy_(init[n])
        print(f"  fit {run + 1}:")
        trainer, launches, wall = fit_once(cfg_t, params)
        losses = [h["loss"] for h in trainer.history]
        print(f"  fit {run + 1}: wall {wall:.2f} s, losses {losses}, "
              f"grad norms {[h['grad_norm'] for h in trainer.history]}")
        if not all(np.isfinite(losses)):
            raise SystemExit("non-finite training loss")
        fits.append((trainer, launches, losses))
    trainer, launches, _ = fits[0]
    if fits[1][2] != fits[0][2]:
        raise SystemExit(f"a second fit from the same init gave other "
                         f"losses: {fits[1][2]} vs {fits[0][2]}")
    print("  the second fit from the same init gave identical losses")
    cur = dict(params.named_parameters())
    changed = [n for n in comp if not torch.equal(cur[n].float(), init[n])]
    if not changed:
        raise SystemExit("the compressor did not change")
    for n in frozen:
        if not torch.equal(cur[n].detach().cpu(), snap[n]):
            raise SystemExit(f"frozen leaf {n} changed")
    print(f"  frozen leaves bitwise unchanged; {len(changed)}/{len(comp)} "
          f"compressor leaves changed (lr(0) = 0: step 1 moves nothing)")
    for key, case_rows in train_rows:
        for row in case_rows:
            kind = row["name"].split("[")[0]
            row["launches"] = launches[kind].get(key, 0)
            print(f"  launches {row['name']}: {row['launches']}")
            if row["launches"] == 0:
                raise SystemExit(f"{row['name']} was never launched by the "
                                 "training step")
    print("  launches in the fit, all shapes: " + ", ".join(
        f"{k} {sum(v.values())}" for k, v in launches.items()))
    print("  one more step (the image batch) under torch.profiler:")
    t2 = fits[1][0]
    batch = t2._device_batch(host_img)
    fams, wall_us = profile_call(
        lambda: step_lib.train_step(t2.state, batch, cfg_t, t2.tx))
    k5 = fams[kernel_family("flash_bwd")]
    k1 = fams[kernel_family("flash_fwd")]
    print(f"  K5a + K5b in the traced image step: {k5 / 1e3:.1f} ms, "
          f"{k5 / sum(fams.values()):.1%} of its device time, "
          f"{k5 / wall_us:.1%} of its wall; K1 {k1 / 1e3:.1f} ms, "
          f"{k1 / sum(fams.values()):.1%}; the cell maps "
          f"{fams[kernel_family('tile_map')] / 1e3:.1f} ms")
    del fits, trainer, t2, batch
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)


def tiny_training_on_card() -> None:
    """Phase 11: the tiny fp32 config, tune full, 3 steps of Trainer.fit on
    the card and on the CPU from the same init and batches: losses within
    rtol 1e-4, params within atol 2e-4 / rtol 2e-3 (lr 1e-5, so Adam's
    1/sqrt(v) on near-zero gradient entries moves no param by more than
    2e-5)."""
    import shutil

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train.trainer import Trainer

    base = config.oryx_tiny()
    cfg = dataclasses.replace(base, attn_impl="pallas", train=dataclasses.replace(
        base.train, tune="full", learning_rate=1e-5, num_train_steps=10,
        warmup_ratio=0.1, remat_policy="attn",
        checkpoint_dir=TRAIN_CKPT + "_tiny",
    ))
    recs = [dict(r, conversations=[
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": f"caption {i}"},
    ]) for i, r in enumerate(train_records())]

    def small(rec):
        return [x[:42, :56] for x in train_media(rec)][:4]

    out = {}
    counters = _flash_counters()
    for dev in ("cpu", "cuda"):
        shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
        for c in counters.values():
            c.clear()
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu").to(dev)
        t = Trainer(cfg, params=model, device=dev)
        t.fit(train_batches(cfg, recs, small, batch=2,
                            buckets=(64, 128, 256)),
              num_steps=3, resume=False, prefetch=0)
        out[dev] = ([h["loss"] for h in t.history],
                    {n: p.detach().cpu() for n, p in
                     model.named_parameters()})
        if dev == "cuda":
            bwd = {k: sum(c.values()) for k, c in counters.items()}
    shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    print(f"  losses card {out['cuda'][0]} cpu {out['cpu'][0]}; kernel "
          f"launches on the card {bwd}")
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    worst = 0.0
    for n, p in out["cpu"][1].items():
        q = out["cuda"][1][n]
        torch.testing.assert_close(q, p, atol=2e-4, rtol=2e-3)
        worst = max(worst, float((q - p).abs().max()))
    if not (bwd["flash_bwd_dq"] and bwd["flash_bwd_dkv"]
            and bwd["flash_fwd_lse"]):
        raise SystemExit("the tiny training run launched no K5")
    print(f"  card == cpu within tolerance; params max abs diff {worst:.3e}")


def main() -> int:
    # Line-buffered: a pipe would otherwise hold back whole blocks of
    # output, so a run that dies (or is killed) would not show the phase it
    # died in.
    sys.stdout.reconfigure(line_buffering=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "oryx_tpu_torch", "csrc")):
        print(f"chip_smoke: no oryx_tpu_torch package (with its kernel "
              f"sources) beside this script in {here}; run it from the root "
              "of a checkout", file=sys.stderr)
        return 2
    if here not in sys.path:
        sys.path.insert(0, here)
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import build
    from oryx_tpu_torch.ops.cuda.measure import gpu_line
    from oryx_tpu_torch.serve.pipeline import Pipeline

    # ---- 1. card and build ------------------------------------------------
    card = gpu_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # One nvcc per source, all started together.
    def timed_build(name):
        t = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t

    sources = ("flash_attention", "flash_attention_bwd", "paged_attention")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        secs = dict(zip(sources, ex.map(timed_build, sources)))
    for name in sources:
        build.load(name)
        print(f"built {name} in {secs[name]:.1f} s")
        print_ptxas(build.build_logs.get(name, ""))

    # ---- 2. kernel vs plain twin at the main path's shapes ----------------
    cfg = dataclasses.replace(config.oryx_7b(), attn_impl="pallas")
    t0 = time.perf_counter()
    params = oryx.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    print(f"oryx_7b bf16 random init: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    tok = ByteTokenizer()
    pipe = Pipeline(tok, params, cfg, device="cuda")
    reqs = requests()
    print(f"phase 2: kernel vs plain twin, bf16, atol=rtol={TOL} "
          f"({card})", flush=True)
    rows, keys = [], []
    gen = torch.Generator("cuda").manual_seed(1)
    for name, kw, keep in attention_cases(pipe, reqs, gen):
        key, row = check_kernel_case(name, kw, keep)
        keys.append(key)
        rows.append(row)

    # ---- 3. the main path at full width -----------------------------------
    print(f"phase 3: Pipeline.chat_batch, oryx_7b bf16, greedy, "
          f"max_new_tokens={MAX_NEW} ({card})", flush=True)
    results = [run_main_path(pipe, reqs, tok) for _ in range(3)]
    for i, (replies, counts, tim, toks, launches, wall, peak, _) in enumerate(
        results
    ):
        steps = tim["decode_steps"]
        print(f"  run {i}: wall {wall:.3f} s | visual {tim['visual_s']:.3f}"
              f" s | prefill {tim['prefill_s']:.3f} s | decode "
              f"{tim['decode_s']:.3f} s ({steps} steps, "
              f"{len(reqs) * steps / tim['decode_s']:.1f} tok/s) | peak "
              f"{peak / 1e9:.2f} GB")
        for r, ((pt, gt), rep) in enumerate(zip(counts, replies)):
            print(f"    request {r}: prompt {pt} tokens, generated {gt} "
                  f"tokens, reply {rep[:40]!r}")
        if any(gt < 1 or pt < 1 for pt, gt in counts):
            raise SystemExit("a request produced no tokens")
    toks0 = results[0][3]
    if any(r[3] != toks0 for r in results[1:]):
        raise SystemExit("the runs produced different tokens")
    print(f"  tokens identical across the {len(results)} runs")
    launches = results[0][4]
    for key, row in zip(keys, rows):
        row["launches"] = launches.get(key, 0)
        print(f"  launches {row['name']}: {row['launches']}")
        if row["launches"] == 0:
            raise SystemExit(f"{row['name']} was never launched on the "
                             "main path")
    if sum(launches.values()) != sum(launches.get(k, 0) for k in set(keys)):
        raise SystemExit(f"launches outside the checked shapes: {launches}")
    # Every Tq = 1 call (the decode steps) took the split-KV decode route,
    # and no other call did.
    decode_keys = {k for k in launches if k[5] == 1}
    routed = results[0][7]
    if not decode_keys or routed != {k: launches[k] for k in decode_keys}:
        raise SystemExit(f"decode calls {launches} vs decode-route launches "
                         f"{routed}")
    print(f"  decode route: {sum(routed.values())} of the "
          f"{sum(launches[k] for k in decode_keys)} Tq = 1 calls")

    # ---- 4. the plain attention path --------------------------------------
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    pipe_x = Pipeline(tok, params, cfg_x, device="cuda")
    res_x = run_main_path(pipe_x, reqs, tok)
    print(f"phase 4: attn_impl='xla' run: wall {res_x[5]:.3f} s", flush=True)
    agree = total = 0
    for a, b in zip(toks0, res_x[3]):
        n = min(len(a), len(b))
        agree += sum(int(x == y) for x, y in zip(a[:n], b[:n]))
        total += max(len(a), len(b))
    print(f"  greedy token agreement kernel vs plain: {agree}/{total}")
    # The fp32 witness: the same bf16 weights, upcast in every product
    # (the models cast weights to the activations' dtype), fp32 activations,
    # plain attention, full-precision fp32 matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe_f = Pipeline(
        tok, params, dataclasses.replace(cfg_x, dtype="float32"),
        device="cuda",
    )
    la, lb, lf = (prefill_logits(p, reqs) for p in (pipe, pipe_x, pipe_f))
    if not all(bool(torch.isfinite(x).all()) for x in (la, lb, lf)):
        raise SystemExit("non-finite prefill logits")

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    rk, rp, rkp = rel(la, lf), rel(lb, lf), rel(la, lb)
    print(f"  prefill last-token logits {tuple(la.shape)}, per-row rel L2:")
    print(f"    kernel path vs fp32 witness {[f'{x:.3e}' for x in rk]}")
    print(f"    plain path  vs fp32 witness {[f'{x:.3e}' for x in rp]}")
    print(f"    kernel path vs plain path   {[f'{x:.3e}' for x in rkp]}")
    print(f"    ratio kernel/plain error    "
          f"{[f'{a / b:.3f}' for a, b in zip(rk, rp)]} (limit {NOISE_RATIO})")
    print(f"    argmax equal to the witness: kernel "
          f"{(la.argmax(-1) == lf.argmax(-1)).tolist()}, plain "
          f"{(lb.argmax(-1) == lf.argmax(-1)).tolist()}")
    if any(a > NOISE_RATIO * b for a, b in zip(rk, rp)):
        raise SystemExit("the kernel path is further from the fp32 witness "
                         "than bf16 noise allows")
    print("kernels launched and checked: flash_fwd "
          f"({', '.join(r['name'] for r in rows)})")

    # ---- 5. where the device time goes ------------------------------------
    walls = [f"{r[5]:.3f}" for r in results]
    print(f"phase 5: chat_batch under torch.profiler ({card}); unprofiled "
          f"walls of phase 3: {walls} s", flush=True)
    fams, wall_us = profile_call(
        lambda: pipe.chat_batch(reqs, max_new_tokens=MAX_NEW))
    k1 = fams[kernel_family("flash_fwd")] + fams[kernel_family("tile_map")]
    print(f"  K1 (with its cell map) in the traced call: {k1 / 1e3:.1f} ms, "
          f"{k1 / sum(fams.values()):.1%} of its device time, "
          f"{k1 / wall_us:.1%} of its wall")

    # ---- 7. the serving engine at full width ------------------------------
    print(f"phase 7: ContinuousScheduler, oryx_7b bf16, greedy, {SERVE}, "
          f"{len(serve_requests())} requests, prefix cache on ({card})",
          flush=True)
    spipe = Pipeline(ByteTokenizer(), params, cfg, device="cuda")
    serving = {}
    for mode in ("split", "ragged"):
        runs = [run_scheduler(spipe, mode == "ragged", record=i == 0)
                for i in range(2)]
        for i, run in enumerate(runs):
            check_serving_run(mode, i, run)
        if runs[1]["results"] != runs[0]["results"]:
            raise SystemExit(f"{mode}: the two runs produced different "
                             "tokens")
        print(f"  {mode}: tokens identical across the two runs")
        serving[mode] = runs[0]
    same = sum(
        a[0] == b[0] for a, b in zip(serving["split"]["results"],
                                     serving["ragged"]["results"])
    )
    print(f"  split vs ragged replies equal (bf16, not asserted): "
          f"{same}/{len(serve_requests())}")
    print("  one more split-engine run under torch.profiler:")
    profile_call(lambda: run_scheduler(spipe, False, record=False))

    # ---- 6. paged kernels at the serving shapes ---------------------------
    print(f"phase 6: paged kernels vs plain twins at phase 7's call shapes, "
          f"bf16, atol=rtol={TOL} ({card})", flush=True)
    llm = cfg.llm
    # The default pool: num_slots * max_ctx / page_size pages.
    pool_shape = (SERVE["num_slots"] * SERVE["max_ctx"] // SERVE["page_size"],
                  SERVE["page_size"], llm.num_kv_heads, llm.head_dim)
    gen = torch.Generator("cuda").manual_seed(2)
    dec_calls = serving["split"]["recorder"].calls["paged_decode"]
    rag_calls = serving["ragged"]["recorder"].calls["ragged_paged"]
    S = SERVE["num_slots"]
    cases = [
        ("paged_decode[decode]", "paged_decode",
         _pick(dec_calls, lambda c: int(c[2].sum()))),
        ("ragged_paged[prefill]", "ragged_paged",
         _pick([c for c in rag_calls if c[0][0][0] > S],
               lambda c: int((c[3] + 1).sum()))),
        ("ragged_paged[decode]", "ragged_paged",
         _pick([c for c in rag_calls if c[0][0][0] == S],
               lambda c: int((c[3] + 1).sum()))),
    ]
    for name, kind, call in cases:
        row = paged_kernel_case(name, kind, call, pool_shape, gen)
        mode = "split" if kind == "paged_decode" else "ragged"
        # Launches of the run the call was recorded in, split by whether
        # the dispatch carried prefill lanes (R > S).
        row["launches"] = sum(
            n for key, n in serving[mode]["paged_keys"].items()
            if key[0] == kind and (
                kind == "paged_decode"
                or (key[1] > S) == name.endswith("[prefill]")
            )
        )
        print(f"  launches {name}: {row['launches']}")
        if row["launches"] == 0:
            raise SystemExit(f"{name} was never launched on the serving "
                             "path")
        rows.append(row)
    longest = max(u[0] for _, _, u in serving["split"]["results"])
    name, kw, keep = paged_prefill_case(spipe, longest, gen)
    key, row = check_kernel_case(name, kw, keep)
    row["launches"] = serving["split"]["flash"].get(key, 0)
    print(f"  launches {row['name']}: {row['launches']}")
    if row["launches"] == 0:
        raise SystemExit(f"{row['name']} was never launched on the serving "
                         "path")
    rows.append(row)

    # ---- 8. tiny fp32 engines on the card ---------------------------------
    print(f"phase 8: tiny fp32 engines (bf16 and int8 pools), card vs CPU "
          f"({card})", flush=True)
    tiny_engines_on_card()

    # ---- 12. the int8 engine, prefix cache and host tier -------------------
    shared = shared_requests(spipe)
    print(f"phase 12: ContinuousScheduler kv_dtype='int8', oryx_7b bf16, "
          f"{SERVE}, host tier {HOST_CACHE >> 20} MiB; shared-context "
          f"prompts of {[len(spipe._prepare_request({'question': q})[0]) for q in shared]}"
          f" tokens ({card})", flush=True)
    int8_runs = {}
    for mode in ("split", "ragged"):
        runs = [run_int8_engine(spipe, mode == "ragged", i == 0, shared)
                for i in range(2)]
        for i, run in enumerate(runs):
            check_int8_run(mode, i, run)
        if runs[1]["results"] != runs[0]["results"]:
            raise SystemExit(f"int8 {mode}: the two runs produced different "
                             "tokens")
        print(f"  int8 {mode}: tokens identical across the two runs")
        int8_runs[mode] = runs[0]
        n = len(serve_requests())
        same = sum(a[0] == b[0] for a, b in zip(
            runs[0]["results"][:n], serving[mode]["results"]))
        print(f"  int8 {mode} vs phase 7's bf16 pool, replies of the phase-7 "
              f"mix equal (not asserted): {same}/{n}")
    rows_bf16 = 2 * llm.num_layers * pool_shape[0] * pool_shape[1] * (
        llm.num_kv_heads * llm.head_dim * 2)
    print(f"  pool bytes at {pool_shape[0]} pages: int8 "
          f"{int8_runs['split']['pool_bytes'] / 1e9:.4f} GB, bf16 "
          f"{rows_bf16 / 1e9:.4f} GB (ratio "
          f"{int8_runs['split']['pool_bytes'] / rows_bf16:.4f})")
    fp8_launches = {}
    for ragged in (False, True):
        toks, launches, wall = generate_fp8(spipe, shared, ragged)
        print(f"  generate_paged fp8_e4m3 {'ragged' if ragged else 'split'}: "
              f"wall {wall:.3f} s, paged launches {launches}, first row "
              f"{toks[0, :8].tolist()}")
        want = "ragged_paged_fp8_e4m3" if ragged else "paged_decode_fp8_e4m3"
        if not launches.get(want) or toks.shape[1] != MAX_NEW:
            raise SystemExit(f"generate_paged fp8: {launches}")
        fp8_launches.update(launches)

    # ---- 13. the dequantizing paged kernels at phase 12's shapes ----------
    print(f"phase 13: K3q/K4q vs plain twins at phase 12's call shapes, int8 "
          f"and fp8 pools, bf16, atol=rtol={TOL} ({card})", flush=True)
    dec_calls = int8_runs["split"]["recorder"].calls["paged_decode"]
    rag_calls = int8_runs["ragged"]["recorder"].calls["ragged_paged"]
    qcases = [
        ("paged_decode", "decode",
         _pick(dec_calls, lambda c: int(c[2].sum()))),
        ("ragged_paged", "prefill",
         _pick([c for c in rag_calls if c[0][0][0] > S],
               lambda c: int((c[3] + 1).sum()))),
        ("ragged_paged", "decode",
         _pick([c for c in rag_calls if c[0][0][0] == S],
               lambda c: int((c[3] + 1).sum()))),
    ]
    gen = torch.Generator("cuda").manual_seed(4)
    for fmt in ("int8", "fp8_e4m3"):
        for kind, shape, call in qcases:
            kernel = f"{kind}_{fmt}"
            name = f"{kernel}[{shape}]"
            row = paged_kernel_case(name, kind, call, pool_shape, gen, fmt)
            if fmt == "int8":
                mode = "split" if kind == "paged_decode" else "ragged"
                row["launches"] = sum(
                    n for key, n in int8_runs[mode]["paged_keys"].items()
                    if key[0] == kernel and (
                        kind == "paged_decode"
                        or (key[1] > S) == (shape == "prefill")
                    )
                )
            else:  # generate_paged's fp8 runs: decode steps only
                row["launches"] = (
                    0 if shape == "prefill" else fp8_launches.get(kernel, 0)
                )
            print(f"  launches {name}: {row['launches']}")
            if row["launches"] == 0:
                # No entry point runs fp8 prefill lanes (the engine takes
                # no fp8 pool): checked and timed above, not a path kernel.
                print(f"  {name} is on no path's run; left out of the table")
                continue
            rows.append(row)

    # ---- 9. training kernels at the training step's shapes ----------------
    cfg_t = train_config()
    # The image batch has 4 x 1,936 visual tokens, the video batch 512.
    first_two = list(itertools.islice(train_batches(cfg_t), 2))
    host_img, host_vid = sorted(first_two, key=lambda b: -b["is_visual"].sum())
    if host_vid["is_visual"].sum() > 4096:
        raise SystemExit("the first two training batches are not one image "
                         "and one video batch")
    print(f"phase 9: K1 with lse, K5a, K5b vs plain twins at the training "
          f"step's shapes, bf16 ({card})", flush=True)
    gen = torch.Generator("cuda").manual_seed(3)
    train_rows = []
    for name, kw in training_attention_cases(cfg_t, host_img, host_vid, gen):
        key, case_rows = check_backward_case(name, kw, gen)
        train_rows.append((key, case_rows))

    # ---- 10. Trainer.fit at full width and depth --------------------------
    print(f"phase 10: Trainer.fit, oryx_7b_pretrain.json at full width and "
          f"depth, {TRAIN_STEPS} steps of {TRAIN_BATCH} records ({card})",
          flush=True)
    train_full_size(cfg_t, params, host_img, train_rows, card)
    for _, case_rows in train_rows:
        rows.extend(case_rows)
    del params, pipe, pipe_x, pipe_f, spipe
    torch.cuda.empty_cache()

    # ---- 11. tiny fp32 training on the card --------------------------------
    print(f"phase 11: tiny fp32 Trainer.fit, tune full, card vs CPU ({card})",
          flush=True)
    tiny_training_on_card()

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
