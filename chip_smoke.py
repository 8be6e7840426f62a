#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. The card (nvidia-smi name and power limit, torch/CUDA versions) and the
     build of every kernel from `oryx_tpu_torch/csrc` (one nvcc per source,
     in parallel).
  2. The main path's host side at full width (`config.oryx_7b()`, a
     four-request image/multi-image/video/text mix), then each kernel call
     shape of that path (ViT segments, compressor regions, decoder prefill,
     decode) run through the kernel and through its plain PyTorch twin on
     the same bf16 inputs, held to atol = rtol = 1e-2 on the rows callers
     keep. Median kernel time from CUDA events beside the twin's time, SDPA
     with a boolean mask as a yardstick, and the least time the card could
     take (bytes / 3.35 TB/s vs flops / 989 TFLOP/s).
  3. `Pipeline.chat_batch` on the mix, greedy, 32 new tokens, random bf16
     weights from torch.Generator("cuda") seeded 0, three times: the tokens
     must be identical, and the kernel must have launched for every call
     shape in the first run.
  4. The same mix with attn_impl="xla" (plain attention); greedy token
     agreement with the kernel path is printed, not asserted. Prefill
     last-token logits of both bf16 paths are held against an fp32 witness
     (plain attention, the same bf16 weights upcast in every product): per
     row, the kernel path's relative L2 error may be at most NOISE_RATIO
     times the plain path's, so the kernel adds no error beyond bf16
     rounding noise.
  5. One more chat_batch under torch.profiler (CUDA activity only, so the
     host is barely slowed): device time by kernel family, the top
     kernels, and the device's idle share inside the trace (1 - union of
     kernel intervals / the call's wall).
  7. The serving engine, `ContinuousScheduler`, at full width on the
     phase-1 weights: 4 slots, 64-token pages, 8-step chunks, max_ctx
     4096, the default 256-page pool, greedy; the four requests above at
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
     the recorded layout and the int operands as recorded. Wrapper and
     twin times, gather_pages + SDPA with an explicit mask as a two-call
     yardstick, and the least time the card could take.
  8. The tiny fp32 config through both engines on the card (kernel path)
     and on the CPU (plain twins): replies, finish reasons and usage equal.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-2  # kernel vs plain twin, bf16 outputs (atol = rtol)
NOISE_RATIO = 1.5  # kernel path vs plain path, error against the fp32 witness
MAX_NEW = 32
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
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


def gpu_line() -> str:
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
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    args, flags = fa._prepare(
        q, k, v, rest.get("q_positions"), None, rest.get("q_segment_ids"),
        rest.get("kv_segment_ids"), rest.get("kv_mask"), rest["causal"],
        None,
    )
    got = fa.flash_attention(q, k, v, **rest)
    ref = fa._mha_forward_reference(*args, **flags).transpose(1, 2)
    torch.cuda.synchronize()
    g, r = got[keep].float(), ref[keep].float()
    err = (g - r).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL + TOL * r.abs()).all()) and bool(
        torch.isfinite(g).all()
    )
    print(f"  {name}: q {tuple(q.shape)} k {tuple(k.shape)} "
          f"max_abs_err={max_err:.3e} ok={ok}")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain twin on {name}")

    ms = cuda_time_ms(lambda: fa._mha_forward(*args, **flags), iters=20)
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
    print(f"    kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | sdpa "
          f"{library_ms:.4f} ms | bound {max(t_ops, t_bytes):.4f} ms "
          f"(unmasked pairs {pairs}, {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
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
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def run_main_path(pipe, reqs, tok):
    """One chat_batch on the mix; returns (replies, counts, timings,
    tokens, launches, seconds, peak bytes)."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    tok.decoded.clear()
    fa.LAUNCHES.clear()
    t0 = time.perf_counter()
    replies, counts = pipe.chat_batch(
        reqs, max_new_tokens=MAX_NEW, return_token_counts=True,
        timings=timings,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    return (replies, counts, timings, [list(t) for t in tok.decoded],
            launches, wall, torch.cuda.max_memory_allocated())


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
    if "flash_fwd" in n:
        return "flash_fwd (hand-written attention)"
    if "paged_bf16" in n or "paged_f32" in n:
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


def profile_call(fn) -> None:
    """fn() under torch.profiler, CUDA activity only: device time by kernel
    family, the top kernels, and the device's idle share inside the trace.
    Raises when the trace holds no device time."""
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


class PagedCallRecorder:
    """While active, keeps q's layout (shape and strides) and the int
    operands, as given, of every paged-kernel call made on layer 0 of
    `sched`'s pool (one call per forward), cloned on the device without a
    sync, for phase 6 to replay through the same wrappers."""

    def __init__(self, sched):
        self.layer0 = sched.kv_pages["k"][0].data_ptr()
        self.calls: dict[str, list] = {"paged_decode": [], "ragged_paged": []}

    def __enter__(self):
        from oryx_tpu_torch.ops.cuda import paged_attention as pa

        self._orig = (pa.ragged_decode_attention, pa.ragged_paged_attention)
        dec, rag = self._orig

        def rec_dec(q, k, v, bt, lens, **kw):
            if k.data_ptr() == self.layer0:
                self.calls["paged_decode"].append(
                    ((tuple(q.shape), q.stride()), bt.clone(), lens.clone())
                )
            return dec(q, k, v, bt, lens, **kw)

        def rec_rag(q, k, v, bt, seg, pos, **kw):
            if k.data_ptr() == self.layer0:
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
        "metrics": sched.metrics, "peak": torch.cuda.max_memory_allocated(),
        "flash": dict(fa.LAUNCHES), "paged": dict(paged),
        "paged_keys": dict(pa.LAUNCHES), "recorder": recorder,
    }


def check_serving_run(mode: str, i: int, run: dict) -> None:
    """Print one phase-7 run and fail on a request without its usage or a
    missing kernel launch."""
    m = run["metrics"]
    gen = sum(u[1] for _, _, u in run["results"])
    print(f"  {mode} run {i}: wall {run['wall']:.3f} s | {gen} tokens, "
          f"{gen / run['wall']:.1f} tok/s | dispatches "
          f"{dict(m['dispatches_total'])} | evicted {m['evicted']} | peak "
          f"{run['peak'] / 1e9:.2f} GB | paged launches {run['paged']} | "
          f"flash launches {sum(run['flash'].values())}")
    print(f"    TTFT s: {[round(t, 4) for t in run['ttft']]}")
    for r, ((reply, reason, (pt, gt)), cap) in enumerate(
        zip(run["results"], run["caps"])
    ):
        print(f"    request {r}: prompt {pt}, generated {gt}/{cap} "
              f"({reason}), reply {reply[:32]!r}")
        if pt < 1 or not (
            gt == cap if reason == "length" else 1 <= gt <= cap
        ):
            raise SystemExit(f"{mode}: request {r} has usage {(pt, gt)}")
    want = "ragged_paged" if mode == "ragged" else "paged_decode"
    other = "paged_decode" if mode == "ragged" else "ragged_paged"
    if not run["paged"].get(want) or run["paged"].get(other):
        raise SystemExit(f"{mode}: paged kernel launches {run['paged']}")
    if not run["flash"]:
        raise SystemExit(f"{mode}: the flash kernel never launched")


def _pick(calls, work):
    """The recorded call with the most work (host reads after the run)."""
    if not calls:
        raise SystemExit("phase 7 recorded no call of this kind")
    return max(calls, key=work)


def paged_kernel_case(name, kind, call, pool_shape, gen):
    """Kernel vs plain twin at one recorded call, both through the public
    functions the model calls, on q in the recorded layout and the int
    operands as the model passed them; returns the table row."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    P, ps, Hk, D = pool_shape
    (q_shape, q_stride), bt = call[0], call[1]
    R, Hq = q_shape[0], q_shape[-2]
    dev = bt.device
    kp = paged_kv.init_paged_pool(1, P, ps, Hk, D, dtype=torch.bfloat16,
                                  device=dev)[0]
    vp = paged_kv.init_paged_pool(1, P, ps, Hk, D, dtype=torch.bfloat16,
                                  device=dev)[0]
    kp.copy_(torch.randn(kp.shape, generator=gen, device=dev))
    vp.copy_(torch.randn(vp.shape, generator=gen, device=dev))
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
    torch.cuda.synchronize()
    if sum(pa.LAUNCHES.values()) != before + 1:
        raise SystemExit(f"{name}: the wrapper did not launch the kernel")
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
          f"{tuple(kp.shape)} table {tuple(bt.shape)} {bt.dtype}, ints "
          f"{(call[2].dtype)}, visible slots per row "
          f"{visible.min().item()}..{visible.max().item()} "
          f"max_abs_err={max_err:.3e} ok={ok}")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain twin")
    ms = cuda_time_ms(kernel, iters=50)
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
    # Least time: q and o once, the int operands once, and the k/v rows some
    # query sees once (a segment's visible prefix is the longest row's),
    # vs 4 * D flops per visible (query head, slot) pair.
    seg_host, vis_host = segl.tolist(), visible.tolist()
    longest: dict[int, int] = {}
    for s_, n in zip(seg_host, vis_host):
        longest[s_] = max(longest.get(s_, 0), n)
    kv_rows = sum(longest.values())
    nbytes = (
        2 * q.numel() * 2 + bt.numel() * 4
        + R * 4 * (1 if kind == "paged_decode" else 2)
        + 2 * kv_rows * Hk * D * 2
    )
    flops = 4.0 * D * Hq * sum(vis_host)
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"    kernel {ms:.4f} ms | plain {plain_ms:.4f} ms | gather+sdpa "
          f"{library_ms:.4f} ms | bound {max(t_ops, t_bytes):.4f} ms "
          f"({kv_rows} kv rows read, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    return {
        "name": name,
        "route": "cuda",
        "source": "oryx_tpu_torch/csrc/paged_attention.cu",
        "replaces": (
            "oryx_tpu/ops/pallas/paged_attention.py:144"
            if kind == "paged_decode"
            else "oryx_tpu/ops/pallas/paged_attention.py:528"
        ),
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
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
    geom = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
    for ragged in (False, True):
        out = []
        pa.LAUNCHES.clear()
        for device in ("cpu", "cuda"):
            sched = ContinuousScheduler(
                Pipeline(ByteTokenizer(), params, cfg, device=device),
                autostart=False, ragged=ragged,
                prefill_chunk=32 if ragged else None, **geom,
            )
            hs = [sched.submit(r, n) for r, n in reqs]
            sched.start()
            out.append([h.result(timeout=600) for h in hs])
            sched.close()
        mode = "ragged" if ragged else "split"
        print(f"  {mode}: card == cpu: {out[0] == out[1]}; paged launches "
              f"on the card {sum(pa.LAUNCHES.values())}; replies "
              f"{[r[0][:12] for r in out[1]]}")
        if out[0] != out[1] or not pa.LAUNCHES:
            raise SystemExit(f"tiny {mode} engine on the card differs from "
                             f"the CPU: {out[1]} vs {out[0]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import build
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

    sources = ("flash_attention", "paged_attention")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        secs = dict(zip(sources, ex.map(timed_build, sources)))
    for name in sources:
        build.load(name)
        print(f"built {name} in {secs[name]:.1f} s")
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

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
          f"({card})")
    rows, keys = [], []
    gen = torch.Generator("cuda").manual_seed(1)
    for name, kw, keep in attention_cases(pipe, reqs, gen):
        key, row = check_kernel_case(name, kw, keep)
        keys.append(key)
        rows.append(row)

    # ---- 3. the main path at full width -----------------------------------
    print(f"phase 3: Pipeline.chat_batch, oryx_7b bf16, greedy, "
          f"max_new_tokens={MAX_NEW} ({card})")
    results = [run_main_path(pipe, reqs, tok) for _ in range(3)]
    for i, (replies, counts, tim, toks, launches, wall, peak) in enumerate(
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

    # ---- 4. the plain attention path --------------------------------------
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    pipe_x = Pipeline(tok, params, cfg_x, device="cuda")
    res_x = run_main_path(pipe_x, reqs, tok)
    print(f"phase 4: attn_impl='xla' run: wall {res_x[5]:.3f} s")
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
          f"walls of phase 3: {walls} s")
    profile_call(lambda: pipe.chat_batch(reqs, max_new_tokens=MAX_NEW))

    # ---- 7. the serving engine at full width ------------------------------
    print(f"phase 7: ContinuousScheduler, oryx_7b bf16, greedy, {SERVE}, "
          f"{len(serve_requests())} requests ({card})")
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
          f"bf16, atol=rtol={TOL} ({card})")
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
    print(f"phase 8: tiny fp32 engines, card vs CPU ({card})")
    tiny_engines_on_card()

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
