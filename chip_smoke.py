#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. The card (nvidia-smi name and power limit, torch/CUDA versions) and the
     build of every kernel from `oryx_tpu_torch/csrc`.
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

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
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
    """Stand-in byte-level tokenizer: ids 0..255 are bytes; any other id
    (random weights emit them) decodes to a fixed placeholder. Keeps the
    ids of every decode call, so a run's tokens can be compared."""

    def __init__(self) -> None:
        self.decoded: list[list[int]] = []

    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids]
        self.decoded.append(ids)
        out = bytearray()
        for i in ids:
            if skip_special_tokens and i == EOS:
                continue
            out += bytes([i]) if i < 256 else b"<?>"
        return out.decode("utf-8", errors="replace")


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


def profile_main_path(pipe, reqs) -> None:
    """One chat_batch under torch.profiler, CUDA activity only: device time
    by kernel family, the top kernels, and the device's idle share inside
    the trace. Raises when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.chat_batch(reqs, max_new_tokens=MAX_NEW)
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
    t0 = time.perf_counter()
    build.load("flash_attention")
    print(f"built flash_attention in {time.perf_counter() - t0:.1f} s")
    for line in build.build_logs.get("flash_attention", "").splitlines():
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
    profile_main_path(pipe, reqs)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
