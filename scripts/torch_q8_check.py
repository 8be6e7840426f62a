#!/usr/bin/env python3
"""Check (and optionally time) the port's int8-weight product on one NVIDIA
GPU (`oryx_tpu_torch/csrc/q8_linear.cu`), on each of its routes: every
launch of an oryx_7b decoder step (`measure.q8_shapes`: the grouped q/k/v,
o, the grouped gate/up, down, lm_head) at M = 1, 4, 20, 64 (the byte-bound
route) and 65, 68, 128, 129, 516, 2048 (the wgmma route), the tied head
(the embedding table's codes with one scale per column), the ViT's and the
projector's products, and tails whose K and N are not multiples of 16, in
bf16 and fp32.

    python3 scripts/torch_q8_check.py [--time] [--iters 50]
        [--only gate_up,down --rows 8192]

Prints the build's ptxas lines (registers, spills), then per case the
kernel's largest error against the plain twin (dequantize, then F.linear;
atol = rtol = 1e-2 in bf16, atol 2e-4 / rtol 2e-3 in fp32), both relative
L2 errors against an fp32 witness (the kernel's at most NOISE_RATIO times
the twin's, in bf16), whether two launches give the same bits, whether a
row's bits are the same at other row counts of its route, whether a
grouped launch gives each member the bits of its own launch, and past 64
rows whether the first 64 rows get the small route's bits (reported, not
required); then whether a replay of the kernel captured in a CUDA graph
gives the eager bits, at 4 and at 516 rows. With --time: per bf16 case the
CUDA-event median of the kernel's call, its device time
(`measure.device_ms`), the twin's, one F.linear on the dequantized bf16
weights (what the bf16 model pays; the port never calls it) and the least
time the card could take (`measure.q8_bound`); then, at M = 4, 20, 68 and
516, the products of one decoder forward (each launch times its count a
forward) summed on each of the three, and the host time of a call at
M = 4 beside F.linear's. --only and --rows restrict the run to those
decoder launches at those row counts (and skip the rest). Exits 1 on a
disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

NOISE_RATIO = 1.5
ROWS = (1, 4, 20, 64, 65, 68, 128, 129, 516, 2048)
# (K, Ns, M, bias, dtype): K and N not multiples of 16.
TAILS = ((72, (100,), 3, True, torch.bfloat16),
         (130, (37,), 20, False, torch.bfloat16),
         (130, (37, 20), 100, True, torch.bfloat16),
         (72, (100,), 3, True, torch.float32),
         (130, (37,), 64, True, torch.float32),
         (130, (37, 20), 100, False, torch.float32))
FORWARD_ROWS = (4, 20, 68, 516)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default=None, metavar="PROJ[,PROJ]",
                    help="decoder launches to check (qkv, o, gate_up, down, "
                    "lm_head); the other cases are skipped")
    ap.add_argument("--rows", default=None, metavar="M[,M]",
                    help="row counts of the decoder launches")
    args = ap.parse_args()
    rows = (tuple(int(m) for m in args.rows.split(",")) if args.rows
            else ROWS)
    only = set(args.only.split(",")) if args.only else None
    if not torch.cuda.is_available():
        print("torch_q8_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from oryx_tpu_torch import config
    from oryx_tpu_torch.ops.cuda import build, measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {measure.gpu_line()}")
    build.load("q8_linear")
    for line in build.build_logs.get("q8_linear", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator("cuda").manual_seed(0)
    cfg = config.oryx_7b()
    shapes = measure.q8_shapes(cfg.llm)
    cases = [(f"{proj}[M={M}]", K, Ns, M, bias, torch.bfloat16, False)
             for proj, (K, Ns, bias) in shapes.items() for M in rows
             if only is None or proj in only]
    K, Ns, _ = shapes["lm_head"]
    cases += [(f"tied_head[M={M}]", K, Ns, M, False, torch.bfloat16, True)
              for M in (1, 4, 20, 68, 516)]
    cases += [(f"{name}[M={M}]", K, Ns, M, True,
               torch.float32 if dt == "f32" else torch.bfloat16, False)
              for name, (K, Ns, dt) in measure.q8_vision_shapes(cfg).items()
              for M in (20, 1936)]
    cases += [(f"tail[K={K},N={Ns},M={M},{str(dt)[6:]}{',tied' * col}]", K,
               Ns, M, bias, dt, col)
              for K, Ns, M, bias, dt in TAILS for col in (False, True)]
    if only is not None:
        cases = [c for c in cases if c[0].split("[")[0] in only]
    bad = 0
    for name, K, Ns, M, bias, dt, col in cases:
        kw = measure.q8_case(K, Ns, M, bias, gen, dt, col)
        f32 = dt == torch.float32
        r = measure.q8_compare(kw, *((2e-4, 2e-3) if f32 else (1e-2, 1e-2)))
        # In fp32 the witness is the twin itself: no noise ratio.
        ok = (r["within"] and r["same_bits"] and r["rows_independent"]
              and r["grouped_equal"] and r["finite"]
              and (f32 or r["rel_kernel"] <= NOISE_RATIO * r["rel_twin"]))
        bad += not ok
        p = q8.plan(K, M, not f32)
        print(f"{name}: K={K} N={Ns} {p} max abs err {r['max_abs_err']:.3e}"
              f", rel L2 kernel {r['rel_kernel']:.3e} twin "
              f"{r['rel_twin']:.3e}, same bits {r['same_bits']}, rows "
              f"independent {r['rows_independent']}, grouped == alone "
              f"{r['grouped_equal']}, first 64 rows == small route "
              f"{r['cross_route']} {'ok' if ok else 'FAILED'}", flush=True)
        if args.time and not f32:
            kern, plain, lib = measure.q8_calls(kw)
            ms = measure.cuda_time_ms(kern, args.iters)
            dev = measure.device_ms(kern)
            plain_ms = measure.cuda_time_ms(plain, args.iters)
            lib_ms = measure.cuda_time_ms(lib, args.iters)
            bound, by = measure.q8_bound(M, Ns, K)
            print(f"    ms {ms:.4f} | device {dev} | plain {plain_ms:.4f} | "
                  f"F.linear bf16 {lib_ms:.4f} | bound {bound:.4f} ({by})")
    for M in (4, 516) if only is None else ():
        same = graph_equals_eager(q8, measure.q8_case(
            3584, (18944, 18944), M, False, gen))
        bad += not same
        print(f"graph replay == eager at M = {M}: {same}")
    if args.time and only is None:
        forward(cfg.llm, gen, args.iters)
    print("all ok" if not bad else f"{bad} FAILED")
    return 1 if bad else 0


def graph_equals_eager(q8, kw) -> bool:
    """A replay of a captured grouped launch gives the eager bits."""
    x, members = kw["x"], kw["members"]
    eager = q8.q8_linear_group(x, members)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        q8.q8_linear_group(x, members)  # warm-up on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            out = q8.q8_linear_group(x, members)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(out, eager))


def host_us(fn, n: int = 200) -> float:
    """Host microseconds a call of fn, the device left to catch up after."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def forward(llm, gen, iters: int) -> None:
    """At each M of FORWARD_ROWS, CUDA-event ms of every decoder launch on
    the kernel, the dequantized product (the twin) and one F.linear on a
    bf16 weight, then each summed over one forward (each launch times its
    count: per layer one each; lm_head once)."""
    from oryx_tpu_torch.ops.cuda import measure

    count = {"lm_head": 1}
    print("host us a call at M = 4 (200 calls, no sync between): kernel / "
          "F.linear bf16")
    for proj, (K, Ns, bias) in measure.q8_shapes(llm).items():
        kern, _, lib = measure.q8_calls(measure.q8_case(K, Ns, 4, bias, gen))
        print(f"  {proj}: {host_us(kern):.1f} / {host_us(lib):.1f}")
    print("a decoder forward's int8 products, bf16, event ms: kernel / "
          "dequantized twin / F.linear bf16")
    for M in FORWARD_ROWS:
        total = [0.0, 0.0, 0.0]
        cells = []
        for proj, (K, Ns, bias) in measure.q8_shapes(llm).items():
            kw = measure.q8_case(K, Ns, M, bias, gen)
            ts = [measure.cuda_time_ms(f, iters)
                  for f in measure.q8_calls(kw)]
            n = count.get(proj, llm.num_layers)
            for i, t in enumerate(ts):
                total[i] += n * t
            cells.append(f"{proj} {ts[0]:.4f}/{ts[1]:.4f}/{ts[2]:.4f}")
        print(f"  M={M}: " + " | ".join(cells))
        print(f"  M={M} a forward: kernel {total[0]:.3f} ms, dequantized "
              f"{total[1]:.3f} ms, F.linear bf16 {total[2]:.3f} ms")


if __name__ == "__main__":
    sys.exit(main())
