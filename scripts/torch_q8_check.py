#!/usr/bin/env python3
"""Check (and optionally time) the port's int8-weight product on one NVIDIA
GPU (`oryx_tpu_torch/csrc/q8_linear.cu`), at every distinct (K, N) of an
oryx_7b decoder step (`measure.q8_shapes`: q, k/v, o, gate/up, down,
lm_head) and at M = 1, 4, 20, 64 and 100 rows (two launches), the tied
head (the embedding table's codes with one scale per column) at lm_head's
shape, plus tails whose K and N are not multiples of 16, in bf16 and fp32.

    python3 scripts/torch_q8_check.py [--time] [--iters 50]

Prints the build's ptxas lines (registers, spills), then per case the
kernel's largest error against the plain twin (dequantize, then F.linear;
atol = rtol = 1e-2 in bf16, atol 2e-4 / rtol 2e-3 in fp32), both relative
L2 errors against an fp32 witness (the kernel's at most NOISE_RATIO times
the twin's, in bf16), whether two launches give the same bits and whether
a row's bits are the same at 1, 4 and M rows, and whether a replay of the
kernel captured in a CUDA graph gives the eager bits. With --time: the
CUDA-event median of the kernel's call, its device time
(`measure.device_ms`), the twin's, F.linear on a bf16 weight of the same
shape (what the bf16 model pays), and the least time the card could take
(`measure.q8_bound`); then, per decoder shape at M from 64 to 516 rows
(the ragged engine's mixed dispatches: 4 decode rows and 64 or 512
prefill lanes), the kernel in launches of 64 rows against the dequantized
product, both summed over one forward's products, and the most rows at
which the kernel's forward is still the faster: what `q8_linear.MAX_ROWS`
is set from. Exits 1 on a disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

NOISE_RATIO = 1.5
ROWS = (1, 4, 20, 64, 100)
# (K, N, M, bias, dtype): K and N not multiples of 16.
TAILS = ((72, 100, 3, True, torch.bfloat16), (130, 37, 20, False,
                                              torch.bfloat16),
         (72, 100, 3, True, torch.float32), (130, 37, 64, True,
                                             torch.float32),
         (130, 37, 100, False, torch.float32))
# Rows of the route comparison: the kernel in 64-row launches against the
# dequantized product.
CROSS_ROWS = (64, 68, 128, 192, 256, 384, 516)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_q8_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from oryx_tpu_torch import config
    from oryx_tpu_torch.ops.cuda import build, measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    print(f"card: {measure.gpu_line()}")
    build.load("q8_linear")
    for line in build.build_logs.get("q8_linear", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = measure.q8_shapes(config.oryx_7b().llm)
    cases = [(f"{proj}[M={M}]", K, N, M, bias, torch.bfloat16, False)
             for proj, (K, N, bias) in shapes.items() for M in ROWS]
    K, N, _ = shapes["lm_head"]
    cases += [(f"tied_head[M={M}]", K, N, M, False, torch.bfloat16, True)
              for M in ROWS]
    cases += [(f"tail[K={K},N={N},M={M},{str(dt)[6:]}{',tied' * col}]", K,
               N, M, bias, dt, col)
              for K, N, M, bias, dt in TAILS for col in (False, True)]
    bad = 0
    for name, K, N, M, bias, dt, col in cases:
        kw = measure.q8_case(K, N, M, bias, gen, dt, col)
        f32 = dt == torch.float32
        r = measure.q8_compare(kw, *((2e-4, 2e-3) if f32 else (1e-2, 1e-2)))
        # In fp32 the witness is the twin itself: no noise ratio.
        ok = (r["within"] and r["same_bits"] and r["rows_independent"]
              and r["finite"] and (f32 or r["rel_kernel"] <= NOISE_RATIO
                                   * r["rel_twin"]))
        bad += not ok
        print(f"{name}: K={K} N={N} max abs err {r['max_abs_err']:.3e}, "
              f"rel L2 kernel {r['rel_kernel']:.3e} twin {r['rel_twin']:.3e}"
              f", same bits {r['same_bits']}, rows independent "
              f"{r['rows_independent']} {'ok' if ok else 'FAILED'}")
        if args.time and dt == torch.bfloat16:
            x, qq, s, b = kw["x"], kw["q"], kw["scale"], kw["bias"]
            w = q8.dequantize_weight(qq, s, x.dtype, col)
            ms = measure.cuda_time_ms(
                lambda: q8.q8_linear_kernel(x, qq, s, b, col), args.iters)
            dev = measure.device_ms(
                lambda: q8.q8_linear_kernel(x, qq, s, b, col))
            plain = measure.cuda_time_ms(
                lambda: q8.q8_linear_reference(x, qq, s, b, column_scale=col),
                args.iters)
            lib = measure.cuda_time_ms(
                lambda: torch.nn.functional.linear(x, w, b), args.iters)
            bound, by = measure.q8_bound(M, N, K)
            print(f"    ms {ms:.4f} | device {dev} | plain {plain:.4f} | "
                  f"F.linear bf16 {lib:.4f} | bound {bound:.4f} ({by})")
    # A replay of a captured launch gives the eager bits.
    kw = measure.q8_case(3584, 18944, 4, False, gen)
    eager = q8.q8_linear(**kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        q8.q8_linear(**kw)  # warm-up on the capture stream
        with torch.cuda.graph(graph, stream=stream):
            out = q8.q8_linear(**kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(out, eager)
    bad += not same
    print(f"graph replay == eager: {same}")
    if args.time:
        crossover(config.oryx_7b().llm, gen, args.iters)
    print("all ok" if not bad else f"{bad} FAILED")
    return 1 if bad else 0


def crossover(llm, gen, iters: int) -> None:
    """Per decoder shape and row count of CROSS_ROWS: CUDA-event ms of the
    kernel in 64-row launches and of the dequantized product; then the
    products of one forward over the whole decoder (each shape times its
    count: per layer q, o, down once, k/v and gate/up twice; lm_head once)
    on each route, and the most rows at which the kernel's forward is still
    the faster."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    L = llm.num_layers
    count = {"q": L, "kv": 2 * L, "o": L, "gate_up": 2 * L, "down": L,
             "lm_head": 1}
    print(f"kernel (64-row launches) vs dequantized product, bf16, event ms "
          f"(q8_linear.MAX_ROWS = {q8.MAX_ROWS})")
    total = {M: [0.0, 0.0] for M in CROSS_ROWS}
    for proj, (K, N, bias) in measure.q8_shapes(llm).items():
        cells = []
        for M in CROSS_ROWS:
            kw = measure.q8_case(K, N, M, bias, gen)
            x, qq, s, b = kw["x"], kw["q"], kw["scale"], kw["bias"]
            kern = measure.cuda_time_ms(
                lambda: q8.q8_linear_kernel(x, qq, s, b), iters)
            plain = measure.cuda_time_ms(
                lambda: q8.q8_linear_reference(x, qq, s, b), iters)
            total[M][0] += count[proj] * kern
            total[M][1] += count[proj] * plain
            cells.append(f"M={M} {kern:.4f}/{plain:.4f}")
        print(f"  {proj} (K={K}, N={N}): " + " | ".join(cells))
    print("  a forward's products: " + " | ".join(
        f"M={M} {k:.3f}/{p:.3f}" for M, (k, p) in total.items()))
    wins = [M for M in CROSS_ROWS
            if all(total[m][0] < total[m][1] for m in CROSS_ROWS if m <= M)]
    print(f"the kernel's forward is the faster up to M = "
          f"{max(wins, default=None)}")


if __name__ == "__main__":
    sys.exit(main())
