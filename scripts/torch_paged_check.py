#!/usr/bin/env python3
"""Check (and optionally time) the port's paged-attention kernels K3/K4 on
one NVIDIA GPU, at the serving engine's call shapes with synthetic block
tables (`oryx_tpu_torch.ops.cuda.measure.paged_case`: a 256 x 64 pool, 4 kv
heads of 28 q heads, D = 128):

  decode          K3, 4 rows of 1,100-1,200 visible slots;
  ragged_decode   K4, the same 4 rows as a packed decode dispatch;
  ragged_prefill  K4, R = 68: the 4 decode rows, then 64 prefill lanes of
                  one slot at consecutive positions;

each over a bf16, an int8 and an fp8-e4m3 pool.

    python3 scripts/torch_paged_check.py [--shapes decode,ragged_prefill]
        [--formats bf16,int8,fp8_e4m3] [--time] [--iters 50]

Prints the build's ptxas lines (registers, spills) for the paged library,
then per case the kernel's largest error against the plain twin
(`ops/paged_kv.py`) on the rows that see a slot (atol = rtol = 1e-2),
whether two calls give the same bits, and the split plan and row tile.
With --time: each kernel's time per call from one profiler pass, the
CUDA-event median of the wrapper call, its device time
(`measure.device_ms`: the split kernel and its merge), the plain twin,
gather_pages + SDPA with an explicit mask on the same inputs, and the
least time the card could take (`measure.paged_bound`). Exits 1 on a
disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

TOL = 1e-2
SHAPES = ("decode", "ragged_decode", "ragged_prefill")
FORMATS = ("bf16", "int8", "fp8_e4m3")


def kernel_us(fn, iters: int):
    """(kernel name, microseconds per call) of fn's kernels, from one
    torch.profiler pass of `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")[:48]
            us[name] = us.get(name, 0.0) + e.time_range.elapsed_us() / iters
    return sorted(us.items(), key=lambda kv: -kv[1])


def check(name: str, fmt: str, gen, timing: bool, iters: int) -> bool:
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.ops.cuda.measure import (
        cuda_time_ms, device_ms, paged_bound, paged_case,
    )

    code = None if fmt == "bf16" else fmt
    c = paged_case(name, gen, code)
    q, k, v, bt, ints = c["q"], c["k"], c["v"], c["bt"], c["ints"]
    if c["kind"] == "paged_decode":
        def kernel():
            return pa.ragged_decode_attention(q, k, v, bt, *ints)

        def plain():
            return paged_kv.ragged_decode_attention(q, k, v, bt, *ints)
    else:
        def kernel():
            return pa.ragged_paged_attention(q, k, v, bt, *ints)

        def plain():
            return paged_kv.ragged_paged_attention(q, k, v, bt, *ints)
    before = sum(pa.LAUNCHES.values())
    got, again, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    launched = sum(pa.LAUNCHES.values()) - before
    keep = torch.tensor(c["visible"], device=q.device) > 0
    g, r = got[keep].float(), ref[keep].float()
    err = (g - r).abs()
    close = bool((err <= TOL + TOL * r.abs()).all())
    same = torch.equal(got, again)
    empty_zero = bool((got[~keep] == 0).all())
    ok = (close and same and empty_zero and launched == 2
          and bool(torch.isfinite(g).all()))
    R, Hq, D = q.shape
    Hk = k.shape[2]
    S, maxp = bt.shape
    plan_of = getattr(pa, "plan_of", None)  # absent before the split route
    plan = ("not planned (one block per row and kv head)" if plan_of is None
            else plan_of(c["kind"], R, S, Hk, Hq // Hk, maxp, k.shape[1],
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count))
    print(f"  {name} [{fmt}]: q {tuple(q.shape)}, table {tuple(bt.shape)}, "
          f"visible {min(c['visible'])}..{max(c['visible'])}; max abs err "
          f"{float(err.max()):.3e}; two calls bitwise equal {same}; "
          f"launches counted {launched}/2; plan {plan}; ok={ok}")
    if not timing:
        return ok
    ms = cuda_time_ms(kernel, iters)
    dev = device_ms(kernel, iters)
    plain_ms = cuda_time_ms(plain, max(3, iters // 10), warmup=1)
    vis = torch.tensor(c["visible"], device=q.device)
    segl = torch.tensor(c["segments"], device=q.device).long()
    mask = (torch.arange(maxp * k.shape[1], device=q.device)[None]
            < vis[:, None])[:, None, None, :]

    def library():
        kk = paged_kv.gather_pages(k, bt)[segl].transpose(1, 2)
        vv = paged_kv.gather_pages(v, bt)[segl].transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(R, Hq, 1, D), kk, vv, attn_mask=mask, enable_gqa=True)

    lib = cuda_time_ms(library, iters)
    bound, by, kv_rows, flops, nbytes = paged_bound(
        q.numel(), Hq, D, Hk, bt.numel(), c["segments"], c["visible"],
        len(ints), code)
    split = ", ".join(f"{n} {us:.2f} us" for n, us in kernel_us(kernel, iters))
    print(f"    kernels per call: {split}")
    print(f"    event {ms:.4f} ms | device {dev} | plain {plain_ms:.4f} ms "
          f"| gather+sdpa {lib:.4f} ms | bound {bound:.4f} ms ({by}: "
          f"{kv_rows} kv rows, {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} "
          f"MB)")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--formats", default=",".join(FORMATS))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from oryx_tpu_torch.ops.cuda import build
    from oryx_tpu_torch.ops.cuda.measure import gpu_line

    print(f"card: {gpu_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.load("paged_attention")
    for line in build.build_logs.get("paged_attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "warning",
                                   "Compiling", "error")):
            print(f"  ptxas: {line.strip()}")
    gen = torch.Generator("cuda").manual_seed(5)
    ok = True
    for fmt in a.formats.split(","):
        if fmt not in FORMATS:
            raise SystemExit(f"unknown format {fmt}")
        for name in a.shapes.split(","):
            if name not in SHAPES:
                raise SystemExit(f"unknown shape {name}")
            ok &= check(name, fmt, gen, a.time, a.iters)
    print("all agree" if ok else "DISAGREEMENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
