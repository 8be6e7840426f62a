#!/usr/bin/env python3
"""Check (and optionally time) the port's flash-attention forward K1 on one
NVIDIA GPU, on each of its bf16 routes, at the main path's call shapes with
synthetic packing metadata (`oryx_tpu_torch.ops.cuda.measure.flash_case`):

  decode      the chat_batch decode step (the split-KV decode route);
  prefill     its prefill against the 4,096-slot cache (the wgmma/TMA
              body over the cell map, as below);
  vit         the ViT's 8,192 patch slots, D=72;
  compressor  2,048 pooled queries against the 8,192 patches;
  decoder     the training decoder with the logsumexp (slot positions);
  vit_lse     vit with the logsumexp (the training ViT);
  compressor_lse  512 queries against the 8,192 patches, with the
              logsumexp (the training compressor).

    python3 scripts/torch_flash_fwd_check.py [--shapes decode,vit]
        [--time] [--iters 20]

Prints the build's ptxas lines for the forward library, then per shape the
kernel's largest error against the plain twin on the rows with a visible
key (atol = rtol = 1e-2), the relative L2 error against an fp32 witness
(the twin on the same inputs upcast) beside the bf16 twin's, which it may
exceed by at most 1.5x, the logsumexp's error (1e-3), and whether two calls
give the same bits. With --time: the CUDA-event median of the wrapper call,
its device time (`measure.device_ms`: summed kernel durations per call, the
cell map's or the merge's launches included), SDPA with an explicit boolean
mask on the same inputs, and the least time the card could take (the
larger of 4 D flops per visible pair / 989 TFLOP/s and the bytes once /
3.35 TB/s). Exits 1 on a disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

TOL = 1e-2
NOISE_RATIO = 1.5
# Shape name -> (measure.flash_case shape, timed with the logsumexp).
SHAPES = {
    "decode": ("decode", False), "prefill": ("prefill", False),
    "vit": ("vit", False), "compressor": ("compressor", False),
    "decoder": ("decoder", True), "vit_lse": ("vit", True),
    "compressor_lse": ("train_compressor", True),
}


def _rel(a, w):
    return float((a.float() - w).norm() / w.norm())


def check(name, kw, with_lse, timing: bool, iters: int) -> bool:
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda.measure import (
        PEAK_BYTES, PEAK_FLOPS, cuda_time_ms, device_ms,
    )

    q, k, v = kw["q"], kw["k"], kw["v"]
    args, flags = fa._prepare(
        q, k, v, kw.get("q_positions"), kw.get("kv_positions"),
        kw.get("q_segment_ids"), kw.get("kv_segment_ids"), kw.get("kv_mask"),
        kw["causal"], None, kw.get("slot_positions", False),
    )
    ints = args[3:]
    B, Tq = q.shape[:2]
    vis = torch.stack([
        fa._mask(b, *ints, flags["causal"], flags["has_segments"]).expand(
            Tq, k.shape[1]) for b in range(B)])
    keep = vis.any(-1)  # [B, Tq]

    def run():
        return fa._mha_forward(*args, **flags, with_lse=True)

    decode = sum(fa.LAUNCHES_DECODE.values())
    o, lse = run()
    o2, lse2 = run()
    route = ("decode" if sum(fa.LAUNCHES_DECODE.values()) > decode
             else "wgmma/TMA")
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    wo = fa._mha_forward_reference(*(x.float() for x in args[:3]), *ints,
                                   **flags)
    torch.cuda.synchronize()
    rows = keep[:, None, :, None]
    g, r = o.transpose(1, 2)[keep].float(), ro.transpose(1, 2)[keep].float()
    err = (g - r).abs()
    close = bool((err <= TOL + TOL * r.abs()).all())
    kl = keep[:, None, :].expand(lse.shape)
    lse_err = float((lse[kl] - rlse[kl]).abs().max())
    ek = _rel(o * rows, wo * rows)
    ep = _rel(ro * rows, wo * rows)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    ok = (close and bool(torch.isfinite(g).all()) and ek <= NOISE_RATIO * ep
          and lse_err <= 1e-3 and same)
    print(f"  {name} [{route}]: q {tuple(q.shape)} k {tuple(k.shape)}, rows "
          f"with a visible key {int(keep.sum())}/{keep.numel()}; max abs "
          f"err {float(err.max()):.3e}; rel L2 vs fp32 kernel {ek:.3e} "
          f"plain {ep:.3e}; lse err {lse_err:.3e}; two calls bitwise equal "
          f"{same}; ok={ok}")
    if not timing:
        return ok

    def call():
        return fa._mha_forward(*args, **flags, with_lse=with_lse)

    ms = cuda_time_ms(call, iters)
    dev = device_ms(call, iters)
    Hq, D = q.shape[2], q.shape[3]
    Hk = k.shape[2]
    G = Hq // Hk
    qp, kp, vp = args[:3]
    kr, vr = (x.repeat_interleave(G, dim=1) for x in (kp, vp))
    m4 = vis[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = cuda_time_ms(lambda: sdpa(qp, kr, vr, attn_mask=m4,
                                    scale=flags["scale"]), iters)
    pairs = float(vis.sum())
    flops = 4.0 * D * Hq * pairs
    kv_rows = int(vis.any(1).sum())
    nbytes = (2 * q.numel() * 2 + 2 * kv_rows * Hk * D * 2
              + sum(x.numel() * 4 for x in ints)
              + (B * Hq * Tq * 4 if with_lse else 0))
    bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
    rate = ("" if dev.ms is None else
            f" | {flops / dev.ms / 1e9:.1f} TFLOP/s on the device time")
    print(f"    event {ms:.4f} ms | device {dev} | sdpa {lib:.4f} ms | bound "
          f"{bound:.4f} ms{rate}")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from oryx_tpu_torch.ops.cuda import build
    from oryx_tpu_torch.ops.cuda.measure import flash_case, gpu_line

    print(f"card: {gpu_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    build.load("flash_attention")
    for line in build.build_logs.get("flash_attention", "").splitlines():
        if any(w in line for w in ("registers", "spill", "wgmma", "warning",
                                   "Compiling", "error")):
            print(f"  ptxas: {line.strip()}")
    gen = torch.Generator("cuda").manual_seed(3)
    ok = True
    for name in a.shapes.split(","):
        if name not in SHAPES:
            raise SystemExit(f"unknown shape {name}")
        shape, with_lse = SHAPES[name]
        ok &= check(name, flash_case(shape, gen), with_lse, a.time, a.iters)
    print("all agree" if ok else "DISAGREEMENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
