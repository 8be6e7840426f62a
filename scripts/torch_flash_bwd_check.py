#!/usr/bin/env python3
"""Check (and optionally time) the port's flash-attention backward kernels
K5a (dq) and K5b (dk/dv) on one NVIDIA GPU, at the training step's three
call shapes with synthetic packing metadata
(`oryx_tpu_torch.ops.cuda.measure.flash_case`):

  decoder     B=4, T=2048, 28 q / 4 kv heads, D=128, causal on slot
              positions, rows of 2048/1800/1500/1153 real tokens;
  vit         8,192 patch slots, 16 heads, D=72, four 44 x 44-patch images
              (7,744 real patches, pads attending pads);
  compressor  512 pooled queries against 8,192 patches, 16 heads, D=72,
              4 x 4-patch regions of the same four images
              (`train_compressor` there).

    python3 scripts/torch_flash_bwd_check.py [--shapes decoder,vit]
        [--time] [--iters 10]

Prints the build's ptxas lines for the backward library, then per shape
the relative L2 error of each of dq, dk, dv against an fp32 witness (the
plain twins on the same inputs upcast) beside the bf16 twin's, which it
may exceed by at most 1.5x (the rule of chip_smoke.py's phase 9). With
--time: CUDA-event medians of each kernel, SDPA forward and forward +
backward (explicit boolean mask) on the same inputs, and each kernel's
least time (flops / 989 TFLOP/s). Exits 1 on a disagreement.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

NOISE_RATIO = 1.5
# Shape name -> measure.flash_case shape.
SHAPES = {"decoder": "decoder", "vit": "vit",
          "compressor": "train_compressor"}


def _rel(a, w):
    return float((a.float() - w).norm() / w.norm())


def check(name, kw, gen, timing: bool, iters: int) -> bool:
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda.measure import PEAK_FLOPS, cuda_time_ms

    q, k, v = kw["q"], kw["k"], kw["v"]
    args, flags = fa._prepare(
        q, k, v, kw.get("q_positions"), kw.get("kv_positions"),
        kw.get("q_segment_ids"), kw.get("kv_segment_ids"), kw.get("kv_mask"),
        kw["causal"], None, kw.get("slot_positions", False),
    )
    qkv, ints = args[:3], args[3:]
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    B = q.shape[0]
    vis = torch.stack([
        fa._mask(b, *ints, flags["causal"], flags["has_segments"]).expand(
            q.shape[1], k.shape[1]) for b in range(B)])
    keep = vis.any(-1)
    do = (torch.randn(q.shape, generator=gen, device=q.device)
          * keep[:, :, None, None]).to(torch.bfloat16).transpose(1, 2)
    delta = torch.einsum("bhqd,bhqd->bhq", do.float(), o.float()).contiguous()
    got = fa._mha_backward(*qkv, do, lse, delta, *ints, **flags)
    again = fa._mha_backward(*qkv, do, lse, delta, *ints, **flags)
    plain = fa._mha_backward_reference(*qkv, do, lse, delta, *ints, **flags)
    f32 = [x.float() for x in qkv]
    witness = fa._mha_backward_reference(*f32, do.float(), lse, delta, *ints,
                                         **flags)
    torch.cuda.synchronize()
    ok = True
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    print(f"  {name}: q {tuple(q.shape)} k {tuple(k.shape)}; two launches "
          f"bitwise equal: {same}")
    ok &= same
    for gname, a, p_, w in zip(("dq", "dk", "dv"), got, plain, witness):
        ek, ep = _rel(a, w), _rel(p_, w)
        mabs = float((a.float() - p_.float()).abs().max())
        mag = float(p_.float().abs().max())
        good = ek <= NOISE_RATIO * ep and bool(torch.isfinite(a).all())
        ok &= good
        print(f"    {gname}: rel L2 vs fp32 kernel {ek:.3e} plain {ep:.3e}; "
              f"max abs err vs plain {mabs:.3e} (max |plain| {mag:.3e}) "
              f"ok={good}")
    if not timing:
        return ok
    ms_dq = cuda_time_ms(lambda: fa._mha_backward_dq(
        *qkv, do, lse, delta, *ints, **flags), iters)
    ms_dkv = cuda_time_ms(lambda: fa._mha_backward_dkv(
        *qkv, do, lse, delta, *ints, **flags), iters)
    G = q.shape[2] // k.shape[2]
    kr = qkv[1].repeat_interleave(G, dim=1)
    vr = qkv[2].repeat_interleave(G, dim=1)
    m4 = vis[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_time_ms(lambda: sdpa(qkv[0], kr, vr, attn_mask=m4,
                                        scale=flags["scale"]), iters)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qkv[0], kr, vr))

    def fwd_bwd():
        out = sdpa(qg, kg, vg, attn_mask=m4, scale=flags["scale"])
        return torch.autograd.grad(out, (qg, kg, vg), do)

    lib_all = cuda_time_ms(fwd_bwd, max(3, iters // 2))
    pairs = float(vis.sum()) * q.shape[2] * q.shape[3]
    for label, ms, per in (("dq", ms_dq, 6.0), ("dkv", ms_dkv, 8.0)):
        bound = per * pairs / PEAK_FLOPS * 1e3
        print(f"    {label}: {ms:.4f} ms, {per * pairs / ms / 1e9:.1f} "
              f"TFLOP/s, bound {bound:.4f} ms ({bound / ms:.1%})")
    print(f"    K5a+K5b {ms_dq + ms_dkv:.4f} ms | sdpa fwd {lib_fwd:.4f} ms, "
          f"fwd+bwd {lib_all:.4f} ms, bwd alone {lib_all - lib_fwd:.4f} ms")
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--iters", type=int, default=10)
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
    for name in ("flash_attention", "flash_attention_bwd"):
        build.load(name)
        for line in build.build_logs.get(name, "").splitlines():
            if name.endswith("bwd") and (
                "registers" in line or "spill" in line or "wgmma" in line
                or "warning" in line or "Compiling" in line
            ):
                print(f"  ptxas: {line.strip()}")
    gen = torch.Generator("cuda").manual_seed(3)
    ok = True
    for name in SHAPES:  # the order the random draws were made in
        if name in a.shapes.split(","):
            ok &= check(name, flash_case(SHAPES[name], gen), gen, a.time,
                        a.iters)
    print("all agree" if ok else "DISAGREEMENT")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
