#!/usr/bin/env python3
"""Repeat chip_smoke.py's phase 21 (b) alone on one NVIDIA GPU: the
continuous ragged engine over HTTP at full oryx_7b width (bf16, seeded
weights), sampled device time every second dispatch, then
GET /debug/profile?steps=4 around an image request's admission, whose K4
kernel records must equal the K4 wrapper's launches over the captured
dispatches.

    python3 scripts/torch_capture_check.py [--runs 5]

Each run prints the phase's own lines, among them the capture's K4 kernel
records beside the K4 wrapper's launches over the captured steps, and the
periodic samples' K4 records beside their dispatches' launches (graph
replays apart from eager dispatches; measured, not held); then the
activity records CUPTI reports it dropped since the last run
(`cuptiActivityGetNumDroppedRecords`, when libcupti is loaded). The last
line sums the runs (a run whose check failed counts as failed, and the
others still run). Exits 1 when any run failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_capture_check: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    os.chdir(root)
    import chip_smoke
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import build
    from oryx_tpu_torch.ops.cuda.measure import gpu_line
    from oryx_tpu_torch.serve.pipeline import Pipeline

    sys.stdout.reconfigure(line_buffering=True)
    card = gpu_line()
    print(f"card: {card}")
    for name in ("flash_attention", "paged_attention"):
        build.build(name)
        build.load(name)
    cfg = dataclasses.replace(config.oryx_7b(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                              device="cuda", dtype=torch.bfloat16)
    pipe = Pipeline(chip_smoke.ByteTokenizer(), params, cfg, device="cuda")
    server = chip_smoke.HttpServer(pipe, engine="continuous",
                                   **chip_smoke.HTTP_SERVE)
    try:
        unarmed = chip_smoke._sequential(server, "unarmed")
    finally:
        server.close()
    failed = 0
    for i in range(args.runs):
        print(f"run {i}:")
        try:
            chip_smoke.sampled_device_time(pipe, unarmed, card)
        except SystemExit as e:
            failed += 1
            print(f"run {i} failed: {e}")
        print(f"  CUPTI's dropped activity records: {_dropped()}")
    print(f"{args.runs - failed} of {args.runs} runs held K4's kernel "
          f"records equal to its launches ({card})")
    return 1 if failed else 0


def _cupti():
    """libcupti as this process loaded it (the profiler's), or None."""
    import ctypes

    for name in ("libcupti.so.12", "libcupti.so"):
        try:
            return ctypes.CDLL(name, mode=os.RTLD_NOLOAD | os.RTLD_GLOBAL)
        except OSError:
            continue
    return None


def _dropped():
    """The activity records CUPTI says it dropped: from its global queue
    and from the current context's (`cuptiActivityGetNumDroppedRecords`),
    or None when libcupti is not loaded in this process."""
    import ctypes

    lib = _cupti()
    if lib is None:
        return None
    out = []
    ctx = ctypes.c_void_p(0)
    try:
        ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(ctx))
    except OSError:
        pass
    for c in (None, ctx):
        n = ctypes.c_size_t(0)
        rc = lib.cuptiActivityGetNumDroppedRecords(c, 0, ctypes.byref(n))
        out.append(int(n.value) if rc == 0 else f"error {rc}")
    return {"global": out[0], "context": out[1]}


if __name__ == "__main__":
    sys.exit(main())
