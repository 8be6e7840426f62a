"""Readings for the limits of `correct`: runs a cell's whole path on each
seed in turn (set-up, a window, the check) in one process and prints, per
seed, the program's compared numbers beside the control's (the fp8
reference in the program's place) and, for training, a fault's (half of
each batch left out). Not run by the benchmark's own runs.

    python3 benchmark/tools/control.py --workload oryx-7b.video-qa \
        --seconds 20 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402


class Ctx:
    def __init__(self, workload, config, seed, seconds):
        self.workload, self.config = workload, config
        self.seed, self.seconds = seed, seconds
        self.trace, self.control, self.device = False, True, "cuda"
        self.t_start = time.perf_counter()
        self.setup_s = None

    def mark_setup(self):
        import torch

        torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start

    def device_record(self):
        from benchmark.harness.device import device_record

        return device_record(1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    w = spec.workload(args.workload)
    cfg = spec.config(w["config"])
    driver = importlib.import_module(f"benchmark.drivers.{w['driver']}")
    for seed in args.seeds:
        import torch

        out = driver.run(Ctx(w, cfg, seed, args.seconds))
        print(json.dumps({"seed": seed, "failed": out["failed"],
                          "checks": {k: v["value"]
                                     for k, v in out["checks"].items()}}),
              flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
