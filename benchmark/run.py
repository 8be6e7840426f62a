"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's file (`benchmark/workloads/<name>.json`) names its
configuration (`benchmark/configs/<config>.json`), its driver
(`benchmark/drivers/<driver>.py`) and its traffic. Set-up (weights, engine
or trainer, warm-up) is timed as `setup_s`; then the driver measures for
`--seconds`. With `--trace 0` the last line of standard output is the
result with the cell's end-to-end metrics; with `--trace 1` a traced window
gives its per-layer metrics instead, each read by `metrics/<name>.py`. Every
run checks what the timed path produced against the plain reference
(`benchmark/reference/`) and prints each compared number beside its limit,
last on standard error and last in the result.

Exits non-zero, printing no result, without the cards the cell needs, or
if JAX or the JAX package was loaded."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# Caches the program may build live at fixed paths inside the checkout.
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import isolation, spec  # noqa: E402
from benchmark.harness.result import finite, verdict  # noqa: E402


class Context:
    def __init__(self, args, workload: dict, config: dict) -> None:
        self.workload, self.config = workload, config
        self.seed, self.seconds = args.seed, float(args.seconds)
        self.trace = bool(args.trace)
        self.t_start = T_START
        self.setup_s = None
        self.device = "cuda"
        # benchmark/tools/control.py reads the control beside each check.
        self.control = False

    def mark_setup(self) -> None:
        """Set-up ends here: the window opens next."""
        import torch

        torch.cuda.synchronize()
        self.setup_s = time.perf_counter() - self.t_start

    def device_record(self) -> dict:
        from benchmark.harness.device import device_record

        return device_record(self.workload["chips"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load_spec()
    workload = spec.workload(args.workload)
    config = spec.config(workload["config"])
    from benchmark.harness import device

    device.require_cards(workload["chips"])
    sys.stderr.write(f"card: {device.power_limit()}\n")
    import importlib

    driver = importlib.import_module(f"benchmark.drivers.{workload['driver']}")
    ctx = Context(args, workload, config)
    out = driver.run(ctx)

    found = isolation.banned_loaded()
    if found:
        sys.stderr.write(f"benchmark: loaded {', '.join(found)}: the run "
                         "may not load JAX or the JAX package\n")
        return 4

    e2e, per_layer = spec.cell_metrics(bench, args.workload)
    metrics = {}
    if not args.trace:
        values = dict(out["metrics"], setup_s=ctx.setup_s)
        for m in e2e:
            v = values.get(m["name"])
            if not finite(v):
                sys.stderr.write(f"benchmark: no value for {m['name']}\n")
                return 5
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        run = out["trace"]
        for m in per_layer:
            v = spec.metric_reader(m["name"])(run)
            if v is not None and finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = dict(out["device"])
    if args.trace:
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
    checks = out["checks"]
    result = {"correct": verdict(out), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        result["breakdown"] = out["trace"]["breakdown"]
    result["checks"] = checks
    sys.stderr.write(f"setup_s {ctx.setup_s}\n")
    for name, c in checks.items():
        sys.stderr.write(f"check {name} {c['value']} limit {c['limit']}\n")
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
