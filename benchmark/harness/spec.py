"""The benchmark's data: `BENCHMARK.json` at the checkout's root, one file
per configuration (`configs/<name>.json`), one per cell
(`workloads/<name>.json`) and one reader per per-layer metric
(`metrics/<name>.py`). Everything is found by the name `BENCHMARK.json`
gives it, so a new cell, configuration or metric is a new file."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
SPEC_PATH = ROOT / "BENCHMARK.json"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_spec(path: Path = SPEC_PATH) -> dict:
    with open(path) as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> dict:
    """The cell's file: its configuration, driver and traffic."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad workload name {name!r}")
    path = BENCH_DIR / "workloads" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no workload file {path}")
    w = load_json(path)
    w["name"] = name
    return w


def config(name: str) -> dict:
    if not NAME_RE.match(name):
        raise ValueError(f"bad config name {name!r}")
    return load_json(BENCH_DIR / "configs" / f"{name}.json")


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) metric entries that `cell` reports: those
    without a `workloads` key, and those that name it."""
    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    return ([m for m in spec["end_to_end"] if applies(m)],
            [m for m in spec["per_layer"] if applies(m)])


def metric_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py` (loaded by path:
    metric names hold dots)."""
    if not NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}")
    path = BENCH_DIR / "metrics" / f"{name}.py"
    mod_name = "benchmark_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
