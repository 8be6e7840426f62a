"""On the card: each cell run once through the command the benchmark's
checks run, at a short window, ends correct with every metric of its
kind (`python3 -m pytest benchmark/tests -m cuda` on a machine with an
H100). Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec

BENCH = spec.load_spec()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "15", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    e2e, layer = spec.cell_metrics(BENCH, cell)
    want = {m["name"] for m in (layer if trace else e2e)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
