"""The cells' whole paths at a tiny size on the CPU: each driver's set-up,
window and check run on the port's plain path; the reference loads nothing
of the program and no run loads JAX; and with the timed path broken
underneath, `correct` comes out false, while the fp8 control fails the
served-token check that the program passes."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import isolation
from benchmark.harness.result import verdict
from benchmark.harness.spec import ROOT
from benchmark.tests import tiny

# At the tiny size the program runs in float32, so its greedy tokens are
# the reference's argmax up to float32 rounding: a gap above this is a
# token the program got wrong.
TINY_GAP = 1e-3


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_whole_run_loads_no_jax():
    """The open-loop driver's whole run, in its own process: afterwards
    sys.modules holds neither JAX nor the JAX package by top-level name."""
    got = _run(
        "import json, sys\n"
        "from benchmark.tests import tiny\n"
        "from benchmark.drivers import serve_open\n"
        "from benchmark.harness import isolation\n"
        "w, c = tiny.open_loop()\n"
        "serve_open.run(tiny.Ctx(w, c, 3, 2.0))\n"
        "print(json.dumps({'banned': isolation.banned_loaded(),\n"
        "  'program': 'oryx_tpu_torch' in sys.modules}))\n")
    assert got == {"banned": [], "program": True}


def test_the_reference_loads_nothing_of_the_program():
    got = _run(
        "import json, sys\n"
        "import benchmark.reference.oryx_ref, benchmark.reference.serve_check\n"
        "import benchmark.reference.train_ref\n"
        "from benchmark.harness import isolation\n"
        "print(json.dumps(isolation.banned_loaded(\n"
        "  banned=isolation.BANNED | {isolation.PROGRAM})))\n")
    assert got == []


def test_top_level_names_compare_whole():
    assert isolation.banned_loaded(["oryx_tpu_torch.models", "numpy"]) == []
    assert isolation.banned_loaded(["oryx_tpu.models"]) == ["oryx_tpu"]
    assert isolation.banned_loaded(["jax._src.core", "flax"]) == \
        ["flax", "jax"]


# ---- serving -----------------------------------------------------------------

def _serve(which, seed, control=False, sample=None, seconds=2.0):
    import importlib

    w, c = getattr(tiny, which)()
    w["check"] = dict(w["check"], max_gap=TINY_GAP,
                      sample=sample or w["check"]["sample"])
    driver = importlib.import_module(f"benchmark.drivers.{w['driver']}")
    return driver.run(tiny.Ctx(w, c, seed, seconds, control=control))


@pytest.mark.parametrize("which", ["video_qa", "chat_backlog", "open_loop"])
def test_serving_path_is_correct(which):
    out = _serve(which, 2**32 + 17)
    assert out["attempted"] > 0 and verdict(out)
    assert out["checks"]["max_gap"]["value"] <= TINY_GAP
    assert set(out["metrics"]) == ({"ttft_p90_s", "tpot_p90_ms"}
                                   if which == "open_loop" else
                                   {"output_tokens_per_s", "tpot_p90_ms"})


def test_the_control_fails_the_served_token_check():
    """The control (the fp8 reference in the program's place) over some
    hundreds of served tokens: the token it ranks first lies below the
    float32 reference's best by more than the limit the program keeps."""
    out = _serve("chat_backlog", 2**32 + 19, control=True, sample=12,
                 seconds=12.0)
    assert out["checks"]["checked_tokens"]["value"] >= 100
    assert out["checks"]["max_gap"]["value"] <= TINY_GAP
    assert out["checks"]["control_max_gap"]["value"] > TINY_GAP


@pytest.mark.parametrize("which", ["video_qa", "chat_backlog"])
def test_an_altered_token_is_not_correct(which, monkeypatch):
    """A token altered where the engine produces it (each chunk's first
    token of every request, +1)."""
    from oryx_tpu_torch.serve import scheduler

    orig = scheduler.ContinuousScheduler._advance

    def altered(self, s, tokens):
        tokens = list(tokens)
        if tokens:
            tokens[0] = (int(tokens[0]) + 1) % self.cfg.llm.vocab_size
        return orig(self, s, tokens)
    monkeypatch.setattr(scheduler.ContinuousScheduler, "_advance", altered)
    out = _serve(which, 5)
    assert not verdict(out)
    assert out["checks"]["max_gap"]["value"] > TINY_GAP


# ---- training ----------------------------------------------------------------

def _sft(seed, control=False):
    from benchmark.drivers import train

    w, c = tiny.sft("oryx-34b-l2.sft")
    return train.run(tiny.Ctx(w, c, seed, 2.0, control=control))


def test_training_cell_is_correct():
    out = _sft(2**31 + 3)
    assert out["attempted"] > 0 and verdict(out), out["checks"]


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(monkeypatch):
    from oryx_tpu_torch.train import optimizer

    def unchanged(self, grads, state, params):
        return {}, state
    monkeypatch.setattr(optimizer.AdamW, "update", unchanged)
    out = _sft(7)
    assert not verdict(out)
    assert out["checks"]["change_leaf"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    """Each step's gradient and loss taken over the first half of its
    microbatches only (the mean over the rest)."""
    from oryx_tpu_torch.train import step

    orig = step.gradients

    def half(params, cfg, batch, **kw):
        n = batch["token_ids"].shape[0] // 2
        return orig(params, cfg, {k: v[:n] for k, v in batch.items()}, **kw)
    monkeypatch.setattr(step, "gradients", half)
    out = _sft(8)
    assert not verdict(out), out["checks"]
