"""The port's Trainer under injected faults, as the JAX package's
(mirrors tests/test_trainer_faults.py): checkpoint-save retry on a pinned
backoff schedule, its budget, atomic projector saves, a data-loader fault
that retries the same fetch (the loss trajectory unchanged), a dead loader
that aborts after `max_data_faults`, a corrupt batch that the non-finite
guard skips, and a mid-run crash that a fresh Trainer resumes bit for bit
from the last checkpoint. Tiny fp32 config on the CPU, on the JAX init's
weights (tests/test_torch_trainer.py holds the clean fit to the JAX
Trainer's); the backoff delays are the JAX policy's."""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oryx_tpu.utils import faults as jfaults  # noqa: E402
from oryx_tpu.utils.retry import BackoffPolicy as JPolicy  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.train.trainer import Trainer  # noqa: E402
from oryx_tpu_torch.utils import faults  # noqa: E402
from oryx_tpu_torch.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    save_projector_only,
)
from oryx_tpu_torch.utils.retry import BackoffPolicy  # noqa: E402
from torch_train_common import cfgs, make_batches, make_tree  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def data():
    """Four step-dependent batches (JAX-collated): two images, the two
    microbatches of the accum-2 collation (two images | two videos), two
    images again."""
    b = make_batches()
    one = {k: v[0] for k, v in b[1].items()}
    return [one, {k: v[0] for k, v in b[2].items()},
            {k: v[1] for k, v in b[2].items()}, one]


def _trainer(tree, tmp_path, name, *, every=1, metrics=True, **kw):
    _, ct = cfgs(tune="projector_only", lr=1e-3,
                 **kw.pop("train", {}))
    cfg = dataclasses.replace(ct, train=dataclasses.replace(
        ct.train, checkpoint_dir=str(tmp_path / name),
        checkpoint_every=every, log_every=1))
    return Trainer(cfg, params=from_jax_params(tree, cfg), device="cpu",
                   metrics_path=str(tmp_path / f"{name}.jsonl")
                   if metrics else None, **kw)


def _losses(path) -> dict[int, float]:
    return {rec["step"]: rec["loss"] for rec in map(
        json.loads, path.read_text().splitlines())}


def _state():
    model = torch.nn.Linear(4, 2)
    return types.SimpleNamespace(params=model, step=1,
                                 opt_state={"count": 1, "m": torch.ones(2)})


# ---------------------------------------------------------------------------
# Checkpoint-save retry (manager-level)
# ---------------------------------------------------------------------------


def test_checkpoint_save_retries_injected_failures(tmp_path):
    slept = []
    mgr = CheckpointManager(
        str(tmp_path / "ck"),
        save_retry=BackoffPolicy(retries=3, base_s=0.5, factor=2.0,
                                 jitter=0.0),
        sleep=slept.append,
    )
    faults.configure("checkpoint_save:times=2")
    state = _state()
    assert mgr.save(1, state, ["weight"]) is True
    mgr.wait()
    assert mgr.save_retries == 2
    assert slept == [0.5, 1.0]  # pinned schedule, no wall clock
    assert mgr.latest_step() == 1
    want = state.params.weight.detach().clone()
    with torch.no_grad():
        state.params.weight.zero_()
    mgr.restore(state)
    assert torch.equal(state.params.weight, want)


def test_checkpoint_save_budget_exhaustion_raises(tmp_path):
    slept = []
    mgr = CheckpointManager(
        str(tmp_path / "ck2"),
        save_retry=BackoffPolicy(retries=2, base_s=0.1, jitter=0.0),
        sleep=slept.append,
    )
    faults.configure("checkpoint_save:times=10")
    with pytest.raises(faults.FaultInjected):
        mgr.save(1, _state(), ["weight"])
    from oryx_tpu.utils.retry import backoff_delays

    assert slept == [0.1, 0.2] == backoff_delays(
        JPolicy(retries=2, base_s=0.1, jitter=0.0))
    assert mgr.latest_step() is None


def test_projector_save_is_atomic(tmp_path, tree):
    _, ct = cfgs()
    model = from_jax_params(tree, ct)
    path = tmp_path / "proj.npz"
    save_projector_only(str(path), model)
    assert path.exists()
    leftovers = [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert not leftovers, leftovers
    assert len(np.load(path).files) > 0


# ---------------------------------------------------------------------------
# Data-loader containment
# ---------------------------------------------------------------------------


def test_data_fault_skips_and_preserves_trajectory(tmp_path, tree, data):
    """A transient loader failure retries the same fetch (nothing was
    consumed): the run's losses are the fault-free run's, bit for bit."""
    t = _trainer(tree, tmp_path, "clean", every=100)
    t.fit(iter(data[:2]), num_steps=2, resume=False, prefetch=0)
    t.close()
    clean = _losses(tmp_path / "clean.jsonl")
    faults.configure("data_loader_next:after=1")
    t2 = _trainer(tree, tmp_path, "faulted", every=100)
    t2.fit(iter(data[:2]), num_steps=2, resume=False, prefetch=2)
    t2.close()
    assert t2.data_faults == 1
    assert faults.injected_count("data_loader_next") == 1
    assert _losses(tmp_path / "faulted.jsonl") == clean


def test_data_fault_budget_exhaustion_aborts(tmp_path, tree, data):
    faults.configure("data_loader_next:every=1")
    t = _trainer(tree, tmp_path, "deadloader", every=100, metrics=False,
                 max_data_faults=3)
    with pytest.raises(RuntimeError, match="consecutive data-loader"):
        t.fit(iter(data[:2]), num_steps=2, resume=False, prefetch=0)
    t.close()
    assert t.data_faults == 3


def test_corrupt_batch_hits_skip_guard(tmp_path, tree, data):
    """corrupt=1 at the loader site NaNs one float leaf; the non-finite
    guard skips the step instead of training on it."""
    faults.configure("data_loader_next:corrupt=1,times=1")
    t = _trainer(tree, tmp_path, "poisoned", every=100,
                 train=dict(skip_nonfinite_steps=True))
    before = {n: p.detach().clone()
              for n, p in t.state.params.named_parameters()}
    t.fit(iter(data[:1]), num_steps=1, resume=False, prefetch=0)
    t.close()
    rec = json.loads((tmp_path / "poisoned.jsonl").read_text()
                     .splitlines()[-1])
    assert rec["skipped"] == 1
    for n, p in t.state.params.named_parameters():
        assert torch.equal(p, before[n]), n


# ---------------------------------------------------------------------------
# The headline: injected mid-run crash -> auto-resume, bit-identical
# ---------------------------------------------------------------------------


def test_injected_crash_auto_resumes_bit_identical(tmp_path, tree, data):
    steps = 4
    ta = _trainer(tree, tmp_path, "uninterrupted")
    ta.fit(iter(data), num_steps=steps, resume=False, prefetch=0)
    ta.close()
    ref = _losses(tmp_path / "uninterrupted.jsonl")
    assert sorted(ref) == [1, 2, 3, 4]
    assert len(set(ref.values())) > 1
    # The process dies at the top of step 3 (checkpoints at 1 and 2).
    faults.configure("trainer_crash:after=2")
    tb = _trainer(tree, tmp_path, "crashed")
    with pytest.raises(faults.FaultInjected):
        tb.fit(iter(data), num_steps=steps, resume=False, prefetch=0)
    tb.ckpt.wait()
    tb.close()
    assert faults.injected_count("trainer_crash") == 1
    faults.reset()
    # A fresh Trainer on the same directory resumes from the last good
    # step and replays the remaining data.
    tc = Trainer(tb.cfg, params=from_jax_params(tree, tb.cfg),
                 device="cpu", metrics_path=str(tmp_path / "resumed.jsonl"))
    start = tc.resume_if_available()
    assert start == 2
    tc.fit(iter(data[start:]), num_steps=steps, resume=True, prefetch=0)
    tc.close()
    got = {**_losses(tmp_path / "crashed.jsonl"),
           **_losses(tmp_path / "resumed.jsonl")}
    assert sorted(got) == [1, 2, 3, 4]
    for s in (1, 2, 3, 4):
        assert got[s] == ref[s], (s, got[s], ref[s])
