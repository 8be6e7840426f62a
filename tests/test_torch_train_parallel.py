"""The port's Trainer over ranks (parallel/zero.py, parallel/sharding.py,
ops/ring_attention.py) against JAX's Trainer on its 8-device CPU mesh, in
the same mode and from the same weights and batches:

  * fsdp (ZeRO-3), zero2 and ddp on two ranks (fsdp=2) against JAX's
    dp=2 x fsdp=4 (tests/test_trainer_modes.py's mesh), including
    grad_accum_steps=2 and a batch whose two rows (one a rank) hold
    different supervised-token counts;
  * the packed visual buffer over the data width (each rank encodes half
    of it) under attn_impl "pallas" and "xla";
  * (sequence parallelism: tests/test_torch_train_ring.py);
  * placement, as JAX's test asserts it, on the shapes each rank holds:
    fsdp shards `embed`, zero2 and ddp keep the parameters whole; the
    moments are sharded under fsdp and zero2, whole under ddp;
  * checkpoint, then a fresh Trainer resumes: the step after equals the
    uninterrupted run's bit for bit.

Compared: every step's loss and grad_norm, and every leaf after the last
step. Tolerance: atol 2e-4, rtol 2e-3. Rank 0 is a process of its own
(tests/torch_tp_common.RankZero); this process holds jax.
"""

import dataclasses
import json

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import to_jax_layout  # noqa: E402

from torch_tp_common import RankZero  # noqa: E402
from torch_train_common import (  # noqa: E402
    TOL, assert_trees, cfgs, make_batches, make_tree, port_model)

STEPS = 3
_JAX: dict = {}


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def batches():
    return make_batches()


@pytest.fixture(scope="module")
def two():
    d = RankZero(shape=(1, 2, 1, 1))
    try:
        yield d
    finally:
        d.close()


@pytest.fixture(autouse=True)
def numpy_packing(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


def _data(batches, accum):
    b = batches[accum]
    one = b if accum > 1 else {k: v[0] for k, v in b.items()}
    return [one] * STEPS


def _configs(tmp_path, name, impl, accum, jmesh, tmesh):
    cj, _ = cfgs(impl=impl, accum=accum, lr=1e-3)
    cj = dataclasses.replace(
        cj, mesh=jmesh,
        train=dataclasses.replace(cj.train, log_every=1, checkpoint_every=100,
                                  checkpoint_dir=str(tmp_path / f"j{name}")))
    ct = tcfg.OryxConfig.from_dict(dataclasses.replace(
        cj, mesh=tmesh, train=dataclasses.replace(
            cj.train, checkpoint_dir=str(tmp_path / f"t{name}"))).to_dict())
    return cj, ct


def _jax_fit(tmp_path, key, cj, tree, mode, data):
    """JAX's Trainer in `mode`: ([(loss, grad_norm)] by step, params),
    once per key."""
    if key not in _JAX:
        path = tmp_path / f"{key}.jsonl"
        jt = JTrainer(cj, params=jax.tree_util.tree_map(jnp.asarray, tree),
                      sharding_mode=mode, metrics_path=str(path))
        jt.fit(iter(data), num_steps=STEPS, resume=False, prefetch=0)
        jt.close()
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        _JAX[key] = ([(r["loss"], r["grad_norm"]) for r in recs],
                     jax.tree_util.tree_map(np.asarray, jt.state.params))
    return _JAX[key]


def _compare(got, want, tree, ct):
    hist, jparams = want
    assert len(got["history"]) == len(hist) == STEPS
    for h, (loss, gnorm) in zip(got["history"], hist):
        np.testing.assert_allclose(h["loss"], loss, **TOL)
        np.testing.assert_allclose(h["grad_norm"], gnorm, **TOL)
    import torch

    model = port_model(tree, ct)
    whole = {n: torch.from_numpy(a) for n, a in got["params"].items()}
    assert_trees(to_jax_layout(model, whole), jparams, "params")


JAX_DATA_MESH = jcfg.MeshConfig(dp=2, fsdp=4)


@pytest.mark.parametrize("mode,accum", [("fsdp", 2), ("zero2", 1),
                                        ("ddp", 1)])
def test_modes_match_jax_and_place_as_jax(two, tree, batches, tmp_path,
                                          mode, accum):
    cj, ct = _configs(tmp_path, mode, "xla", accum, JAX_DATA_MESH,
                      tcfg.MeshConfig(fsdp=2))
    data = _data(batches, accum)
    got = two.run("job_fit", mode, tree, ct.to_dict(), mode, data, STEPS)
    _compare(got, _jax_fit(tmp_path, f"{mode}{accum}", cj, tree, mode, data),
             tree, ct)
    # Placement on the shapes each rank holds (JAX's test_trainer_modes).
    H = ct.llm.hidden_size
    for rep in got["reports"]:
        embed = rep["param_shapes"]["llm.embed.weight"]
        mu = rep["mu_shapes"]["llm.embed.weight"]
        assert embed == ((512, H // 2) if mode == "fsdp" else (512, H))
        assert mu == ((512, H) if mode == "ddp" else (512, H // 2))
        # A leaf with no embed axis stays whole.
        assert rep["param_shapes"]["llm.final_norm.weight"] == (H,)
    a, b = got["reports"]
    if mode == "fsdp":
        assert a["param_bytes"] == b["param_bytes"]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_visual_encode_shards_over_the_data_width(two, tree, batches,
                                                  tmp_path, impl):
    """Each of the two ranks encodes its half of every microbatch's packed
    visual buffer (its patches, its compressor queries; the keys and
    values gathered, the region sums summed): losses, grad norms and
    every leaf, the encoder's included, are JAX's."""
    cj, ct = _configs(tmp_path, f"vis{impl}", impl, 2, JAX_DATA_MESH,
                      tcfg.MeshConfig(fsdp=2))
    data = _data(batches, 2)
    got = two.run("job_fit", f"vis{impl}", tree, ct.to_dict(), "fsdp", data,
                  STEPS)
    _compare(got, _jax_fit(tmp_path, f"vis{impl}", cj, tree, "fsdp", data),
             tree, ct)
    P = batches[2]["patches"].shape[1]
    assert [r["vit_rows"] for r in got["reports"]] == [P // 2, P // 2]


def test_resume_continues_identically(two, tree, batches, tmp_path):
    """Two steps, the final save, then a fresh Trainer on the same
    directory resumes and takes step 3: its loss, grad norm and every leaf
    are the uninterrupted run's bits."""
    _, ct0 = _configs(tmp_path, "straight", "xla", 1, JAX_DATA_MESH,
                      tcfg.MeshConfig(fsdp=2))
    _, ct = _configs(tmp_path, "resume", "xla", 1, JAX_DATA_MESH,
                     tcfg.MeshConfig(fsdp=2))
    data = _data(batches, 1)
    straight = two.run("job_fit", "straight", tree, ct0.to_dict(), "fsdp",
                       data, STEPS)
    first = two.run("job_fit", "first", tree, ct.to_dict(), "fsdp", data,
                    STEPS - 1)
    assert first["step"] == STEPS - 1
    resumed = two.run("job_fit", "resumed", tree, ct.to_dict(), "fsdp",
                      data, STEPS, True)
    assert resumed["start"] == STEPS - 1 and resumed["step"] == STEPS
    assert resumed["history"] == straight["history"][-1:]
    for n, t in straight["params"].items():
        assert np.array_equal(resumed["params"][n], t), n
