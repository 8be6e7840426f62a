"""The pieces around the port's SFT step against the JAX package on the
CPU, tiny fp32 config, the same weights and collated numpy batches:
  (b) dense and chunked loss values and gradients (train/loss.py);
  (c) schedules at counts 0..N and AdamW updates/moments against optax, for
      `full` and `projector_only`, with per-group clipping shown on groups
      whose norms differ;
  (f) collated arrays byte-equal to train/data's;
  (g) Trainer.fit JSONL records against the JAX Trainer;
  (h) a resumed Trainer continues bit for bit.
The step itself is in tests/test_torch_train.py. Tolerance: atol 2e-4,
rtol 2e-3 (tests/test_qwen2.py); the optimizer against optax, on the same
gradients, to 1e-6/1e-4.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.train import data as jdata  # noqa: E402
from oryx_tpu.train import loss as jloss  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params,
    to_jax_layout,
)
from oryx_tpu_torch.train import data as tdata  # noqa: E402
from oryx_tpu_torch.train import loss as tloss  # noqa: E402
from oryx_tpu_torch.train import optimizer as topt  # noqa: E402
from oryx_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_train_common import (  # noqa: E402
    COLLATE,
    TOL,
    assert_moments,
    assert_trees,
    cfgs,
    datasets,
    make_batches,
    make_tree,
    port_model,
)


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    # The port's packing is numpy; the JAX package may take its native
    # loader, so both sides use the numpy path.
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def batches():
    return make_batches()


# ---- (b) loss ---------------------------------------------------------------


@pytest.mark.parametrize("T,chunk", [(24, 32), (64, 16), (40, 16)])
def test_loss_dense_and_chunked(T, chunk):
    """Chunked (T % chunk == 0, T > chunk) and both dense fallbacks."""
    rng = np.random.default_rng(T)
    B, H, V = 2, 16, 50
    h = rng.standard_normal((B, T, H), np.float32)
    w = rng.standard_normal((V, H), np.float32) * 0.3
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.3] = -100

    def jf(h_, w_):
        return jloss.chunked_causal_lm_loss(h_, w_.T, jnp.asarray(labels),
                                            chunk=chunk)

    (jl, jm), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w)
    )
    dl, _ = jloss.causal_lm_loss(jnp.asarray(h) @ jnp.asarray(w).T,
                                 jnp.asarray(labels))
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tl, tm = tloss.chunked_causal_lm_loss(th, tw, torch.from_numpy(labels),
                                          chunk=chunk)
    tg = torch.autograd.grad(tl, (th, tw))
    np.testing.assert_allclose(tl.item(), float(jl), **TOL)
    np.testing.assert_allclose(tl.item(), float(dl), **TOL)
    assert int(tm["num_tokens"]) == int(jm["num_tokens"])
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ---- (c) schedules and optimizer -----------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_match_optax(schedule):
    cj, ct = cfgs(lr=1.0, lr_schedule=schedule)
    cj = dataclasses.replace(cj, train=dataclasses.replace(
        cj.train, warmup_ratio=0.1, num_train_steps=100))
    ct = tcfg.OryxConfig.from_dict(cj.to_dict())
    js = jopt.make_schedule(cj.train, 1.0)
    ts = topt.make_schedule(ct.train, 1.0)
    for c in range(0, 110):
        np.testing.assert_allclose(ts(c), float(js(c)), atol=1e-6)
    # The first update has lr 0: lr 0.0, 0.1, 0.2 at counts 0-2 of a
    # 10-step warmup.
    assert [round(ts(c), 6) for c in range(3)] == [0.0, 0.1, 0.2]


@pytest.mark.parametrize("tune", ["full", "projector_only"])
def test_optimizer_matches_optax(tree, tune):
    """Three updates from the same gradients. The llm group's gradients are
    scaled so its norm is clipped while the projector's is not: a single
    global clip would give other updates."""
    cj, ct = cfgs(tune=tune, lr=1e-2, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.make_optimizer(cj.train, jp)
    jstate = tx.init(jp)
    jupdate = jax.jit(tx.update)
    model = port_model(tree, ct)
    ttx = topt.make_optimizer(ct.train, model)
    tstate = ttx.init(model)
    rng = np.random.default_rng(1)
    names = [n for n, _ in model.named_parameters()]
    for it in range(3):
        grads = {}
        for n, p in model.named_parameters():
            scale = {"llm": 1.0, "projector": 1e-3, "vision": 0.05}[
                topt.group_of(n)
            ]
            grads[n] = torch.from_numpy(
                rng.standard_normal(p.shape).astype(np.float32) * scale
            )
        norms = {g: float(topt.global_norm(
            [grads[n] for n in names if topt.group_of(n) == g]))
            for g in topt.GROUPS}
        assert norms["llm"] > 1.0 > norms["projector"]
        jgrads = jax.tree_util.tree_map(jnp.asarray,
                                        to_jax_layout(model, grads))
        jup, jstate = jupdate(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, jup)
        params = dict(model.named_parameters())
        tup, tstate = ttx.update(grads, tstate, params)
        with torch.no_grad():
            for n, u in tup.items():
                params[n].add_(u)
        full_up = {n: tup.get(n, torch.zeros_like(params[n])) for n in names}
        assert_trees(to_jax_layout(model, full_up), jup, f"update {it}",
                      atol=1e-7, rtol=1e-4)
    assert_trees(to_jax_layout(model), jp, "params", atol=1e-6, rtol=1e-5)
    assert_moments(model, tstate, jstate)


# ---- (f) collation ----------------------------------------------------------


def test_collated_arrays_byte_equal():
    jit_ = jdata.grouped_batch_iterator(datasets(jdata, "qwen"), 2, seed=3,
                                        num_epochs=2, **COLLATE)
    tit = tdata.grouped_batch_iterator(datasets(tdata, "qwen"), 2, seed=3,
                                       num_epochs=2, **COLLATE)
    n = 0
    for jb, tb in zip(jit_, tit, strict=True):
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            assert jb[k].tobytes() == tb[k].tobytes(), k
        n += 1
    assert n == 6
    ex_j, ex_t = datasets(jdata), datasets(tdata)
    jm = jdata.collate_microbatches([ex_j[i] for i in (0, 1, 4, 5)], 2,
                                    **COLLATE)
    tm = tdata.collate_microbatches([ex_t[i] for i in (0, 1, 4, 5)], 2,
                                    **COLLATE)
    for k in jm:
        assert jm[k].dtype == tm[k].dtype and jm[k].tobytes() == tm[k].tobytes()


# ---- (g) Trainer ------------------------------------------------------------


def test_trainer_jsonl_matches_jax(tree, batches, tmp_path):
    from oryx_tpu.train.trainer import Trainer as JTrainer

    cj, _ = cfgs(tune="projector_only")
    cj = dataclasses.replace(
        cj, mesh=jcfg.MeshConfig(dp=jax.device_count()),
        train=dataclasses.replace(cj.train, log_every=1, checkpoint_every=100,
                                  checkpoint_dir=str(tmp_path / "j")),
    )
    ct = tcfg.OryxConfig.from_dict(dataclasses.replace(
        cj, train=dataclasses.replace(
            cj.train, checkpoint_dir=str(tmp_path / "t"))).to_dict())
    data = [{k: v[0] for k, v in batches[1].items()}] * 3
    jt = JTrainer(cj, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  sharding_mode="ddp", metrics_path=str(tmp_path / "j.jsonl"))
    jt.fit(iter(data), num_steps=3, resume=False, prefetch=0)
    jt.close()
    tt = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                 metrics_path=str(tmp_path / "t.jsonl"))
    tt.fit(iter(data), num_steps=3, resume=False, prefetch=2)
    tt.close()
    jr = [json.loads(x)
          for x in (tmp_path / "j.jsonl").read_text().splitlines()]
    tr = [json.loads(x)
          for x in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [1, 2, 3]
    for a, b in zip(tr, jr):
        assert set(a) == set(b)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], **TOL)
    assert tt.ckpt.latest_step() == 3


# ---- (h) checkpoint resume ------------------------------------------------------


def test_resume_continues_bit_for_bit(tree, batches, tmp_path):
    data = [{k: v[0] for k, v in batches[1].items()}] * 3
    _, ct = cfgs(tune="projector_only", lr=1e-3)

    def trainer(name, every):
        cfg = dataclasses.replace(ct, train=dataclasses.replace(
            ct.train, checkpoint_dir=str(tmp_path / name),
            checkpoint_every=every, log_every=1))
        return Trainer(cfg, params=from_jax_params(tree, ct), device="cpu")

    whole = trainer("whole", 100)
    whole.fit(iter(data), num_steps=3, resume=False, prefetch=0)
    first = trainer("resumed", 1)
    first.fit(iter(data[:2]), num_steps=2, resume=False, prefetch=0)
    again = trainer("resumed", 1)
    again.fit(iter(data[2:]), num_steps=3, resume=True, prefetch=0)
    assert again.state.step == 3
    assert again.history[0]["loss"] == whole.history[2]["loss"]
    for (n, a), (_, b) in zip(again.state.params.named_parameters(),
                              whole.state.params.named_parameters()):
        assert torch.equal(a, b), n
    for kind in ("mu", "nu"):
        for n, t in whole.state.opt_state[kind].items():
            assert torch.equal(again.state.opt_state[kind][n], t), n
    assert again.state.opt_state["count"] == whole.state.opt_state["count"]
