"""The port's SFT step (oryx_tpu_torch/train/step.py) against the JAX
package on the CPU, tiny fp32 config, the same weights (JAX init -> numpy
-> `from_jax_params`) and the same collated numpy batches:
  (d) train_step over 3 steps (accum 1 and 2, attn_impl xla and pallas,
      tune full and projector_only): loss, grad_norm, num_tokens, every
      gradient leaf (accum 1), the Adam moments and the params; the
      non-finite step guard;
  (e) remat none / block / attn give equal losses and gradients, and "attn"
      keeps the flash forward instead of recomputing it.
The loss, optimizer, collation, Trainer and resume are in
tests/test_torch_trainer.py.

Tolerance: atol 2e-4, rtol 2e-3 (tests/test_qwen2.py). Adam divides by
sqrt(v_hat), so where a gradient entry is ~0, fp32 noise of 1e-9 moves that
entry's update by up to lr: gradients and moments are compared leaf by leaf,
and params after the steps at lr 1e-5, where that noise is below atol. The
first update is zero (lr(0) = 0), so every parity run takes 3 steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu.train import step as jstep  # noqa: E402
from oryx_tpu_torch.models.convert import to_jax_layout  # noqa: E402
from oryx_tpu_torch.ops.cuda import flash_attention as tfa  # noqa: E402
from oryx_tpu_torch.train import optimizer as topt  # noqa: E402
from oryx_tpu_torch.train import step as tstep  # noqa: E402
from torch_train_common import (  # noqa: E402
    TOL,
    assert_moments,
    assert_trees,
    cfgs,
    make_batches,
    make_tree,
    port_model,
    tbatch,
)


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    # Both packages take their native loader when it builds; both sides
    # use the numpy path here, so the pixels are byte-equal.
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def batches():
    return make_batches()


# ---- (d) train_step ---------------------------------------------------------


@pytest.mark.parametrize(
    "impl,accum,tune,chunk",
    [("xla", 1, "full", 16), ("pallas", 1, "projector_only", 128),
     ("xla", 2, "projector_only", 128), ("pallas", 2, "full", 32)],
)
def test_train_step_matches_jax(tree, batches, impl, accum, tune, chunk):
    cj, ct = cfgs(impl=impl, tune=tune, accum=accum, loss_chunk=chunk)
    batch = batches[accum]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.make_optimizer(cj.train, jp)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)

    model = port_model(tree, ct)
    if accum == 1:
        # Every gradient leaf at the initial params (with accum 2 the
        # moments after 3 steps hold the microbatch-mean gradients).
        jgrads = jax.jit(jax.grad(
            lambda p: jstep.microbatch_loss(
                p, cj, jax.tree_util.tree_map(lambda x: x[0], jb))[0]
        ))(jp)
        tgrads, _, _ = tstep.gradients(model, ct, tbatch(batch))
        names = [n for n, _ in model.named_parameters()]
        assert_trees(to_jax_layout(model, dict(zip(names, tgrads))), jgrads,
                     "grad")

    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=tx.init(jp))
    ttx = topt.make_optimizer(ct.train, model)
    tstate = tstep.init_state(model, ttx)
    for it in range(3):
        jstate, jm = jstep.train_step(jstate, jb, cfg=cj, tx=tx)
        tstate, tm = tstep.train_step(tstate, tbatch(batch), ct, ttx)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL, err_msg=f"loss {it}")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), **TOL)
        assert int(tm["num_tokens"]) == int(jm["num_tokens"])
    assert tstate.step == int(jstate.step) == 3
    assert_moments(model, tstate.opt_state, jstate.opt_state)
    assert_trees(to_jax_layout(model), jstate.params, "params")


def test_skip_nonfinite_keeps_params_and_moments(tree, batches):
    _, ct = cfgs(tune="projector_only", skip_nonfinite_steps=True)
    model = port_model(tree, ct)
    ttx = topt.make_optimizer(ct.train, model)
    state = tstep.init_state(model, ttx)
    state, _ = tstep.train_step(state, tbatch(batches[1]), ct, ttx)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    moments = {n: t.clone() for n, t in state.opt_state["mu"].items()}
    bad = dict(batches[1])
    bad["patches"] = bad["patches"].copy()
    bad["patches"].flat[0] = np.nan
    state, m = tstep.train_step(state, tbatch(bad), ct, ttx)
    assert int(m["skipped"]) == 1 and state.step == 2
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
    for n, t in state.opt_state["mu"].items():
        assert torch.equal(t, moments[n]), n


# ---- (e) remat --------------------------------------------------------------


def test_remat_policies_change_no_number(tree, batches, monkeypatch):
    calls = []
    orig = tfa._mha_forward_reference

    def counting(*a, **k):
        if k.get("with_lse"):
            calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tfa, "_mha_forward_reference", counting)
    out = {}
    for policy in ("none", "block", "attn"):
        _, ct = cfgs(impl="pallas", remat=policy != "none",
                      remat_policy="block" if policy == "none" else policy)
        model = port_model(tree, ct)
        calls.clear()
        grads, loss, _ = tstep.gradients(model, ct, tbatch(batches[1]))
        out[policy] = (loss, grads, len(calls))
    # Per step: 2 ViT layers + 1 compressor + 2 decoder layers call the
    # flash forward; "block" recomputes the 4 checkpointed ones.
    assert [out[p][2] for p in ("none", "block", "attn")] == [5, 9, 5]
    for policy in ("block", "attn"):
        assert torch.equal(out[policy][0], out["none"][0])
        for a, b in zip(out[policy][1], out["none"][1]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
    from oryx_tpu_torch.utils import remat

    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.check_policy("attn_everything")
