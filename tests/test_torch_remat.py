"""The port's six remat policies (`utils/remat.py`: none, block, dots, attn,
attn_qkv, attn_o) on the CPU, tiny fp32 config with LoRA adapters on every
decoder projection, attn_impl "pallas" (the flash op's plain twin):
  * each policy's gradients equal "none"'s exactly (remat changes no
    number);
  * each policy's train_step equals JAX's jitted step at that policy
    (atol 2e-4, rtol 2e-3);
  * the backward recomputes fewer products under each richer policy:
    "dots" fewer than "block", and "attn" > "attn_qkv" > "attn_o", counted
    as the dense ops (aten mm/addmm/bmm/baddbmm) that run during the
    backward (saved ones are not run again).
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu.train import step as jstep  # noqa: E402
from oryx_tpu_torch.models.convert import to_jax_layout  # noqa: E402
from oryx_tpu_torch.train import optimizer as topt  # noqa: E402
from oryx_tpu_torch.train import step as tstep  # noqa: E402
from oryx_tpu_torch.utils import remat  # noqa: E402
from torch_train_common import (  # noqa: E402
    TOL,
    assert_trees,
    cfgs,
    make_batches,
    make_tree,
    port_model,
    tbatch,
)

POLICIES = ("none", "block", "dots", "attn", "attn_qkv", "attn_o")
LORA = jcfg.LoraConfig(enable=True, r=4, alpha=8.0, targets=(
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj"))


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


def policy_cfgs(policy):
    return cfgs(impl="pallas", tune="lora", lora=LORA, lr=1e-4,
                remat=policy != "none",
                remat_policy="block" if policy == "none" else policy)


@pytest.fixture(scope="module")
def tree():
    """make_tree() with JAX's adapters, lora_b nonzero."""
    cj, _ = policy_cfgs("none")
    t = joryx.enable_lora(jax.tree_util.tree_map(jnp.asarray, make_tree()),
                          cj, jax.random.key(1))
    rng = np.random.default_rng(1)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        if str(getattr(path[-1], "key", "")) == "lora_b":
            return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, t)


@pytest.fixture(scope="module")
def batch():
    return make_batches()[1]


class DenseOps(TorchDispatchMode):
    """Counts the dense products (and flash forwards) that run under it."""

    DENSE = ("mm", "addmm", "bmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.count = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.DENSE:
            self.count["dense"] += 1
        elif name == "flash_fwd_lse":
            self.count["flash"] += 1
        return func(*args, **(kwargs or {}))


def backward_ops(tree, batch, policy):
    """(gradients in named_parameters order, loss, ops run in the
    backward)."""
    _, ct = policy_cfgs(policy)
    model = port_model(tree, ct)
    leaves = [p for _, p in model.named_parameters()]
    mb = {k: v[0] for k, v in tbatch(batch).items()}
    with tstep.compute_params(model, torch.float32):
        loss, _ = tstep.microbatch_loss(model, ct, mb)
        mode = DenseOps()
        with mode:
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return grads, loss.detach(), mode.count


@pytest.fixture(scope="module")
def runs(tree, batch):
    return {p: backward_ops(tree, batch, p) for p in POLICIES}


@pytest.mark.parametrize("policy", POLICIES[1:])
def test_policy_gradients_equal_none(runs, policy):
    grads, loss, _ = runs[policy]
    want_grads, want_loss, _ = runs["none"]
    assert torch.equal(loss, want_loss)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_richer_policies_recompute_fewer_products(runs):
    dense = {p: runs[p][2]["dense"] for p in POLICIES}
    flash = {p: runs[p][2]["flash"] for p in POLICIES}
    assert dense["dots"] < dense["block"]
    assert dense["attn_o"] < dense["attn_qkv"] < dense["attn"]
    # 2 decoder layers: "attn_qkv" spares the 3 projections' base
    # products a layer, "attn_o" also o's; the adapters' thin products
    # still run, as they do under XLA.
    assert dense["attn"] - dense["attn_qkv"] == 2 * 3
    assert dense["attn_qkv"] - dense["attn_o"] == 2
    # Only "block" and "dots" run the flash forward again (2 ViT layers,
    # 2 decoder layers; the compressor is not checkpointed).
    assert flash["none"] == 0
    assert flash["block"] == flash["dots"] == 4
    assert flash["attn"] == flash["attn_qkv"] == flash["attn_o"] == 0
    # "dots" recomputes no product of the checkpointed blocks: it runs the
    # backward's own products, as "none" does.
    assert dense["dots"] == dense["none"]


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_train_step_matches_jax(tree, batch, policy):
    """Two steps (the first has lr 0): loss and grad_norm each step, then
    the params, against JAX's jitted step at the same policy."""
    cj, ct = policy_cfgs(policy)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.make_optimizer(cj.train, jp)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=tx.init(jp))
    model = port_model(tree, ct)
    ttx = topt.make_optimizer(ct.train, model)
    tstate = tstep.init_state(model, ttx)
    for it in range(2):
        jstate, jm = jstep.train_step(jstate, jb, cfg=cj, tx=tx)
        tstate, tm = tstep.train_step(tstate, tbatch(batch), ct, ttx)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL, err_msg=f"loss {it}")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), **TOL)
    assert_trees(to_jax_layout(model), jstate.params, "params")


def test_check_policy():
    assert remat.check_policy(False) == remat.check_policy(None) == "none"
    assert remat.check_policy(True) == "block"
    for p in POLICIES:
        assert remat.check_policy(p) == p
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.check_policy("everything")
