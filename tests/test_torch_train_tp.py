"""Tensor-parallel training in the port (parallel/zero.TpGroup, the
two-dimensional placements of parallel/sharding.py): each rank holds its
heads and MLP columns, the row-parallel sums meet its tp group with an
identity backward and the column-parallel inputs sum their gradient over
it; under fsdp x tp each (fsdp, sp) chunk is gathered inside the rank's tp
group. Against JAX's Trainer on its 8-device CPU mesh, from the same
weights and batches:

  * tp=2 on two ranks and fsdp=2 x tp=2 on four, in modes fsdp, zero2 and
    ddp, accum 1 and 2, tune full and projector_only, 3 steps;
  * each rank's held parameter shapes against JAX's `param_specs`, leaf by
    leaf, and its ViT rows (the packed visual buffer over the data width);
  * the two autograd Functions' gradients against one process.

JAX's witness runs on its data mesh (dp=2 x fsdp=4), not on a tp mesh:
under a tp axis JAX's step computes a wrong gradient for the embedding
table and for it alone (on the first batch its norm is 25.4 against 2.13
on the data mesh and on one device; every other leaf agrees to 1e-7),
and its grad_norm, clipping and updates follow it.
`test_jax_tp_mesh_departs_only_on_the_embedding_gradient` pins that. The
function the port computes on its tp ranks is JAX's on one device.

Compared: every step's loss and grad_norm, and every leaf after the last
step. Tolerance: atol 2e-4, rtol 2e-3. The helpers are
tests/test_torch_train_parallel.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.parallel import sharding as jsharding  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import oryx  # noqa: E402
from oryx_tpu_torch.parallel import sharding  # noqa: E402
from oryx_tpu_torch.parallel.zero import TpGroup  # noqa: E402

from test_torch_sharding import _jax_specs, _on_two_ranks  # noqa: E402
from test_torch_train_parallel import (  # noqa: E402, F401
    STEPS, _compare, _configs, _data, _jax_fit, batches, numpy_packing,
    tree)
from torch_tp_common import RankZero  # noqa: E402

JAX_DATA_MESH = jcfg.MeshConfig(dp=2, fsdp=4)
SHAPES = {"tp2": (1, 1, 2, 1), "fsdp2_tp2": (1, 2, 2, 1)}
CASES = [
    ("tp2", "fsdp", 2, "full"),
    ("tp2", "zero2", 1, "full"),
    ("tp2", "ddp", 1, "full"),
    ("tp2", "fsdp", 1, "projector_only"),
    ("fsdp2_tp2", "fsdp", 1, "full"),
    ("fsdp2_tp2", "zero2", 2, "full"),
    ("fsdp2_tp2", "ddp", 1, "projector_only"),
]


@pytest.fixture(scope="module")
def ranks():
    out = {}
    try:
        yield out
    finally:
        for d in out.values():
            d.close()


def _rank_zero(ranks, mesh):
    if mesh not in ranks:
        for d in ranks.values():  # one world at a time
            d.close()
        ranks.clear()
        ranks[mesh] = RankZero(shape=SHAPES[mesh])
    return ranks[mesh]


def _held_shapes(cj, tree, ct, mode, shape):
    """Each parameter's shape on a rank of `shape` by JAX's param_specs
    (layer axis dropped, linear kernels reversed; the ViT o_proj pair by
    the rules JAX declares, and a column-split weight's bias with its
    columns: parallel/sharding.py's two stated departures)."""
    sizes = dict(zip(("dp", "fsdp", "tp", "sp"), shape))
    want = _jax_specs(tree, mode)
    rules = jsharding.mesh_rules(mode)
    declared = dict(jsharding.LOGICAL_RULES)
    model = oryx.empty_model(ct)
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    specs = {}
    for name, p in model.named_parameters():
        path, stacked = sharding.jax_path(name, name in linear)
        jspec = want[path]
        if path.startswith("vit/layers/o_proj/"):
            jspec = tuple(None if a is None else rules.get(a)
                          for a in declared[path])
        jspec = jspec[1:] if stacked else jspec
        if name in linear:
            jspec = tuple(reversed(jspec))
        specs[name] = jspec
    out = {}
    for name, p in model.named_parameters():
        spec = list(specs[name])
        w = specs.get(name[:-len("bias")] + "weight")
        if name.endswith(".bias") and w and w[0] == "tp":
            spec[0] = "tp"
        dims = list(p.shape)
        for d, axes in enumerate(spec):
            axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
            parts = int(np.prod([sizes[a] for a in axes]))
            if parts > 1 and (axes == ("tp",) or dims[d] % parts == 0):
                dims[d] //= parts
        out[name] = tuple(dims)
    return out


@pytest.mark.parametrize("mesh,mode,accum,tune", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_tp_training_matches_jax_and_places_as_jax(ranks, tree, batches,
                                                   tmp_path, mesh, mode,
                                                   accum, tune):
    shape = SHAPES[mesh]
    cj, ct = _configs(tmp_path, f"{mesh}{mode}{tune}", "xla", accum,
                      JAX_DATA_MESH, tcfg.MeshConfig(*shape))
    cj = _tuned(cj, tune)
    ct = tcfg.OryxConfig.from_dict({**ct.to_dict(), "train": {
        **ct.to_dict()["train"], "tune": tune}})
    data = _data(batches, accum)
    got = _rank_zero(ranks, mesh).run(
        "job_fit", f"{mesh}{mode}{tune}", tree, ct.to_dict(), mode, data,
        STEPS)
    _compare(got, _jax_fit(tmp_path, f"tp{mode}{accum}{tune}", cj, tree,
                           mode, data), tree, ct)
    # Placement on the shapes each rank holds: the parameters by `mode`'s
    # rules, the moments by fsdp's under fsdp and zero2.
    params = _held_shapes(cj, tree, ct, mode, shape)
    moments = _held_shapes(cj, tree, ct, "ddp" if mode == "ddp" else
                           "fsdp", shape)
    W = shape[0] * shape[1] * shape[3]
    P = batches[accum]["patches"].shape[1]
    for rep in got["reports"]:
        assert rep["param_shapes"] == params
        assert rep["mu_shapes"] == {n: moments[n] for n in rep["mu_shapes"]}
        assert rep["vit_rows"] == P // W


def _tuned(cfg, tune):
    import dataclasses

    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, tune=tune))


def test_lora_on_tp_is_refused(tree, batches, tmp_path):
    """LoRA adapters on tensor-parallel layers are not ported yet: the
    Trainer names the queue that holds them."""
    _, ct = _configs(tmp_path, "lora", "xla", 1, JAX_DATA_MESH,
                     tcfg.MeshConfig(tp=2))
    ct = tcfg.OryxConfig.from_dict({**ct.to_dict(), "train": {
        **ct.to_dict()["train"], "tune": "lora"}})
    d = RankZero(shape=SHAPES["tp2"])
    try:
        with pytest.raises(RuntimeError, match="Queue 1"):
            d.run("job_fit", "lora", tree, ct.to_dict(), "fsdp",
                  _data(batches, 1), 1)
    finally:
        d.close()


class _World:
    """Two thread ranks' `sum` over a group (test_torch_sharding._Peers)."""

    def __init__(self, rank):
        self.rank = rank

    def sum(self, x, group, op="sum"):
        return self.rank.all_reduce(x, op)


def test_row_sum_and_column_input_gradients_match_one_process():
    """A column-parallel product then a row-parallel one, each rank
    holding half the hidden columns: the output, the input's gradient
    (summed over the group by `enter`) and each rank's weight gradients
    equal one process's, and the row sum's backward is the identity."""
    rng = np.random.default_rng(3)
    x, g = (torch.from_numpy(rng.normal(size=(3, 6)).astype(np.float32))
            for _ in range(2))
    wc = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    wr = torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32))

    def run(x, wc, wr, group=None):
        h = x if group is None else group.enter(x)
        y = torch.relu(h @ wc.T) @ wr.T
        y = y if group is None else group.all_reduce(y)
        dx, dwc, dwr = torch.autograd.grad((y * g).sum(), (x, wc, wr))
        return y.detach(), dx, dwc, dwr

    leaves = [t.clone().requires_grad_() for t in (x, wc, wr)]
    y1, dx1, dwc1, dwr1 = run(*leaves)

    def rank(peer, r):
        cols = slice(4 * r, 4 * r + 4)
        mine = [x.clone(), wc[cols].clone(), wr[:, cols].clone()]
        return run(*(t.requires_grad_() for t in mine),
                   TpGroup(_World(peer), [0, 1]))

    got = _on_two_ranks(rank)
    for r, (y, dx, dwc, dwr) in enumerate(got):
        cols = slice(4 * r, 4 * r + 4)
        torch.testing.assert_close(y, y1, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dx, dx1, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dwc, dwc1[cols], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(dwr, dwr1[:, cols], atol=1e-5,
                                   rtol=1e-5)


def test_jax_tp_mesh_departs_only_on_the_embedding_gradient(tree, batches):
    """The reference fault behind the witness mesh: JAX's microbatch loss
    differentiated with its parameters and batch placed on fsdp=4 x tp=2
    gives the data mesh's gradient on every leaf but `llm/embed/weight`,
    and there a different one."""
    import jax.numpy as jnp

    from oryx_tpu.train import step as jstep
    from oryx_tpu.train.trainer import Trainer as JTrainer
    from torch_train_common import flat

    grads = {}
    for tp, mesh in ((1, JAX_DATA_MESH), (2, jcfg.MeshConfig(fsdp=4, tp=2))):
        cj, _ = _configs_plain(mesh)
        jt = JTrainer(cj, params=jax.tree_util.tree_map(jnp.asarray, tree),
                      sharding_mode="fsdp")
        try:
            mb = jt._device_batch({k: v[0] for k, v in batches[1].items()})
            with jsharding.mesh_scope(jt.mesh):
                g = jax.jit(jax.grad(lambda p, m, c=cj: jstep.microbatch_loss(
                    p, c, m, "fsdp", False)[0]))(
                        jt.state.params, jax.tree.map(lambda x: x[0], mb))
        finally:
            jt.close()
        grads[tp] = flat(jax.tree_util.tree_map(np.asarray, g))
    for k, want in grads[1].items():
        got = grads[2][k]
        if k == "['llm']['embed']['weight']":
            assert not np.allclose(got, want, atol=2e-4, rtol=2e-3), k
        else:
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5,
                                       err_msg=k)


def _configs_plain(mesh):
    import dataclasses

    from torch_train_common import cfgs

    cj, ct = cfgs(impl="xla")
    return dataclasses.replace(cj, mesh=mesh), ct
