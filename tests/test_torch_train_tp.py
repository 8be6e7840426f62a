"""Tensor-parallel training in the port (parallel/zero.TpGroup, the
two-dimensional placements of parallel/sharding.py): each rank holds its
heads and MLP columns, the row-parallel sums meet its tp group with an
identity backward and the column-parallel inputs sum their gradient over
it; under fsdp x tp each (fsdp, sp) chunk is gathered inside the rank's tp
group. Against JAX's Trainer on its 8-device CPU mesh, from the same
weights and batches:

  * tp=2 on two ranks and fsdp=2 x tp=2 on four, in modes fsdp, zero2 and
    ddp, accum 1 and 2, tune full, projector_only and lora (adapters on
    all seven decoder projections, held whole on every rank), 3 steps;
  * each rank's held parameter shapes against JAX's `param_specs`, leaf by
    leaf, and its ViT rows (the packed visual buffer over the data width);
  * the two autograd Functions' gradients against one process, and a
    LoRA layer's on two ranks (column- and row-parallel, float and int8
    base) against one process.

JAX's witness runs on its data mesh (dp=2 x fsdp=4), not on a tp mesh:
under a tp axis JAX's step computes a wrong gradient for the embedding
table and for it alone (on the first batch its norm is 25.4 against 2.13
on the data mesh and on one device; every other leaf agrees to 1e-7),
and its grad_norm, clipping and updates follow it.
`test_jax_tp_mesh_departs_only_on_the_embedding_gradient` pins that. The
function the port computes on its tp ranks is JAX's on one device.

Compared: every step's loss and grad_norm, and every leaf after the last
step. Tolerance: atol 2e-4, rtol 2e-3. Under LoRA also each adapter's
change over the fit, at rel L2 2e-3 of JAX's. The helpers are
tests/test_torch_train_parallel.py's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.parallel import sharding as jsharding  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params, to_jax_layout)
from oryx_tpu_torch.parallel import sharding  # noqa: E402
from oryx_tpu_torch.parallel import zero  # noqa: E402
from oryx_tpu_torch.parallel.zero import TpGroup  # noqa: E402
from oryx_tpu_torch.utils import quant  # noqa: E402

from test_torch_lora import LORA, with_adapters  # noqa: E402
from test_torch_sharding import _jax_specs, _on_two_ranks  # noqa: E402
from test_torch_train_parallel import (  # noqa: E402, F401
    STEPS, _compare, _configs, _data, _jax_fit, batches, numpy_packing,
    tree)
from torch_tp_common import RankZero  # noqa: E402
from torch_train_common import flat, port_model  # noqa: E402

JAX_DATA_MESH = jcfg.MeshConfig(dp=2, fsdp=4)
SHAPES = {"tp2": (1, 1, 2, 1), "fsdp2_tp2": (1, 2, 2, 1)}
CASES = [
    ("tp2", "fsdp", 2, "full"),
    ("tp2", "zero2", 1, "full"),
    ("tp2", "ddp", 1, "full"),
    ("tp2", "fsdp", 1, "projector_only"),
    ("tp2", "fsdp", 2, "lora"),
    ("tp2", "zero2", 1, "lora"),
    ("fsdp2_tp2", "fsdp", 1, "full"),
    ("fsdp2_tp2", "zero2", 2, "full"),
    ("fsdp2_tp2", "ddp", 1, "projector_only"),
    ("fsdp2_tp2", "fsdp", 1, "lora"),
    ("fsdp2_tp2", "ddp", 1, "lora"),
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
    columns: parallel/sharding.py's two stated departures). LoRA leaves,
    which no JAX rule names, come out whole."""
    sizes = dict(zip(("dp", "fsdp", "tp", "sp"), shape))
    want = _jax_specs(tree, mode)
    rules = jsharding.mesh_rules(mode)
    declared = dict(jsharding.LOGICAL_RULES)
    model = from_jax_params(tree, ct)
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
    ct = tcfg.OryxConfig.from_dict({**ct.to_dict(), "train": cj.to_dict()[
        "train"] | {"checkpoint_dir": ct.train.checkpoint_dir}})
    if tune == "lora":  # both trainers start from the same adapters
        tree = with_adapters(tree, cj)
    data = _data(batches, accum)
    got = _rank_zero(ranks, mesh).run(
        "job_fit", f"{mesh}{mode}{tune}", tree, ct.to_dict(), mode, data,
        STEPS)
    want = _jax_fit(tmp_path, f"tp{mode}{accum}{tune}", cj, tree, mode, data)
    _compare(got, want, tree, ct)
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
    if tune == "lora":
        adapters = [n for n in params if n.split(".")[-1] in
                    quant.LORA_LEAVES]
        assert len(adapters) == 3 * 7 * ct.llm.num_layers
        whole = {n: t.shape for n, t in from_jax_params(tree, ct)
                 .named_parameters()}
        assert all(params[n] == whole[n] for n in adapters)
        _assert_adapter_changes(got, want[1], tree, ct)


def _assert_adapter_changes(got, jparams, tree, ct):
    """Each adapter's change over the fit (after minus before) against
    JAX's, at rel L2 2e-3 of JAX's change. The updates are ~lr = 1e-5 a
    step, under the leaf comparison's atol, which cannot see a wrong
    adapter gradient; this can: one that missed its tp sum moves a
    column layer's B on its rank's columns alone."""
    model = port_model(tree, ct)
    whole = {n: torch.from_numpy(a) for n, a in got["params"].items()}
    after, want, start = (flat(t) for t in (
        to_jax_layout(model, whole), jparams, tree))
    keys = [k for k in want if "'lora_a'" in k or "'lora_b'" in k]
    assert len(keys) == 2 * len(LORA["targets"])
    for k in keys:
        moved = want[k].astype(np.float64) - start[k]
        err = (after[k] - start[k]) - moved
        rel = np.linalg.norm(err) / np.linalg.norm(moved)
        assert rel <= 2e-3, (k, rel)


def _tuned(cfg, tune):
    import dataclasses

    train = dataclasses.replace(cfg.train, tune=tune)
    if tune == "lora":
        train = dataclasses.replace(train, lora=jcfg.LoraConfig(**LORA))
    return dataclasses.replace(cfg, train=train)


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


class _RankWorld:
    """A thread rank's world for a TpGroup: its rank and the two peers'
    sum (test_torch_sharding._Peers)."""

    def __init__(self, peer, rank):
        self.peer, self.rank = peer, rank

    def sum(self, x, group, op="sum"):
        return self.peer.all_reduce(x, op)


LORA_LAYERS = [("column", "float"), ("row", "float"), ("column", "int8"),
               ("row", "int8")]


@pytest.mark.parametrize("kind,base", LORA_LAYERS,
                         ids=["-".join(c) for c in LORA_LAYERS])
def test_lora_layer_on_two_ranks_matches_one_process(kind, base):
    """A LoRA layer on two thread ranks, each holding half its base
    weight's output columns (column) or input rows (row) and the adapters
    whole: the output and the input's gradient equal one process's; after
    the trainer's rule (`zero._tp_partial` leaves summed over the group,
    the rest kept) each adapter's gradient does too. The rule's two traps:
    a row layer's B gradient is already whole on each rank (a sum would
    double it), and a column layer's A gradient is a partial sum."""
    rng = np.random.default_rng(4)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    x, w, bias = t(3, 8), t(8, 8), t(8)
    a, b, s = t(8, 4) * 0.5, t(4, 8) * 0.5, torch.full((1, 1), 2.0)
    g = t(3, 8)
    names = ["p.lora_a", "p.lora_b", "p.lora_scale"]
    dim = 0 if kind == "column" else 1

    q, qs = quant.quantize_array(w, dim=-1)
    qs = qs[:, 0]

    def layer(rows, cols, bt):
        """The layer over the base weight's [rows, cols] (the int8 codes'
        and their output channels' scales, or the float weight's)."""
        if base == "int8":
            mod = quant.Q8Linear(q[rows, cols], qs[rows], bt)
        else:
            mod = torch.nn.Linear(8, 8)
            mod.weight = torch.nn.Parameter(w[rows, cols],
                                            requires_grad=False)
            mod.bias = torch.nn.Parameter(bt, requires_grad=False)
        for leaf, v in zip(quant.LORA_LEAVES, (a, b, s)):
            mod.register_parameter(leaf, torch.nn.Parameter(v.clone()))
        return mod

    def run(mod, xin, gy, group=None):
        xin = xin.clone().requires_grad_()
        if kind == "column":
            h = xin if group is None else group.enter(xin)
            # Two members take the grouped int8 product; the first counts.
            y = quant.linear_group(h, (mod, mod), None, group)[0]
        else:
            y = quant.row_linear(xin, mod, group)
        leaves = [xin] + [mod._parameters[n] for n in quant.LORA_LEAVES]
        return [y.detach()] + list(torch.autograd.grad((y * gy).sum(),
                                                       leaves))

    every = slice(None)
    want = run(layer(every, every, bias), x, g)

    def rank(peer, r):
        cut = slice(4 * r, 4 * r + 4)
        if kind == "column":  # the rank's output columns
            mod, xr, gr = layer(cut, every, bias[cut]), x, g[:, cut]
        else:
            mod, xr, gr = layer(every, cut, bias), x[:, cut], g
        group = TpGroup(_RankWorld(peer, r), [0, 1])
        y, dx, *grads = run(mod, xr, gr, group)
        places = {"p.weight": sharding.Placement(None, 1, 0, (dim, 2, r))}
        partial = zero._tp_partial(["p.weight"] + names, places)
        grads = [group.world.sum(x_, group.group) if n in partial else x_
                 for n, x_ in zip(names, grads)]
        return y, dx, grads, partial

    got = _on_two_ranks(rank)
    tol = dict(atol=1e-4, rtol=1e-4)
    for r, (y, dx, grads, partial) in enumerate(got):
        cut = slice(4 * r, 4 * r + 4)
        if kind == "column":
            torch.testing.assert_close(y, want[0][:, cut], **tol)
            torch.testing.assert_close(dx, want[1], **tol)
        else:
            torch.testing.assert_close(y, want[0], **tol)
            torch.testing.assert_close(dx, want[1][:, cut], **tol)
        for n, gr, wg in zip(names, grads, want[2:]):
            torch.testing.assert_close(gr, wg, **tol, msg=n)
        assert partial == ({"p.lora_a", "p.lora_b", "p.lora_scale"}
                           if kind == "column" else {"p.lora_a"})


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
