"""The port's debug posture (oryx_tpu_torch/utils/debug.py) against the
JAX package's (mirrors tests/test_debug.py): debug_mode arms and restores
torch's anomaly NaN check and the graph routes, a NaN made in a backward
raises under it, and assert_finite_tree names the same non-finite leaves
as the JAX function, on nested dicts and on the port's model converted
from the same JAX tree."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.utils import debug as jdebug  # noqa: E402
from oryx_tpu_torch.ops.cuda import graphs  # noqa: E402
from oryx_tpu_torch.utils import debug  # noqa: E402


def test_debug_mode_restores_flags():
    before = (torch.is_anomaly_enabled(), graphs.enabled())
    with debug.debug_mode(nan_checks=True):
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        assert graphs.enabled()
    assert (torch.is_anomaly_enabled(), graphs.enabled()) == before
    with debug.debug_mode(nan_checks=False, disable_jit=True):
        assert not torch.is_anomaly_enabled()
        assert not graphs.enabled()
    assert (torch.is_anomaly_enabled(), graphs.enabled()) == before
    debug.enable_nan_checks(True)
    assert torch.is_anomaly_enabled()
    debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_nan_check_faults_in_backward():
    x = torch.tensor(-1.0, requires_grad=True)
    with debug.debug_mode(nan_checks=True):
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    x.grad = None
    torch.sqrt(x).backward()  # disarmed: the NaN gradient goes through
    assert torch.isnan(x.grad)


def test_disable_jit_takes_the_eager_routes():
    """Inside debug_mode(disable_jit=True) the engine's graph route is off
    (the card runs its eager witness path), and back on after; on a
    tensor-parallel pipe it is off."""
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    from types import SimpleNamespace

    sched = ContinuousScheduler.__new__(ContinuousScheduler)
    sched.device = torch.device("cuda")
    sched.pipe = SimpleNamespace(tp=None)  # one device
    assert sched._graph_route()
    with debug.debug_mode(nan_checks=False, disable_jit=True):
        assert not sched._graph_route()
    assert sched._graph_route()
    # A tensor-parallel pipe takes the eager route too (gloo collectives
    # cannot be captured).
    sched.pipe = SimpleNamespace(tp=object())
    assert not sched._graph_route()


def _message(fn, tree, name="tree"):
    try:
        fn(tree, name)
    except FloatingPointError as e:
        return str(e)
    return None


def test_assert_finite_tree_equals_jax():
    ok = {"a": np.ones((2,), np.float32), "b": {"c": np.zeros((3,))}}
    bad = {"a": np.ones((2,), np.float32),
           "b": {"c": np.asarray([1.0, np.nan]), "d": [np.inf, 1.0]},
           "z": (np.zeros(1), np.asarray([-np.inf]))}
    ints = {"ids": np.arange(3)}
    for tree in (ok, bad, ints):
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        ttree = jax.tree_util.tree_map(torch.as_tensor, tree)
        want = _message(jdebug.assert_finite_tree, jtree, "grads")
        assert _message(debug.assert_finite_tree, ttree, "grads") == want
        assert _message(debug.assert_finite_tree, tree, "grads") == want
    assert "['b']['c']" in _message(debug.assert_finite_tree, bad)


def test_assert_finite_tree_on_the_port_model():
    """A NaN planted in one leaf of the JAX tree: the port's model built
    from it names that leaf, and its JAX-layout tree names it as JAX
    does."""
    from oryx_tpu import config as jcfg
    from oryx_tpu.models import oryx as joryx
    from oryx_tpu_torch import config as tcfg
    from oryx_tpu_torch.models.convert import from_jax_params, to_jax_layout

    cfg = jcfg.oryx_tiny()
    tree = jax.tree_util.tree_map(
        lambda x: np.array(x, np.float32),
        joryx.init_params(cfg, jax.random.key(0)))
    tree["compressor"]["q_proj"]["kernel"][0, 0] = np.nan
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    model = from_jax_params(tree, tc)
    with pytest.raises(FloatingPointError) as e:
        debug.assert_finite_tree(model, "params")
    assert len(e.value.args[0].split(", ")) == 1
    assert "q_proj" in str(e.value)
    want = _message(jdebug.assert_finite_tree,
                    jax.tree_util.tree_map(jnp.asarray, tree), "params")
    assert _message(debug.assert_finite_tree, to_jax_layout(model),
                    "params") == want
    debug.assert_finite_tree(to_jax_layout(from_jax_params(
        jax.tree_util.tree_map(np.nan_to_num, tree), tc)))
