"""The port's runtime sanitizers (mirrors tests/test_sanitizers.py): the
capture watchdog, the torch counterpart of the JAX package's
recompile_watchdog, catches an induced capture storm through the port's
capture hook (`ops/cuda/graphs.note_capture`, which every finished
`CountedGraph` capture calls; the CPU captures no graph, so the hook is
fed as a capture feeds it) and exports oryx_recompiles_total in the JAX
watchdog's exposition; the in-place guard proves that the port's
optimizer step and pool writers update their tensors in place and trips
on swapped storage."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oryx_tpu_torch.analysis.sanitizers import (  # noqa: E402
    RecompileStormError,
    UseAfterDonateError,
    donation_guard,
    recompile_watchdog,
)
from oryx_tpu_torch.ops import paged_kv  # noqa: E402
from oryx_tpu_torch.ops.cuda import graphs  # noqa: E402
from oryx_tpu_torch.utils.metrics import Registry  # noqa: E402


def _captures(label, n):
    for _ in range(n):
        graphs.note_capture(label)


def test_watchdog_catches_induced_capture_storm():
    """The acceptance scenario: an engine whose graph key churns captures
    one key per dispatch; the watchdog raises and the recapture counter
    lands in the registry as oryx_recompiles_total{fn=...}, rendered as
    the JAX watchdog renders it."""
    reg = Registry(prefix="oryx_serving")
    label = graphs.key_label("engine_step", ("churn",), "engine7")
    with pytest.raises(RecompileStormError, match="recompile storm"):
        with recompile_watchdog(budget=2, registry=reg) as stats:
            _captures(label, 5)
    assert stats.counts[label] == 5
    assert stats.over_budget()[label] == 5
    fam = reg.existing("oryx_recompiles_total", raw_name=True)
    assert fam is not None
    assert fam.labels(fn=label).value == 4.0
    rendered = reg.render()
    assert f'oryx_recompiles_total{{fn="{label}"}} 4' in rendered
    assert "# TYPE oryx_recompiles_total counter" in rendered


def test_watchdog_quiet_within_budget():
    steady = graphs.key_label("decode", ("steady",))
    with recompile_watchdog(budget=1) as stats:
        _captures(steady, 1)  # one capture, then replays
    assert stats.counts.get(steady, 0) == 1
    assert not stats.over_budget()
    # One label per key and owner: two engines' graphs of one key are two
    # labels, each within a budget of one.
    key = ("same", "key")
    with recompile_watchdog(budget=1) as stats:
        for owner in ("engine0", "engine1"):
            _captures(graphs.key_label("engine_step", key, owner), 1)
    assert sorted(stats.counts.values()) == [1, 1]
    assert graphs.key_label("engine_step", key, "engine0") == \
        graphs.key_label("engine_step", key, "engine0")


def test_watchdog_record_mode_does_not_raise():
    label = graphs.key_label("engine_step", ("quiet",), "engine3")
    with recompile_watchdog(budget=1, action="record") as stats:
        _captures(label, 3)
    assert stats.counts[label] == 3
    assert stats.over_budget()[label] == 3


def test_watchdog_restores_the_capture_hooks():
    before = list(graphs._CAPTURE_HOOKS)
    with recompile_watchdog(budget=100):
        assert len(graphs._CAPTURE_HOOKS) == len(before) + 1
    assert graphs._CAPTURE_HOOKS == before
    with pytest.raises(RecompileStormError):
        with recompile_watchdog(budget=0):
            _captures("x", 1)
    assert graphs._CAPTURE_HOOKS == before
    _captures("outside", 2)  # no watchdog: nothing counts, nothing raises


def test_watchdog_rejects_bad_action():
    with pytest.raises(ValueError, match="action"):
        with recompile_watchdog(action="explode"):
            pass


def _pool():
    return paged_kv.init_paged_pool(
        num_layers=2, num_pages=4, page_size=4, num_kv_heads=1, head_dim=8,
        dtype=torch.float32, device="cpu")


def test_donation_guard_proves_in_place_and_trips_on_swap():
    """The pool writers update the pool in place: the guard proves it, and
    trips once a tracked tensor's storage is swapped for a copy."""
    pool = _pool()
    layer = pool[0]
    new = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 1, 8)
    bt = torch.tensor([[0, 1], [2, 3]])
    with donation_guard(layer, expect_consumed=True, label="kv") as guard:
        paged_kv.write_pages(layer, new, bt, torch.tensor([0, 1]))
    assert guard.consumed
    guard.check()
    guard.check({"fresh": torch.zeros(3)})  # untracked tensors are fine
    layer.data = layer.clone()  # the update became a copy
    with pytest.raises(UseAfterDonateError, match="use-after-donate"):
        guard.check()
    with pytest.raises(AssertionError, match="NOT"):
        guard.assert_consumed()


def test_donation_guard_flags_unconsumed():
    keep = {"k": torch.ones(4)}
    with pytest.raises(AssertionError, match="never written"):
        with donation_guard(keep, expect_consumed=True):
            _ = {"k": keep["k"] + 1}  # a fresh tensor, no update in place


def test_donation_guard_empty_tracking_is_not_vacuous():
    """A tree of host arrays tracks no tensor: assert_consumed must fail,
    not pass while verifying nothing."""
    with pytest.raises(AssertionError, match="no tensors were tracked"):
        with donation_guard({"k": np.ones((4,))}, expect_consumed=True):
            pass


def test_donation_guard_over_the_optimizer_step():
    """train_step applies the AdamW update to every trainable parameter in
    place (p.copy_), so a holder of a parameter sees the new bytes."""
    from oryx_tpu_torch.train import optimizer as topt
    from oryx_tpu_torch.train import step as tstep

    from torch_train_common import cfgs, make_batches, make_tree, \
        port_model, tbatch

    _, ct = cfgs(tune="projector_only")
    model = port_model(make_tree(), ct)
    ttx = topt.make_optimizer(ct.train, model)
    state = tstep.init_state(model, ttx)
    trainable = [p for n, p in model.named_parameters()
                 if n in set(ttx.trainable())]
    frozen = [p for n, p in model.named_parameters()
              if n not in set(ttx.trainable())]
    batch = tbatch(make_batches()[1])
    with donation_guard(trainable, expect_consumed=True,
                        label="params") as guard:
        state, _ = tstep.train_step(state, batch, ct, ttx)
    guard.check(dict(model.named_parameters()))
    with pytest.raises(AssertionError, match=re.escape(
            f"{len(frozen)} were never written")):
        with donation_guard(frozen, expect_consumed=True):
            tstep.train_step(state, batch, ct, ttx)


def test_a_capture_tallies_only_its_own_thread():
    """Two engines on one card: while one thread captures, its wrapper
    calls are the graph's (its tally), and the other thread's real
    launches still reach the counters."""
    import collections
    import threading

    from oryx_tpu_torch.ops.cuda import launches

    counter = collections.Counter()
    started, go = threading.Event(), threading.Event()
    result = {}

    def capturing():
        launches.begin_tally()
        started.set()
        go.wait(10)
        for _ in range(3):
            launches.count(counter, "decode")
        result["tally"] = launches.end_tally([counter])

    t = threading.Thread(target=capturing)
    t.start()
    assert started.wait(10)
    for _ in range(2):
        launches.count(counter, "decode")  # the other engine, launching
    go.set()
    t.join(10)
    assert counter == {"decode": 2}
    assert result["tally"] == (collections.Counter({"decode": 3}),)
    launches.count(counter, "decode")  # after the tally: counted again
    assert counter == {"decode": 3}
