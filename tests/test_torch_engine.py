"""The port's Engine registry and the scheduler's engine contract against
the JAX package's (mirrors tests/test_engine.py and the scheduler half of
tests/test_containment.py): the protocol and the registry; per request,
the cost ledger's token and step fields, the span names in order and the
engine's counters equal the JAX engine's on the same requests (split,
ragged, speculative and fused engines); deadlines, the bounded queue,
drain, and the supervised restart that replays in-flight requests to the
same replies."""

import time

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu.serve import engine as jengine  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu_torch.serve import api_server  # noqa: E402
from oryx_tpu_torch.serve.engine import (  # noqa: E402
    Engine,
    create_engine,
    engine_names,
    register_engine,
)
from oryx_tpu_torch.serve.scheduler import (  # noqa: E402
    AdmissionRejected,
    ContinuousScheduler,
)
from oryx_tpu_torch.utils.metrics import REQUEST_COST_KEYS  # noqa: E402

from torch_serve_common import make_pipes  # noqa: E402

GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
LEDGER = ("prefill_tokens", "cached_tokens", "decode_steps",
          "decode_tokens", "peak_pages")
COUNTERS = ("admitted", "completed", "evicted", "cancelled", "chunks",
            "prefill_tokens_total", "prefix_cache_hit_tokens_total",
            "prefix_cache_miss_tokens_total", "harvest_total",
            "decode_steps_total", "decode_steps_useful",
            "decode_steps_wasted", "draft_accepted_total")


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _wait(pred, timeout=60.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(0.01)
    return False


def _crash_after(sched, turns: int) -> None:
    """Kill the engine thread at its (turns + 1)-th busy loop turn: a raise
    from the watchdog's set_active(True), which the loop calls outside its
    containment (the scheduler needs a stall_timeout)."""
    orig = sched.watchdog.set_active
    seen = [0]

    def set_active(active):
        if active:
            seen[0] += 1
            if seen[0] == turns + 1:
                raise RuntimeError("injected engine crash")
        orig(active)

    sched.watchdog.set_active = set_active


def test_registry_names_and_protocol_members_equal_jax():
    assert engine_names() == jengine.engine_names() == [
        "continuous", "sharded"]
    members = lambda proto: sorted(  # noqa: E731
        n for n in dir(proto) if not n.startswith("_"))
    assert members(Engine) == members(jengine.Engine)


def test_continuous_scheduler_satisfies_engine_protocol(pipes):
    _, tp = pipes
    sched = create_engine("continuous", tp, autostart=False, **GEOM)
    assert isinstance(sched, ContinuousScheduler)
    assert isinstance(sched, Engine)
    ready, reason = sched.readiness()
    assert ready is False and "dead" in reason
    sched.start()
    try:
        assert sched.alive() and sched.readiness() == (True, "ok")
        assert sched.queue_len() == 0
        h = sched.submit({"question": "hello there"}, 3)
        reply, why, _ = h.result(timeout=600)
        assert reply and why in ("stop", "length")
        sched.cancel(h)
        assert h.cancelled
    finally:
        sched.stop()
    assert not sched.alive() and sched.stopping


def test_unknown_duplicate_and_sharded_engines(pipes):
    _, tp = pipes
    with pytest.raises(ValueError, match="unknown engine"):
        create_engine("warp-drive", tp)
    with pytest.raises(ValueError, match="already registered"):
        register_engine("continuous")(lambda pipe, **kw: None)
    # JAX's refusal: no mesh on the pipe (the tp cases run in
    # tests/test_torch_tp_serving.py).
    with pytest.raises(ValueError, match="mesh absent"):
        create_engine("sharded", tp, **GEOM)


def _mix():
    return [({"question": "hello there"}, 9, None),
            ({"question": "tell me more"}, 14, None),
            ({"question": "hello there, again"}, 6, {"stop": ["\x01"]}),
            ({"question": "what now?"}, 11, None)]


CASES = {
    "split": dict(GEOM),
    "ragged": dict(GEOM, ragged=True, prefill_chunk=16),
    "spec": dict(GEOM, ragged=True, prefill_chunk=16, speculate=2),
    "fused": dict(GEOM, ragged=True, prefill_chunk=16, fuse_steps=4),
}


def _run(cls, pipe, kw):
    sched = cls(pipe, autostart=False, **kw)
    hs = [sched.submit(r, n, s) for r, n, s in _mix()]
    sched.start()
    out = [h.result(timeout=600) for h in hs]
    sched.close()
    return sched, hs, out


@pytest.mark.parametrize("case", list(CASES))
def test_ledger_spans_and_counters_equal_jax(pipes, case):
    jp, tp = pipes
    with jax.default_matmul_precision("highest"):
        jsched, jhs, want = _run(JaxScheduler, jp, CASES[case])
    sched, hs, got = _run(ContinuousScheduler, tp, CASES[case])
    assert got == want
    for h, jh in zip(hs, jhs):
        cost = h.debug["cost"]
        assert list(cost) == list(REQUEST_COST_KEYS)
        assert {k: cost[k] for k in LEDGER} == \
            {k: jh.debug["cost"][k] for k in LEDGER}
        spans = [(s.name, s.parent) for s in h.trace.spans]
        assert spans == [(s.name, s.parent) for s in jh.trace.spans]
        assert {"queue_wait", "admission", "prompt_prep", "prefill",
                "decode_chunk", "emission"} <= {n for n, _ in spans}
        assert h.trace.done and h.trace.meta["cost"] == cost
    if case == "spec":
        assert any(h.debug["cost"]["decode_steps"]
                   > h.debug["cost"]["decode_tokens"] for h in hs)
    for name in COUNTERS:
        assert sched.metrics.get(name) == jsched.metrics.get(name), name
    # The dispatch kinds, as exposition lines.
    kind_lines = lambda text: sorted(  # noqa: E731
        ln for ln in text.splitlines()
        if ln.startswith("oryx_serving_dispatches_total{"))
    assert kind_lines(sched.metrics.render()) == \
        kind_lines(jsched.metrics.render())
    assert sched.metrics.get("admitted") == sched.metrics.get("completed")
    kinds = sched.metrics.by_label("dispatches_total")
    assert sum(kinds.values()) >= sched.metrics.get("harvest_total")


def test_deadline_mid_decode_frees_pages(pipes):
    _, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False, **GEOM)
    step = sched._step_chunk

    def slow_step():  # a hung dispatch
        time.sleep(0.6)
        step()

    sched._step_chunk = slow_step
    h = sched.submit({"question": "hello there"}, 300, timeout_s=0.3)
    sched.start()
    with pytest.raises(RuntimeError, match="deadline exceeded"):
        h.result(timeout=600)
    assert h.error_kind == "timeout"
    assert sched.metrics.get("deadline_exceeded_total") == 1
    assert _wait(lambda: all(r is None for r in sched.slots))
    sched.check_pool_invariant()
    sched.close()
    assert list(h.debug["cost"]) == list(REQUEST_COST_KEYS)


def test_deadline_expires_in_queue(pipes):
    jp, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False,
                                **dict(GEOM, num_slots=1))
    h_long = sched.submit({"question": "hello there"}, 64)
    h_queued = sched.submit({"question": "what now?"}, 4, timeout_s=0.005)
    sched.start()
    with pytest.raises(RuntimeError, match="deadline exceeded before"):
        h_queued.result(timeout=600)
    assert h_queued.error_kind == "timeout"
    reply, _, _ = h_long.result(timeout=600)
    with jax.default_matmul_precision("highest"):
        assert reply == jp.chat("hello there", max_new_tokens=64)
    sched.check_pool_invariant()
    sched.close()


def test_bounded_queue_rejects_as_jax(pipes):
    jp, tp = pipes
    out = []
    for cls, p in ((JaxScheduler, jp), (ContinuousScheduler, tp)):
        sched = cls(p, autostart=False, max_queue=2,
                    **dict(GEOM, num_slots=1))
        hs = [sched.submit({"question": f"q {i}"}, 3) for i in range(2)]
        with pytest.raises(Exception) as e:
            sched.submit({"question": "one too many"}, 3)
        assert type(e.value).__name__ == "AdmissionRejected"
        with jax.default_matmul_precision("highest"):
            sched.start()
            replies = [h.result(timeout=600)[0] for h in hs]
        sched.close()
        text = sched.metrics.render()
        out.append((e.value.reason, e.value.retry_after_s, replies,
                    'oryx_serving_admission_rejected_total'
                    '{reason="backpressure"} 1' in text))
    assert out[1] == out[0]
    assert out[1][0] == "backpressure" and out[1][3]


def test_drain_finishes_residents_rejects_new(pipes):
    jp, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False,
                                **dict(GEOM, num_slots=1))
    h_res = sched.submit({"question": "hello there"}, 24)
    h_queued = sched.submit({"question": "never admitted"}, 4)
    sched.start()
    assert _wait(lambda: sched.slots[0] is not None, timeout=120)
    sched.begin_drain()
    assert sched.readiness() == (False, "draining")
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit({"question": "too late"}, 2)
    assert ei.value.reason == "draining"
    with pytest.raises(RuntimeError, match="draining"):
        h_queued.result(timeout=600)
    assert h_queued.error_kind == "unavailable"
    reply, _, _ = h_res.result(timeout=600)
    with jax.default_matmul_precision("highest"):
        assert reply == jp.chat("hello there", max_new_tokens=24)
    assert sched.drain(timeout=120) is True
    assert not sched.alive()
    sched.check_pool_invariant()


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_supervisor_restart_replays_to_the_same_reply(pipes, ragged):
    """The engine thread dies mid-decode; the EngineSupervisor restarts it,
    the residents replay, and the replies equal the unbroken engine's (and
    the JAX pipeline's). No client sees an error."""
    jp, tp = pipes
    kw = dict(GEOM, ragged=ragged, prefill_chunk=16 if ragged else None,
              stall_timeout=600)
    reqs = [("hello there", 12), ("tell me more", 9)]
    base = ContinuousScheduler(tp, autostart=False, **kw)
    want = [base.submit({"question": q}, m) for q, m in reqs]
    base.start()
    want = [h.result(timeout=600) for h in want]
    base.close()
    sched = ContinuousScheduler(tp, autostart=False, **kw)
    sup = api_server.EngineSupervisor(sched, poll_s=0.05)
    sup.start()
    handles = [sched.submit({"question": q}, m) for q, m in reqs]
    _crash_after(sched, 2)
    sched.start()
    got = [h.result(timeout=600) for h in handles]
    assert got == want
    assert sched.restarts == 1 and not sup.gave_up
    assert sched.metrics.get("engine_restarts_total") == 1
    assert sum(h.trace.meta.get("cost") is not None for h in handles) == 2
    assert any(
        s.name == "engine_restart_replay" for h in handles
        for s in h.trace.spans
    )
    with jax.default_matmul_precision("highest"):
        for (q, m), (reply, _, _) in zip(reqs, got):
            assert reply == jp.chat(q, max_new_tokens=m)
    assert _wait(lambda: all(r is None for r in sched.slots))
    sched.check_pool_invariant()
    sup.stop()
    sched.close()


def test_dead_engine_without_supervisor_rejects_and_drains(pipes):
    _, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False, stall_timeout=600,
                                **dict(GEOM, num_slots=1))
    h = sched.submit({"question": "hello there"}, 4)
    _crash_after(sched, 0)
    sched.start()
    assert _wait(lambda: not sched.alive(), timeout=120)
    with pytest.raises(AdmissionRejected) as ei:
        sched.submit({"question": "too late"}, 2)
    assert ei.value.reason == "engine_dead"
    assert sched.drain(timeout=30) is True
    with pytest.raises(RuntimeError, match="engine stopped"):
        h.result(timeout=60)
    assert h.error_kind == "unavailable"
    sched.check_pool_invariant()
    sched.close()


def test_supervisor_gives_up_on_crash_loop(pipes):
    _, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False, stall_timeout=600,
                                **GEOM)
    sup = api_server.EngineSupervisor(sched, poll_s=0.02, max_restarts=2,
                                      window_s=60)
    sup.start()
    h = sched.submit({"question": "hello there"}, 8)
    def crash(active):
        raise RuntimeError("crash loop")

    sched.watchdog.set_active = crash
    sched.start()
    assert _wait(lambda: sup.gave_up, timeout=60)
    with pytest.raises(RuntimeError, match="gave up"):
        h.result(timeout=60)
    assert h.error_kind == "unavailable"
    with pytest.raises(AdmissionRejected):
        sched.submit({"question": "x"}, 2)
    sup.stop()
    sched.close()
