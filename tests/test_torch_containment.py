"""Failure containment in the port's serving engine against the JAX
package's: the degraded-mode ladder (SLO firings escalate it, quiet
cooldowns walk it down, mode 3 sheds load with the reference's rejection),
the degraded_escalation forensic, and injected allocator failures that
leave every refcount exact, with the copy-on-write allocation falling back
to a recompute (mirrors tests/test_containment.py's ladder and allocator
cases and tests/test_forensics.py::test_degraded_escalation_captures_
forensic). Each allocator scenario's completed replies equal the port's
unfaulted engine's, which equal the JAX engine's with the prefix cache
off on the same weights (on this workload JAX's own cached engine departs
from its uncached one; ROADMAP Queue 3)."""

import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

from oryx_tpu.serve.scheduler import AdmissionRejected as JRejected  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JSched  # noqa: E402
from oryx_tpu.utils import faults as jfaults  # noqa: E402
from oryx_tpu.utils.anomaly import AnomalyMonitor as JMonitor  # noqa: E402
from oryx_tpu.utils.anomaly import AnomalyThresholds as JThresholds  # noqa: E402
from oryx_tpu_torch.serve.scheduler import (  # noqa: E402
    AdmissionRejected,
    ContinuousScheduler,
)
from oryx_tpu_torch.utils import faults  # noqa: E402
from oryx_tpu_torch.utils.anomaly import (  # noqa: E402
    AnomalyMonitor,
    AnomalyThresholds,
)
from oryx_tpu_torch.utils.metrics import ServingMetrics  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serve_common import make_pipes  # noqa: E402


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _wait(predicate, timeout=60.0, interval=0.02) -> bool:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(interval)
    return False


def test_degraded_ladder_escalates_and_decays(pipes):
    """SLO firings walk the ladder up (shed cache -> clamp -> shed load);
    quiet time walks it back down to 0, idle engine included. The walk is
    read from the journal's `degraded` entries (a timing-coupled run may
    finish its requests after the first cooldown)."""
    from oryx_tpu_torch.serve.journal import DecisionJournal

    pipe = pipes[1]
    metrics = ServingMetrics()
    anomaly = AnomalyMonitor(
        source="serve", thresholds=AnomalyThresholds(queue_depth_slo=1),
        registry=metrics.registry,
    )
    journal = DecisionJournal(None)
    sched = ContinuousScheduler(
        pipe, num_slots=1, page_size=16, chunk=4, max_ctx=512,
        metrics=metrics, anomaly=anomaly, autostart=False,
        degraded_cooldown=0.3, degraded_clamp_tokens=2, journal=journal,
    )
    h1 = sched.submit({"question": "hello there"}, 8)
    h2 = sched.submit({"question": "what now?"}, 8)
    assert anomaly.counts.get("queue_depth_slo") == 1
    sched.start()
    h1.result(timeout=600)
    r2, reason2, usage2 = h2.result(timeout=600)
    assert _wait(lambda: sched.degraded_mode == 0, timeout=30)
    assert metrics.get("degraded_mode") == 0
    entries = journal.snapshot()
    modes = [e["mode"] for e in entries if e["kind"] == "degraded"]
    assert modes and modes[0] == 1 and modes[-1] == 0
    admit2 = [e for e in entries if e["kind"] == "admit"][-1]
    # The clamp, when the ladder reached 2 before h2's admission.
    assert admit2["max_new"] in (8, 2) and usage2[1] <= admit2["max_new"]
    # Each escalation captured its forensic.
    esc = [r for r in sched.forensics.snapshot()
           if r["trigger"] == "degraded_escalation"]
    assert len(esc) == sum(1 for a, b in zip([0] + modes, modes) if b > a)
    sched.check_pool_invariant()
    sched.close()


def test_degraded_transitions_equal_jax():
    """The ladder's rule, stepped by hand on both engines' _update_degraded
    with the same firings and clock: the same mode walk, the cache shed at
    1 and restored at 0, the clamp at 2."""
    from oryx_tpu_torch.serve import scheduler as tsched

    walks = []
    for sched_mod, monitor, thresholds in (
        (__import__("oryx_tpu.serve.scheduler", fromlist=["x"]), JMonitor,
         JThresholds),
        (tsched, AnomalyMonitor, AnomalyThresholds),
    ):
        cls = sched_mod.ContinuousScheduler
        obj = cls.__new__(cls)
        import threading

        obj._cond = threading.Condition()
        obj.anomaly = monitor(source="serve",
                              thresholds=thresholds(queue_depth_slo=1))
        obj.metrics = ServingMetrics() if sched_mod is tsched else \
            __import__("oryx_tpu.utils.metrics",
                       fromlist=["x"]).ServingMetrics()
        obj.journal = None
        obj.prefix_cache = None
        obj.degraded_cooldown = 10.0
        obj._degraded = 0
        obj._slo_fired_seen = 0
        obj._cache_shed = False
        obj._capture_oom = lambda *a, **k: None
        clock = [100.0]
        obj._degraded_changed = clock[0]
        walk = []
        orig = sched_mod.time.monotonic
        sched_mod.time.monotonic = lambda: clock[0]
        try:
            for depth, dt in ((2, 0), (0, 1), (2, 1), (0, 1), (2, 1),
                              (5, 1), (0, 11), (0, 5), (0, 11), (0, 11)):
                clock[0] += dt
                obj.anomaly.observe_queue_depth(depth)
                obj._update_degraded()
                walk.append((obj._degraded, obj._cache_shed))
        finally:
            sched_mod.time.monotonic = orig
        walks.append(walk)
    assert walks[0] == walks[1]
    assert max(m for m, _ in walks[1]) == 3 and walks[1][-1] == (0, False)


def test_degraded_mode3_sheds_load(pipes):
    """Mode 3 rejects admission: the reference's reason, message and
    Retry-After."""
    jp, tp = pipes
    got = []
    for cls, exc, pipe in ((JSched, JRejected, jp),
                           (ContinuousScheduler, AdmissionRejected, tp)):
        sched = cls(pipe, num_slots=1, page_size=16, chunk=4, max_ctx=512,
                    autostart=False, degraded_cooldown=3600.0)
        sched._set_degraded(3)
        with pytest.raises(exc) as ei:
            sched.submit({"question": "hi"}, 2)
        got.append((ei.value.reason, str(ei.value), ei.value.retry_after_s))
        sched.close()
    assert got[0] == got[1]
    assert got[1][0] == "shed_load"


def test_degraded_escalation_captures_forensic(pipes):
    pipe = pipes[1]
    anomaly = AnomalyMonitor(
        source="serve", thresholds=AnomalyThresholds(queue_depth_slo=1),
    )
    sched = ContinuousScheduler(
        pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
        anomaly=anomaly, autostart=False,
    )
    handles = [
        sched.submit({"question": f"question {i}"}, 4) for i in range(4)
    ]
    sched.start()
    for h in handles:
        h.result(timeout=600)
    assert sched.forensics.total >= 1
    rec = sched.forensics.snapshot()[-1]  # oldest = the escalation
    assert rec["trigger"] == "degraded_escalation"
    assert rec["degraded_mode"] >= 1
    assert rec["pool"]["reconciled"]
    assert sched.metrics.by_label("oom_forensics_total").get(
        "degraded_escalation", 0) >= 1
    sched.close()


def _allocator_run(cls, pipe, fmod, spec, **kw):
    """Five requests over a tight pool under an allocator fault schedule:
    (per-request reply or None when it errored cleanly)."""
    sched = cls(pipe, num_slots=2, page_size=16, chunk=4, max_ctx=256,
                num_pages=12, autostart=False, **kw)
    fmod.configure(spec)
    shared = "shared prefix for the cache to splice around! "
    handles = [
        sched.submit({"question": shared + f"q{i}"}, 4 + i % 3)
        for i in range(5)
    ]
    sched.start()
    out = []
    for h in handles:
        try:
            out.append(h.result(timeout=600)[0])
        except RuntimeError:
            out.append(None)
    fmod.reset()
    assert _wait(
        lambda: all(r is None for r in sched.slots)
        and sched.queue_len() == 0
    )
    check = getattr(sched, "check_pool_invariant", None) or \
        sched._check_pool_invariant
    check()
    sched.close()
    return out


@pytest.mark.parametrize("spec", [
    "page_alloc_oom:after=0",        # very first allocation fails
    "page_alloc_oom:after=3",        # mid-splice/grow
    "page_alloc_oom:every=2",        # every other allocation
    "page_alloc_oom:p=0.4,seed=3",   # random schedule A
    "page_alloc_oom:p=0.4,seed=9",   # random schedule B
])
def test_allocator_failures_leave_refcounts_exact(pipes, spec):
    """Injected pool exhaustion during splices, copies on write and
    growth: every request completes or errors cleanly and the pool
    invariant holds; a completed reply is the unfaulted one."""
    jp, tp = pipes
    got = _allocator_run(ContinuousScheduler, tp, faults, spec)
    clean = _allocator_run(ContinuousScheduler, tp, faults, None)
    want = _allocator_run(JSched, jp, jfaults, None, prefix_cache=False)
    assert clean == want
    assert all(g is None or g == w for g, w in zip(got, want)), (got, want)
    assert faults.injected_count() == 0  # reset after the run
    if spec.endswith("after=0"):
        assert None not in got


def test_cow_alloc_failure_falls_back_to_recompute(pipes):
    """The copy-on-write allocation fails: the partial page is recomputed,
    the reply unchanged, refcounts exact."""
    jp, tp = pipes
    sched = ContinuousScheduler(tp, num_slots=2, page_size=4, chunk=4,
                                max_ctx=256, autostart=False)
    q = "hello there friend"
    ref = jp.chat(q, max_new_tokens=4)
    h1 = sched.submit({"question": q}, 4)
    sched.start()
    assert h1.result(timeout=600)[0] == ref
    faults.configure("page_alloc_oom:after=0")
    h2 = sched.submit({"question": q}, 4)
    assert h2.result(timeout=600)[0] == ref
    assert faults.injected_count("page_alloc_oom") == 1
    faults.reset()
    assert _wait(lambda: all(r is None for r in sched.slots))
    sched.check_pool_invariant()
    assert sched.forensics.snapshot()[0]["trigger"] == "oom"
    sched.close()


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_armed_unfired_faults_never_perturb(pipes, ragged):
    """Every serving fault site armed on a schedule that never fires:
    replies, usage and dispatch counts equal the unarmed engine's."""
    tp = pipes[1]
    reqs = [("hello there", 6), ("what now?", 5), ("tell me more", 7)]
    sites = ("engine_crash", "prefill_dispatch", "decode_dispatch",
             "page_alloc_oom", "host_spill_upload")
    out = []
    for spec in (None, ";".join(f"{s}:after=1000000" for s in sites)):
        faults.configure(spec)
        sched = ContinuousScheduler(
            tp, num_slots=2, page_size=16, chunk=4, max_ctx=512,
            ragged=ragged, prefill_chunk=32 if ragged else None,
            autostart=False)
        handles = [sched.submit({"question": q}, n) for q, n in reqs]
        sched.start()
        out.append(([h.result(timeout=600) for h in handles],
                    sched.metrics.by_label("dispatches_total")))
        sched.close()
        assert faults.injected_count() == 0
        faults.reset()
    assert out[1] == out[0]
