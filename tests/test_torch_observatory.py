"""The port's serving observatories against the JAX package's, on the CPU:
the step timeline (utils/timeline.py), the allocator's ownership data and
the page map (ops/paged_kv.PageAllocator, utils/pagemap.py), OOM
forensics (utils/forensics.py, the scheduler's capture sites) and the
serving half of the numerics probes (utils/numerics.py, the `numerics=`
flag of the paged steps and the scheduler's cadence). The same inputs go
through both packages; records are compared field by field, times left
out (mirrors tests/test_timeline.py, test_pagemap.py, test_forensics.py
and test_numerics.py; the cases that need utils/faults.py, which the port
does not have, drive real pool shortfalls instead)."""

import math
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu.utils import forensics as jforensics  # noqa: E402
from oryx_tpu.utils import metrics as jmetrics  # noqa: E402
from oryx_tpu.utils import numerics as jnumerics  # noqa: E402
from oryx_tpu.utils import pagemap as jpagemap  # noqa: E402
from oryx_tpu.utils import request_log as jrequest_log  # noqa: E402
from oryx_tpu.utils import timeline as jtimeline  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils import forensics  # noqa: E402
from oryx_tpu_torch.utils import metrics  # noqa: E402
from oryx_tpu_torch.utils import numerics  # noqa: E402
from oryx_tpu_torch.utils import pagemap  # noqa: E402
from oryx_tpu_torch.utils import request_log  # noqa: E402
from oryx_tpu_torch.utils import timeline  # noqa: E402

from torch_serve_common import make_pipes  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
TIMES = ("ts_unix_s", "dur_s")


@pytest.fixture(scope="module")
def pipes():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield make_pipes()
    jax.config.update("jax_default_matmul_precision", old)


def _untimed(records):
    return [{k: v for k, v in r.items() if k not in TIMES} for r in records]


def _pages_untimed(snap):
    """A snapshot's page records without their clocks (None-ness kept)."""
    return [
        {**{k: v for k, v in r.items() if k not in ("age_s", "idle_s")},
         "resident": r["age_s"] is not None and r["idle_s"] is not None}
        for r in snap["pages"]
    ]


def _summary_untimed(s):
    out = {k: v for k, v in s.items()
           if k not in ("resident_age_s", "resident_idle_s")}
    out["resident_n"] = (s["resident_age_s"]["n"], s["resident_idle_s"]["n"])
    return out


# ---------------------------------------------------------------------------
# Declared constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", [
    "PAGE_LIFETIME_BUCKETS", "AUDIT_DIFF_BUCKETS", "AUDIT_KL_BUCKETS",
    "AUDIT_EVENT_KEYS", "OOM_EVENT_KEYS",
])
def test_metric_constants_equal_jax(name):
    assert getattr(metrics, name) == getattr(jmetrics, name)


def test_record_keys_and_gauge_tables_equal_jax():
    assert timeline.STEP_RECORD_KEYS == jtimeline.STEP_RECORD_KEYS
    assert forensics.TOP_K == jforensics.TOP_K
    assert numerics.NUMERICS_STAT_KEYS == jnumerics.NUMERICS_STAT_KEYS
    assert numerics.NUMERICS_GAUGES == jnumerics.NUMERICS_GAUGES


@pytest.mark.parametrize("builder,fields,bad", [
    ("build_oom_event", dict(trigger="oom", detail="x", free_pages=3),
     "OOM_EVENT_KEYS"),
    ("build_audit_event", dict(request_id="r1", verdict="pass"),
     "AUDIT_EVENT_KEYS"),
])
def test_kind_events_and_log_schema_as_jax(builder, fields, bad):
    ev = getattr(request_log, builder)(**fields)
    jev = getattr(jrequest_log, builder)(**fields)
    assert {k: v for k, v in ev.items() if k != "ts_unix_s"} == \
        {k: v for k, v in jev.items() if k != "ts_unix_s"}
    for mod in (request_log, jrequest_log):
        with pytest.raises(ValueError, match=bad):
            getattr(mod, builder)(**{"bogus_field": 1})
    log = request_log.RequestLog()
    log.append(ev)  # the kind dispatches to its own schema
    with pytest.raises(ValueError):
        log.append({"kind": ev["kind"], "bogus": 1})
    with pytest.raises(ValueError):
        log.append({"trigger": "oom"})  # no kind: a request event


# ---------------------------------------------------------------------------
# The step timeline
# ---------------------------------------------------------------------------


def _feed(tl, n):
    for i in range(n):
        tl.record(dur_s=0.001 * i, kind=("ragged", "prefill", "decode")[i % 3],
                  rows=i, live_slots=i % 4, accepted_tokens=2 * i,
                  queue_depth=i % 2, free_pages=100 - i, degraded_mode=0,
                  device_us=None if i % 2 else 7 * i, ts_unix_s=1000.0 + i)


@pytest.mark.parametrize("capacity,n", [(1, 3), (4, 10), (16, 10)])
def test_timeline_ring_equals_jax(capacity, n):
    a, b = timeline.StepTimeline(capacity), jtimeline.StepTimeline(capacity)
    _feed(a, n)
    _feed(b, n)
    for k in (None, 0, 2, 100):
        assert a.to_dict(k) == b.to_dict(k), k
    assert a.total_steps == n and a.counts_by_kind() == b.counts_by_kind()
    recs = a.snapshot()
    assert [r["step"] for r in recs] == list(range(n, n - len(recs), -1))
    assert all(tuple(r) == timeline.STEP_RECORD_KEYS for r in recs)


def test_timeline_snapshot_under_concurrent_writer():
    tl = timeline.StepTimeline(capacity=8)
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            _feed(tl, 5)

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(300):
            for rec in tl.snapshot():
                assert tuple(rec) == timeline.STEP_RECORD_KEYS
            body = tl.to_dict(4)
            assert len(body["records"]) <= 4
    finally:
        stop.set()
        t.join()
    assert sum(tl.counts_by_kind().values()) == tl.total_steps


# ---------------------------------------------------------------------------
# The allocator's ownership data and the page map
# ---------------------------------------------------------------------------


class _Obs:
    def __init__(self):
        self.freed = []

    def page_freed(self, lifetime_s, idle_s):
        self.freed.append((lifetime_s, idle_s))


def _drive(alloc, seed):
    """A seeded run of alloc / share / free transitions with owner tags
    (and failed allocations) applied the same way to either allocator."""
    rng = np.random.default_rng(seed)
    held: list[tuple[int, str]] = []
    for _ in range(60):
        op = rng.integers(0, 4)
        owner = ["req:a", "req:b", "cache", None][rng.integers(0, 4)]
        if op == 0:
            try:
                pages = alloc.alloc(int(rng.integers(0, 4)), owner=owner)
            except (tpk.OutOfPagesError, jpk.OutOfPagesError):
                continue
            held.extend((p, owner) for p in pages)
        elif op == 1 and held:
            p, _ = held[int(rng.integers(0, len(held)))]
            alloc.share([p], owner=owner)
            held.append((p, owner))
        elif held:
            p, tag = held.pop(int(rng.integers(0, len(held))))
            alloc.free([p], owner=tag if op == 2 else None)
    return held


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_ownership_map_equals_jax(seed):
    a, b = tpk.PageAllocator(12, 4), jpk.PageAllocator(12, 4)
    a.observer, b.observer = _Obs(), _Obs()
    held = _drive(a, seed)
    assert _drive(b, seed) == held
    sa, sb = a.snapshot(), b.snapshot()
    assert _pages_untimed(sa) == _pages_untimed(sb)
    assert {k: v for k, v in sa.items() if k != "pages"} == \
        {k: v for k, v in sb.items() if k != "pages"}
    assert len(a.observer.freed) == len(b.observer.freed)
    assert all(0 <= idle <= life + 1e-6 for life, idle in a.observer.freed)
    assert _summary_untimed(pagemap.summarize(sa)) == \
        _summary_untimed(jpagemap.summarize(sb))
    a.check_invariant([[p for p, _ in held]])
    for r in sa["pages"]:
        assert tpk.PageAllocator.classify(r["refcount"], r["owners"]) == \
            jpk.PageAllocator.classify(r["refcount"], r["owners"])


def test_ages_idle_and_observer_clocks():
    a = tpk.PageAllocator(4, 2)
    a.observer = _Obs()
    p = a.alloc(2, owner="x")
    time.sleep(0.02)
    rec = [r for r in a.snapshot()["pages"] if r["page"] == p[0]][0]
    assert rec["age_s"] >= 0.02 and rec["idle_s"] >= 0.02
    a.share([p[0]], owner="cache")
    rec = [r for r in a.snapshot()["pages"] if r["page"] == p[0]][0]
    assert rec["idle_s"] < 0.02 <= rec["age_s"]
    a.free(p, owner="x")
    a.free([p[0]], owner="cache")
    assert len(a.observer.freed) == 2
    for life, idle in a.observer.freed:
        assert life >= 0.02 and 0 <= idle <= life + 1e-6
    q = a.alloc(1, owner="y")[0]
    rec = [r for r in a.snapshot()["pages"] if r["page"] == q][0]
    assert rec["age_s"] < 0.02
    assert a.min_free == 2


@pytest.mark.parametrize("free,n", [
    ([], None), ([3], None), ([0, 1, 2, 3], None), ([0, 2, 4, 6], None),
    ([1, 2, 3, 7, 8], None), ([5, 6, 9], 5),
])
def test_fragmentation_ratio_equals_jax(free, n):
    assert pagemap.fragmentation_ratio(free, n) == \
        jpagemap.fragmentation_ratio(free, n)


def _gauge_lines(text):
    return sorted(
        ln for ln in text.splitlines()
        if ln.startswith(("oryx_pool_", "oryx_page_")) and
        not ln.startswith(("oryx_page_lifetime_seconds_bucket",
                           "oryx_page_lifetime_seconds_sum",
                           "oryx_page_idle_seconds_bucket",
                           "oryx_page_idle_seconds_sum"))
    )


@pytest.mark.parametrize("seed", [0, 5])
def test_pool_observatory_gauges_equal_jax(seed):
    out = []
    for mpk, mpm, mmet in ((tpk, pagemap, metrics),
                           (jpk, jpagemap, jmetrics)):
        reg = mmet.Registry()
        alloc = mpk.PageAllocator(12, 4)
        obs = mpm.PoolObservatory(reg, lambda: alloc, ttl_s=0.0)
        obs.attach(alloc)
        _drive(alloc, seed)
        out.append(reg.render())
    assert _gauge_lines(out[0]) == _gauge_lines(out[1])
    assert "# TYPE oryx_page_idle_seconds histogram" in out[0]


def test_pool_observatory_ttl_and_force():
    reg = metrics.Registry()
    alloc = tpk.PageAllocator(8, 2)
    walks = {"n": 0}
    real = alloc.classify

    def counting(*a):
        walks["n"] += 1
        return real(*a)

    alloc.classify = counting
    obs = pagemap.PoolObservatory(reg, lambda: alloc, ttl_s=3600.0)
    n0 = walks["n"]
    obs.collect()
    assert walks["n"] == n0  # inside the TTL: no walk
    alloc.alloc(3)
    obs.collect(force=True)
    assert walks["n"] == n0 + 8
    assert reg.get("oryx_pool_slot_pages", raw_name=True) == 3
    assert reg.get("oryx_pool_min_free_pages", raw_name=True) == 5


# ---------------------------------------------------------------------------
# The forensic ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep", [1, 3, 64])
def test_forensic_ring_equals_jax(keep):
    a, b = forensics.ForensicRing(keep), jforensics.ForensicRing(keep)
    for i in range(5):
        assert a.append({"kind": "oom_pressure", "n": i,
                         "ts_unix_s": 1.0 * i}) == \
            b.append({"kind": "oom_pressure", "n": i, "ts_unix_s": 1.0 * i})
    for n in (None, 0, 2):
        assert a.to_dict(n) == b.to_dict(n)
    recs = a.snapshot()
    recs[0]["n"] = 99  # a copy: the ring is untouched
    assert a.snapshot(1)[0]["n"] == 4


# ---------------------------------------------------------------------------
# Numerics probes
# ---------------------------------------------------------------------------


def _probe_cases():
    rng = np.random.default_rng(0)
    peaked = np.zeros((1, 16), np.float32)
    peaked[0, 3] = 30.0
    nan = rng.standard_normal((2, 8)).astype(np.float32)
    nan[1, :4] = np.nan
    nan[0, 2] = np.inf
    return {
        "uniform": [(np.zeros((2, 64), np.float32), [True, True])],
        "peaked": [(peaked, [True])],
        "nonfinite": [(nan, [True, True])],
        "dead_rows": [(np.stack([np.zeros(8, np.float32),
                                 np.full(8, 100.0, np.float32)]),
                       [True, False])],
        "all_dead": [(np.ones((2, 8), np.float32), [False, False])],
        "steps": [(5 * rng.standard_normal((3, 50)).astype(np.float32),
                   [True, False, True]) for _ in range(4)],
    }


@pytest.mark.parametrize("case", list(_probe_cases()))
def test_logit_stats_equal_jax(case):
    steps = _probe_cases()[case]
    acc, jacc = numerics.init_logit_stats(), jnumerics.init_logit_stats()
    for logits, live in steps:
        acc = numerics.accumulate_logit_stats(
            acc, torch.from_numpy(logits), torch.tensor(live))
        jacc = jnumerics.accumulate_logit_stats(
            jacc, jnp.asarray(logits), jnp.asarray(live))
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc),
                               atol=ATOL, rtol=RTOL)
    got, want = (numerics.finalize_logit_stats(acc),
                 jnumerics.finalize_logit_stats(jacc))
    if want is None:
        assert got is None
        return
    assert list(got) == list(want)
    assert all(math.isfinite(v) for v in got.values())
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=ATOL, rel=RTOL), k


def test_tree_probes_equal_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4, 5)).astype(np.float32)
    v = rng.standard_normal((3, 2)).astype(np.float32) * 7
    c = np.asarray([0.5], np.float32)
    ttree = {"a": {"w": torch.from_numpy(w), "v": torch.from_numpy(v)},
             "c": torch.from_numpy(c), "ints": torch.tensor([9])}
    jtree = {"a": {"w": jnp.asarray(w), "v": jnp.asarray(v)},
             "c": jnp.asarray(c), "ints": jnp.asarray([9])}
    assert float(numerics.tree_absmax(ttree)) == \
        float(jnumerics.tree_absmax(jtree))
    np.testing.assert_array_equal(
        numerics.stacked_layer_absmax(ttree["a"]).numpy(),
        np.asarray(jnumerics.stacked_layer_absmax(jtree["a"])))
    assert numerics.stacked_layer_absmax({}) is None
    layers = torch.nn.Sequential(torch.nn.Linear(2, 3), torch.nn.Linear(3, 2))
    assert float(numerics.tree_absmax(layers)) == max(
        float(p.detach().abs().max()) for p in layers.parameters())
    assert numerics.is_finite(1.0) and not numerics.is_finite("x")


# ---------------------------------------------------------------------------
# The engines: port vs JAX on the same requests
# ---------------------------------------------------------------------------

REQS = [("hello there", 6), ("tell me more", 5), ("another one", 4)]
ENGINES = {
    "split": dict(),
    "ragged": dict(ragged=True, prefill_chunk=32),
}


def _serve(cls, pipe, reqs=REQS, **kw):
    sched = cls(pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
                autostart=False, **kw)
    handles = [sched.submit({"question": q}, cap, request_id=f"r{i}")
               for i, (q, cap) in enumerate(reqs)]
    sched.start()
    results = [h.result(timeout=600) for h in handles]
    sched.close()
    return sched, results


@pytest.mark.parametrize("engine", list(ENGINES))
def test_timeline_and_page_map_equal_jax(pipes, engine):
    jp, tp = pipes
    js, jres = _serve(JaxScheduler, jp, **ENGINES[engine])
    ts, tres = _serve(ContinuousScheduler, tp, **ENGINES[engine])
    assert tres == jres
    counts = {k: int(v) for k, v in
              ts.metrics.by_label("dispatches_total").items() if v}
    assert ts.timeline.counts_by_kind() == counts
    assert ts.timeline.total_steps == sum(counts.values())
    assert ts.timeline.counts_by_kind() == js.timeline.counts_by_kind()
    assert _untimed(ts.timeline.snapshot()) == \
        _untimed(js.timeline.snapshot())
    assert all(r["dur_s"] >= 0 and r["device_us"] is None
               for r in ts.timeline.snapshot())
    snap, jsnap = ts.pool_snapshot(), js.pool_snapshot()
    assert _pages_untimed(snap) == _pages_untimed(jsnap)
    assert {k: v for k, v in snap.items() if k not in ("pages", "summary")} \
        == {k: v for k, v in jsnap.items() if k not in ("pages", "summary")}
    assert _summary_untimed(snap["summary"]) == \
        _summary_untimed(jsnap["summary"])
    s = snap["summary"]
    ts.check_pool_invariant()
    assert s["reconciled"] and s["slot"] == s["shared"] == 0
    assert all(r["owners"] == ["cache"] for r in snap["pages"]
               if r["state"] == "cache")
    reg = ts.metrics.registry
    for key in ("free", "slot", "cache", "shared"):
        assert reg.get(f"oryx_pool_{key}_pages", raw_name=True) == s[key]
    assert reg.get("oryx_pool_size_pages", raw_name=True) == ts.num_pages
    lifetime = reg.existing("oryx_page_lifetime_seconds", raw_name=True)
    assert lifetime.children()[()].total > 0
    for h in ts.timeline.snapshot():
        assert 0 <= h["free_pages"] <= ts.num_pages


def _pressure_geometry(tp, qs, cap, ps=16, chunk=4):
    return max(
        math.ceil((len(tp._prepare_request({"question": q})[0]) + cap
                   + chunk) / ps)
        for q in qs
    )


def _forensic_untimed(r):
    r = dict(r)
    r.pop("ts_unix_s")
    r["pool"] = _summary_untimed(r["pool"])
    r["top_requests"] = [
        {**t, "cost": {k: v for k, v in t["cost"].items()
                       if k != "page_seconds"}}
        for t in r["top_requests"]
    ]
    r["timeline_tail"] = _untimed(r["timeline_tail"])
    return r


@pytest.mark.parametrize("where,prefix_cache", [
    ("admission", False), ("admission", True), ("growth", False),
])
def test_real_shortfall_forensics_equal_jax(pipes, where, prefix_cache):
    """Two requests that cannot both hold their pages: the shortfall (at
    admission, or in a resident's growth, which evicts the younger)
    captures one pool_pressure record an episode, with the residents and
    the asking request named, as the JAX engine captures it."""
    jp, tp = pipes
    qs = [("pressure question A", 48), ("pressure question B", 48)]
    if where == "admission":
        num_pages = _pressure_geometry(tp, [q for q, _ in qs], 48) + 2
    else:  # both prompts fit; their growth does not
        num_pages = 2 * _pressure_geometry(tp, [q for q, _ in qs], 0) + 1
    kw = dict(num_pages=num_pages, prefix_cache=prefix_cache)
    js, jres = _serve(JaxScheduler, jp, qs, **kw)
    ts, tres = _serve(ContinuousScheduler, tp, qs, **kw)
    assert tres == jres
    recs, jrecs = ts.forensics.snapshot(), js.forensics.snapshot()
    assert recs and len(recs) == len(jrecs)
    assert [_forensic_untimed(r) for r in recs] == \
        [_forensic_untimed(r) for r in jrecs]
    pressure = [r for r in recs if r["trigger"] == "pool_pressure"]
    assert pressure
    for r in pressure:
        assert r["top_requests"] and "shortfall" in r["detail"]
        assert r["pool"]["reconciled"]
    if where == "growth":
        assert ts.metrics.get("evicted") >= 1
        assert any(r["detail"].startswith("free-list") for r in pressure)
    assert len(recs) <= 2 * ts.metrics.get("evicted") + 4
    def oom_lines(m):
        return [ln for ln in m.render().splitlines()
                if ln.startswith("oryx_serving_oom_forensics_total")]

    assert oom_lines(ts.metrics) == oom_lines(js.metrics)
    assert ts.metrics.by_label("oom_forensics_total") == \
        {"pool_pressure": len(pressure)}
    ooms = [e for e in ts.request_log.snapshot()
            if e.get("kind") == "oom_pressure"]
    jooms = [e for e in js.request_log.snapshot()
             if e.get("kind") == "oom_pressure"]
    assert [{k: v for k, v in e.items() if k != "ts_unix_s"} for e in ooms] \
        == [{k: v for k, v in e.items() if k != "ts_unix_s"} for e in jooms]
    assert [e["forensic_index"] for e in ooms] == \
        sorted(r["index"] for r in recs)
    ts.check_pool_invariant()


@pytest.mark.parametrize("engine", list(ENGINES))
def test_probe_armed_tokens_and_stats_equal(pipes, engine):
    """numerics_every on or off gives the same replies and dispatch
    counts; the gauges equal the JAX engine's, sample for sample."""
    jp, tp = pipes
    base, bres = _serve(ContinuousScheduler, tp, **ENGINES[engine])
    ts, tres = _serve(ContinuousScheduler, tp, numerics_every=1,
                      **ENGINES[engine])
    js, _ = _serve(JaxScheduler, jp, numerics_every=1, **ENGINES[engine])
    assert tres == bres
    assert ts.metrics.by_label("dispatches_total") == \
        base.metrics.by_label("dispatches_total")
    reg, jreg = ts.metrics.registry, js.metrics.registry
    n = reg.get("oryx_numerics_samples_total", raw_name=True)
    assert n >= 1 and n == jreg.get("oryx_numerics_samples_total",
                                    raw_name=True)
    for fam in numerics.NUMERICS_GAUGES:
        assert reg.get(fam, raw_name=True) == pytest.approx(
            jreg.get(fam, raw_name=True), abs=ATOL, rel=RTOL), fam
    assert reg.get("oryx_numerics_logits_finite_frac", raw_name=True) == 1.0
    assert reg.get("oryx_numerics_logits_entropy", raw_name=True) > 0


def test_numerics_cadence_and_rejections_as_jax(pipes):
    jp, tp = pipes
    reqs = [("hello there", 12)]
    ts, _ = _serve(ContinuousScheduler, tp, reqs, numerics_every=3)
    js, _ = _serve(JaxScheduler, jp, reqs, numerics_every=3)
    n = ts.metrics.registry.get("oryx_numerics_samples_total", raw_name=True)
    assert 0 < n <= ts.metrics.get("chunks") / 3 + 1
    assert n == js.metrics.registry.get("oryx_numerics_samples_total",
                                        raw_name=True)
    text = ContinuousScheduler(tp, autostart=False).metrics.render()
    for fam in numerics.NUMERICS_GAUGES:
        assert f"{fam} 0" in text
    for kw in (dict(numerics_every=-1),
               dict(numerics_every=4, ragged=True, prefill_chunk=8,
                    speculate=2)):
        for cls, pipe in ((ContinuousScheduler, tp), (JaxScheduler, jp)):
            with pytest.raises(ValueError, match="numerics_every"):
                cls(pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
                    autostart=False, **kw)


def test_armed_engine_never_fuses(pipes):
    _, tp = pipes
    kw = dict(ragged=True, prefill_chunk=32, fuse_steps=4)
    base, bres = _serve(ContinuousScheduler, tp, [("hello there", 24)], **kw)
    armed, ares = _serve(ContinuousScheduler, tp, [("hello there", 24)],
                         numerics_every=2, **kw)
    assert ares == bres
    assert base.engine_stats["megasteps_total"]
    assert not armed.engine_stats["megasteps_total"]
    assert set(armed.timeline.counts_by_kind()) == {"ragged"}
