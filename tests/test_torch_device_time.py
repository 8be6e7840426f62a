"""The port's device-time attribution (utils/profiling.DeviceTimeSampler
over torch.profiler, utils/xplane's interval unions) against the JAX
package's: the busy-union math, window clipping and kind bucketing give
the reference's numbers on the same planes; the sampling cadence; the
capture-failure contract (a labeled counter, never a crashed step); a CPU
capture joined to live timeline records with byte parity and unchanged
dispatch counts (mirrors tests/test_device_time.py and the
format-independent cases of tests/test_xplane.py). The sampled record's
device time and wall come from one clock, so the bound is exact."""

import re
import sys
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from oryx_tpu.utils import profiling as jprofiling  # noqa: E402
from oryx_tpu.utils import xplane as jxplane  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils import profiling, xplane  # noqa: E402
from oryx_tpu_torch.utils import trace as trace_lib  # noqa: E402
from oryx_tpu_torch.utils.metrics import Registry, ServingMetrics  # noqa: E402
from oryx_tpu_torch.utils.profiling import (  # noqa: E402
    DeviceTimeSampler,
    attribute_capture,
)
from oryx_tpu_torch.utils.xplane import (  # noqa: E402
    Event,
    Line,
    Plane,
    busy_time_us,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serve_common import make_pipes  # noqa: E402


@pytest.fixture(scope="module")
def pipe():
    return make_pipes()[1]


T0 = 1_700_000_000_000_000_000


def _plane(mod, name, line_name, events, ts_ns=T0):
    """events: (offset_us, dur_us) pairs, as mod's planes."""
    return mod.Plane(name, [mod.Line(
        line_name,
        [mod.Event("op", int(d * 1e6), int(o * 1e6)) for o, d in events],
        timestamp_ns=ts_ns,
    )])


# ---------------------------------------------------------------------------
# Busy-union math (the same numbers as the reference on the same planes)
# ---------------------------------------------------------------------------


def test_union_counts_overlaps_once():
    ev = [(0, 100), (10, 40), (90, 60)]
    got = busy_time_us(
        [_plane(xplane, "/device:GPU:0", "Stream 7", ev)], T0,
        T0 + 1_000_000, plane_filter="/device:GPU", line_filter="Stream")
    want = jxplane.busy_time_us(
        [_plane(jxplane, "/device:TPU:0", "XLA Ops", ev)], T0,
        T0 + 1_000_000, plane_filter="TPU", line_filter="Ops")
    assert got == want == (150, 150)


def test_window_clipping_never_exceeds_window():
    planes = [_plane(xplane, "/device:GPU:0", "Stream 7", [(0, 1_000_000)])]
    w0, w1 = T0 + 200_000_000, T0 + 300_000_000
    busy, total = busy_time_us(planes, w0, w1, plane_filter="/device:GPU",
                               line_filter="Stream")
    assert busy == 100_000
    assert total == 1_000_000


def test_busiest_line_wins_not_the_sum():
    for mod in (xplane, jxplane):
        p = mod.Plane("/host:CPU", [
            mod.Line("thread 1", [mod.Event("f", int(300e6), 0)],
                     timestamp_ns=T0),
            mod.Line("thread 2", [mod.Event("g", int(10e6), 0)],
                     timestamp_ns=T0),
        ])
        busy, total = mod.busy_time_us([p], T0, T0 + 1_000_000_000)
        assert total == 300


# ---------------------------------------------------------------------------
# Kind bucketing
# ---------------------------------------------------------------------------


def test_attribute_capture_kind_bucketing():
    ev = [(100, 40), (300, 25), (900, 10)]
    windows = [
        ("ragged", T0 + 90_000, T0 + 200_000),
        ("prefill", T0 + 290_000, T0 + 400_000),
    ]
    att = attribute_capture(
        [_plane(xplane, "/device:GPU:0", "Stream 7", ev)], windows)
    want = jprofiling.attribute_capture(
        [_plane(jxplane, "/device:TPU:0", "XLA Ops", ev)], windows)
    assert att["source"] == "gpu_kernels"
    assert want["source"] == "tpu_xla_ops"
    assert att["by_kind_us"] == want["by_kind_us"] == {
        "ragged": 40, "prefill": 25}
    assert att["other_us"] == want["other_us"] == 10


def test_attribute_capture_host_fallback_excludes_modules():
    att = attribute_capture([
        _plane(xplane, "/host:CPU", "Thread 1", [(0, 50)]),
        _plane(xplane, "/host:CPU", "Thread 1 Modules", [(0, 500)]),
    ], [("decode", T0, T0 + 100_000)])
    want = jprofiling.attribute_capture([
        _plane(jxplane, "/host:CPU", "python threads", [(0, 50)]),
        _plane(jxplane, "/host:CPU", "XLA Modules", [(0, 500)]),
    ], [("decode", T0, T0 + 100_000)])
    assert att["source"] == want["source"] == "host_fallback"
    assert att["by_kind_us"] == want["by_kind_us"] == {"decode": 50}


def test_chrome_trace_shape():
    ev = [(0, 10), (20, 5)]
    body = xplane.chrome_trace([_plane(xplane, "/device:GPU:0", "Stream 7",
                                       ev)])
    assert body == jxplane.chrome_trace(
        [_plane(jxplane, "/device:GPU:0", "Stream 7", ev)])
    xs = [e for e in body["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == 2
    for e in xs:
        assert all(k in e for k in ("name", "ts", "dur", "pid", "tid"))
    names = [e for e in body["traceEvents"] if e["ph"] == "M"]
    assert any(e["name"] == "process_name" for e in names)
    assert body["truncated"] is False
    assert xplane.chrome_trace(
        [_plane(xplane, "/device:GPU:0", "Stream 7", ev * 10)], limit=5
    )["truncated"] is True


def test_attribute_device_time_midpoint_rule():
    """Events land in the window holding their midpoint; the rest in
    _unattributed; empty windows still appear; identical windows split
    the credit (mirrors tests/test_xplane.py)."""
    for mod, pname, lname, pf, lf in (
        (xplane, "/device:GPU:0", "Stream 7", "/device:GPU", "Stream"),
        (jxplane, "/device:TPU:0", "XLA Ops", "TPU", "Ops"),
    ):
        planes = [mod.Plane(pname, [mod.Line(lname, events=[
            mod.Event("a", duration_ps=2_000_000, offset_ps=0),
            mod.Event("b", duration_ps=2_000_000, offset_ps=4_000_000),
            mod.Event("c", duration_ps=2_000_000, offset_ps=90_000_000),
        ], timestamp_ns=T0)])]
        windows = [("w1", T0, T0 + 2_000), ("w2", T0 + 4_000, T0 + 6_000),
                   ("empty", T0 + 40_000, T0 + 41_000)]
        got = mod.attribute_device_time(planes, windows, plane_filter=pf,
                                        line_filter=lf)
        assert got == {"w1": 2_000_000, "w2": 2_000_000, "empty": 0,
                       "_unattributed": 2_000_000}
        shared = [("r1", T0, T0 + 2_000), ("r2", T0, T0 + 2_000)]
        got2 = mod.attribute_device_time(planes, shared, plane_filter=pf,
                                         line_filter=lf)
        assert got2["r1"] == got2["r2"] == 1_000_000
        assert got2["_unattributed"] == 4_000_000


def test_attribute_device_time_relative_timeline_aligns_on_end():
    got_by = []
    for mod in (xplane, jxplane):
        planes = [mod.Plane("/host:CPU", [mod.Line("python", events=[
            mod.Event("step", duration_ps=2_000_000, offset_ps=0),
            mod.Event("tail", duration_ps=2_000_000, offset_ps=8_000_000),
        ], timestamp_ns=10_000)])]
        got = mod.attribute_device_time(
            planes, [("w", T0 + 10_000, T0 + 12_000)],
            session_end_ns=T0 + 20_000)
        assert got == {"w": 2_000_000, "_unattributed": 2_000_000}
        got0 = mod.attribute_device_time(
            planes, [("w", T0 + 10_000, T0 + 12_000)])
        assert got0["w"] == 0 and got0["_unattributed"] == 4_000_000
        got_by.append((got, got0))
    assert got_by[0] == got_by[1]


def test_span_xplane_join_smoke(tmp_path):
    """Host spans from utils/trace.py joined against a real torch.profiler
    capture: the events land inside the span windows (one clock)."""
    import torch

    x = torch.randn(128, 128)
    tracer = trace_lib.Tracer()
    tr = tracer.start_trace("profile", id="smoke")
    prof = profiling._start_trace("cpu")
    for _ in range(3):
        with tr.span("train_step"):
            (x @ x).sum().item()
    planes = profiling._stop_trace(prof)
    tr.finish()
    windows = trace_lib.windows_from_traces([tr.to_dict()], "train_step")
    assert len(windows) == 3
    jsonl = tmp_path / "traces.jsonl"
    jsonl.write_text(json_line(tr.to_dict()))
    assert trace_lib.windows_from_jsonl(str(jsonl), "train_step") == windows
    got = xplane.attribute_device_time(planes, windows)
    for label, _, _ in windows:
        assert got[label] > 0, got


def json_line(d) -> str:
    import json

    return json.dumps(d) + "\n"


def test_planes_from_a_cpu_capture_and_op_profile(tmp_path):
    """planes_from_kineto: a host plane, a line a thread, the
    record_function ranges on the thread's Modules line; op_profile ranks
    host ops (host_fallback) and writes the Chrome trace."""
    import torch

    x = torch.randn(64, 64)

    def fn():
        with profiling.annotate("phase"):
            return x @ x

    out = profiling.op_profile(fn, trace_dir=str(tmp_path), steps=2,
                               device="cpu")
    assert out.source == "host_fallback"
    assert any("mm" in name for name, _ in out.top)
    assert Path(out.trace_path).exists()
    assert out.trace_end_ns > out.trace_start_ns > 10**15
    prof = profiling._start_trace("cpu")
    fn()
    planes = profiling._stop_trace(prof)
    assert [p.name for p in planes] == ["/host:CPU"]
    names = [ln.name for ln in planes[0].lines]
    assert any(n.endswith("Modules") for n in names)
    modules = [ln for ln in planes[0].lines if ln.name.endswith("Modules")]
    assert any(e.name == "phase" for ln in modules for e in ln.events)


# ---------------------------------------------------------------------------
# Sampling cadence + failure degradation
# ---------------------------------------------------------------------------


def test_cadence_zero_is_off_and_every_nth_fires():
    for mod in (profiling, jprofiling):
        s = mod.DeviceTimeSampler(every=0)
        assert not any(s.tick() for _ in range(20))
        s = mod.DeviceTimeSampler(every=3)
        assert [i for i in range(1, 10) if s.tick()] == [3, 6, 9]


def test_capture_failure_degrades_to_labeled_counter(monkeypatch):
    reg = Registry(prefix="oryx_serving")
    s = DeviceTimeSampler(reg, every=1, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(profiling, "_start_trace", boom)
    assert s.tick()
    assert s.begin() is False
    assert ('oryx_profile_capture_errors_total{stage="start"} 1'
            in reg.render())
    monkeypatch.undo()
    assert s.begin() is True
    monkeypatch.setattr(xplane, "planes_from_kineto", boom)
    assert s.end("decode", 0, 10) is None
    assert ('oryx_profile_capture_errors_total{stage="parse"} 1'
            in reg.render())
    assert s._prof is None


def test_abort_recovers_profiler_state():
    s = DeviceTimeSampler(every=1, device="cpu")
    assert s.begin()
    s.abort()
    assert s._prof is None
    assert s.begin()
    s.abort()


# ---------------------------------------------------------------------------
# CPU smoke: real capture joined to live timeline records
# ---------------------------------------------------------------------------


def _run(sched, reqs):
    handles = [sched.submit({"question": q}, cap) for q, cap in reqs]
    sched.start()
    out = [h.result(timeout=600)[0] for h in handles]
    sched.close()
    return out


def test_sampling_preserves_parity_and_feeds_timeline(pipe):
    """profile_sample_every armed: tokens and dispatch accounting unchanged,
    sampled records carry device_us within their own window (one clock: no
    slack), per-kind device time within the sampled wall."""
    reqs = [("hello there paged world", 8), ("what now then?", 6),
            ("tell me more", 7)]
    kw = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
              prefill_chunk=32, ragged=True, autostart=False)
    plain = ServingMetrics()
    baseline = _run(ContinuousScheduler(pipe, metrics=plain, **kw), reqs)
    armed = ServingMetrics()
    sched = ContinuousScheduler(pipe, metrics=armed,
                                profile_sample_every=2, **kw)
    sampled = _run(sched, reqs)
    assert sampled == baseline
    assert armed.by_label("dispatches_total") == \
        plain.by_label("dispatches_total")
    recs = sched.timeline.snapshot()
    dev = [r for r in recs if r["device_us"] is not None]
    assert dev, "no sampled step carried device_us"
    for r in dev:
        assert 0 <= r["device_us"] <= round(r["dur_s"] * 1e6)
    text = armed.render()
    dev_by = dict(re.findall(
        r'^oryx_device_time_seconds_total\{kind="(\w+)"\} '
        r"([0-9.e+-]+)$", text, re.M))
    wall_by = dict(re.findall(
        r'^oryx_profile_sampled_wall_seconds_total\{kind="(\w+)"\} '
        r"([0-9.e+-]+)$", text, re.M))
    assert wall_by, "no sampled wall windows recorded"
    for kind, v in dev_by.items():
        if kind in wall_by:
            assert float(v) <= float(wall_by[kind])
    assert "oryx_profile_captures_total" in text


def test_on_demand_capture_finishes_early_on_idle(pipe):
    sched = ContinuousScheduler(pipe, num_slots=2, page_size=16, chunk=4,
                                max_ctx=512, autostart=False)
    sched.start()
    result = {}

    def capture():
        result.update(sched.request_profile(50, timeout=60))

    t = threading.Thread(target=capture)
    t.start()
    sched.submit({"question": "short burst"}, 8).result(timeout=600)
    t.join(timeout=60)
    assert not t.is_alive(), "requester hung past the idle drain"
    assert 1 <= result["steps"] < 50, result["steps"]
    assert result.get("traceEvents")
    result2 = {}
    t = threading.Thread(
        target=lambda: result2.update(sched.request_profile(2, timeout=60)))
    t.start()
    sched.submit({"question": "more traffic"}, 8).result(timeout=600)
    t.join(timeout=60)
    assert result2.get("steps") == 2, result2.get("steps")
    sched.close()


def test_on_demand_request_profile(pipe):
    sched = ContinuousScheduler(pipe, num_slots=2, page_size=16, chunk=4,
                                max_ctx=512, autostart=False)
    sched.start()
    with pytest.raises(TimeoutError):
        sched.request_profile(2, timeout=0.5)
    with pytest.raises(ValueError):
        sched.request_profile(0)
    result = {}

    def capture():
        result.update(sched.request_profile(3, timeout=120))

    t = threading.Thread(target=capture)
    t.start()
    handles = [
        sched.submit({"question": f"traffic {i}"}, 8) for i in range(3)
    ]
    for h in handles:
        h.result(timeout=600)
    t.join(timeout=120)
    assert not t.is_alive()
    assert result.get("steps") == 3
    assert result.get("traceEvents")
    assert result.get("source") == "host_fallback"
    assert isinstance(result.get("device_time_us"), dict)
    sched.close()


def test_step_timer_rolls_like_the_reference():
    import time

    for mod in (profiling, jprofiling):
        t = mod.StepTimer(window=2, n_chips=2)
        assert t.tick(10) is None
        time.sleep(0.01)
        s = t.tick(10)
        assert set(s) == {"step_time_s", "step_time_avg_s",
                          "tokens_per_sec", "tokens_per_sec_per_chip"}
        assert s["tokens_per_sec_per_chip"] == pytest.approx(
            s["tokens_per_sec"] / 2)
    assert profiling.DISPATCH_KINDS == jprofiling.DISPATCH_KINDS
