"""The port's `utils/trace.py` against the JAX package's: the same calls
give the same span trees (names, parents, args, meta), Chrome-trace events
and JSONL records up to timestamps; the flight recorder's bounds and id
rules, context propagation, request-id sanitizing and the stall
watchdog's one-dump-per-stall contract (mirrors tests/test_trace.py)."""

import io
import json
import threading
import time

import pytest

pytest.importorskip("torch")

from oryx_tpu.utils import trace as jtrace  # noqa: E402
from oryx_tpu_torch.utils import trace as ttrace  # noqa: E402


def _tree(tr):
    return [(s.name, s.parent, s.args, s.dur_ns is None) for s in tr.spans]


def _script(lib):
    tr = lib.Trace("request", label="t", id="rid0")
    with tr.span("outer"):
        with tr.span("inner", detail=7):
            pass
        tr.event("marker", slot=2)
    h = tr.begin("queue_wait")
    tr.add_complete("tail", lib.now_ns(), 1000, chunk=3)
    tr.end(h)
    tr.annotate(routed=True)
    h2 = tr.begin("admission")
    tr.finish(finish_reason="stop", cost={"a": 1})
    return tr, h2


@pytest.mark.parametrize("lib", [ttrace], ids=["port"])
def test_span_tree_equals_jax(lib):
    want, jh = _script(jtrace)
    got, th = _script(lib)
    assert _tree(got) == _tree(want)
    assert got.meta == want.meta and got.done and th == jh
    assert got.spans[th].dur_ns is not None  # finish closed it
    marker = got.spans[2]
    assert marker.dur_ns == 0 and got.spans[4].dur_ns == 1000
    s, w = got.summary(), want.summary()
    for k in ("duration_ms", "created_unix_s"):
        s.pop(k), w.pop(k)
    assert s == w
    assert set(got.span_seconds()) == set(want.span_seconds())


def _chrome_shape(body):
    return [
        {k: v for k, v in e.items() if k not in ("ts", "dur")}
        for e in body["traceEvents"]
    ]


def test_chrome_export_equals_jax():
    bodies = []
    for lib in (jtrace, ttrace):
        tr, _ = _script(lib)
        bodies.append(lib.Tracer().chrome_trace([tr]))
    want, got = bodies
    assert _chrome_shape(got) == _chrome_shape(want)
    assert got["displayTimeUnit"] == want["displayTimeUnit"] == "ms"
    xs = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(xs[0])
    json.dumps(got)


def test_jsonl_records_equal_jax(tmp_path):
    recs = []
    for lib in (jtrace, ttrace):
        tracer = lib.Tracer()
        tr = tracer.start_trace("request", id="rid1")
        tr.add_complete("decode_chunk", 1_000, 500)
        tr.add_complete("decode_chunk", 2_000, 700)
        tr.finish()
        path = tmp_path / f"{lib.__name__}.jsonl"
        assert tracer.write_jsonl(str(path)) == 1
        rec = json.loads(path.read_text())
        for k in ("created_unix_s", "duration_ms"):
            rec.pop(k)
        recs.append(rec)
    assert recs[1] == recs[0]


def test_flight_recorder_bound_lookup_and_collision():
    tracer = ttrace.Tracer(capacity=3)
    traces = [tracer.start_trace("request", id=f"r{i}") for i in range(5)]
    assert [t["id"] for t in tracer.snapshot()] == ["r4", "r3", "r2"]
    assert tracer.get("r0") is None and tracer.get("r4") is traces[4]
    assert tracer.snapshot()[0]["done"] is False
    # A held id is minted anew: an id names one trace.
    dup = tracer.start_trace("request", id="r4")
    assert dup.id != "r4" and tracer.get("r4") is traces[4]
    t0 = ttrace.Tracer(capacity=0)
    t0.start_trace("request", id="a")
    t0.start_trace("request", id="b")
    assert [t["id"] for t in t0.snapshot()] == ["b"]


@pytest.mark.parametrize("raw", [
    None, "", "  ok-id_1.2 ", "x" * 64, "x" * 65, "-lead", "has space",
    "semi;colon", "ünï",
])
def test_sanitize_request_id_equals_jax(raw):
    assert ttrace.sanitize_request_id(raw) == jtrace.sanitize_request_id(raw)


def test_new_request_id_shape():
    a, b = ttrace.new_request_id(), ttrace.new_request_id()
    assert a != b and len(a) == len(jtrace.new_request_id()) == 16
    assert ttrace.sanitize_request_id(a) == a


def test_contextvar_propagation_and_noop():
    tr = ttrace.Trace("request")
    with ttrace.span("ignored"):
        pass
    ttrace.add_complete("ignored", ttrace.now_ns())
    ttrace.event("ignored")
    assert ttrace.current() is None
    with ttrace.activate(tr):
        assert ttrace.current() is tr
        with ttrace.span("inside"):
            pass
        ttrace.add_complete("chunk", ttrace.now_ns())
        ttrace.event("mark")
    assert ttrace.current() is None
    assert [s.name for s in tr.spans] == ["inside", "chunk", "mark"]
    seen = []
    t = threading.Thread(target=lambda: seen.append(ttrace.current()))
    with ttrace.activate(tr):
        t.start()
        t.join()
    assert seen == [None]


def test_watchdog_one_dump_per_stall():
    tracer = ttrace.Tracer()
    tr = tracer.start_trace("request", id="stuck1")
    tr.begin("decode_chunk")
    out = io.StringIO()
    wd = ttrace.StallWatchdog(tracer, 0.15, name="test", out=out).start()
    try:
        time.sleep(0.4)
        assert wd.dumps == 0  # inactive: a missing beat is no stall
        wd.set_active(True)
        deadline = time.monotonic() + 5
        while wd.dumps == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.dumps == 1 and wd.stalled()
        time.sleep(0.5)
        assert wd.dumps == 1
        text = out.getvalue()
        assert "STALL WATCHDOG" in text and "stuck1" in text
        assert "MainThread" in text
        wd.beat()
        assert not wd.stalled()
        deadline = time.monotonic() + 5
        while wd.dumps == 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert wd.dumps == 2
    finally:
        wd.stop()


def test_watchdog_beats_prevent_dumps():
    wd = ttrace.StallWatchdog(None, 0.2, name="test", out=io.StringIO())
    wd.start()
    try:
        wd.set_active(True)
        for _ in range(8):
            time.sleep(0.05)
            wd.beat()
        assert wd.dumps == 0
    finally:
        wd.stop()


def test_now_ns_monotone_and_anchored():
    a = ttrace.now_ns()
    b = ttrace.now_ns()
    assert b >= a
    assert abs(a - time.time_ns()) < 60 * 1_000_000_000


def test_span_handle_resolves_under_concurrent_appends():
    tr = ttrace.Trace("req")
    stop = threading.Event()

    def appender():
        while not stop.is_set():
            tr.add_complete("noise", ttrace.now_ns(), 10)

    workers = [threading.Thread(target=appender) for _ in range(2)]
    for w in workers:
        w.start()
    try:
        for i in range(200):
            with tr.span("work", i=i) as sp:
                assert sp.name == "work" and sp.args == {"i": i}
    finally:
        stop.set()
        for w in workers:
            w.join()
    tr.finish()
    assert {s.name for s in tr.spans} == {"noise", "work"}
