"""The port's metrics registry against the JAX package's: the same
sequence of counter, gauge, histogram and info calls renders byte-identical
Prometheus text (labels and escaping included); the quantile helpers give
equal results; ServingMetrics, the collectors and the TelemetryServer
behave as JAX's (mirrors tests/test_metrics_registry.py)."""

import json
import math
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from oryx_tpu.utils import metrics as jm  # noqa: E402
from oryx_tpu_torch.utils import metrics as tm  # noqa: E402


def _script(m, seed: int) -> str:
    """One seeded sequence of registry calls; returns the exposition."""
    rng = np.random.default_rng(seed)
    r = m.Registry(prefix="oryx_test")
    r.counter("reqs").inc()
    r.counter("reqs").inc(float(rng.uniform(0, 10)))
    r.gauge("depth").set(float(rng.integers(0, 100)))
    r.gauge("ratio").set(1 / 3)
    r.counter("big").inc(2 ** 53 + 1.0)
    kinds = r.counter("dispatches_total", ("kind",))
    for k in rng.choice(["ragged", "prefill", "decode"], 7):
        kinds.labels(kind=str(k)).inc()
    r.gauge("paths", ("path", "host")).labels(
        path='a\\b"c\nd', host="h1").set(-2.5)
    lat = r.histogram("lat", (0.1, 1.0, 10.0))
    for x in rng.exponential(1.0, 40):
        lat.observe(float(x))
    per = r.histogram("rows", (1.0, 4.0, 16.0), ("engine",))
    for e, x in zip(rng.choice(["a", "b"], 9), rng.integers(0, 30, 9)):
        per.labels(engine=str(e)).observe(int(x))
    r.counter("oryx_anomaly_total", ("kind",), raw_name=True).labels(
        kind="ttft_slo").inc()
    r.info("build_info", {"revision": "abc", "engine": "continuous",
                          "model": 'm"x'})
    r.info("build_info", {"revision": "def", "engine": "window",
                          "model": "y", "replica": "r1"})
    r.histogram("empty", (1.0,))
    return r.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exposition_byte_identical_to_jax(seed):
    assert _script(tm, seed) == _script(jm, seed)


def _serving(m):
    s = m.ServingMetrics()
    s.inc("admitted")
    s.inc("admitted", 2)
    s.inc("dispatches_total", labels={"kind": "ragged"})
    s.inc("dispatches_total", 3, labels={"kind": "spec"})
    s.set_gauge("queue_depth", 4)
    s.observe("ttft_seconds", 0.3)
    s.observe("dispatch_rows", 12, buckets=tm.DISPATCH_ROWS_BUCKETS)
    s.observe("dispatch_rows", 70, buckets=(1.0,))  # first touch wins
    s.set_info("build_info", {"revision": "x", "engine": "continuous",
                              "model": "m"})
    return s


def test_serving_metrics_equal_jax():
    """Same families, same text (the device-memory gauges read 0 on both
    on a host without a card)."""
    t, j = _serving(tm), _serving(jm)
    got, want = t.render(), j.render()
    drop = ("oryx_serving_hbm_live_bytes ",)  # JAX sums host arrays here
    strip = lambda text: [l for l in text.splitlines()
                          if not l.startswith(drop)]
    assert strip(got) == strip(want)
    assert t.get("admitted") == j.get("admitted") == 3
    assert t.get("queue_depth") == 4 and t.get("dispatches_total") == 0
    assert t.by_label("dispatches_total") == {"ragged": 1, "spec": 3}
    assert t.by_label("never") == {}
    assert t.histogram_totals("dispatch_rows") == (2, 82.0)
    assert t.histogram_totals("never") == (0, 0.0)


def test_bucket_ladders_and_schema_equal_jax():
    for name in ("TTFT_BUCKETS", "PER_TOKEN_BUCKETS", "PREFILL_CHUNK_BUCKETS",
                 "DISPATCH_ROWS_BUCKETS", "SPEC_ACCEPT_BUCKETS",
                 "REQUEST_TOKEN_BUCKETS", "REQUEST_SECONDS_BUCKETS",
                 "PAGE_SECONDS_BUCKETS", "REQUEST_COST_KEYS",
                 "REQUEST_EVENT_KEYS", "PROMETHEUS_CONTENT_TYPE"):
        assert getattr(tm, name) == getattr(jm, name), name


def test_registry_rules():
    r = tm.Registry()
    with pytest.raises(ValueError, match=">= 0"):
        r.counter("c").inc(-1)
    with pytest.raises(ValueError, match="declares"):
        r.counter("k", ("kind",)).labels(other="x")
    # One family, one kind: the clashing calls go through the generic
    # spellings (the repo's metric-name rule holds every literal family
    # name to one kind).
    r.counter("dup")
    with pytest.raises(ValueError, match="re-declared"):
        r.declare("dup", "gauge")
    r.histogram("h", (1.0, 2.0))
    with pytest.raises(ValueError, match="re-declared"):
        r.histogram("h", (1.0, 3.0))
    with pytest.raises(ValueError, match="info"):
        r.declare_info("dup", {"a": "b"})
    assert r.get("h") == 0.0 and r.get("k") == 0.0
    assert re.findall(r"^# TYPE (\S+) (\S+)$", r.render(), re.M) == [
        ("c", "counter"), ("dup", "counter"), ("h", "histogram"),
        ("k", "counter")]


def test_concurrent_increments_exact():
    r = tm.Registry()
    c = r.counter("n")
    h = r.histogram("lat", (0.5,))

    def work():
        for _ in range(2000):
            c.inc()
            h.observe(0.1)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert r.get("n") == 16000
    assert 'lat_bucket{le="0.5"} 16000' in r.render()


def test_collectors_refresh_and_never_break_scrape():
    r = tm.Registry()
    g = r.gauge("live")
    calls = []
    r.register_collector(lambda: (calls.append(1), g.set(len(calls))))

    def broken():
        raise RuntimeError("boom")

    r.register_collector(broken)
    assert "live 1" in r.render()
    assert "live 2" in r.render()


def test_process_and_device_memory_collectors():
    r = tm.Registry(prefix="p")
    tm.register_process_collector(r)
    tm.register_device_memory_collector(r, ttl_s=0)
    text = r.render()
    for name in ("process_cpu_seconds_total", "process_resident_memory_bytes",
                 "process_open_fds", "process_threads",
                 "process_start_time_seconds"):
        assert f"# TYPE p_{name} gauge" in text
    assert r.get("process_threads") >= 1
    # No card here: the four card-memory gauges read 0.
    for name in ("hbm_live_bytes", "hbm_bytes_in_use", "hbm_peak_bytes",
                 "hbm_limit_bytes"):
        assert f"# TYPE p_{name} gauge" in text and r.get(name) == 0


def test_histogram_quantile_equals_jax():
    rng = np.random.default_rng(0)
    bounds = [0.01, 0.1, 0.5, 1.0, 5.0]
    for _ in range(20):
        counts = np.cumsum(rng.integers(0, 5, len(bounds))).tolist()
        total = counts[-1] + int(rng.integers(0, 3))
        for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
            a = tm.histogram_quantile(q, bounds, counts, total)
            b = jm.histogram_quantile(q, bounds, counts, total)
            assert (math.isnan(a) and math.isnan(b)) or a == b
    assert math.isnan(tm.histogram_quantile(0.5, bounds, [0] * 5))
    with pytest.raises(ValueError):
        tm.histogram_quantile(1.5, bounds, [1] * 5)


def test_sample_quantile_equals_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 100):
        vals = rng.normal(size=n).tolist()
        for q in (0.0, 0.25, 0.5, 0.99, 1.0):
            a, b = tm.sample_quantile(vals, q), jm.sample_quantile(vals, q)
            assert (math.isnan(a) and math.isnan(b)) or a == b


def test_parse_and_inject_equal_jax():
    text = _script(tm, 3)
    for fam in ("oryx_test_lat", "oryx_test_empty", "oryx_test_missing"):
        assert tm.parse_prom_histogram(text, fam) == \
            jm.parse_prom_histogram(text, fam)
    b, c, total, s = tm.parse_prom_histogram(text, "oryx_test_lat")
    assert total == 40 and b == [0.1, 1.0, 10.0]
    assert tm.inject_exposition_label(text, "replica", 'r"1') == \
        jm.inject_exposition_label(text, "replica", 'r"1')


def test_telemetry_server_endpoints():
    r = tm.Registry(prefix="t")
    r.counter("x").inc(5)
    state = {"ready": (True, "ok")}
    srv = tm.TelemetryServer(r, ready_check=lambda: state["ready"]).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with urllib.request.urlopen(base + "/metrics") as resp:
            assert resp.headers["Content-Type"] == tm.PROMETHEUS_CONTENT_TYPE
            assert "t_x 5" in resp.read().decode()
        with urllib.request.urlopen(base + "/healthz") as resp:
            assert json.load(resp) == {"status": "ok"}
        with urllib.request.urlopen(base + "/readyz") as resp:
            assert json.load(resp) == {"ready": True, "reason": "ok"}
        state["ready"] = (False, "draining")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/readyz")
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope")
        assert e.value.code == 404
    finally:
        srv.close()
