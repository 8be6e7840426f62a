"""The port's fault injection (utils/faults.py) and bounded retry
(utils/retry.py) against the JAX package's: the same specs parse the same,
fire on the same hits and raise the same way; the same policies give the
same backoff delays and retry schedules (mirrors tests/test_faults.py and
tests/test_retry.py). Each scenario runs against both modules; the port's
outcome must be the reference's."""

import threading
import time

import pytest

pytest.importorskip("torch")

from oryx_tpu.utils import faults as jfaults  # noqa: E402
from oryx_tpu.utils import metrics as jmetrics  # noqa: E402
from oryx_tpu.utils import retry as jretry  # noqa: E402
from oryx_tpu_torch.utils import faults as tfaults  # noqa: E402
from oryx_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from oryx_tpu_torch.utils import retry as tretry  # noqa: E402

BOTH = [(jfaults, jmetrics), (tfaults, tmetrics)]


@pytest.fixture(autouse=True)
def _clean_faults():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


def _schedule(faults, spec: str, site: str, hits: int) -> list[bool]:
    """Which of `hits` calls of `site` raised under `spec`."""
    faults.configure(spec)
    out = []
    for _ in range(hits):
        try:
            faults.fault_point(site)
            out.append(False)
        except faults.FaultInjected:
            out.append(True)
    return out


def test_parse_spec_full_grammar():
    spec = "page_alloc_oom:p=0.05,seed=7;engine_crash:after=40"
    want = {
        "page_alloc_oom": {"p": 0.05, "seed": 7.0},
        "engine_crash": {"after": 40.0},
    }
    assert tfaults.parse_spec(spec) == jfaults.parse_spec(spec) == want


@pytest.mark.parametrize("bad", [
    "site:notakey=1",          # unknown option
    "site:p=high",             # non-numeric
    "site:p=1.5",              # probability out of range
    "bad site:p=0.5",          # bad site name
    "a:p=0.1;a:p=0.2",         # duplicate site
])
def test_parse_spec_rejects_malformed(bad):
    msgs = []
    for faults, _ in BOTH:
        with pytest.raises(faults.FaultSpecError) as ei:
            faults.parse_spec(bad)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_disarmed_fault_point_is_inert():
    for faults, _ in BOTH:
        assert faults.armed() is False
        assert faults.fault_point("anything") is False
        assert faults.injected_count() == 0


def test_after_fires_exactly_once_at_the_right_hit():
    runs = [_schedule(f, "boom:after=3", "boom", 9) for f, _ in BOTH]
    assert runs[0] == runs[1] == [False] * 3 + [True] + [False] * 5
    for faults, _ in BOTH:
        assert faults.injected_count("boom") == 1
    tfaults.configure("boom:after=0")
    with pytest.raises(tfaults.FaultInjected) as ei:
        tfaults.fault_point("boom")
    assert ei.value.site == "boom"
    assert str(ei.value) == "injected fault at 'boom'"


def test_every_and_times_cap():
    runs = [_schedule(f, "tick:every=2,times=2", "tick", 10) for f, _ in BOTH]
    assert runs[0] == runs[1]
    assert sum(runs[1]) == 2
    assert tfaults.injected_count("tick") == 2


@pytest.mark.parametrize("spec", [
    "p50:p=0.5,seed=11", "p50:p=0.2,seed=3", "p50:p=0.9,seed=0",
])
def test_probability_schedule_is_seed_deterministic(spec):
    a = [_schedule(f, spec, "p50", 32) for f, _ in BOTH]
    b = _schedule(tfaults, spec, "p50", 32)
    # The port's Bernoulli stream is the reference's (same seeded RNG).
    assert a[0] == a[1] == b
    assert any(b) and not all(b)


def test_custom_exception_factory():
    class MyOOM(RuntimeError):
        pass

    for faults, _ in BOTH:
        faults.configure("oom:after=0")
        with pytest.raises(MyOOM):
            faults.fault_point("oom", exc=MyOOM)


def test_delay_sleeps_and_does_not_raise():
    for faults, _ in BOTH:
        faults.configure("slow:delay=0.05,times=1")
        t0 = time.monotonic()
        assert faults.fault_point("slow") is False
        assert time.monotonic() - t0 >= 0.04
        assert faults.injected_count("slow") == 1


def test_corrupt_returns_true_for_the_caller():
    for faults, _ in BOTH:
        faults.configure("garble:corrupt=1,times=1")
        assert faults.fault_point("garble") is True
        assert faults.fault_point("garble") is False


def test_unlisted_site_never_fires():
    for faults, _ in BOTH:
        faults.configure("only_this:after=0")
        assert faults.fault_point("something_else") is False
        assert faults.injected_count() == 0


def test_metrics_registry_reconciles_with_injected_count():
    texts = []
    for faults, metrics in BOTH:
        reg = metrics.Registry(prefix="oryx_serving")
        faults.configure("a:every=1,times=3;b:after=1")
        faults.bind_registry(reg)
        for _ in range(5):
            for site in ("a", "b"):
                try:
                    faults.fault_point(site)
                except faults.FaultInjected:
                    pass
        text = reg.render()
        assert 'oryx_faults_injected_total{site="a"} 3' in text
        assert 'oryx_faults_injected_total{site="b"} 1' in text
        assert faults.injected_count() == 4
        assert "# TYPE oryx_faults_injected_total counter" in text
        texts.append(text)
    # The exposition is the reference's byte for byte.
    assert texts[0] == texts[1]


def test_configure_resets_counts_between_scenarios():
    for faults, _ in BOTH:
        faults.configure("x:after=0")
        with pytest.raises(faults.FaultInjected):
            faults.fault_point("x")
        faults.configure("x:after=0")
        assert faults.injected_count("x") == 0
        with pytest.raises(faults.FaultInjected):
            faults.fault_point("x")


def test_configure_from_env(monkeypatch):
    for faults, _ in BOTH:
        monkeypatch.setenv("ORYX_FAULTS", "envsite:after=0")
        assert faults.configure_from_env() is True
        with pytest.raises(faults.FaultInjected):
            faults.fault_point("envsite")
        monkeypatch.delenv("ORYX_FAULTS")
        faults.reset()
        assert faults.configure_from_env() is False


def test_thread_safety_exact_total_under_contention():
    tfaults.configure("race:every=1")
    hits_per_thread, nthreads = 200, 4
    errs = []

    def worker():
        for _ in range(hits_per_thread):
            try:
                tfaults.fault_point("race")
            except tfaults.FaultInjected:
                pass
            except Exception as e:  # pragma: no cover - failure detail
                errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert tfaults.injected_count("race") == hits_per_thread * nthreads


def test_observers_see_each_firing_in_order():
    """The journal's hook: (site, cumulative count) for every firing, the
    same stream in both packages."""
    seen = []
    for faults, _ in BOTH:
        got = []
        faults.configure("s:every=2")
        faults.add_observer(lambda site, n, got=got: got.append((site, n)))
        for _ in range(6):
            try:
                faults.fault_point("s")
            except faults.FaultInjected:
                pass
        seen.append(got)
    assert seen[0] == seen[1] == [("s", 1), ("s", 2), ("s", 3)]


# ---------------------------------------------------------------------------
# Retry (mirrors tests/test_retry.py)
# ---------------------------------------------------------------------------

RETRY = [jretry, tretry]


def test_backoff_schedule_is_deterministic_and_capped():
    for r in RETRY:
        policy = r.BackoffPolicy(retries=5, base_s=0.1, factor=2.0,
                                 max_s=0.5, jitter=0.0)
        assert r.backoff_delays(policy) == [0.1, 0.2, 0.4, 0.5, 0.5]


@pytest.mark.parametrize("seed", [3, 4, 17])
def test_jitter_is_seeded_and_bounded(seed):
    delays = []
    for r in RETRY:
        policy = r.BackoffPolicy(retries=8, base_s=1.0, factor=1.0,
                                 max_s=1.0, jitter=0.25)
        delays.append(r.backoff_delays(policy, seed=seed))
    # The port's jittered schedule is the reference's exactly.
    assert delays[0] == delays[1]
    a = delays[1]
    assert a != tretry.backoff_delays(
        tretry.BackoffPolicy(retries=8, base_s=1.0, factor=1.0, max_s=1.0,
                             jitter=0.25), seed=seed + 1)
    assert all(0.75 <= d <= 1.25 for d in a)
    assert len(set(a)) > 1


def test_retry_call_succeeds_after_transient_failures():
    for r in RETRY:
        slept = []
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        out = r.retry_call(
            flaky,
            policy=r.BackoffPolicy(retries=4, base_s=0.1, factor=2.0,
                                   jitter=0.0),
            retry_on=(OSError,), sleep=slept.append,
        )
        assert out == "ok"
        assert calls["n"] == 3
        assert slept == [0.1, 0.2]


def test_retry_budget_exhaustion_reraises_last_error():
    for r in RETRY:
        slept = []

        def always():
            raise ValueError("permanent")

        with pytest.raises(ValueError, match="permanent"):
            r.retry_call(
                always,
                policy=r.BackoffPolicy(retries=2, base_s=0.5, jitter=0.0),
                sleep=slept.append,
            )
        assert slept == [0.5, 1.0]


def test_non_retryable_exception_propagates_immediately():
    for r in RETRY:
        slept = []

        def typed():
            raise KeyError("wrong kind")

        with pytest.raises(KeyError):
            r.retry_call(typed, retry_on=(OSError,), sleep=slept.append)
        assert slept == []


def test_on_retry_callback_sees_attempt_exc_delay():
    seen_by = []
    for r in RETRY:
        seen = []

        def flaky(seen=seen):
            if len(seen) < 2:
                raise OSError("again")
            return 1

        r.retry_call(
            flaky,
            policy=r.BackoffPolicy(retries=3, base_s=0.1, factor=3.0,
                                   jitter=0.0),
            retry_on=(OSError,), sleep=lambda _d: None,
            on_retry=lambda a, e, d, seen=seen: seen.append((a, str(e), d)),
        )
        assert seen == [(0, "again", 0.1), (1, "again", pytest.approx(0.3))]
        seen_by.append(seen)
    assert seen_by[0] == seen_by[1]


def test_zero_retries_means_one_attempt():
    for r in RETRY:
        calls = {"n": 0}

        def once():
            calls["n"] += 1
            raise OSError("no")

        with pytest.raises(OSError):
            r.retry_call(once, policy=r.BackoffPolicy(retries=0),
                         sleep=lambda _d: None)
        assert calls["n"] == 1


@pytest.mark.parametrize("kw", [
    {"retries": -1}, {"factor": 0.5}, {"jitter": 1.0}, {"base_s": -1.0},
])
def test_policy_validation(kw):
    for r in RETRY:
        with pytest.raises(ValueError):
            r.BackoffPolicy(**kw)


def test_urlopen_json_rides_out_a_refused_connection(monkeypatch):
    """The HTTP client of the check and chaos scripts: connection errors
    retried on the policy's schedule, HTTP error statuses returned."""
    import json
    import socket
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            code = 200 if self.path == "/ok" else 503
            data = json.dumps({"path": self.path}).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        assert tretry.urlopen_json(base + "/ok")[:2] == (200, {"path": "/ok"})
        assert tretry.urlopen_json(base + "/busy")[:2] == (
            503, {"path": "/busy"})
        # A port nothing listens on: every attempt refused, the schedule
        # slept, the last error raised.
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
        s.close()
        slept = []
        policy = tretry.BackoffPolicy(retries=2, base_s=0.01, jitter=0.0)
        with pytest.raises(OSError):
            tretry.urlopen_json(f"http://127.0.0.1:{dead}/x", policy=policy,
                                sleep=slept.append, timeout=2.0)
        assert slept == tretry.backoff_delays(policy) == \
            jretry.backoff_delays(jretry.BackoffPolicy(
                retries=2, base_s=0.01, jitter=0.0))
    finally:
        srv.shutdown()
        srv.server_close()


def test_checkpoint_save_retries_on_the_policy(tmp_path):
    """CheckpointManager(save_retry=): an injected checkpoint_save failure
    is retried on the policy's schedule (counted in save_retries), and
    max_to_keep prunes the oldest (mirrors tests/test_trainer_faults.py's
    save leg at the manager)."""
    import types

    import torch

    from oryx_tpu_torch.utils.checkpoint import CheckpointManager

    model = torch.nn.Linear(2, 2)
    state = types.SimpleNamespace(params=model, step=1, opt_state={
        "m": torch.zeros(2)})
    slept = []
    mgr = CheckpointManager(
        str(tmp_path), max_to_keep=2,
        save_retry=tretry.BackoffPolicy(retries=3, base_s=0.5, jitter=0.0),
        sleep=slept.append,
    )
    tfaults.configure("checkpoint_save:times=2")
    assert mgr.save(1, state, ["weight"]) is True
    assert slept == [0.5, 1.0] and mgr.save_retries == 2
    tfaults.configure(None)
    for step in (2, 3):
        state.step = step
        mgr.save(step, state, ["weight"])
    assert mgr.steps() == [2, 3]
    tfaults.configure("checkpoint_restore:after=0")
    with pytest.raises(tfaults.FaultInjected):
        mgr.restore(state)
    tfaults.configure(None)
    assert mgr.restore(state).step == 3
