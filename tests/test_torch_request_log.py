"""The port's wide-event request log against the JAX package's: schema
validation against REQUEST_EVENT_KEYS, the bounded ring and the
size-capped file with rotation, one event per terminal request on every
scheduler path (ok / rejected / cancelled / error, evictions counted) with
the same fields as the JAX engine's events on the same requests, and the
/debug/requests?format=jsonl export (mirrors tests/test_request_log.py)."""

import json
import math
import re

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu.utils.request_log import RequestLog as JaxLog  # noqa: E402
from oryx_tpu_torch.serve import api_server  # noqa: E402
from oryx_tpu_torch.serve.scheduler import (  # noqa: E402
    AdmissionRejected,
    ContinuousScheduler,
)
from oryx_tpu_torch.utils.metrics import (  # noqa: E402
    REQUEST_COST_KEYS,
    REQUEST_EVENT_KEYS,
)
from oryx_tpu_torch.utils.request_log import (  # noqa: E402
    RequestLog,
    build_request_event,
)

from torch_serve_common import Server, make_pipes  # noqa: E402

# Ledger fields that do not depend on wall time.
TOKEN_KEYS = ("prefill_tokens", "cached_tokens", "decode_steps",
              "decode_tokens", "peak_pages")
EVENT_KEYS = ("status", "error_kind", "finish_reason", "prompt_tokens",
              "completion_tokens", "streaming", "evictions", "routed",
              "engine", "replica", "accepted_tokens_per_step",
              "journal_seq") + TOKEN_KEYS


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _events(log):
    """Request events (the JAX log also carries oom_pressure events) in
    log order, each cut to the fields that do not depend on timing."""
    return [{k: e[k] for k in EVENT_KEYS}
            for e in log.snapshot() if "kind" not in e]


def test_registry_is_superset_of_cost_keys():
    assert set(REQUEST_COST_KEYS) < set(REQUEST_EVENT_KEYS)
    for k in REQUEST_EVENT_KEYS:
        assert re.match(r"^[a-z][a-z0-9_]*$", k), k


def test_build_request_event_validates_keys():
    ev = build_request_event(request_id="r1", status="ok")
    assert ev["schema"] == 1 and ev["ts_unix_s"] > 0
    with pytest.raises(ValueError, match="mystery_field"):
        build_request_event(**{"mystery_field": 1})
    with pytest.raises(ValueError, match="REQUEST_EVENT_KEYS"):
        build_request_event(**{"request_id": "r", "BadCase": 2})
    with pytest.raises(ValueError, match="sneaky"):
        RequestLog().append({"sneaky": 1})


def test_ring_and_file_with_rotation_equal_jax(tmp_path):
    files = []
    for cls, name in ((JaxLog, "jax"), (RequestLog, "port")):
        path = tmp_path / name / "requests.jsonl"
        log = cls(str(path), keep=4, max_bytes=400)
        for i in range(10):
            log.append({"schema": 1, "ts_unix_s": 0.0,
                        "request_id": f"r{i}", "status": "ok",
                        "prefill_tokens": i})
        assert log.total == 10
        assert [e["request_id"] for e in log.snapshot()] == \
            ["r6", "r7", "r8", "r9"]
        assert [e["request_id"] for e in log.snapshot(2)] == ["r8", "r9"]
        export = log.export_jsonl()
        log.close()
        files.append((export, path.read_text(),
                      (path.parent / "requests.jsonl.1").read_text()))
    assert files[1] == files[0]


def _terminal_paths(make, log):
    sched = make(log)
    ok = sched.submit({"question": "hello there"}, 4)
    gone = sched.submit({"question": "tell me more"}, 4)
    gone.cancelled = True  # cancelled while queued
    bad = sched.submit({"question": "hi"}, 2048)  # past max_ctx
    sched.start()
    ok.result(timeout=600)
    with pytest.raises(RuntimeError):
        bad.result(timeout=600)
    sched.close()
    return ok


def test_every_terminal_path_emits_one_event_as_jax(pipes, tmp_path):
    jp, tp = pipes
    kw = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
              autostart=False, replica_id="rA")
    jlog, log = JaxLog(), RequestLog(str(tmp_path / "req.jsonl"))
    with jax.default_matmul_precision("highest"):
        _terminal_paths(lambda lg: JaxScheduler(jp, request_log=lg, **kw),
                        jlog)
    ok = _terminal_paths(
        lambda lg: ContinuousScheduler(tp, request_log=lg, **kw), log)
    got, want = _events(log), _events(jlog)
    assert got == want
    # Admission rejects `bad` while `ok` still decodes.
    assert [e["status"] for e in got] == ["cancelled", "error", "ok"]
    e_ok = next(e for e in log.snapshot() if e["status"] == "ok")
    assert e_ok["request_id"] == ok.request_id
    for k in REQUEST_COST_KEYS:
        assert e_ok[k] == ok.debug["cost"][k], k
    lines = (tmp_path / "req.jsonl").read_text().splitlines()
    assert [json.loads(ln)["status"] for ln in lines] == \
        ["cancelled", "error", "ok"]


def test_submit_rejection_emits_rejected_event_as_jax(pipes):
    jp, tp = pipes
    out = []
    for cls, p, lg in ((JaxScheduler, jp, JaxLog()),
                       (ContinuousScheduler, tp, RequestLog())):
        sched = cls(p, num_slots=2, page_size=16, chunk=4, max_ctx=512,
                    autostart=False, request_log=lg, max_queue=1)
        sched.submit({"question": "hello there"}, 4)
        with pytest.raises(Exception) as e:
            sched.submit({"question": "tell me more"}, 4)
        assert type(e.value).__name__ == "AdmissionRejected"
        assert e.value.reason == "backpressure"
        sched.close()
        out.append(_events(lg))
    assert out[1] == out[0]
    assert out[1][0]["status"] == "rejected"
    assert out[1][0]["error_kind"] == "backpressure"
    assert AdmissionRejected is not None


def test_eviction_count_lands_in_event_as_jax(pipes):
    jp, tp = pipes
    q1, q2 = "hello there", "tell me more"
    chunk, ps = 4, 16
    ids1 = len(tp._prepare_request({"question": q1})[0])
    ids2 = len(tp._prepare_request({"question": q2})[0])
    admit1 = math.ceil((ids1 + chunk) / ps)
    admit2 = math.ceil((ids2 + chunk) / ps)
    cap = (admit1 * ps - ids1) + ps
    out = []
    for cls, p, lg in ((JaxScheduler, jp, JaxLog()),
                       (ContinuousScheduler, tp, RequestLog())):
        sched = cls(p, num_slots=2, page_size=ps, chunk=chunk, max_ctx=512,
                    num_pages=admit1 + admit2 + 1, autostart=False,
                    prefix_cache=False, request_log=lg)
        hs = [sched.submit({"question": q}, cap) for q in (q1, q2)]
        sched.start()
        with jax.default_matmul_precision("highest"):
            for h in hs:
                h.result(timeout=600)
        sched.close()
        out.append(_events(lg))
    assert out[1] == out[0]
    assert sum(e["evictions"] for e in out[1]) >= 1
    assert all(e["status"] == "ok" for e in out[1])


def test_jsonl_export_over_http(pipes):
    _, tp = pipes
    s = Server(api_server.build_server(
        tp, port=0, engine="continuous", num_slots=2, page_size=16,
        decode_chunk=4, max_ctx=512, prefill_chunk=32, replica_id="r9",
    ))
    try:
        rids = []
        for i in range(3):
            code, hdr, _ = s.post({
                "messages": [{"role": "user", "content": f"question {i}?"}],
                "max_tokens": 3,
            })
            assert code == 200
            rids.append(hdr["X-Request-Id"])
        code, hdr, text = s.get("/debug/requests?format=jsonl")
        assert code == 200 and hdr["Content-Type"] == "application/x-ndjson"
        events = [json.loads(ln) for ln in text.splitlines() if ln]
        assert [e["request_id"] for e in events] == rids
        for e in events:
            assert e["replica"] == "r9" and set(e) <= set(REQUEST_EVENT_KEYS)
        code, _, text = s.get("/debug/requests?format=jsonl&limit=1")
        lim = [ln for ln in text.splitlines() if ln]
        assert len(lim) == 1 and json.loads(lim[0])["request_id"] == rids[-1]
        assert s.get("/debug/requests?format=xml")[0] == 400
        assert s.get("/debug/requests?limit=-1")[0] == 400
    finally:
        s.close()
