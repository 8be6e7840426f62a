"""The port's OpenAI-compatible server against the JAX package's: the
same sequential requests (text, a PNG image, multi-turn, streamed, seeded
sampling, stop strings, bad input) to a JAX server and the port's server
on the same tiny weights give identical replies, finish reasons, usage,
SSE chunk sequences and status codes, over the window engine and the
split and ragged continuous engines. Then the /metrics families (JAX's
minus the families of modules not ported yet), the counters, the cost
ledgers, the trace spans and the debug endpoints (the observatories'
bodies as the JAX server's); 429 / 504 / 503 as the JAX server answers
them; the options not ported yet and the observatories' flags; and
scripts/check_serving_endpoints.py's `run_checks`, unchanged, with one
scripts/loadgen.py stage, against the port's server (mirrors
tests/test_api_server.py and the HTTP half of
tests/test_containment.py)."""

import base64
import importlib.util
import json
import os
import re
import threading
import time
import urllib.request

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu.serve import api_server as japi  # noqa: E402
from oryx_tpu.utils.metrics import (  # noqa: E402
    histogram_quantile,
    parse_prom_histogram,
)
from oryx_tpu_torch.serve import api_server as tapi  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils.metrics import REQUEST_COST_KEYS  # noqa: E402

from torch_serve_common import (  # noqa: E402
    Server,
    bomb_png,
    image,
    make_pipes,
    png_uri,
    sse_chunks,
)

LEDGER = ("prefill_tokens", "cached_tokens", "decode_steps",
          "decode_tokens", "peak_pages")
ENGINES = {
    "window": dict(engine="window"),
    "split": dict(engine="continuous", num_slots=2, page_size=16,
                  decode_chunk=4, max_ctx=512),
    "ragged": dict(engine="continuous", num_slots=2, page_size=16,
                   decode_chunk=4, max_ctx=512, ragged=True,
                   prefill_chunk=32),
}
DEBUG_PATHS = ("/debug/timeline?n=0", "/debug/pages?format=summary",
               "/debug/pages", "/debug/oom", "/debug/audit")


@pytest.fixture(scope="module")
def pipes():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield make_pipes()
    jax.config.update("jax_default_matmul_precision", old)


def _user(text, img=None):
    content = text if img is None else [
        {"type": "text", "text": text},
        {"type": "image_url", "image_url": {"url": png_uri(img)}},
    ]
    return [{"role": "user", "content": content}]


def _requests(stop_char):
    """(request id, body) in order: the sequential mix of every engine."""
    multi = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": png_uri(image(1))}},
        ]},
        {"role": "assistant", "content": "a picture"},
        {"role": "user", "content": "why?"},
    ]
    return [
        ("r-text", {"messages": _user("hello there"), "max_tokens": 6}),
        ("r-image", {"messages": _user("what is this?", image(2)),
                     "max_tokens": 5}),
        ("r-multi", {"messages": multi, "max_tokens": 7}),
        ("r-history", {"messages": [
            {"role": "user", "content": "hi"},
            {"role": "assistant", "content": "hello"},
            {"role": "user", "content": "tell me more"}], "max_tokens": 8}),
        ("r-stream", {"messages": _user("tell me a story"),
                      "max_tokens": 9, "stream": True,
                      "stream_options": {"include_usage": True}}),
        ("r-stream-img", {"messages": _user("describe", image(3, 28, 28)),
                          "max_tokens": 4, "stream": True}),
        ("r-seeded", {"messages": _user("hello there"), "max_tokens": 6,
                      "temperature": 0.7, "top_p": 0.01, "seed": 3}),
        ("r-stop", {"messages": _user("hello there"), "max_tokens": 6,
                    "stop": [stop_char]}),
        ("r-stop-stream", {"messages": _user("hello there"),
                           "max_tokens": 6, "stop": stop_char,
                           "stream": True}),
        # Bad input: status codes only.
        ("e-n", {"messages": _user("q"), "n": 2}),
        ("e-logprobs", {"messages": _user("q"), "logprobs": True}),
        ("e-img-assistant", {"messages": [
            {"role": "user", "content": "q"},
            {"role": "assistant", "content": [
                {"type": "image_url",
                 "image_url": {"url": png_uri(image(4))}}]},
            {"role": "user", "content": "and?"}]}),
        ("e-img-late", {"messages": [
            {"role": "user", "content": "q"},
            {"role": "assistant", "content": "a"},
            {"role": "user", "content": [
                {"type": "image_url",
                 "image_url": {"url": png_uri(image(5))}}]}]}),
        ("e-img-bomb", {"messages": [{"role": "user", "content": [
            {"type": "text", "text": "q"},
            {"type": "image_url", "image_url": {
                "url": "data:image/png;base64,"
                + base64.b64encode(bomb_png()).decode()}}]}]}),
        ("e-max0", {"messages": _user("q"), "max_tokens": 0}),
        ("e-max-limit", {"messages": _user("q"), "max_tokens": 100}),
        ("e-temp", {"messages": _user("q"), "temperature": 3.0}),
        ("e-roles", {"messages": [{"role": "assistant", "content": "x"}]}),
        ("e-stream-opts", {"messages": _user("q"),
                           "stream_options": {"include_usage": True}}),
    ]


def _norm(code, body):
    """A response cut to what must match: status; replies, finish reasons,
    usage and the ledger's token fields; SSE chunks without ids/stamps;
    an error's type."""
    if isinstance(body, list):
        return code, sse_chunks(body)
    if code != 200:
        return code, body["error"].get("type")
    out = {k: body[k] for k in ("object", "model", "choices", "usage")}
    if "oryx" in body:
        out["cost"] = {k: body["oryx"]["cost"][k] for k in LEDGER}
    return code, out


def _serve_all(api, pipe, kw, reqs):
    s = Server(api.build_server(pipe, port=0, max_tokens_limit=64, **kw))
    try:
        out = {}
        for rid, body in reqs:
            code, hdr, resp = s.post(body, headers={"X-Request-Id": rid})
            out[rid] = _norm(code, resp)
            if code == 200:
                assert hdr["X-Request-Id"] == rid
            # The reply is released inside the harvest, before the step's
            # timeline record: the next submit waits for that record.
            s.quiesce()
        text = s.get("/metrics")[2]
        traces = {rid: s.get(f"/debug/trace?id={rid}")[2]
                  for rid, _ in reqs[:9]}
        done = json.loads(s.get("/debug/requests?state=done")[2])
        debug = {path: s.get(path)[::2] for path in DEBUG_PATHS}
        return out, text, traces, done, debug
    finally:
        s.close()


def _families(text):
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _span_names(trace_json):
    return [e["name"] for e in json.loads(trace_json)["traceEvents"]
            if e["ph"] == "X"]


@pytest.fixture(scope="module")
def served(pipes):
    """Both servers' answers to the mix, per engine."""
    jp, tp = pipes
    stop_char = None
    out = {}
    for name, kw in ENGINES.items():
        if stop_char is None:
            probe = Server(tapi.build_server(tp, port=0, **kw))
            reply = probe.post({"messages": _user("hello there"),
                                "max_tokens": 6})[2]
            probe.close()
            stop_char = reply["choices"][0]["message"]["content"][2]
        reqs = _requests(stop_char)
        out[name] = (_serve_all(japi, jp, kw, reqs),
                     _serve_all(tapi, tp, kw, reqs), reqs)
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_replies_usage_sse_and_codes_equal_jax(served, engine):
    (want, *_), (got, *_), reqs = served[engine]
    for rid, _ in reqs:
        assert got[rid] == want[rid], rid
    codes = {rid: got[rid][0] for rid, _ in reqs}
    assert all(c == 200 for r, c in codes.items() if r.startswith("r-"))
    assert all(c == 400 for r, c in codes.items() if r.startswith("e-"))
    # The stop string really cut the reply.
    stop = got["r-stop"][1]["choices"][0]
    assert stop["finish_reason"] == "stop"
    assert len(stop["message"]["content"]) == 2
    # SSE: deltas, a finish chunk, the usage chunk, [DONE].
    chunks = got["r-stream"][1]
    assert chunks[-1] == "[DONE]" and chunks[-2]["choices"] == []
    assert chunks[-2]["usage"]["completion_tokens"] == 9
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks[:-3])
    assert text and chunks[-3]["choices"][0]["finish_reason"] == "length"


@pytest.mark.parametrize("engine", list(ENGINES))
def test_metrics_families_and_counters_equal_jax(served, engine):
    (_, jtext, *_), (_, text, *_), _ = served[engine]
    # Exactly the JAX server's families, the device-time ones included.
    assert _families(text) == _families(jtext)
    if engine != "window":
        assert "oryx_device_time_seconds_total" in _families(text)
    if engine == "window":
        names = ("completed", "decode_steps_total", "decode_steps_useful")
    else:
        names = ("admitted", "completed", "prefill_tokens_total",
                 "prefix_cache_hit_tokens_total", "chunks",
                 "decode_steps_total", "decode_steps_useful")
    for name in names:
        pat = rf"^oryx_serving_{name} (\S+)$"
        assert re.search(pat, text, re.M).group(1) == \
            re.search(pat, jtext, re.M).group(1), name


@pytest.mark.parametrize("engine", list(ENGINES))
def test_trace_spans_and_ledgers_equal_jax(served, engine):
    (_, _, jtraces, jdone, _), (_, _, traces, done, _), reqs = \
        served[engine]
    for rid, _ in reqs[:9]:
        assert _span_names(traces[rid]) == _span_names(jtraces[rid]), rid
    if engine == "window":
        return
    assert {"queue_wait", "admission", "prompt_prep", "prefill",
            "decode_chunk", "emission"} <= set(_span_names(traces["r-text"]))
    jcost = {r["id"]: r["meta"]["cost"] for r in jdone["requests"]}
    assert {r["id"] for r in done["requests"]} == set(jcost)
    for r in done["requests"]:
        assert r["done"] and list(r["meta"]["cost"]) == \
            list(REQUEST_COST_KEYS)
        assert {k: r["meta"]["cost"][k] for k in LEDGER} == \
            {k: jcost[r["id"]][k] for k in LEDGER}, r["id"]


def _untimed_debug(path, code, body):
    """A debug endpoint's answer without its clocks: the timeline's
    record times, the page map's ages and idle times (their None-ness
    kept) and the time quantiles of its summary."""
    body = json.loads(body)
    if code != 200:
        return code, body
    for rec in body.get("records", []):
        for k in ("ts_unix_s", "dur_s", "audit_s"):
            rec.pop(k, None)
    for rec in body.get("pages", []):
        rec["resident"] = rec.pop("age_s") is not None and \
            rec.pop("idle_s") is not None
    if "summary" in body:
        for k in ("resident_age_s", "resident_idle_s"):
            body["summary"][k] = body["summary"][k]["n"]
    return code, body


@pytest.mark.parametrize("engine", list(ENGINES))
def test_debug_endpoints_equal_jax(served, engine):
    """/debug/timeline, /pages (json and summary), /oom and /audit after
    the mix answer as the JAX server's (times left out); the window engine
    answers each with the JAX server's 400."""
    (*_, jdebug), (*_, debug), _ = served[engine]
    for path in DEBUG_PATHS:
        assert _untimed_debug(path, *debug[path]) == \
            _untimed_debug(path, *jdebug[path]), path
    codes = {debug[path][0] for path in DEBUG_PATHS}
    assert codes == ({400} if engine == "window" else {200})
    if engine != "window":
        tl = json.loads(debug["/debug/timeline?n=0"][1])
        assert tl["records"] and \
            tl["total_steps"] == sum(tl["counts_by_kind"].values())
        assert json.loads(debug["/debug/pages"][1])["summary"]["reconciled"]


@pytest.mark.parametrize("option,value,reads", [
    ("audit_sample_every", 4, lambda sc: sc.auditor.sample_every),
    ("audit_tol_maxdiff", 0.25, lambda sc: sc.auditor.fail_abs_tol),
    ("audit_tol_kl", 0.03, lambda sc: sc.auditor.fail_kl_tol),
    ("numerics_every", 8, lambda sc: sc.numerics_every),
])
def test_observatory_flags_reach_the_engine(pipes, option, value, reads):
    """Each flag reaches the auditor or the numerics cadence, as in the JAX
    server, over an int8 pool (the auditor's quantized twin armed); the
    window engine refuses the two that arm something."""
    jp, tp = pipes
    for api, pipe in ((tapi, tp), (japi, jp)):
        srv = api.build_server(pipe, port=0, engine="continuous",
                               kv_dtype="int8", **{option: value})
        try:
            assert reads(srv.scheduler) == value
            assert srv.scheduler.auditor.compare_quant
        finally:
            srv.scheduler.close()
            if srv.supervisor is not None:
                srv.supervisor.stop()
            srv.server_close()
        if option in ("audit_sample_every", "numerics_every"):
            with pytest.raises(ValueError, match="scheduler engine"):
                api.build_server(pipe, port=0, engine="window",
                                 **{option: value})


def _script(name):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_endpoint_gate_passes_on_the_port(pipes, tmp_path):
    """scripts/check_serving_endpoints.py's `run_checks`, as written for
    the JAX server, against the port's tiny ragged replica: it returns
    "replica". Then one scripts/loadgen.py stage against the same server
    carries the step timeline and the page map in its report."""
    _, tp = pipes
    s = Server(tapi.build_server(tp, port=0, **ENGINES["ragged"]))
    try:
        assert _script("check_serving_endpoints").run_checks(s.base) == \
            "replica"
        for path in ("/debug/timeline?n=-1", "/debug/oom?n=x",
                     "/debug/audit?n=-2", "/debug/pages?format=bogus"):
            assert s.get(path)[0] == 400, path
        report = _script("loadgen").run([
            "--base-url", s.base, "--rates", "2", "--duration", "2",
            "--drain-s", "60", "--max-tokens-choices", "4,8",
            "--out", str(tmp_path / "loadgen.json"),
        ])
        (stage,) = report["stages"]
        assert stage["ok"] == stage["sent"] >= 1
        tl = stage["timeline"]
        assert tl["records"] and set(tl["counts_by_kind"]) == {"ragged"}
        mem = stage["memory"]
        assert mem["end"]["reconciled"] and mem["pool"]["num_pages"] == 64
        assert mem["page_lifetime_s"]["count"] >= 1
    finally:
        s.close()


def test_armed_server_never_perturbs_and_audits_reconcile(pipes):
    """The same sequential greedy requests to a server with
    audit_sample_every=1 and numerics_every=4 and to an unarmed one:
    byte-equal replies and dispatch counts; every audit passes, the
    /debug/audit totals equal oryx_audit_total, and each record joins one
    kind="audit" wide event (check_serving_endpoints.run_audit_check)."""
    _, tp = pipes
    bodies = [{"messages": _user(q), "max_tokens": n} for q, n in (
        ("hello there, audit me", 6), ("a different question now", 4),
        ("hello there, audit me", 6), ("one more to finish", 5))]
    out = []
    for armed in (True, False):
        kw = dict(audit_sample_every=1, numerics_every=4) if armed else {}
        s = Server(tapi.build_server(tp, port=0, **ENGINES["ragged"], **kw))
        try:
            replies = [s.post(b)[2]["choices"][0]["message"]["content"]
                       for b in bodies]
            end = time.monotonic() + 120
            while time.monotonic() < end:
                au = json.loads(s.get("/debug/audit?n=64")[2])
                if au["pending"] == 0 and au["total"] >= len(bodies) * armed:
                    break
                time.sleep(0.05)
            text = s.get("/metrics")[2]
            events = [json.loads(ln) for ln in s.get(
                "/debug/requests?format=jsonl")[2].splitlines() if ln]
        finally:
            s.close()
        dispatches = re.findall(
            r'^oryx_serving_dispatches_total\{kind="([^"]+)"\} (\S+)$',
            text, re.M)
        out.append((replies, dispatches, au, text, events))
    (replies, disp, au, text, events), (ureplies, udisp, uau, _, _) = out
    assert replies == ureplies and disp == udisp
    assert au["verdicts"] == {"pass": 4, "drift": 0, "fail": 0}
    assert uau["total"] == uau["sampled"] == 0
    for verdict, n in au["verdicts"].items():
        assert re.search(rf'^oryx_audit_total\{{verdict="{verdict}"\}} '
                         rf"{n}$", text, re.M), verdict
    assert re.search(r"^oryx_numerics_samples_total [1-9]", text, re.M)
    audits = {e["audit_index"]: e for e in events
              if e.get("kind") == "audit"}
    assert sorted(audits) == sorted(r["index"] for r in au["records"])
    for rec in au["records"]:
        assert audits[rec["index"]]["request_id"] == rec["request_id"]
        assert audits[rec["index"]]["verdict"] == rec["verdict"]


def test_sampled_replies_match_the_ports_own_engines(pipes):
    """Seeded sampling at temperature 0.9 draws other numbers than JAX's
    sampler; over HTTP it gives the port's in-process replies, twice."""
    _, tp = pipes
    body = {"messages": _user("hello there"), "max_tokens": 8,
            "temperature": 0.9, "seed": 5}
    req = {"question": "hello there", "images": [], "is_video": False,
           "history": []}
    for name, kw in ENGINES.items():
        s = Server(tapi.build_server(tp, port=0, **kw))
        try:
            a, b = (s.post(body)[2]["choices"][0]["message"]["content"]
                    for _ in range(2))
        finally:
            s.close()
        if name == "window":
            want = tp.chat_batch([req], max_new_tokens=16, per_row_max=[8],
                                 temperature=0.9, seed=5)[0]
        else:
            sched = ContinuousScheduler(
                tp, autostart=False, num_slots=2, page_size=16, chunk=4,
                max_ctx=512, ragged=kw.get("ragged", False),
                prefill_chunk=kw.get("prefill_chunk"))
            h = sched.submit(req, 8, {"temperature": 0.9, "seed": 5})
            sched.start()
            want = h.result(timeout=600)[0]
            sched.close()
        assert a == b == want, name


def test_endpoint_checks_on_the_port(pipes):
    """The checks of scripts/check_serving_endpoints.py that apply to the
    port's replica, with the JAX package's quantile helpers."""
    _, tp = pipes
    s = Server(tapi.build_server(tp, port=0, **ENGINES["ragged"]))
    try:
        code, hdr, text = s.get("/metrics")
        assert code == 200
        assert hdr["Content-Type"] == "text/plain; version=0.0.4"
        prefixes = ("oryx_serving_", "oryx_anomaly_", "oryx_pool_",
                    "oryx_page_", "oryx_audit_", "oryx_numerics_",
                    "oryx_cache_", "oryx_device_time_", "oryx_profile_")
        assert [ln for ln in text.splitlines()
                if ln and not ln.startswith("#")
                and not ln.startswith(prefixes)] == []
        assert re.search(r'^oryx_serving_build_info\{[^}]*engine='
                         r'"continuous"[^}]*\} 1$', text, re.M)
        assert 'revision="' in text
        for fam in ("oryx_serving_hbm_live_bytes",
                    "oryx_cache_spilled_pages", "oryx_cache_host_bytes",
                    "oryx_cache_reload_hit_total",
                    "oryx_cache_reload_upload_total"):
            assert re.search(rf"^{fam} ", text, re.M), fam
        assert re.search(r'^oryx_pool_kv_dtype\{kv_dtype="bf16"\} 1$',
                         text, re.M)
        assert json.loads(s.get("/healthz")[2]) == {"status": "ok"}
        assert json.loads(s.get("/readyz")[2]) == {"ready": True,
                                                   "reason": "ok"}
        assert s.get("/v1/models")[0] == 200
        _, hdr, _ = s.post({"messages": _user("hello there"),
                            "max_tokens": 4},
                           headers={"X-Request-Id": "endpoint-check-1"})
        assert hdr["X-Request-Id"] == "endpoint-check-1"
        sysmsg = "You are a helpful assistant. " * 6
        for i in range(3):
            s.post({"messages": [{"role": "system", "content": sysmsg},
                                 {"role": "user", "content": f"q {i}?"}],
                    "max_tokens": 3})
        text = s.get("/metrics")[2]
        for fam in ("prefix_cache_hit_tokens_total",
                    "prefix_cache_miss_tokens_total",
                    "prefix_cache_evicted_pages_total",
                    "prefix_cache_entries", "prefix_cache_pages",
                    "prefill_tokens_total"):
            assert re.search(rf"^oryx_serving_{fam} ([0-9.e+-]+)$", text,
                             re.M), fam
        assert float(re.search(
            r"^oryx_serving_prefix_cache_hit_tokens_total (\S+)$", text,
            re.M).group(1)) > 0
        assert re.search(r'^oryx_serving_prefill_chunk_tokens_bucket\{le='
                         r'"\+Inf"\} [1-9]', text, re.M)
        bounds, counts, total, _ = parse_prom_histogram(
            text, "oryx_serving_ttft_seconds")
        assert total >= 4
        p50 = histogram_quantile(0.5, bounds, counts, total)
        p99 = histogram_quantile(0.99, bounds, counts, total)
        assert 0 < p50 <= p99
        assert re.search(r"^oryx_serving_request_page_seconds_count [1-9]",
                         text, re.M)
        lim = json.loads(s.get("/debug/requests?limit=1")[2])
        assert lim["returned"] == 1 and lim["total"] >= 4
        done = json.loads(s.get("/debug/requests?state=done")[2])
        assert done["requests"]
        for rec in done["requests"]:
            assert rec["done"]
            assert set(REQUEST_COST_KEYS) <= set(rec["meta"]["cost"])
        assert s.get("/debug/requests?state=bogus")[0] == 400
        tr = json.loads(s.get("/debug/trace?id=endpoint-check-1")[2])
        names = {e["name"] for e in tr["traceEvents"]}
        assert {"queue_wait", "prefill", "decode_chunk"} <= names
        assert s.get("/debug/trace")[0] == 400
        assert s.get("/debug/trace?id=nope")[0] == 404
    finally:
        s.close()


def test_http_backpressure_deadline_and_drain_as_jax(pipes):
    """429 + Retry-After on a full queue, 504 past a deadline, 503 once
    draining (readyz and POST): the JAX server's codes and error types."""
    jp, tp = pipes
    kw = dict(engine="continuous", num_slots=1, page_size=16,
              decode_chunk=4, max_ctx=512)
    out = []
    for api, pipe in ((japi, jp), (tapi, tp)):
        s = Server(api.build_server(pipe, port=0, max_queue=1, **kw))
        sched = s.srv.scheduler
        done = []
        threads = [threading.Thread(target=lambda n=n, i=i: done.append(
            s.post({"messages": _user(f"load {i}"), "max_tokens": n})[0]))
            for i, n in enumerate((256, 2))]
        threads[0].start()
        end = time.monotonic() + 120
        while sched.slots[0] is None and time.monotonic() < end:
            time.sleep(0.005)
        threads[1].start()
        while sched.queue_len() < 1 and time.monotonic() < end:
            time.sleep(0.005)
        code, hdr, body = s.post({"messages": _user("over the cap"),
                                  "max_tokens": 2})
        over = (code, int(hdr["Retry-After"]) >= 1, body["error"]["type"],
                body["error"]["reason"])
        for t in threads:
            t.join()
        s.close()
        s = Server(api.build_server(pipe, port=0, request_timeout=0.01,
                                    **kw))
        code, _, body = s.post({"messages": _user("too slow"),
                                "max_tokens": 300})
        late = (code, body["error"]["type"])
        s.close()
        s = Server(api.build_server(pipe, port=0, **kw))
        ready0 = s.get("/readyz")[0]
        s.srv.begin_drain()
        rz = s.get("/readyz")
        code, hdr, body = s.post({"messages": _user("post-drain"),
                                  "max_tokens": 2})
        drain = (ready0, rz[0], json.loads(rz[2])["reason"], code,
                 body["error"]["type"], bool(hdr.get("Retry-After")),
                 s.srv.scheduler.drain(timeout=120))
        s.close()
        out.append((sorted(done), over, late, drain))
    assert out[1] == out[0]
    assert out[1][1][0] == 429 and out[1][2][0] == 504
    assert out[1][3][1] == out[1][3][3] == 503


def _profile_body(s):
    """GET /debug/profile while three requests run: (status, body)."""
    got = {}
    th = threading.Thread(target=lambda: got.update(
        r=s.get("/debug/profile?steps=2&timeout=60", timeout=120)))
    th.start()
    time.sleep(0.2)
    for i in range(3):
        s.post({"messages": _user(f"profile me {i}"), "max_tokens": 6})
    th.join(timeout=120)
    code, _, text = got["r"]
    return code, json.loads(text)


def test_journal_and_profile_endpoints_equal_jax(pipes, tmp_path):
    """/debug/journal (disarmed and armed) and /debug/profile answer with
    the JAX server's bodies: the same keys and defaults, the same 400s for
    bad queries, 503 with Retry-After on an idle engine, the same 400 on
    the window engine; a capture over live traffic returns the Chrome
    trace and the per-kind attribution."""
    jp, tp = pipes
    out = []
    for api, pipe, tag in ((japi, jp, "j"), (tapi, tp, "t")):
        res = {}
        s = Server(api.build_server(pipe, port=0, **ENGINES["ragged"]))
        try:
            res["disarmed"] = json.loads(s.get("/debug/journal")[2])
            for q in ("steps=0", "steps=257", "steps=x", "timeout=x"):
                code, _, text = s.get(f"/debug/profile?{q}")
                res[q] = (code, json.loads(text))
            code, hdr, text = s.get("/debug/profile?steps=1&timeout=0.1")
            res["idle"] = (code, hdr.get("Retry-After"),
                           json.loads(text)["error"].split(" (")[0])
            code, body = _profile_body(s)
            res["capture"] = (code, sorted(body), body["steps"],
                              body["engine"], body["truncated"],
                              set(body["device_time_us"]) <= {"ragged"},
                              body["source"])
            assert any(e["ph"] == "X" for e in body["traceEvents"])
        finally:
            s.close()
        path = str(tmp_path / f"{tag}.jsonl")
        s = Server(api.build_server(pipe, port=0, journal_path=path,
                                    **ENGINES["ragged"]))
        try:
            s.post({"messages": _user("journal me"), "max_tokens": 4})
            s.quiesce()
            body = json.loads(s.get("/debug/journal?n=2")[2])
            res["armed"] = (sorted(body), body["armed"], body["path"] == path,
                            len(body["entries"]), body["counts_by_kind"],
                            sorted(body["header"]["config"]),
                            body["header"]["config"]["model"])
            res["bad_n"] = s.get("/debug/journal?n=-1")[0]
        finally:
            s.close()
            s.srv.journal.close()
        s = Server(api.build_server(pipe, port=0, engine="window"))
        try:
            res["window"] = [(c, json.loads(t)) for c, _, t in (
                s.get("/debug/journal"), s.get("/debug/profile"))]
        finally:
            s.close()
        out.append(res)
    assert out[1] == out[0]
    assert out[1]["disarmed"]["armed"] is False
    assert out[1]["idle"][:2] == (503, "1")
    assert out[1]["capture"][0] == 200 and out[1]["capture"][2] == 2
    assert out[1]["steps=0"][0] == out[1]["timeout=x"][0] == 400


@pytest.mark.parametrize("option,value,reads,window_refuses", [
    ("journal_path", "journal.jsonl",
     lambda srv: (os.path.basename(srv.scheduler.journal.path),
                  srv.journal is srv.scheduler.journal,
                  srv.scheduler.journal.header["config"]["model"]), True),
    ("faults_spec", "engine_crash:after=100",
     lambda srv: "# TYPE oryx_faults_injected_total counter"
     in srv.metrics.render(), False),
    ("profile_sample_every", 8, lambda srv: srv.scheduler.profiler.every,
     True),
    ("ttft_slo", 1.0, lambda srv: srv.anomaly.thresholds.ttft_slo_s, True),
    ("queue_depth_slo", 4,
     lambda srv: srv.anomaly.thresholds.queue_depth_slo, True),
])
def test_formerly_cut_options_reach_their_modules(pipes, tmp_path, option,
                                                  value, reads,
                                                  window_refuses):
    """Each option build_server used to refuse reaches its module as the
    JAX server wires it (the journal and its header, the fault registry
    bound to /metrics, the sampler's cadence, the SLO detectors behind the
    degraded ladder), and the window engine refuses it where JAX's
    does."""
    from oryx_tpu.utils import faults as jfaults
    from oryx_tpu_torch.utils import faults as tfaults

    jp, tp = pipes
    if option == "journal_path":
        value = str(tmp_path / value)
    got = []
    for api, pipe, fmod in ((japi, jp, jfaults), (tapi, tp, tfaults)):
        srv = api.build_server(pipe, port=0, engine="continuous",
                               **{option: value})
        try:
            got.append(reads(srv))
        finally:
            srv.scheduler.close()
            if srv.supervisor is not None:
                srv.supervisor.stop()
            if getattr(srv, "journal", None) is not None:
                srv.journal.close()
            srv.server_close()
            fmod.reset()
        if window_refuses:
            with pytest.raises(ValueError, match="scheduler engine"):
                api.build_server(pipe, port=0, engine="window",
                                 **{option: value})
    assert got[1] == got[0]
    assert got[1] not in (None, False, 0)


def test_main_refuses_shard_and_needs_a_card_for_cuda(monkeypatch):
    """A malformed --shard, int8 with --shard (tp or fsdp) and --engine
    sharded without it are argument errors, as in JAX's main (tp=N and
    fsdp=N themselves run: tests/test_torch_tp_serving.py,
    tests/test_torch_fsdp_serving.py)."""
    import torch

    for argv in (["--shard", "tp=x"], ["--shard", "fsdp=0"],
                 ["--shard", "tp=2", "--quantize", "int8"],
                 ["--shard", "fsdp=2", "--quantize", "int8"],
                 ["--engine", "sharded"]):
        with pytest.raises(SystemExit):
            tapi.main(["--model-path", "x", "--device", "cpu"] + argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tapi.main(["--model-path", "/nonexistent"])


def test_pairing_checks_as_jax(pipes):
    jp, tp = pipes
    for kw in (dict(engine="window", ragged=True),
               dict(engine="continuous", speculate=2),
               dict(engine="window", fuse_steps=4),
               dict(engine="continuous", fuse_steps=4),
               dict(engine="continuous", draft_model="init:8:8:8:0"),
               dict(engine="window", request_timeout=5.0),
               dict(engine="window", kv_dtype="int8")):
        for api, pipe in ((japi, jp), (tapi, tp)):
            with pytest.raises(ValueError):
                api.build_server(pipe, port=0, **kw)


def test_parse_messages_and_sampling_equal_jax():
    msgs = [
        {"role": "developer", "content": "be brief"},
        {"role": "system", "content": "in French"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is this?"},
            {"type": "image_url", "image_url": {"url": png_uri(image(7))}},
        ]},
        {"role": "assistant", "content": "a cat"},
        {"role": "user", "content": "why?"},
    ]
    q, hist, imgs = tapi.parse_messages(msgs)
    jq, jhist, jimgs = japi.parse_messages(msgs)
    assert (q, hist) == (jq, jhist)
    assert len(imgs) == len(jimgs) == 1
    assert (imgs[0] == jimgs[0]).all()
    for body in ({"temperature": 0.123, "top_p": 0.456, "stop": "x",
                  "seed": 4}, {"stop": ["a", "", "b"]}, {}):
        assert tapi._parse_sampling(body) == japi._parse_sampling(body)
    for bad in ({"n": 2}, {"logprobs": True}, {"temperature": -1},
                {"top_p": 0}, {"stop": ["x"] * 9}):
        for api in (tapi, japi):
            with pytest.raises(ValueError):
                api._parse_sampling(bad)
    with pytest.raises(ValueError, match="allow-local-files"):
        tapi.parse_messages([{"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "/etc/x.png"}}]}])
