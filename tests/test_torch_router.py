"""The port's prefix-affinity router against the JAX package's (mirrors
tests/test_router.py's 11 tests): the same fingerprints and affinity
decisions unit by unit; then a JAX router fronting two JAX replicas and the
port's router fronting two port replicas, on the same tiny weights, take the
same requests and give the same replies, the same chosen replica per
request, the same retry, error and drain status codes and router headers,
and the same router /metrics families."""

import json
import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu.serve import api_server as japi  # noqa: E402
from oryx_tpu.serve import router as jrouter  # noqa: E402
from oryx_tpu_torch.serve import api_server as tapi  # noqa: E402
from oryx_tpu_torch.serve import router as trouter  # noqa: E402

from torch_serve_common import make_pipes  # noqa: E402

SYS = ("You are a careful assistant. Study the context and answer "
       "briefly. " * 2)
ROUTERS = {"jax": jrouter, "torch": trouter}


@pytest.fixture(scope="module")
def pipes():
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    jp, tp = make_pipes()
    yield {"jax": (japi, jrouter, jp), "torch": (tapi, trouter, tp)}
    jax.config.update("jax_default_matmul_precision", old)


# ---------------------------------------------------------------------------
# Unit: fingerprint + affinity routing (no servers)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("messages", [
    [{"role": "system", "content": SYS},
     {"role": "user", "content": "question one?"}],
    [{"role": "system", "content": SYS},
     {"role": "user", "content": "a different question two?"}],
    [{"role": "user", "content": "no shared prefix at all"}],
    [{"role": "user", "content": [
        {"type": "text", "text": "hi"},
        {"type": "image_url", "image_url": {"url": "data:..."}}]}],
    [{"role": "user", "content": "x" * 5000}],
    [{"content": "no role"}, {"role": "user"}],
])
def test_prefix_fingerprint_equals_jax(messages):
    got = trouter.prefix_fingerprint(messages)
    want = jrouter.prefix_fingerprint(messages)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert trouter.FINGERPRINT_CAP == jrouter.FINGERPRINT_CAP
    assert len(got) <= trouter.FINGERPRINT_CAP


def _affinity_story(mod):
    """The JAX test's sticky / eject / restore / least-loaded sequence:
    (replica id, hit) of every decision, the transitions and the
    snapshot."""
    r = mod.PrefixAffinityRouter(
        [("r0", "http://127.0.0.1:1"), ("r1", "http://127.0.0.1:2")]
    )
    out = []

    def route(content, user="q1"):
        toks = mod.prefix_fingerprint([
            {"role": "system", "content": content},
            {"role": "user", "content": user},
        ])
        rep, hit = r.route(toks)
        out.append((rep.rid, hit))
        return rep

    first = route(SYS)
    for i in range(3):
        route(SYS, f"q{i + 2}")
    out.append(r.set_health(first.rid, False, "test eject"))
    route(SYS)
    route(SYS)
    out.append(r.set_health(first.rid, True, "ok"))
    out.append(r.set_health(first.rid, True, "ok"))
    route(SYS)
    r2 = mod.PrefixAffinityRouter(
        [("a", "http://127.0.0.1:1"), ("b", "http://127.0.0.1:2")]
    )
    r2.begin_request("a")
    out.append(r2.route(mod.prefix_fingerprint(
        [{"role": "user", "content": "x" * 64}]))[0].rid)
    out.append(r.snapshot())
    out.append(r.registry.render())
    return out


def test_affinity_routing_sticks_and_rebalances_as_jax():
    got, want = _affinity_story(trouter), _affinity_story(jrouter)
    assert got == want
    decisions = got[:4]
    assert decisions[0][1] is False and all(h for _, h in decisions[1:])
    assert got[4] is True and got[5][0] != decisions[0][0]
    assert got[5][1] is False and got[6] == (got[5][0], True)
    assert got[-3] == "b"


def test_affinity_trie_stays_bounded_as_jax():
    sizes = {}
    for name, mod in ROUTERS.items():
        r = mod.PrefixAffinityRouter(
            [("r0", "http://127.0.0.1:1")], max_trie_nodes=32
        )
        seen = []
        for i in range(64):
            r.route(mod.prefix_fingerprint(
                [{"role": "user", "content": f"unique prompt {i} " * 8}]
            ))
            with r._lock:
                seen.append(len(r.trie))
        sizes[name] = seen
    assert sizes["torch"] == sizes["jax"]
    assert max(sizes["torch"]) <= 32


def _refused(mod):
    srv = mod.build_router(
        [("d0", "http://127.0.0.1:9"), ("d1", "http://127.0.0.1:13")],
        port=0, probe=False,
    )
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        code, hdr, body = _call(base, {
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 2})
        srv.router.probe_all(timeout=0.2)
        ready = _get(base, "/readyz")
        return (code, _router_headers(hdr), body,
                srv.router.healthy_ids(), ready[0], ready[2]["reason"],
                _families(_get(base, "/metrics")[2]))
    finally:
        srv.shutdown()
        srv.server_close()


def test_router_error_when_no_replica_reachable_as_jax():
    got, want = _refused(trouter), _refused(jrouter)
    assert got == want
    assert got[0] == 503
    assert got[1]["X-Oryx-Router-Error"] == "no_healthy_replica"
    assert got[3] == [] and got[4] == 503


# ---------------------------------------------------------------------------
# Live fleets: a JAX router over JAX replicas, the port's over the port's
# ---------------------------------------------------------------------------


def _base(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _boot(api, pipe, rid):
    srv = api.build_server(
        pipe, port=0, engine="continuous", num_slots=2, page_size=16,
        decode_chunk=4, max_ctx=512, prefill_chunk=32, replica_id=rid,
    )
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


class Fleet:
    """Two replicas of one package behind that package's router (prober
    off: the tests drive probe_all)."""

    def __init__(self, api, mod, pipe):
        self.pipe = pipe
        self.reps = [_boot(api, pipe, f"r{i}") for i in range(2)]
        self.rsrv = mod.build_router(
            [(f"r{i}", _base(s)) for i, s in enumerate(self.reps)],
            port=0, probe=False,
        )
        threading.Thread(target=self.rsrv.serve_forever,
                         daemon=True).start()
        self.base = _base(self.rsrv)

    def close(self):
        self.rsrv.stop_prober()
        for s in self.reps:
            if s.scheduler is not None:
                s.scheduler.close()
            if s.supervisor is not None:
                s.supervisor.stop()
            s.shutdown()
            s.server_close()
        self.rsrv.shutdown()
        self.rsrv.server_close()


@pytest.fixture()
def fleets(pipes):
    """Both packages' fleets, function-scoped: the drain and kill tests
    consume replicas."""
    out = {name: Fleet(*pipes[name]) for name in ("jax", "torch")}
    yield out
    for f in out.values():
        f.close()


def _call(base, body, timeout=300, raw=None):
    """(status, headers, parsed body) of one completion, errors included."""
    data = raw.encode() if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=data,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.load(r)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, dict(e.headers), json.loads(e.read())


def _get(base, path, timeout=60):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            text = r.read().decode()
            code, hdr = r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        with e:
            text = e.read().decode()
            code, hdr = e.code, dict(e.headers)
    try:
        return code, hdr, json.loads(text)
    except ValueError:
        return code, hdr, text


def _router_headers(hdr):
    return {k: v for k, v in hdr.items()
            if k.startswith("X-Oryx-Router") or k == "Retry-After"}


def _reply(body):
    return body["choices"][0]["message"]["content"]


def _families(text):
    return dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))


def _stream(base, body, timeout=300, on_first_delta=None):
    """One SSE stream through `base`: (text, finish seen)."""
    req = urllib.request.Request(
        base + "/v1/chat/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"},
    )
    text, finished = "", False
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for raw in r:
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                break
            obj = json.loads(payload)
            assert "error" not in obj, obj
            for ch in obj.get("choices") or []:
                delta = ch.get("delta", {}).get("content")
                if delta:
                    if not text and on_first_delta is not None:
                        on_first_delta()
                    text += delta
                if ch.get("finish_reason"):
                    finished = True
    return text, finished


def _both(fleets, scenario):
    got = scenario(fleets["torch"])
    want = scenario(fleets["jax"])
    assert got == want
    return got


def _roundtrip(f):
    body = {"messages": [{"role": "user", "content": "hello there"}],
            "max_tokens": 5}
    direct = _call(_base(f.reps[0]), body)
    code, hdr, got = _call(f.base, body)
    return (code, _reply(got), _reply(direct[2]),
            _router_headers(hdr), bool(hdr.get("X-Request-Id")))


def test_router_roundtrip_matches_direct_and_jax(fleets):
    code, via, direct, hdr, has_id = _both(fleets, _roundtrip)
    assert code == 200 and via == direct and has_id
    assert hdr["X-Oryx-Router-Replica"] in ("r0", "r1")
    assert hdr["X-Oryx-Router-Retries"] == "0"


def _burst(f):
    landed, replies = [], []
    for i in range(4):
        _, hdr, body = _call(f.base, {
            "messages": [{"role": "system", "content": SYS},
                         {"role": "user", "content": f"question {i}?"}],
            "max_tokens": 3})
        landed.append(hdr["X-Oryx-Router-Replica"])
        replies.append(_reply(body))
    rid = landed[0]
    hot, cold = f.reps[int(rid[1])], f.reps[1 - int(rid[1])]
    return (landed, replies,
            hot.metrics.get("prefix_cache_hit_tokens_total") > 0,
            cold.metrics.get("prefix_cache_hit_tokens_total"),
            [s.metrics.get("admitted") == s.metrics.get("completed")
             for s in f.reps])


def test_shared_prefix_burst_lands_on_one_replica_as_jax(fleets):
    landed, _, hot, cold, reconciled = _both(fleets, _burst)
    assert len(set(landed)) == 1 and hot and cold == 0
    assert all(reconciled)


def _drain(f):
    _call(f.base, {"messages": [{"role": "system", "content": SYS},
                                {"role": "user", "content": "warm the prefix"}],
                   "max_tokens": 2})
    q = "please answer this one slowly and at length"
    body = {"messages": [{"role": "user", "content": q}], "max_tokens": 48}
    _, h0, _ = _call(f.base, dict(body, max_tokens=2))
    victim_id = h0["X-Oryx-Router-Replica"]
    victim = f.reps[int(victim_id[1])]
    drained = threading.Event()

    def start_drain():
        victim.begin_drain()
        f.rsrv.router.probe_all(timeout=5.0)
        drained.set()

    text, finished = _stream(
        f.base, body, on_first_delta=lambda: threading.Thread(
            target=start_drain, daemon=True).start())
    assert drained.wait(30)
    after = []
    for i in range(3):
        code, hdr, _ = _call(f.base, {
            "messages": [{"role": "system", "content": SYS},
                         {"role": "user", "content": f"after drain {i}?"}],
            "max_tokens": 3})
        after.append((code, hdr["X-Oryx-Router-Replica"]))
    return (victim_id, text, finished, f.rsrv.router.healthy_ids(), after,
            _get(f.base, "/readyz")[0], _get(_base(victim), "/readyz")[0])


def test_drain_mid_burst_ejects_finishes_inflight_and_rebalances_as_jax(
        fleets):
    victim, text, finished, healthy, after, ready, victim_ready = _both(
        fleets, _drain)
    survivor = f"r{1 - int(victim[1])}"
    assert finished and text
    assert healthy == [survivor]
    assert after == [(200, survivor)] * 3
    assert ready == 200 and victim_ready == 503


def _dead(f):
    _, hdr, _ = _call(f.base, {
        "messages": [{"role": "system", "content": SYS},
                     {"role": "user", "content": "pin it"}],
        "max_tokens": 2})
    victim_id = hdr["X-Oryx-Router-Replica"]
    victim = f.reps[int(victim_id[1])]
    victim.shutdown()
    victim.server_close()
    code, hdr, body = _call(f.base, {
        "messages": [{"role": "system", "content": SYS},
                     {"role": "user", "content": "pinned to the dead one?"}],
        "max_tokens": 3})
    return (victim_id, code, _router_headers(hdr), _reply(body),
            f.rsrv.router.snapshot()[victim_id]["healthy"],
            f.rsrv.registry.render().count("oryx_router_retried_total{"))


def test_retry_on_dead_replica_is_invisible_to_client_as_jax(fleets):
    victim, code, hdr, _, healthy, _ = _both(fleets, _dead)
    assert code == 200 and int(hdr["X-Oryx-Router-Retries"]) >= 1
    assert hdr["X-Oryx-Router-Replica"] != victim and healthy is False


def _observable(f):
    _, hdr, _ = _call(f.base, {
        "messages": [{"role": "user", "content": "observable?"}],
        "max_tokens": 2})
    rid = hdr["X-Request-Id"]
    merged = _get(f.base, "/debug/requests?limit=1")[2]
    code, thdr, tr = _get(f.base, f"/debug/trace?id={rid}")
    agg = _get(f.base, "/metrics/aggregate")[2]
    own = _get(f.base, "/metrics")[2]
    tl = _get(f.base, "/debug/timeline?n=0")[2]
    spans = sorted({e["name"] for e in tr["traceEvents"]
                    if e.get("ph") == "X" and e.get("tid") == 0})
    return (merged["engine"], merged["returned"], sorted(merged["replicas"]),
            code, thdr.get("X-Oryx-Router-Replica"), tr["merged"], spans,
            ['oryx_serving_ttft_seconds_count{replica="%s"}' % r in agg
             for r in ("r0", "r1")],
            'replica="r0",replica="r0"' in agg,
            _families(own), "oryx_router_healthy_replicas 2" in own,
            tl["engine"], sorted(tl["replicas"]))


def test_merged_debug_and_aggregate_surfaces_as_jax(fleets):
    got = _both(fleets, _observable)
    assert got[:3] == ("router", 1, ["r0", "r1"])
    assert got[3] == 200 and got[4] in ("r0", "r1") and got[5] is True
    assert {"route_decide", "upstream_connect", "upstream_ttfb",
            "proxy_stream"} <= set(got[6])
    assert got[7] == [True, True] and got[8] is False
    assert "oryx_router_requests_total" in got[9] and got[10]


def _malformed(f):
    out = []
    for payload in ('"hi"', "[1, 2]", '{"messages": "hi"}',
                    '{"messages": ["hi"], "max_tokens": 2}'):
        code, hdr, body = _call(f.base, None, timeout=60, raw=payload)
        out.append((code, bool(hdr.get("X-Oryx-Router-Replica")),
                    body["error"].get("type")))
    return out


def test_malformed_bodies_get_the_replicas_400_as_jax(fleets):
    got = _both(fleets, _malformed)
    assert all(code == 400 and tagged for code, tagged, _ in got)


def _router_drain(f):
    f.rsrv.begin_drain()
    code, hdr, body = _call(f.base, {
        "messages": [{"role": "user", "content": "too late"}],
        "max_tokens": 2})
    return code, _router_headers(hdr), body, _get(f.base, "/readyz")[:3:2]


def test_router_drain_refuses_new_work_as_jax(fleets):
    code, hdr, _, ready = _both(fleets, _router_drain)
    assert code == 503 and hdr["X-Oryx-Router-Error"] == "draining"
    assert ready == (503, {"ready": False, "reason": "draining"})
