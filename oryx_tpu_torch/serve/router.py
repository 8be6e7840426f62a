"""Prefix-affinity front-end router: N replica servers behind one door.

The port's multi-replica serving tier, the JAX package's
serve/router.py over the port's replicas. A stdlib-HTTP process that
fronts N `api_server` replicas (any Engine shape behind each; on one
card, several engines over one set of weights) and gives the fleet the
three behaviors one replica cannot:

  * **Prefix affinity.** The shared-prefix KV cache (serve/
    prefix_cache.py) only pays off if look-alike requests land on the
    replica that already holds their prefix. The router fingerprints
    each request's prompt prefix — the (role, content) stream of its
    messages, byte-blocked through the SAME `TokenTrie` block hashing
    the prefix cache indexes with — and routes to the replica whose
    cache is hottest for that prefix: the deepest trie node owned by a
    healthy replica wins; a miss picks the least-loaded healthy
    replica and claims the path for it. A burst of requests sharing a
    system prompt therefore admits cold exactly once fleet-wide, and
    `oryx_router_affinity_hit_rate` is the live measure of how often
    routing preserved cache locality.
  * **Health ejection & drain awareness.** A prober thread polls every
    replica's /readyz (it flips 503 the
    moment drain starts, and stays 503 through a crash-loop give-up).
    A non-200 ejects the replica from rotation — in-flight streams
    keep draining through their open connections untouched — and a
    recovered 200 restores it. An upstream 503 or connection failure
    mid-request ejects immediately (no waiting for the next poll) and
    the request retries on another replica.
  * **Bounded retry.** Retries follow `utils/retry.BackoffPolicy`
    (deterministic schedule, one attempt per distinct healthy replica,
    503/connection-error only — a 429 is backpressure for the CLIENT
    to honor and is forwarded untouched). Retried-then-served
    responses carry `X-Oryx-Router-Retries`; a request that exhausts
    the fleet gets 503 + `X-Oryx-Router-Error: no_healthy_replica`, so
    load tooling (scripts/loadgen.py --router) can tell router-level
    unavailability from a backend's own 503.

Observability: the router owns an `oryx_router_*` Prometheus registry
(routed/retried/ejected/restored counters with per-replica labels,
healthy-replica and affinity gauges, an upstream-TTFB histogram) at
GET /metrics, and GET /metrics/aggregate re-exports every replica's
own scrape with a `replica="<id>"` label injected per sample line
(utils/metrics.inject_exposition_label) — one scrape shows the fleet.
GET /debug/requests merges the replicas' flight recorders (per-replica
totals preserved; ?format=jsonl concatenates their wide-event logs)
and GET /debug/timeline their engine step timelines. Distributed
tracing: every proxied request gets a router-side trace (route_decide
/ upstream_connect / upstream_ttfb spans, retry + eject events) under
the SAME request id the replica adopts — a sanitized client
X-Request-Id is honored, and the id + parent span ride the
X-Oryx-Trace header upstream — so GET /debug/trace?id= returns ONE
merged Perfetto-loadable trace: router spans on track 0, the owning
replica's engine spans (eviction/restart replays included) on track 1,
re-anchored onto the router's clock. /healthz is process liveness;
/readyz is "≥ 1 healthy replica and not draining". SIGTERM drains:
/readyz flips 503 immediately, new POSTs get 503 + Retry-After,
streams already proxying run to completion.

    python -m oryx_tpu_torch.serve.router --port 8100 \
        --replica r0=http://127.0.0.1:8000 \
        --replica r1=http://127.0.0.1:8001

Concurrency model (oryx_tpu_torch/concurrency.py): the replica table and the
affinity trie are guarded by `router._lock` (held only for table/trie
edits — never across network I/O); the prober thread and HTTP handler
threads are the only writers. Metric bumps nest under the lock in the
declared order (`router._lock < registry._lock`).
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import threading
import time
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from oryx_tpu_torch.analysis import sanitizers
from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.serve.prefix_cache import TokenTrie
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils.metrics import (
    TTFT_BUCKETS,
    Registry,
    inject_exposition_label,
)
from oryx_tpu_torch.utils.retry import BackoffPolicy, backoff_delays

_LOG = logging.getLogger("oryx.serve.router")

# Upper bound on the bytes of prompt prefix that participate in the
# fingerprint: affinity only needs the SHARED head of a conversation
# (system prompt, early turns); hashing megabyte prompts would buy
# nothing past the first divergence.
FINGERPRINT_CAP = 4096


def prefix_fingerprint(messages: list[dict[str, Any]],
                       cap: int = FINGERPRINT_CAP) -> np.ndarray:
    """The prompt's affinity stream: role/content of each message in
    order, byte-encoded, capped. Block-hashed through `TokenTrie`
    exactly like the prefix cache hashes token ids — two requests
    sharing a system prompt (and any number of identical early turns)
    share a leading block path, so the trie's longest-prefix walk IS
    the cache-locality estimate. Content-part lists contribute their
    text parts; media parts contribute their type tag only (the router
    never decodes payloads — a re-sent image keys the same replica by
    its surrounding text)."""
    parts = []
    for m in messages:
        content = m.get("content", "")
        if isinstance(content, list):
            content = "\n".join(
                str(p.get("text", p.get("type", "")))
                for p in content if isinstance(p, dict)
            )
        parts.append(f"{m.get('role', '')}\x1f{content}")
    raw = "\x1e".join(parts).encode("utf-8", "replace")[:cap]
    return np.frombuffer(raw, dtype=np.uint8).astype(np.int64)


class Replica:
    """One backend in the rotation. Mutable fields are edited only
    under the router's `_lock` (table scans in `route`/prober) — kept
    lock-adjacent rather than annotation-guarded because the lock
    lives on the router, not here."""

    __slots__ = ("rid", "url", "host", "port", "healthy", "inflight",
                 "reason", "ejections")

    def __init__(self, rid: str, url: str):
        u = urllib.parse.urlsplit(url)
        if u.scheme != "http" or not u.hostname:
            raise ValueError(
                f"replica {rid!r}: need an http://host:port URL, "
                f"got {url!r}"
            )
        self.rid = rid
        self.url = url.rstrip("/")
        self.host = u.hostname
        self.port = u.port or 80
        self.healthy = True  # optimistic: first prober pass corrects
        self.inflight = 0
        self.reason = "unprobed"
        self.ejections = 0


class PrefixAffinityRouter:
    """Replica table + affinity trie + the oryx_router registry.

    `route()` is the one decision point; the HTTP layer (build_router)
    and the prober thread are thin shells around it. Separable from
    the server so tests drive routing/ejection logic directly."""

    def __init__(
        self,
        replicas: list[tuple[str, str]],  # (id, url)
        *,
        block: int = 32,
        max_trie_nodes: int = 4096,
        retry_policy: BackoffPolicy | None = None,
        registry: Registry | None = None,
        flight_recorder_size: int = 256,
    ):
        if not replicas:
            raise ValueError("router needs at least one replica")
        ids = [rid for rid, _ in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self._lock = named_lock("router._lock")
        # The id->Replica MAPPING is immutable after construction (read
        # lock-free everywhere); the mutable fields inside each Replica
        # (healthy/inflight/reason) are edited only under _lock.
        self.replicas: dict[str, Replica] = {
            rid: Replica(rid, url) for rid, url in replicas
        }
        self.trie = TokenTrie(block)  # guarded-by: _lock
        self.max_trie_nodes = max_trie_nodes
        self.block = block
        # One attempt per distinct replica; the delay schedule between
        # attempts is the shared deterministic backoff policy.
        self.retry_policy = retry_policy or BackoffPolicy(
            retries=max(1, len(replicas) - 1), base_s=0.05, max_s=1.0,
        )
        self._hits = 0  # guarded-by: _lock
        self._misses = 0  # guarded-by: _lock
        # Router-side flight recorder: one trace per proxied request
        # (route_decide / upstream_connect / upstream_ttfb spans, retry
        # and eject events), keyed by the SAME request id the replica's
        # trace carries — /debug/trace?id= merges the two into one
        # story.
        self.tracer = trace_lib.Tracer(flight_recorder_size)
        self.registry = registry or Registry(prefix="oryx_router")
        reg = self.registry
        # Pre-registered so the whole surface renders (at zero) from
        # the first scrape — same discipline as the scheduler.
        reg.counter("requests_total", ("replica",))
        reg.counter("retried_total", ("replica",))
        reg.counter("ejected_total", ("replica",))
        reg.counter("restored_total", ("replica",))
        reg.counter("affinity_hits_total")
        reg.counter("affinity_misses_total")
        reg.counter("unavailable_total")
        reg.gauge("affinity_hit_rate")
        reg.gauge("healthy_replicas")
        reg.gauge("replica_healthy", ("replica",))
        reg.histogram("upstream_ttfb_seconds", TTFT_BUCKETS)
        self._publish_health({r: True for r in self.replicas})

    # ---- health ----------------------------------------------------------

    def _publish_health(self, healthy_by_id: dict[str, bool]) -> None:
        reg = self.registry
        for rid, h in healthy_by_id.items():
            reg.gauge("replica_healthy", ("replica",)).labels(
                replica=rid
            ).set(1.0 if h else 0.0)
        reg.gauge("healthy_replicas").set(
            sum(1 for h in healthy_by_id.values() if h)
        )

    def set_health(self, rid: str, healthy: bool, reason: str) -> bool:
        """Record one probe/upstream observation; returns True when the
        state CHANGED (the transition is what ejection/restoration
        counters and logs track)."""
        with self._lock:
            r = self.replicas[rid]
            changed = r.healthy != healthy
            r.healthy = healthy
            r.reason = reason
            if changed and not healthy:
                r.ejections += 1
            snapshot = {x.rid: x.healthy for x in self.replicas.values()}
        if changed:
            if healthy:
                self.registry.counter(
                    "restored_total", ("replica",)
                ).labels(replica=rid).inc()
            else:
                self.registry.counter(
                    "ejected_total", ("replica",)
                ).labels(replica=rid).inc()
            _LOG.warning(
                "replica %s %s (%s)", rid,
                "ejected" if not healthy else "restored", reason,
            )
        self._publish_health(snapshot)
        return changed

    def probe_all(self, timeout: float = 2.0) -> None:
        """One prober pass: GET each replica's /readyz. 200 = in
        rotation; anything else (503 draining / crash-loop give-up,
        connection refused) = ejected. In-flight proxied streams are
        untouched — ejection only stops NEW routing."""
        for rid, url in [
            (r.rid, r.url) for r in list(self.replicas.values())
        ]:
            try:
                req = urllib.request.Request(url + "/readyz")
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    ok = resp.status == 200
                    reason = "ok" if ok else f"readyz {resp.status}"
            except urllib.error.HTTPError as e:
                body = e.read()
                try:
                    reason = (json.loads(body) or {}).get(
                        "reason", f"readyz {e.code}"
                    )
                except ValueError:
                    reason = f"readyz {e.code}"
                ok = False
                e.close()
            except OSError as e:
                ok, reason = False, f"unreachable: {e}"
            self.set_health(rid, ok, reason)

    def healthy_ids(self) -> list[str]:
        with self._lock:
            return [r.rid for r in self.replicas.values() if r.healthy]

    # ---- routing ---------------------------------------------------------

    def route(self, tokens: np.ndarray,
              exclude: set[str] = frozenset()) -> tuple[Replica | None, bool]:
        """Pick the replica for one request: the deepest affinity-trie
        node along `tokens` owned by a healthy (non-excluded) replica,
        else the least-loaded healthy replica. The chosen replica then
        (re)claims the path — nodes owned by nobody, or by an ejected
        replica, re-own to the winner, which is exactly how traffic
        rebalances after an ejection without a flag day. Returns
        (replica, affinity_hit); (None, False) when nothing is
        routable."""
        with self._lock:
            healthy = [
                r for r in self.replicas.values()
                if r.healthy and r.rid not in exclude
            ]
            if not healthy:
                choice = None, False
            else:
                path = self.trie.walk(tokens)
                chosen = None
                hit = False
                for node in reversed(path):
                    owner = self.replicas.get(node.payload)
                    if (
                        owner is not None and owner.healthy
                        and owner.rid not in exclude
                    ):
                        chosen, hit = owner, True
                        break
                if chosen is None:
                    chosen = min(
                        healthy, key=lambda r: (r.inflight, r.rid)
                    )
                for node in self.trie.extend(tokens):
                    owner = self.replicas.get(node.payload)
                    if (
                        owner is None or not owner.healthy
                        or owner.rid in exclude
                    ):
                        node.payload = chosen.rid
                # Keep the affinity index bounded: drop least-recently
                # touched leaves past max_trie_nodes (the same LRU
                # stamps the prefix cache evicts by).
                while len(self.trie) > self.max_trie_nodes:
                    leaves = sorted(
                        self.trie.leaves(), key=lambda n: n.stamp
                    )
                    if not leaves:
                        break
                    for victim in leaves[: max(1, len(leaves) // 4)]:
                        self.trie.remove(victim)
                if hit:
                    self._hits += 1
                else:
                    self._misses += 1
                rate = self._hits / max(1, self._hits + self._misses)
                choice = chosen, hit
        reg = self.registry
        if choice[0] is not None:
            if choice[1]:
                reg.counter("affinity_hits_total").inc()
            else:
                reg.counter("affinity_misses_total").inc()
            reg.gauge("affinity_hit_rate").set(rate)
        return choice

    def begin_request(self, rid: str) -> None:
        with self._lock:
            self.replicas[rid].inflight += 1

    def end_request(self, rid: str) -> None:
        with self._lock:
            self.replicas[rid].inflight -= 1

    def total_inflight(self) -> int:
        """Requests currently proxying across the fleet (the drain
        wait's exit condition)."""
        with self._lock:
            return sum(r.inflight for r in self.replicas.values())

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                r.rid: {
                    "url": r.url, "healthy": r.healthy,
                    "reason": r.reason, "inflight": r.inflight,
                    "ejections": r.ejections,
                }
                for r in self.replicas.values()
            }


def _merge_clock_offset_us(router_meta: dict[str, Any],
                           replica_request: dict[str, Any]) -> float:
    """Microseconds to ADD to the replica's chrome-trace timestamps so
    the merged trace sits on the router's clock.

    Both sides stamp spans on a wall-anchored perf clock
    (utils/trace.py), so on one host — or NTP-synced hosts — the
    offset is ~0 and re-anchoring would only erase real queueing
    delay; the replica's trace is kept where it is. When the replica's
    trace-creation time is IMPLAUSIBLE against the router's recorded
    send time (created before the request was sent, or absurdly after
    it), the clocks disagree and the replica trace re-anchors to the
    router's send instant — slightly compressing the network hop, but
    putting every span on one readable axis."""
    sent_ns = router_meta.get("upstream_sent_ns")
    created_s = replica_request.get("created_unix_s")
    if not sent_ns or not created_s:
        return 0.0
    sent_us = sent_ns / 1e3
    created_us = float(created_s) * 1e6
    # 10ms of backwards slack (float rounding, sub-ms skew) and 120s
    # forward (a request can sit in the replica's accept queue, but
    # not for minutes before its trace even starts).
    if sent_us - 1e4 <= created_us <= sent_us + 120e6:
        return 0.0
    return round(sent_us - created_us, 3)


def build_router(
    replicas: list[tuple[str, str]],
    *,
    host: str = "127.0.0.1",
    port: int = 8100,
    poll_s: float = 0.25,
    probe_timeout: float = 2.0,
    upstream_timeout: float = 600.0,
    block: int = 32,
    retry_policy: BackoffPolicy | None = None,
    probe: bool = True,
) -> ThreadingHTTPServer:
    """Construct (not start) the router HTTP server. Mirrors
    api_server.build_server's shape: the returned server carries
    `.router` (the PrefixAffinityRouter), `.registry`, and
    `.begin_drain()`; callers thread `serve_forever` themselves.
    probe=False skips the background prober (tests drive
    `router.probe_all()` deterministically)."""
    sanitizers.maybe_arm_from_env()
    router = PrefixAffinityRouter(
        replicas, block=block, retry_policy=retry_policy
    )
    sanitizers.bind_lock_metrics(router.registry)
    from oryx_tpu_torch.serve.api_server import _git_revision

    router.registry.info("build_info", {
        "revision": _git_revision(), "engine": "router",
        "replicas": str(len(replicas)),
    })
    draining = threading.Event()
    halt = threading.Event()

    def probe_loop() -> None:
        while not halt.wait(poll_s):
            router.probe_all(timeout=probe_timeout)

    prober = threading.Thread(
        target=probe_loop, daemon=True, name="router-prober"
    )

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        # ---- plumbing ----------------------------------------------------

        def _json(self, code: int, body: dict[str, Any],
                  extra_headers: dict[str, str] | None = None) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _router_error(self, code: int, reason: str, retries: int,
                          retry_after: float = 1.0) -> None:
            """A failure the ROUTER is answering for (vs a forwarded
            backend response): tagged X-Oryx-Router-Error so load
            tooling can split router-level unavailability from a
            backend's own 503s."""
            router.registry.counter("unavailable_total").inc()
            self._json(code, {"error": {
                "message": f"router: {reason}",
                "type": "unavailable_error",
                "reason": reason,
            }}, extra_headers={
                "Retry-After": str(max(1, round(retry_after))),
                "X-Oryx-Router-Error": reason,
                "X-Oryx-Router-Retries": str(retries),
            })

        def _replica_get(self, r: Replica, path: str,
                         timeout: float = 5.0) -> tuple[int, bytes]:
            """GET one replica endpoint; error statuses are returned,
            not raised (the merge endpoints propagate a replica's 400s
            verbatim). The timeout is deliberately SHORT: the merge
            endpoints walk replicas sequentially, and one wedged
            backend must degrade to a `scrape failed` line — never
            stall fleet observability past a Prometheus scrape window
            during the exact incident it exists to show."""
            try:
                with urllib.request.urlopen(
                    r.url + path, timeout=timeout
                ) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                body = e.read()
                e.close()
                return e.code, body

        # ---- GET surface -------------------------------------------------

        def do_GET(self):
            path, _, query = self.path.partition("?")
            if path == "/healthz":
                self._json(200, {"status": "ok"})
            elif path == "/readyz":
                if draining.is_set():
                    self._json(503, {"ready": False, "reason": "draining"})
                    return
                healthy = router.healthy_ids()
                if healthy:
                    self._json(200, {
                        "ready": True, "reason": "ok",
                        "healthy_replicas": len(healthy),
                    })
                else:
                    self._json(503, {
                        "ready": False, "reason": "no_healthy_replica",
                        "replicas": router.snapshot(),
                    })
            elif path == "/metrics":
                data = router.registry.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/metrics/aggregate":
                self._aggregate_metrics()
            elif path == "/debug/replicas":
                self._json(200, {
                    "draining": draining.is_set(),
                    "replicas": router.snapshot(),
                })
            elif path == "/debug/requests":
                self._merged_debug_requests(query)
            elif path == "/debug/timeline":
                self._merged_replica_json("/debug/timeline", query)
            elif path == "/debug/pages":
                # The fleet's page-ownership maps, keyed by replica —
                # same degrade-to-error-entry contract as the timeline
                # merge (a wedged replica never stalls the fleet view).
                self._merged_replica_json("/debug/pages", query)
            elif path == "/debug/oom":
                # The fleet's OOM forensic rings, keyed by replica.
                self._merged_replica_json("/debug/oom", query)
            elif path == "/debug/audit":
                # The fleet's output-audit rings, keyed by replica —
                # same degrade-to-error-entry merge contract.
                self._merged_replica_json("/debug/audit", query)
            elif path == "/debug/journal":
                # The fleet's decision-journal rings, keyed by replica
                # (disarmed replicas answer armed=false bodies) — same
                # degrade-to-error-entry merge contract.
                self._merged_replica_json("/debug/journal", query)
            elif path == "/debug/profile":
                self._proxy_profile(query)
            elif path == "/debug/trace":
                self._find_trace(query)
            elif path == "/v1/models":
                self._proxy_get_first(path)
            else:
                self._json(404, {"error": "not found"})

        def _aggregate_metrics(self) -> None:
            """The fleet in one scrape: the router's own families,
            then each replica's exposition with `replica="<id>"`
            injected per sample line. Replica sections drop their
            comment lines (duplicate # TYPE headers across replicas
            would make the merged text ill-formed); a failed scrape
            becomes one comment line instead of failing the whole
            aggregation."""
            out = [router.registry.render()]
            for rid, info in sorted(router.snapshot().items()):
                r = router.replicas[rid]
                try:
                    status, body = self._replica_get(r, "/metrics")
                    if status != 200:
                        raise OSError(f"/metrics -> {status}")
                    labeled = inject_exposition_label(
                        body.decode(), "replica", rid
                    )
                    out.append(f"# replica {rid} {r.url}\n" + "\n".join(
                        line for line in labeled.splitlines()
                        if line and not line.startswith("#")
                    ) + "\n")
                except (OSError, ValueError) as e:
                    out.append(f"# replica {rid} scrape failed: {e}\n")
            data = "".join(out).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _merged_replica_json(self, path: str, query: str) -> None:
            """Generic per-replica JSON merge (the /debug/timeline,
            /debug/pages and /debug/oom views): each replica's
            response (same query string) under its id, a wedged
            replica degrading to an error entry — never a stalled
            endpoint (same contract as the metrics aggregation)."""
            per: dict[str, Any] = {}
            for rid, info in sorted(router.snapshot().items()):
                r = router.replicas[rid]
                try:
                    status, body = self._replica_get(
                        r, path + (f"?{query}" if query else ""),
                    )
                    if status != 200:
                        raise OSError(f"{path} -> {status}")
                    per[rid] = json.loads(body)
                except (OSError, ValueError) as e:
                    per[rid] = {"error": str(e)}
            self._json(200, {"engine": "router", "replicas": per})

        def _proxy_profile(self, query: str) -> None:
            """Proxy /debug/profile to the OWNING replica: ?replica=
            names it explicitly, otherwise the busiest healthy replica
            (most in-flight requests — profiling needs live
            dispatches) with the first healthy one as the idle-fleet
            fallback. Long timeout: the capture spans real engine
            steps."""
            q = urllib.parse.parse_qs(query)
            want = (q.get("replica") or [""])[0]
            snap = router.snapshot()
            if want:
                if want not in snap:
                    self._json(404, {
                        "error": f"unknown replica {want!r} "
                        f"(known: {sorted(snap)})",
                    })
                    return
                rid = want
            else:
                healthy = router.healthy_ids()
                if not healthy:
                    self._router_error(503, "no_healthy_replica", 0)
                    return
                rid = max(
                    healthy,
                    key=lambda i: snap.get(i, {}).get("inflight", 0),
                )
            pass_q = urllib.parse.urlencode(
                [(k, v[0]) for k, v in q.items() if k != "replica"]
            )
            # The socket timeout must outlive the replica's own wait
            # (it clamps ?timeout= to [1, 300]); a fixed proxy timeout
            # below it would 503 while the replica capture stays in
            # flight and refuses the retry.
            try:
                upstream_t = float((q.get("timeout") or ["30"])[0])
            except ValueError:
                upstream_t = 30.0
            try:
                status, body = self._replica_get(
                    router.replicas[rid],
                    "/debug/profile" + (f"?{pass_q}" if pass_q else ""),
                    timeout=max(1.0, min(upstream_t, 300.0)) + 30.0,
                )
            except OSError as e:
                self._json(503, {
                    "error": f"replica {rid} profile failed: {e}",
                })
                return
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Oryx-Router-Replica", rid)
            self.end_headers()
            self.wfile.write(body)

        def _merged_debug_requests(self, query: str) -> None:
            """One flight-recorder view of the fleet: each replica's
            /debug/requests (same query string) merged, per-replica
            totals preserved, ?limit= re-applied to the merge.
            ?format=jsonl concatenates the replicas' wide-event logs
            (each event already carries its replica identity)."""
            q = urllib.parse.parse_qs(query)
            if (q.get("format") or [""])[0] == "jsonl":
                try:
                    limit = int((q.get("limit") or ["0"])[0])
                    if limit < 0:
                        raise ValueError
                except ValueError:
                    self._json(400, {
                        "error": "limit must be a non-negative integer",
                    })
                    return
                lines: list[str] = []
                for rid, info in sorted(router.snapshot().items()):
                    r = router.replicas[rid]
                    try:
                        status, body = self._replica_get(
                            r, f"/debug/requests?{query}"
                        )
                        if status == 200:
                            lines += [
                                ln for ln in body.decode().splitlines()
                                if ln
                            ]
                    except OSError:
                        pass  # scrape failed: skip replica
                # ?limit= bounds the MERGE, like the JSON path below:
                # interleave by event time first, so the newest N of
                # the fleet survive — not N per replica.
                def ev_ts(ln: str) -> float:
                    try:
                        return float(json.loads(ln).get("ts_unix_s") or 0)
                    except ValueError:
                        return 0.0

                lines.sort(key=ev_ts)
                if limit:
                    lines = lines[-limit:]
                data = ("\n".join(lines) + ("\n" if lines else "")).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            try:
                limit = int((q.get("limit") or ["0"])[0])
                if limit < 0:
                    raise ValueError
            except ValueError:
                self._json(400, {
                    "error": "limit must be a non-negative integer",
                })
                return
            merged: list[dict] = []
            per_replica: dict[str, Any] = {}
            total = 0
            for rid, info in sorted(router.snapshot().items()):
                r = router.replicas[rid]
                try:
                    status, body = self._replica_get(
                        r, "/debug/requests" + (f"?{query}" if query else "")
                    )
                    if status != 200:
                        # Propagate a replica's validation answer (a
                        # bogus ?state= must stay a 400 through the
                        # router, not be silently swallowed).
                        self.send_response(status)
                        self.send_header(
                            "Content-Type", "application/json"
                        )
                        self.send_header(
                            "Content-Length", str(len(body))
                        )
                        self.end_headers()
                        self.wfile.write(body)
                        return
                    rep = json.loads(body)
                    for rec in rep.get("requests", []):
                        rec["replica"] = rid
                        merged.append(rec)
                    total += rep.get("total", 0)
                    per_replica[rid] = {
                        "total": rep.get("total", 0),
                        "engine": rep.get("engine"),
                    }
                except (OSError, ValueError) as e:
                    per_replica[rid] = {"error": str(e)}
            # Interleave by recency BEFORE truncating: each replica
            # returned its own newest-first list, and a rid-ordered
            # concatenation cut at ?limit= would silently drop a later
            # replica's strictly newer entries — exactly the requests
            # an operator is hunting mid-incident.
            merged.sort(
                key=lambda rec: rec.get("created_unix_s") or 0.0,
                reverse=True,
            )
            if limit:
                merged = merged[:limit]
            self._json(200, {
                "engine": "router",
                "total": total,
                "returned": len(merged),
                "replicas": per_replica,
                "requests": merged,
            })

        def _find_trace(self, query: str) -> None:
            """ONE merged Perfetto-loadable trace for ?id=: the
            router's own spans (route_decide, upstream_connect,
            upstream_ttfb, retries, ejects) on track 0 and the owning
            replica's spans — queue_wait, prefill (eviction/restart
            replays included), decode_chunk, emission — on track 1,
            re-anchored onto the router's clock, so a routed (and even
            a replayed) request reads as one story. Falls back to the
            replica's own trace when the router never saw the id (it
            predates this router process, or the recorder rolled)."""
            q = urllib.parse.parse_qs(query)
            rid_param = (q.get("id") or [""])[0]
            if not rid_param:
                self._json(400, {"error": "missing ?id=<request id>"})
                return
            own = router.tracer.get(rid_param)
            # Locate the replica-side trace: the owner recorded on the
            # router trace first, then the rest of the fleet (the id
            # may predate this router's recorder window).
            candidates = []
            if own is not None:
                owner = own.summary()["meta"].get("replica")
                if owner in router.replicas:
                    candidates.append(owner)
            candidates += [
                rid for rid in sorted(router.replicas)
                if rid not in candidates
            ]
            rep_json = rep_rid = None
            for rid in candidates:
                try:
                    status, body = self._replica_get(
                        router.replicas[rid], f"/debug/trace?{query}"
                    )
                except OSError:
                    continue
                if status == 200:
                    try:
                        rep_json = json.loads(body)
                    except ValueError:
                        continue
                    rep_rid = rid
                    break
            if own is None and rep_json is None:
                self._json(404, {
                    "error": "neither the router nor any replica "
                    f"holds a trace for id {rid_param!r}"
                })
                return
            if own is None:
                # Replica-only view (pre-router id): forward verbatim.
                rep_json["merged"] = False
                self._json(200, rep_json, extra_headers={
                    "X-Oryx-Router-Replica": rep_rid,
                })
                return
            events = own.chrome_events(tid=0)
            merged: dict[str, Any] = {
                "traceEvents": events,
                "displayTimeUnit": "ms",
                "request": own.summary(),
                "merged": False,
            }
            if rep_json is not None:
                offset_us = _merge_clock_offset_us(
                    own.summary()["meta"], rep_json.get("request") or {}
                )
                for ev in rep_json.get("traceEvents", []):
                    ev = dict(ev)
                    ev["tid"] = 1
                    if ev.get("ph") == "M":
                        name = (ev.get("args") or {}).get("name", "")
                        ev["args"] = {
                            "name": f"replica {rep_rid} {name}".strip()
                        }
                    elif "ts" in ev:
                        ev["ts"] = ev["ts"] + offset_us
                    events.append(ev)
                merged["merged"] = True
                merged["replica"] = rep_rid
                merged["clock_offset_us"] = offset_us
                merged["replica_request"] = rep_json.get("request")
            # The header contract survives the merge: consumers
            # keyed on X-Oryx-Router-Replica keep working.
            self._json(200, merged, extra_headers=(
                {"X-Oryx-Router-Replica": rep_rid} if rep_rid else None
            ))

        def _proxy_get_first(self, path: str) -> None:
            for rid in router.healthy_ids():
                r = router.replicas[rid]
                try:
                    status, body = self._replica_get(r, path)
                except OSError:
                    continue
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._router_error(503, "no_healthy_replica", 0)

        # ---- the completion proxy ----------------------------------------

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._json(404, {"error": "not found"})
                return
            if draining.is_set():
                self._router_error(503, "draining", 0)
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            # The REPLICA owns request validation (it answers the
            # 400s): any malformed shape here — non-JSON, a non-object
            # body, a non-list messages, non-dict entries — just means
            # "no affinity signal", never a dropped connection.
            try:
                parsed = json.loads(body)
            except ValueError:
                parsed = None
            messages = (
                parsed.get("messages") if isinstance(parsed, dict)
                else None
            )
            if not isinstance(messages, list):
                messages = []
            tokens = prefix_fingerprint(
                [m for m in messages if isinstance(m, dict)]
            )
            # Distributed tracing: one router-side trace per proxied
            # request. A sanitized client X-Request-Id is honored as
            # the trace id — the SAME id the chosen replica will adopt
            # (propagated via X-Oryx-Trace), so /debug/trace?id= can
            # merge the two sides into one story. Colliding or unsafe
            # ids fall back to minting.
            rid_pref = trace_lib.sanitize_request_id(
                self.headers.get("X-Request-Id")
            )
            tr = router.tracer.start_trace(
                "router", label="chat", id=rid_pref,  # minted on collision
            )
            # One attempt per distinct healthy replica, delays from the
            # shared deterministic backoff schedule. 503s and transport
            # errors rotate; anything else — success, 400, 429, 504 —
            # is the client's answer and forwards as-is.
            delays = [0.0] + backoff_delays(router.retry_policy)
            tried: set[str] = set()
            retries = 0
            for delay in delays:
                if delay:
                    time.sleep(delay)
                with tr.span("route_decide", attempt=retries):
                    replica, hit = router.route(tokens, exclude=tried)
                if replica is None:
                    break
                outcome = self._try_upstream(replica, body, retries, tr)
                if outcome is None:
                    tr.finish(
                        replica=replica.rid, retries=retries,
                        affinity_hit=hit,
                    )
                    return  # response (or client hangup) fully handled
                tried.add(replica.rid)
                retries += 1
                tr.event("retry", replica=replica.rid, reason=outcome)
                router.registry.counter(
                    "retried_total", ("replica",)
                ).labels(replica=replica.rid).inc()
                _LOG.info(
                    "retrying off replica %s (%s)", replica.rid, outcome
                )
            tr.finish(error="no_healthy_replica", retries=retries)
            self._router_error(
                503, "no_healthy_replica", retries,
                retry_after=router.retry_policy.base_s * 10,
            )

        def _try_upstream(self, replica: Replica, body: bytes,
                          retries: int,
                          tr: trace_lib.Trace) -> str | None:
            """Proxy one attempt to `replica`. Returns None when the
            client got an answer (including a forwarded error or a
            mid-stream hangup), or a reason string meaning "rotate to
            another replica" — only ever BEFORE any response byte has
            been forwarded, so a retry can never splice two streams."""
            router.begin_request(replica.rid)
            conn = http.client.HTTPConnection(
                replica.host, replica.port, timeout=upstream_timeout
            )
            t0 = time.monotonic()
            uc = tr.begin("upstream_connect", replica=replica.rid)
            ttfb_h = -1
            try:
                try:
                    # Clock anchor for the merged trace: the replica's
                    # spans re-anchor onto this send timestamp when the
                    # two processes' clocks visibly disagree.
                    tr.annotate(
                        replica=replica.rid,
                        upstream_sent_ns=trace_lib.now_ns(),
                    )
                    conn.request(
                        "POST", "/v1/chat/completions", body=body,
                        headers={
                            "Content-Type": "application/json",
                            # Trace context, router -> replica: the
                            # replica adopts this request id as its own
                            # trace id and records the parent span, so
                            # the fleet shares ONE id per request.
                            "X-Oryx-Trace": f"{tr.id};{uc}",
                        },
                    )
                    tr.end(uc)
                    ttfb_h = tr.begin(
                        "upstream_ttfb", replica=replica.rid
                    )
                    resp = conn.getresponse()
                    tr.end(ttfb_h)
                except OSError as e:
                    tr.end(uc)
                    if ttfb_h >= 0:
                        tr.end(ttfb_h)
                    # Transport failure before a single response byte:
                    # eject now (the prober would take a poll interval
                    # to notice a dead process) and rotate.
                    tr.event(
                        "eject", replica=replica.rid,
                        reason=f"connect failed: {e}",
                    )
                    router.set_health(
                        replica.rid, False, f"connect failed: {e}"
                    )
                    return f"transport: {e}"
                router.registry.histogram(
                    "upstream_ttfb_seconds", TTFT_BUCKETS
                ).observe(time.monotonic() - t0)
                if resp.status == 503:
                    # Drain-aware removal: a 503 body from a replica
                    # means draining / shedding / supervisor give-up —
                    # take it out of rotation immediately and retry
                    # the request elsewhere.
                    resp.read()
                    tr.event(
                        "eject", replica=replica.rid,
                        reason="upstream 503",
                    )
                    router.set_health(
                        replica.rid, False, "upstream 503"
                    )
                    return "upstream 503"
                tr.annotate(status=resp.status)
                # Counted only once a response is actually FORWARDED
                # from this replica (failed attempts show in
                # retried_total instead), so requests_total is a true
                # served-traffic split, not an attempt count.
                router.registry.counter(
                    "requests_total", ("replica",)
                ).labels(replica=replica.rid).inc()
                try:
                    with tr.span("proxy_stream", replica=replica.rid):
                        self._forward(resp, replica, retries)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    # CLIENT hung up mid-stream: closing the upstream
                    # connection (finally) propagates the cancel to
                    # the replica's SSE writer.
                    pass
                return None
            finally:
                conn.close()
                router.end_request(replica.rid)

        def _forward(self, resp, replica: Replica, retries: int) -> None:
            """Stream one upstream response to the client verbatim.
            Content-Length responses copy in one read; SSE responses
            (no length, close-delimited) relay line-by-line, flushing
            at event boundaries so TTFT through the router tracks the
            replica's, not a buffer's."""
            self.send_response(resp.status)
            passthrough = (
                "Content-Type", "Cache-Control", "Retry-After",
                "X-Request-Id",
            )
            for name in passthrough:
                v = resp.getheader(name)
                if v is not None:
                    self.send_header(name, v)
            self.send_header("X-Oryx-Router-Replica", replica.rid)
            self.send_header("X-Oryx-Router-Retries", str(retries))
            cl = resp.getheader("Content-Length")
            if cl is not None:
                data = resp.read(int(cl))
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            self.end_headers()
            while True:
                line = resp.readline()
                if not line:
                    break
                self.wfile.write(line)
                if line == b"\n":
                    self.wfile.flush()  # SSE event boundary
            self.wfile.flush()

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.router = router
    srv.registry = router.registry
    srv.draining = draining

    def begin_drain() -> None:
        """Router drain: /readyz flips 503 NOW and new completions are
        refused; streams already proxying finish on their open
        connections. (Replica drains are their own — a router drain
        does not cascade.)"""
        draining.set()

    def close() -> None:
        halt.set()

    srv.begin_drain = begin_drain
    srv.stop_prober = close
    if probe:
        router.probe_all(timeout=probe_timeout)  # no cold 503 window
        prober.start()
    return srv


def _parse_replica_arg(value: str, index: int) -> tuple[str, str]:
    """--replica [id=]http://host:port; ids default to r0, r1, ..."""
    rid, sep, url = value.partition("=")
    if not sep:
        return f"r{index}", value
    return rid, url


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(
        description="Oryx prefix-affinity front-end router (PyTorch port)"
    )
    ap.add_argument(
        "--replica", action="append", required=True, metavar="[ID=]URL",
        help="backend api_server base URL (repeat per replica); "
        "e.g. r0=http://127.0.0.1:8000",
    )
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument(
        "--poll-interval", type=float, default=1.0,
        help="seconds between /readyz probes of each replica",
    )
    ap.add_argument(
        "--probe-timeout", type=float, default=2.0,
        help="per-probe timeout; an unreachable replica is ejected",
    )
    ap.add_argument(
        "--upstream-timeout", type=float, default=600.0,
        help="per-request upstream socket timeout",
    )
    ap.add_argument(
        "--affinity-block", type=int, default=32,
        help="fingerprint block size in bytes (the TokenTrie block "
        "the affinity index hashes prompt prefixes with)",
    )
    ap.add_argument(
        "--drain-timeout", type=float, default=60.0,
        help="seconds to wait after SIGTERM for in-flight proxied "
        "streams to finish before exiting anyway",
    )
    args = ap.parse_args(argv)
    replicas = [
        _parse_replica_arg(v, i) for i, v in enumerate(args.replica)
    ]
    srv = build_router(
        replicas, host=args.host, port=args.port,
        poll_s=args.poll_interval, probe_timeout=args.probe_timeout,
        upstream_timeout=args.upstream_timeout,
        block=args.affinity_block,
    )

    def _drain_and_exit() -> None:
        # The drain CONTRACT ("streams already proxying finish") needs
        # an actual wait: handler threads are daemons, so exiting
        # straight after shutdown() would sever mid-decode streams.
        deadline = time.monotonic() + args.drain_timeout
        while srv.router.total_inflight() > 0:
            if time.monotonic() >= deadline:
                print(f"drain timed out after {args.drain_timeout:g}s "
                      f"({srv.router.total_inflight()} stream(s) "
                      "still proxying)")
                break
            time.sleep(0.1)
        else:
            print("drain complete")
        srv.shutdown()

    def _on_sigterm(signum, frame):
        print("SIGTERM: router draining (/readyz now 503)")
        srv.begin_drain()
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    import signal

    signal.signal(signal.SIGTERM, _on_sigterm)
    print(
        f"routing {len(replicas)} replica(s) on "
        f"http://{args.host}:{args.port}: "
        + ", ".join(f"{rid}={url}" for rid, url in replicas)
    )
    srv.serve_forever()


if __name__ == "__main__":
    main()
