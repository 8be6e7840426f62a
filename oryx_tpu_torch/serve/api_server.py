"""OpenAI-compatible chat API server over the port's engines (port of
`oryx_tpu.serve.api_server`). Stdlib-only (http.server).

  POST /v1/chat/completions
    {"model": "...", "messages": [{"role": "user", "content": ...}],
     "max_tokens": 64, "stream": false}
  GET /v1/models
  GET /healthz          (liveness: the process is up)
  GET /readyz           (readiness: engine loop alive, un-stalled, not
                         draining; 503 with a reason otherwise)
  GET /metrics          (Prometheus text: build_info, the card-memory
                         gauges, oryx_anomaly_total, the engine families)
  GET /debug/requests   (flight recorder: the last N requests, in-flight
                         too; ?limit=K, ?state=active|done|error;
                         finished entries carry the cost ledger in
                         meta.cost; ?format=jsonl exports the wide-event
                         log, schema utils.metrics.REQUEST_EVENT_KEYS)
  GET /debug/trace?id=  (one request's span tree as Chrome trace JSON;
                         the id is the X-Request-Id every response
                         carries. A client's X-Request-Id is honoured,
                         sanitized, minted on absence or collision.)
  GET /debug/timeline?n= (scheduler engines: the step timeline, newest
                         first, and its dispatch counts by kind, which
                         reconcile with oryx_serving_dispatches_total)
  GET /debug/pages      (the page-ownership map and its summary, which
                         reconciles with the oryx_pool_* gauges;
                         ?format=summary leaves out the per-page records)
  GET /debug/oom?n=     (memory-pressure forensic records)
  GET /debug/audit?n=   (output-audit records and verdict totals, which
                         reconcile with oryx_audit_total)
  GET /debug/journal?n= (the decision journal's ring: header, counts by
                         kind, newest-first entries; armed=false without
                         journal_path)
  GET /debug/profile?steps=K&timeout=S
                        (on-demand device-time capture: the next K engine
                         dispatches under torch.profiler, answered with a
                         Chrome trace and the per-kind attribution; 503
                         when the engine runs no dispatch in time; on the
                         card the engine then waits 0.2 s before the
                         capture stops, utils/profiling.CAPTURE_GRACE_S,
                         and serves nothing meanwhile)

Content may be a plain string or OpenAI content-part lists; image parts
(`{"type": "image_url", "image_url": {"url": "data:image/png;base64,..."
| "file:///path" | "/path"}}`) attach media to the turn. Images decode
through PIL where it is installed; a host without PIL still reads PNG
(data/media.py). Media bind to the FIRST user turn and are
rejected elsewhere with a 400. `temperature`, `top_p`, `stop` and `seed`
are honoured per request; `n > 1` and `logprobs` are rejected with a 400.

engine="window": non-streaming requests arriving within `batch_window`
seconds decode as ONE `Pipeline.chat_batch` call; `stream=true` requests
run singly through `chat_stream` and emit SSE chunks. Any other engine
name resolves through the Engine registry (serve/engine.py):
"continuous" routes every request, streaming or not, through the
`ContinuousScheduler`.

    python -m oryx_tpu_torch.serve.api_server --model-path DIR \\
        [--engine continuous --ragged] [--device cpu] [--port 8000]

`ORYX_LOCK_SANITIZER=1` arms the lock-order sanitizer and race detector
(analysis/sanitizers.py) when the server is built: every lock of the
serving stack is a `named_lock` of oryx_tpu_torch/concurrency.py's order,
and the oryx_lock_{wait,hold}_seconds histograms join /metrics. Disarmed,
the locks are plain `threading` primitives and nothing changes.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
import signal
import subprocess
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

import numpy as np

from oryx_tpu_torch.analysis import sanitizers
from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.data import media
from oryx_tpu_torch.serve import journal as journal_lib
from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils.metrics import ServingMetrics


def _git_revision() -> str:
    """Best-effort build identity for the build_info metric: git HEAD of
    the source tree, or ORYX_GIT_REV when deployed from an export."""
    if rev := os.environ.get("ORYX_GIT_REV"):
        return rev
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _decode_image(url: str, *, allow_local_files: bool) -> np.ndarray:
    """data: URI (base64) or, when explicitly allowed, a file path/URI ->
    HWC uint8 RGB. Local paths are opt-in: a network client must not make
    the server open arbitrary files."""
    if url.startswith("data:"):
        return media.decode_image(base64.b64decode(url.split(",", 1)[1]))
    if not allow_local_files:
        raise ValueError(
            "image_url must be a data: URI (local file paths require "
            "--allow-local-files)"
        )
    path = url[len("file://"):] if url.startswith("file://") else url
    return media.load_image(path)


def parse_messages(
    messages: list[dict[str, Any]],
    *,
    allow_local_files: bool = False,
) -> tuple[str, list[tuple[str, str]], list[np.ndarray]]:
    """OpenAI messages -> (current question, (user, assistant) history,
    images). The last message must be a user turn; system messages fold
    into the next user text (the template carries its own system
    prompt)."""
    turns: list[tuple[str, str | None]] = []
    images: list[np.ndarray] = []
    pending_system = ""
    for m in messages:
        role, content = m.get("role"), m.get("content", "")
        if role == "developer":  # OpenAI's modern alias for system
            role = "system"
        if role in ("tool", "function"):
            raise ValueError(
                "tool/function messages are not supported "
                "(this model has no tool-calling)"
            )
        if role not in ("system", "user", "assistant"):
            raise ValueError(f"unsupported message role {role!r}")
        text_parts: list[str] = []
        msg_images: list[np.ndarray] = []
        if isinstance(content, str):
            text_parts.append(content)
        else:
            for part in content:
                if part.get("type") == "text":
                    text_parts.append(part.get("text", ""))
                elif part.get("type") == "image_url":
                    msg_images.append(_decode_image(
                        part["image_url"]["url"],
                        allow_local_files=allow_local_files,
                    ))
        if msg_images:
            # The template binds media to the FIRST user turn; accepting
            # them elsewhere would silently re-pin them.
            if role != "user":
                raise ValueError(
                    f"image parts are only supported on user messages "
                    f"(got {role!r})"
                )
            if turns:
                raise ValueError(
                    "images must attach to the FIRST user message: this "
                    "model binds all media to the conversation's opening "
                    "turn"
                )
            images.extend(msg_images)
        text = "\n".join(t for t in text_parts if t)
        if role == "system":
            pending_system = (
                f"{pending_system}\n{text}" if pending_system else text
            )
        elif role == "user":
            if pending_system:
                text = f"{pending_system}\n{text}" if text else pending_system
                pending_system = ""
            turns.append((text, None))
        elif role == "assistant":
            if not turns or turns[-1][1] is not None:
                raise ValueError("assistant message without a user turn")
            turns[-1] = (turns[-1][0], text)
    if pending_system:
        raise ValueError("system message must precede a user turn")
    if not turns or turns[-1][1] is not None:
        raise ValueError("the last message must be from the user")
    question = turns[-1][0]
    history = turns[:-1]
    if any(a is None for _, a in history):
        raise ValueError("history user turns must alternate with assistant")
    return question, history, images


class EngineSupervisor(threading.Thread):
    """Watches the continuous scheduler's engine thread and restarts it
    after a crash (`scheduler.restart()`: residents requeued for replay,
    the pool rebuilt with its invariant checked). Bounded: more than
    `max_restarts` deaths inside `window_s` is systemic, and the
    supervisor gives up, fails the stranded requests and leaves /readyz
    at 503."""

    def __init__(self, scheduler, *, poll_s: float = 0.25,
                 max_restarts: int = 5, window_s: float = 60.0):
        super().__init__(daemon=True, name="engine-supervisor")
        self.scheduler = scheduler
        scheduler.set_supervised(True)
        self.poll_s = poll_s
        self.max_restarts = max_restarts
        self.window_s = window_s
        # Written by this thread at give-up, read by /readyz threads.
        self._gave_up = threading.Event()
        # Not `_stop`: threading.Thread has a private _stop() method.
        self._halt = threading.Event()
        self._restart_times: list[float] = []  # thread-owned: supervisor

    @property
    def gave_up(self) -> bool:
        return self._gave_up.is_set()

    def stop(self) -> None:
        self.scheduler.set_supervised(False)
        self._halt.set()

    def run(self) -> None:
        while not self._halt.wait(self.poll_s):
            s = self.scheduler
            if s.stopping:
                return  # deliberate shutdown/drain: nothing to revive
            if s.alive() or self.gave_up:
                continue
            now = time.monotonic()
            self._restart_times = [
                t for t in self._restart_times if now - t < self.window_s
            ]
            if len(self._restart_times) >= self.max_restarts:
                self._gave_up.set()
                s.set_supervised(False)
                try:
                    s.fail_inflight(
                        "engine dead (supervisor gave up after "
                        f"{self.max_restarts} restarts in "
                        f"{self.window_s:g}s)"
                    )
                # fault-boundary: a failing cleanup must not kill the
                # supervisor before it reaches its give-up endpoint
                except Exception:
                    import traceback

                    traceback.print_exc()
                continue
            self._restart_times.append(now)
            try:
                s.restart()
            # fault-boundary: a failed restart counts against the budget
            # and is retried at the next poll
            except Exception:
                import traceback

                traceback.print_exc()


def _decode_bucket(max_new: int) -> int:
    """Decode-length bucket: next power of two, floor 16. Requests whose
    max_tokens share a bucket batch together; each row trims to its own
    cap (chat_batch per_row_max)."""
    return max(16, 1 << (max_new - 1).bit_length())


class _Pending:
    def __init__(
        self, request: dict[str, Any], max_new: int,
        sampling: dict[str, Any] | None = None,
        trace: trace_lib.Trace | None = None,
    ):
        self.request = request
        self.max_new = max_new
        # Requests batch together only when ALL of these match.
        self.sampling = sampling or {}
        self.done = threading.Event()
        self.reply: str | None = None
        self.finish_reason: str = "stop"
        self.usage: tuple[int, int] | None = None
        self.error: str | None = None
        self.trace = trace
        self.request_id = trace.id if trace else trace_lib.new_request_id()
        self._qw = trace.begin("queue_wait") if trace else -1

    @property
    def batch_key(self) -> tuple:
        s = self.sampling
        # A sampled row's draw depends on its row in the batch, so an
        # explicitly seeded request runs solo (a unique key).
        solo = id(self) if "seed" in s else None
        return (
            _decode_bucket(self.max_new), s.get("temperature"),
            s.get("top_p"), tuple(s.get("stop") or ()), s.get("seed"),
            solo,
        )


class Batcher:
    """Groups concurrent non-streaming requests into one chat_batch call.

    One worker thread drains the queue: it waits `window` seconds after
    the first pending request for company (requests batch together when
    their max_tokens share a decode bucket and their sampling matches),
    then runs the group as one `chat_batch`. `device_lock` serializes the
    device against concurrent streams. Each group lands on its members'
    traces as one "decode" span carrying `group` (the Batcher's group
    index), `batch_size` and `row`, so the grouping it formed can be read
    back from /debug/trace."""

    def __init__(
        self,
        pipe,
        *,
        window: float = 0.02,
        max_batch: int = 8,
        device_lock: threading.Lock | None = None,
        metrics: ServingMetrics | None = None,
        tracer: trace_lib.Tracer | None = None,
    ):
        self.pipe = pipe
        self.window = window
        self.max_batch = max_batch
        self.device_lock = device_lock or threading.Lock()
        self.metrics = metrics or ServingMetrics()
        self.tracer = tracer or trace_lib.Tracer()
        self.q: queue.Queue[_Pending] = queue.Queue()
        # A request whose key mismatched the group in flight LEADS the
        # next group (FIFO).
        self._carry: _Pending | None = None  # thread-owned: batcher
        self._groups = 0  # thread-owned: batcher
        self._thread = threading.Thread(
            target=self._run, name="window-batcher", daemon=True
        )
        self._thread.start()

    def submit(
        self, request: dict[str, Any], max_new: int,
        sampling: dict[str, Any] | None = None,
        request_id: str | None = None,
    ) -> _Pending:
        tr = self.tracer.start_trace(
            "request", label=f"chat max_new={max_new}", id=request_id,
        )
        p = _Pending(request, max_new, sampling, trace=tr)
        self.q.put(p)
        return p

    def _run(self) -> None:
        while True:
            first = self._carry or self.q.get()
            self._carry = None
            group = [first]
            deadline = time.monotonic() + self.window
            while len(group) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt.batch_key != first.batch_key:
                    self._carry = nxt
                    break
                group.append(nxt)
            self._decode(group)
            self.metrics.set_gauge("queue_depth", self.q.qsize())

    def _decode(self, group: list[_Pending]) -> None:
        first = group[0]
        s = first.sampling
        bucket = _decode_bucket(first.max_new)
        gid = self._groups
        self._groups += 1
        for p in group:
            p.trace.end(p._qw)
        t0_ns = trace_lib.now_ns()
        try:
            with self.device_lock:
                replies, reasons, counts = self.pipe.chat_batch(
                    [p.request for p in group],
                    max_new_tokens=bucket,
                    per_row_max=[p.max_new for p in group],
                    return_finish_reasons=True,
                    return_token_counts=True,
                    temperature=s.get("temperature"),
                    top_p=s.get("top_p"),
                    stop=s.get("stop"),
                    seed=s.get("seed") or 0,
                )
            for row, (p, r, why, use) in enumerate(
                zip(group, replies, reasons, counts)
            ):
                p.reply, p.finish_reason, p.usage = r, why, use
                p.trace.add_complete(
                    "decode", t0_ns, batch_size=len(group), bucket=bucket,
                    group=gid, row=row,
                )
                p.trace.finish(
                    finish_reason=why, prompt_tokens=use[0],
                    completion_tokens=use[1],
                )
            # The whole group decodes the BUCKET length; a row's useful
            # steps are the tokens it kept.
            useful = sum(c for _, c in counts)
            self.metrics.inc("decode_steps_total", len(group) * bucket)
            self.metrics.inc("decode_steps_useful", useful)
            self.metrics.inc(
                "decode_steps_wasted", len(group) * bucket - useful
            )
            self.metrics.inc("completed", len(group))
        except Exception as e:  # surface per request, keep serving
            for p in group:
                p.error = f"{type(e).__name__}: {e}"
                p.trace.finish(error=p.error)
        for p in group:
            p.done.set()


def _parse_sampling(req: dict[str, Any]) -> dict[str, Any]:
    """Validate OpenAI sampling fields -> kwargs for chat_batch /
    chat_stream / the scheduler. Unsupported values raise (400)."""
    if int(req.get("n", 1)) != 1:
        raise ValueError("n > 1 is not supported")
    if req.get("logprobs"):
        raise ValueError("logprobs is not supported")
    out: dict[str, Any] = {}
    # Two decimals, as the JAX server does (there they are compiled-program
    # arguments).
    if (t := req.get("temperature")) is not None:
        t = float(t)
        if not 0.0 <= t <= 2.0:
            raise ValueError(f"temperature must be in [0, 2], got {t}")
        out["temperature"] = round(t, 2)
    if (p := req.get("top_p")) is not None:
        p = float(p)
        if not 0.0 < p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {p}")
        out["top_p"] = round(p, 2)
    if (stop := req.get("stop")) is not None:
        if isinstance(stop, str):
            stop = [stop]
        if not (
            isinstance(stop, list)
            and all(isinstance(s, str) for s in stop)
            and len(stop) <= 8
        ):
            raise ValueError("stop must be a string or <=8 strings")
        out["stop"] = [s for s in stop if s]
    if (seed := req.get("seed")) is not None:
        out["seed"] = int(seed)
    return out


def _completion_body(
    model: str, reply: str, finish_reason: str = "stop",
    usage: tuple[int, int] | None = None,
    request_id: str | None = None,
) -> dict[str, Any]:
    body = {
        # The completion id embeds the request id, so a client log line
        # joins /debug/trace without the header.
        "id": f"chatcmpl-{request_id or uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": reply},
            "finish_reason": finish_reason,
        }],
    }
    if usage is not None:
        prompt, completion = usage
        body["usage"] = {
            "prompt_tokens": prompt,
            "completion_tokens": completion,
            "total_tokens": prompt + completion,
        }
    return body


def _chunk_body(
    model: str, cid: str, delta: str | None, finish_reason: str = "stop",
    *,
    usage_field: bool = False,
    usage: dict[str, int] | None = None,
) -> dict[str, Any]:
    """One chat.completion.chunk. usage_field=True adds the "usage" key per
    OpenAI's stream_options.include_usage contract: null on every delta
    chunk, the totals on the FINAL chunk (empty choices: pass usage with
    delta=None)."""
    choice: dict[str, Any] = {"index": 0, "delta": {}, "finish_reason": None}
    if delta is None:
        choice["finish_reason"] = finish_reason
    else:
        choice["delta"] = {"content": delta}
    choices = [] if usage else [choice]
    body: dict[str, Any] = {
        "id": cid, "object": "chat.completion.chunk",
        "created": int(time.time()), "model": model, "choices": choices,
    }
    if usage_field:
        body["usage"] = usage
    return body


def build_server(
    pipe,
    *,
    model_name: str = "oryx-tpu",
    host: str = "127.0.0.1",
    port: int = 8000,
    batch_window: float = 0.02,
    max_batch: int = 8,
    allow_local_files: bool = False,
    max_tokens_limit: int = 2048,
    engine: str = "window",
    num_slots: int = 4,
    page_size: int = 64,
    decode_chunk: int = 8,
    max_ctx: int = 2048,
    prefill_chunk: int | None = None,
    prefix_cache: bool = True,
    ragged: bool = False,
    speculate: int = 0,
    fuse_steps: int | str = 1,
    draft_model: str | None = None,
    kv_dtype: str = "bf16",
    host_cache_bytes: int = 0,
    audit_tol_maxdiff: float | None = None,
    audit_tol_kl: float | None = None,
    profile_sample_every: int = 0,
    audit_sample_every: int = 0,
    numerics_every: int = 0,
    stall_timeout: float | None = None,
    flight_recorder_size: int = 256,
    ttft_slo: float | None = None,
    queue_depth_slo: int | None = None,
    events_path: str | None = None,
    max_queue: int | None = 256,
    request_timeout: float | None = None,
    degraded_cooldown: float = 30.0,
    supervise: bool = True,
    faults_spec: str | None = None,
    replica_id: str | None = None,
    requests_log_path: str | None = None,
    requests_log_max_bytes: int = 16 * 1024 * 1024,
    journal_path: str | None = None,
    journal_max_bytes: int = 64 * 1024 * 1024,
) -> ThreadingHTTPServer:
    """Construct (not start) the HTTP server around a pipeline; the engines
    run on the pipeline's device.

    engine: "window" groups non-streaming requests that arrive within
    `batch_window` into one chat_batch and runs streams solo; any other
    name resolves through the Engine registry (serve/engine.py):
    "continuous" routes everything through the ContinuousScheduler.

    Containment (continuous engine): max_queue bounds admission (full ->
    429 + Retry-After), request_timeout deadlines every request (504), an
    EngineSupervisor restarts a dead engine thread with request replay,
    and `srv.begin_drain()` (SIGTERM in main()) flips /readyz to 503,
    stops admission and finishes the residents. events_path: where the
    anomaly monitor appends its JSONL events. ttft_slo / queue_depth_slo
    arm the serving SLO detectors, whose firings drive the degraded-mode
    ladder (gauge oryx_serving_degraded_mode; `degraded_cooldown` quiet
    seconds step it down). faults_spec arms the seeded fault points
    (utils/faults.py), for chaos testing.

    Observatories (scheduler engines): audit_sample_every audits every Nth
    finished request (0 = off; audit_tol_maxdiff / audit_tol_kl set its
    drift-vs-fail boundary), numerics_every arms the logit probe every N
    engine steps (0 = off), profile_sample_every captures the device time
    of every Nth dispatch (0 = off), and journal_path records the decision
    journal (size-capped at journal_max_bytes, rolling to PATH.1) that
    serve/replay.py replays."""
    from oryx_tpu_torch.utils.anomaly import AnomalyMonitor, AnomalyThresholds

    if faults_spec:
        faults.configure(faults_spec)
    if engine == "window" and (ttft_slo or queue_depth_slo):
        raise ValueError(
            "--ttft-slo/--queue-depth-slo require a scheduler engine (the "
            "window batcher does not feed the SLO detectors)"
        )
    if engine == "window" and ragged:
        raise ValueError(
            "--ragged requires a scheduler engine (the window batcher "
            "has no paged dispatch to fuse)"
        )
    if speculate and not ragged:
        raise ValueError(
            "--speculate requires --ragged (draft tokens ride the fused "
            "packed dispatch as extra verify lanes)"
        )
    if fuse_steps != 1:
        if engine == "window":
            raise ValueError(
                "--fuse-steps requires a scheduler engine (the window "
                "batcher has no engine step to fuse)"
            )
        if not ragged:
            raise ValueError(
                "--fuse-steps requires --ragged (the megastep repeats the "
                "fused ragged step)"
            )
        if speculate and not draft_model:
            raise ValueError(
                "--fuse-steps with --speculate needs --draft-model: the "
                "host-side n-gram drafter cannot ride the fused step"
            )
    if draft_model and not speculate:
        raise ValueError(
            "--draft-model requires --speculate (the draft model proposes "
            "speculative tokens)"
        )
    if engine == "window" and request_timeout:
        raise ValueError(
            "--request-timeout requires a scheduler engine (the window "
            "batcher does not enforce per-request deadlines)"
        )
    if engine == "window" and profile_sample_every:
        raise ValueError(
            "--profile-sample-every requires a scheduler engine (the "
            "window batcher has no engine step loop to sample)"
        )
    if engine == "window" and (audit_sample_every or numerics_every):
        raise ValueError(
            "--audit-sample-every/--numerics-every require a scheduler "
            "engine (the window batcher has no paged replay path or "
            "engine step loop)"
        )
    if engine == "window" and (kv_dtype != "bf16" or host_cache_bytes):
        raise ValueError(
            "--kv-dtype/--host-cache-bytes require a scheduler engine (the "
            "window batcher has no paged KV pool or prefix cache)"
        )
    if engine == "window" and journal_path:
        raise ValueError(
            "--journal requires a scheduler engine (the window batcher has "
            "no decision stream to record)"
        )
    # $ORYX_LOCK_SANITIZER=1 arms the lock-order sanitizer and race
    # detector for this server, before the registry and the scheduler are
    # built so every named lock they make is instrumented; the registry is
    # bound right after, so oryx_lock_{wait,hold}_seconds reach /metrics.
    sanitizers.maybe_arm_from_env()
    metrics = ServingMetrics()
    build_labels = {
        "revision": _git_revision(), "engine": engine, "model": model_name,
    }
    if replica_id:
        build_labels["replica"] = replica_id
    metrics.set_info("build_info", build_labels)
    if faults.armed():
        faults.bind_registry(metrics.registry)
    sanitizers.bind_lock_metrics(metrics.registry)
    # Always built, so oryx_anomaly_total exists on every replica.
    anomaly = AnomalyMonitor(
        source="serve",
        thresholds=AnomalyThresholds(
            ttft_slo_s=ttft_slo, queue_depth_slo=queue_depth_slo,
        ),
        events_path=events_path, registry=metrics.registry,
    )
    # One flight recorder for the server: the last `flight_recorder_size`
    # requests, in flight and finished.
    tracer = trace_lib.Tracer(flight_recorder_size)
    # chat_stream and chat_batch share one device: window-engine streams
    # serialize with each other and with the batcher through this lock.
    stream_lock = named_lock("server.stream_lock")
    batcher = scheduler = supervisor = None
    # Set once by begin_drain(), read by /readyz and every POST.
    draining = threading.Event()
    if engine == "window":
        batcher = Batcher(
            pipe, window=batch_window, max_batch=max_batch,
            device_lock=stream_lock, metrics=metrics, tracer=tracer,
        )
    else:
        from oryx_tpu_torch.serve import engine as engine_lib
        from oryx_tpu_torch.utils.request_log import RequestLog

        request_log = RequestLog(
            requests_log_path, max_bytes=requests_log_max_bytes
        )
        # The server stamps the workload's identity into the journal's
        # header; the scheduler stamps its geometry and seals it.
        journal = None
        if journal_path:
            journal = journal_lib.DecisionJournal(
                journal_path, max_bytes=journal_max_bytes
            )
            journal.stamp_header(
                model=model_name, faults_spec=faults_spec or None,
                max_tokens_limit=max_tokens_limit,
            )
        drafter = None
        if draft_model:
            from oryx_tpu_torch.models import generate as generate_lib

            drafter = generate_lib.NeuralDrafter.from_spec(draft_model)
        scheduler = engine_lib.create_engine(
            engine, pipe, num_slots=num_slots, page_size=page_size,
            chunk=decode_chunk, max_ctx=max_ctx, metrics=metrics,
            tracer=tracer, stall_timeout=stall_timeout, anomaly=anomaly,
            prefill_chunk=prefill_chunk, prefix_cache=prefix_cache,
            ragged=ragged, speculate=speculate, fuse_steps=fuse_steps,
            drafter=drafter, kv_dtype=kv_dtype,
            host_cache_bytes=host_cache_bytes, max_queue=max_queue,
            request_timeout=request_timeout, request_log=request_log,
            engine_label=engine, replica_id=replica_id,
            audit_sample_every=audit_sample_every,
            audit_tol_maxdiff=audit_tol_maxdiff, audit_tol_kl=audit_tol_kl,
            numerics_every=numerics_every,
            profile_sample_every=profile_sample_every,
            degraded_cooldown=degraded_cooldown, journal=journal,
        )
        if supervise:
            supervisor = EngineSupervisor(scheduler)
            supervisor.start()

    def _ready() -> tuple[bool, str]:
        """The engine can make progress: its own readiness() plus what
        only the server knows (a server-level drain, a supervisor that
        gave up)."""
        if draining.is_set():
            return False, "draining"
        if scheduler is not None:
            if (
                not scheduler.alive()
                and supervisor is not None and supervisor.gave_up
            ):
                return False, (
                    "engine dead (supervisor gave up after "
                    f"{supervisor.max_restarts} restarts in "
                    f"{supervisor.window_s:g}s)"
                )
            return scheduler.readiness()
        if not batcher._thread.is_alive():
            return False, "batcher loop dead"
        return True, "ok"

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet access log
            pass

        def _json(self, code: int, body: dict[str, Any],
                  request_id: str | None = None,
                  extra_headers: dict[str, str] | None = None) -> None:
            data = json.dumps(body).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if request_id:
                self.send_header("X-Request-Id", request_id)
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def _query(self) -> dict[str, list[str]]:
            return urllib.parse.parse_qs(
                urllib.parse.urlsplit(self.path).query
            )

        def do_GET(self):
            route = self.path.split("?", 1)[0]
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/readyz":
                ready, reason = _ready()
                self._json(
                    200 if ready else 503,
                    {"ready": ready, "reason": reason},
                )
            elif route == "/debug/requests":
                self._debug_requests()
            elif route == "/debug/timeline":
                # Newest-first step records and the cumulative dispatch
                # counts by kind.
                self._ring_debug(
                    lambda: scheduler.timeline, default_n=64,
                    unavailable="the step timeline requires a "
                    "scheduler engine (the window batcher has no "
                    "engine step loop)",
                )
            elif route == "/debug/pages":
                self._debug_pages()
            elif route == "/debug/oom":
                self._ring_debug(
                    lambda: scheduler.forensics, default_n=16,
                    unavailable="OOM forensics require a scheduler "
                    "engine (the window batcher has no paged pool)",
                )
            elif route == "/debug/audit":
                self._ring_debug(
                    lambda: scheduler.auditor, default_n=16,
                    unavailable="output audits require a scheduler "
                    "engine (the window batcher has no paged replay "
                    "path)",
                )
            elif route == "/debug/journal":
                # The decision journal's ring; a server without one serves
                # the same body shape with armed=false.
                self._ring_debug(
                    lambda: scheduler.journal or journal_lib.DISARMED,
                    default_n=64,
                    unavailable="the decision journal requires a "
                    "scheduler engine (the window batcher has no "
                    "decision stream to record)",
                )
            elif route == "/debug/profile":
                self._debug_profile()
            elif self.path.startswith("/debug/trace"):
                rid = (self._query().get("id") or [""])[0]
                if not rid:
                    self._json(400, {"error": "missing ?id=<request id>"})
                    return
                tr = tracer.get(rid)
                if tr is None:
                    self._json(404, {
                        "error": f"no trace for id {rid!r} (the flight "
                        "recorder keeps the last "
                        f"{tracer.capacity} requests)"
                    })
                    return
                body = tracer.chrome_trace([tr])
                body["request"] = tr.summary()
                self._json(200, body, request_id=rid)
            elif self.path == "/metrics":
                if batcher is not None:
                    metrics.set_gauge("queue_depth", batcher.q.qsize())
                data = metrics.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/v1/models":
                self._json(200, {
                    "object": "list",
                    "data": [{
                        "id": model_name, "object": "model",
                        "owned_by": "oryx-tpu",
                    }],
                })
            else:
                self._json(404, {"error": "not found"})

        def _ring_debug(self, get_ring, *, unavailable: str,
                        default_n: int) -> None:
            """The ring-backed debug endpoints (/debug/timeline, /oom,
            /audit): scheduler engines only, one ?n= contract (0 = all),
            the engine label and the ring's to_dict(n)."""
            if scheduler is None:
                self._json(400, {"error": unavailable})
                return
            try:
                n = int((self._query().get("n") or [str(default_n)])[0])
                if n < 0:
                    raise ValueError
            except ValueError:
                self._json(400, {
                    "error": "n must be a non-negative integer",
                })
                return
            body = {"engine": engine}
            body.update(get_ring().to_dict(n or None))
            self._json(200, body)

        def _debug_profile(self) -> None:
            """The next ?steps=K (1..256, default 4) dispatches under one
            capture; ?timeout= seconds (clamped to [1, 300], default 30)
            for them to happen."""
            if scheduler is None:
                self._json(400, {
                    "error": "profiling requires a scheduler engine (the "
                    "window batcher has no engine step loop)",
                })
                return
            q = self._query()
            try:
                steps = int((q.get("steps") or ["4"])[0])
                if not 1 <= steps <= 256:
                    raise ValueError
            except ValueError:
                self._json(400, {
                    "error": "steps must be an integer in [1, 256]",
                })
                return
            try:
                timeout = float((q.get("timeout") or ["30"])[0])
            except ValueError:
                self._json(400, {"error": "timeout must be a number"})
                return
            try:
                result = scheduler.request_profile(
                    steps, timeout=max(1.0, min(timeout, 300.0))
                )
            except TimeoutError as e:
                self._json(503, {"error": str(e)},
                           extra_headers={"Retry-After": "1"})
                return
            except RuntimeError as e:
                self._json(503, {"error": str(e)})
                return
            result["engine"] = engine
            self._json(200, result)

        def _debug_pages(self) -> None:
            """The live page-ownership map and its summary (?format=json,
            the default, or summary: no per-page records)."""
            if scheduler is None:
                self._json(400, {
                    "error": "the page map requires a scheduler engine "
                    "(the window batcher has no paged pool)",
                })
                return
            fmt = (self._query().get("format") or ["json"])[0]
            if fmt not in ("json", "summary"):
                self._json(400, {
                    "error": f"unknown format {fmt!r} (json|summary)",
                })
                return
            snap = scheduler.pool_snapshot()
            body = {
                "engine": engine,
                "num_pages": snap["num_pages"],
                "page_size": snap["page_size"],
                "kv_dtype": snap.get("kv_dtype"),
                "kv_pool_bytes": snap.get("kv_pool_bytes"),
                "summary": snap["summary"],
            }
            if fmt == "json":
                body["pages"] = snap["pages"]
            self._json(200, body)

        def _debug_requests(self) -> None:
            """Newest-first summaries of the last N requests (?limit=,
            ?state=), or the wide-event log (?format=jsonl)."""
            q = self._query()
            fmt = (q.get("format") or [""])[0]
            if fmt not in ("", "json", "jsonl"):
                self._json(400, {
                    "error": f"unknown format {fmt!r} (json|jsonl)",
                })
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
            if fmt == "jsonl":
                if scheduler is None:
                    self._json(400, {
                        "error": "wide events require a scheduler engine "
                        "(the window batcher has no request log)",
                    })
                    return
                data = scheduler.request_log.export_jsonl(
                    limit or None
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            state = (q.get("state") or [""])[0]
            if state not in ("", "all", "active", "done", "error"):
                self._json(400, {
                    "error": f"unknown state {state!r} "
                    "(active|done|error|all)",
                })
                return
            reqs = tracer.snapshot()
            if state == "active":
                reqs = [r for r in reqs if not r["done"]]
            elif state == "done":
                reqs = [
                    r for r in reqs
                    if r["done"] and "error" not in r["meta"]
                ]
            elif state == "error":
                reqs = [r for r in reqs if "error" in r["meta"]]
            total = len(reqs)
            if limit:
                reqs = reqs[:limit]
            self._json(200, {
                "engine": engine, "total": total, "returned": len(reqs),
                "requests": reqs,
            })

        def do_POST(self):
            if self.path != "/v1/chat/completions":
                self._json(404, {"error": "not found"})
                return
            if draining.is_set():
                self._json(503, {"error": {
                    "message": "server is draining (shutting down)",
                    "type": "unavailable_error",
                }}, extra_headers={"Retry-After": "1"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                question, history, images = parse_messages(
                    req["messages"], allow_local_files=allow_local_files
                )
                raw_max = req.get(
                    "max_tokens", req.get("max_completion_tokens")
                )
                if raw_max is None:
                    max_new = pipe.cfg.generation.max_new_tokens
                else:
                    max_new = int(raw_max)
                    if max_new < 1:
                        raise ValueError(
                            f"max_tokens must be >= 1, got {max_new}"
                        )
                    if max_new > max_tokens_limit:
                        raise ValueError(
                            f"max_tokens must be <= {max_tokens_limit}, "
                            f"got {max_new}"
                        )
                sampling = _parse_sampling(req)
                if (so := req.get("stream_options")) is not None:
                    if not req.get("stream"):
                        raise ValueError(
                            "stream_options requires stream: true"
                        )
                    if not isinstance(so, dict) or set(so) - {
                        "include_usage"
                    }:
                        raise ValueError(
                            "stream_options supports only include_usage"
                        )
            except Exception as e:
                self._json(400, {"error": {
                    "message": f"{type(e).__name__}: {e}",
                    "type": "invalid_request_error",
                }})
                return
            # Request identity: a sanitized client X-Request-Id becomes the
            # trace id; a router's X-Oryx-Trace (`rid;parent-span`) wins.
            rid_pref = trace_lib.sanitize_request_id(
                self.headers.get("X-Request-Id")
            )
            routed = False
            router_parent: int | None = None
            if xt := self.headers.get("X-Oryx-Trace"):
                t_rid, _, t_parent = xt.partition(";")
                if t_rid := trace_lib.sanitize_request_id(t_rid):
                    rid_pref = t_rid
                    routed = True
                    try:
                        router_parent = int(t_parent)
                    except ValueError:
                        router_parent = None
            is_video = bool(req.get("video")) and len(images) > 1
            request_dict = {
                "question": question, "images": images,
                "is_video": is_video, "history": history,
            }
            if scheduler is not None:
                self._continuous(
                    req, request_dict, max_new, sampling,
                    request_id=rid_pref, routed=routed,
                    router_parent=router_parent,
                )
            elif req.get("stream"):
                self._window_stream(
                    req, question, images, is_video, history, max_new,
                    sampling, rid_pref,
                )
            else:
                pending = batcher.submit(
                    request_dict, max_new, sampling, request_id=rid_pref
                )
                pending.done.wait()
                if pending.error is not None:
                    self._json(500, {"error": {"message": pending.error}},
                               request_id=pending.request_id)
                else:
                    self._json(200, _completion_body(
                        model_name, pending.reply, pending.finish_reason,
                        usage=pending.usage,
                        request_id=pending.request_id,
                    ), request_id=pending.request_id)

        def _window_stream(self, req, question, images, is_video, history,
                           max_new, sampling, rid_pref) -> None:
            """A solo chat_stream: a producer thread owns the device (and
            the lock); this handler thread only writes to the socket, so a
            slow client never blocks the device. `gone` signals a dead
            client: the producer then stops between chunks."""
            deltas: queue.Queue[tuple[str, str | None]] = queue.Queue(
                maxsize=64
            )
            gone = threading.Event()

            def put(item) -> bool:
                while not gone.is_set():
                    try:
                        deltas.put(item, timeout=0.5)
                        return True
                    except queue.Full:
                        continue
                return False

            want_usage = bool(
                (req.get("stream_options") or {}).get("include_usage")
            )
            usage: dict[str, int] = {}
            tr = tracer.start_trace(
                "request", label=f"stream max_new={max_new}", id=rid_pref,
            )

            def produce():
                gen = pipe.chat_stream(
                    question, images=images or None, is_video=is_video,
                    history=history, max_new_tokens=max_new,
                    usage_out=usage, **sampling,
                )
                try:
                    with stream_lock, trace_lib.activate(tr):
                        while not gone.is_set():
                            try:
                                d = next(gen)
                            except StopIteration as s:
                                reason = s.value or "stop"
                                tr.finish(finish_reason=reason, **usage)
                                put(("end", reason))
                                return
                            if not put(("delta", d)):
                                tr.finish(cancelled=True)
                                return
                        tr.finish(cancelled=True)
                except Exception as e:
                    msg = f"{type(e).__name__}: {e}"
                    tr.finish(error=msg)
                    put(("error", msg))
                finally:
                    gen.close()

            threading.Thread(target=produce, daemon=True).start()
            cid = f"chatcmpl-{tr.id}"
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Request-Id", tr.id)
                self.end_headers()
                while True:
                    kind, payload = deltas.get()
                    if kind == "delta":
                        self._sse(_chunk_body(
                            model_name, cid, payload, usage_field=want_usage,
                        ))
                    elif kind == "error":
                        self._sse({"error": {"message": payload}})
                        break
                    else:
                        self._sse(_chunk_body(
                            model_name, cid, None, payload,
                            usage_field=want_usage,
                        ))
                        break
                if want_usage:
                    p = usage.get("prompt_tokens", 0)
                    c = usage.get("completion_tokens", 0)
                    self._sse(_chunk_body(
                        model_name, cid, None, usage_field=True,
                        usage={
                            "prompt_tokens": p, "completion_tokens": c,
                            "total_tokens": p + c,
                        },
                    ))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:  # BrokenPipe / ConnectionReset included
                gone.set()  # stop the producer at its next chunk

        def _continuous(self, req, request_dict, max_new, sampling,
                        request_id=None, routed=False,
                        router_parent=None) -> None:
            """One request through the continuous scheduler. The engine
            thread owns the device; this handler only drains the handle's
            events (a dead client flips `cancelled`)."""
            from oryx_tpu_torch.serve.scheduler import AdmissionRejected

            try:
                handle = scheduler.submit(
                    request_dict, max_new, sampling,
                    streaming=bool(req.get("stream")),
                    request_id=request_id, routed=routed,
                )
            except AdmissionRejected as e:
                code = (503 if e.reason in ("draining", "engine_dead")
                        else 429)
                self._json(code, {"error": {
                    "message": str(e),
                    "type": "overloaded_error" if code == 429
                    else "unavailable_error",
                    "reason": e.reason,
                }}, extra_headers={
                    "Retry-After": str(max(1, round(e.retry_after_s))),
                })
                return
            rid = handle.request_id
            if routed:
                handle.trace.annotate(
                    routed=True, router_parent_span=router_parent
                )
            if not req.get("stream"):
                handle.done.wait()
                if handle.error is not None:
                    code, kind = {
                        "invalid_request": (400, "invalid_request_error"),
                        "timeout": (504, "timeout_error"),
                        "unavailable": (503, "unavailable_error"),
                    }.get(handle.error_kind, (500, None))
                    err: dict[str, Any] = {"message": handle.error}
                    if kind is not None:
                        err["type"] = kind
                    self._json(
                        code, {"error": err}, request_id=rid,
                        extra_headers=(
                            {"Retry-After": "1"} if code == 503 else None
                        ),
                    )
                else:
                    body = _completion_body(
                        model_name, handle.reply, handle.finish_reason,
                        usage=handle.usage, request_id=rid,
                    )
                    cost = handle.debug.get("cost")
                    if cost is not None:
                        body["oryx"] = {"cost": cost}
                    self._json(200, body, request_id=rid)
                return
            want_usage = bool(
                (req.get("stream_options") or {}).get("include_usage")
            )
            cid = f"chatcmpl-{rid}"
            try:
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("X-Request-Id", rid)
                self.end_headers()
                usage: tuple[int, int] | None = None
                while True:
                    kind, *payload = handle.events.get()
                    if kind == "delta":
                        self._sse(_chunk_body(
                            model_name, cid, payload[0],
                            usage_field=want_usage,
                        ))
                    elif kind == "error":
                        # Terminal: no usage chunk, no [DONE].
                        self._sse({"error": {"message": payload[0]}})
                        return
                    else:  # ("end", reason, usage)
                        usage = payload[1]
                        fin = _chunk_body(
                            model_name, cid, None, payload[0],
                            usage_field=want_usage,
                        )
                        cost = handle.debug.get("cost")
                        if cost is not None:
                            fin["oryx"] = {"cost": cost}
                        self._sse(fin)
                        break
                if want_usage:
                    p, c = usage or (0, 0)
                    self._sse(_chunk_body(
                        model_name, cid, None, usage_field=True,
                        usage={
                            "prompt_tokens": p, "completion_tokens": c,
                            "total_tokens": p + c,
                        },
                    ))
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except OSError:  # BrokenPipe / ConnectionReset included
                handle.cancelled = True

        def _sse(self, body: dict[str, Any]) -> None:
            # Fault site: a client that disconnects mid-stream; the raise
            # takes the path a dropped socket takes (the request is
            # cancelled and its pages freed).
            faults.fault_point("client_disconnect", exc=BrokenPipeError)
            self.wfile.write(f"data: {json.dumps(body)}\n\n".encode())
            self.wfile.flush()

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.metrics = metrics
    srv.scheduler = scheduler
    srv.batcher = batcher
    srv.tracer = tracer
    srv.anomaly = anomaly
    srv.supervisor = supervisor
    srv.request_log = (
        scheduler.request_log if scheduler is not None else None
    )
    srv.journal = scheduler.journal if scheduler is not None else None

    def begin_drain() -> None:
        """Drain-on-shutdown, step 1: /readyz flips to 503 now, POSTs
        answer 503 + Retry-After, and the continuous engine stops
        admission and finishes its residents. Callers then
        `scheduler.drain()` and shutdown()."""
        draining.set()
        if scheduler is not None:
            scheduler.begin_drain()

    srv.begin_drain = begin_drain
    return srv


def main(argv: list[str] | None = None) -> None:
    from oryx_tpu_torch.serve.engine import engine_names

    ap = argparse.ArgumentParser(
        description="Oryx OpenAI-style server (PyTorch/CUDA port)"
    )
    ap.add_argument("--model-path", required=True,
                    help="a directory written by serve/builder.py "
                    "(oryx_config.json + model.safetensors)")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--model-name", default="oryx-tpu")
    ap.add_argument("--device", default="cuda",
                    help="the device the model and engines run on; cpu "
                    "runs the plain twins of every kernel")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch-window", type=float, default=0.02)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument(
        "--engine", choices=["window"] + engine_names(), default="window",
        help="the window batcher (group within --batch-window) or the "
        "continuous-batching scheduler over a paged KV cache; sharded is "
        "the continuous engine over a --shard tp=N pipeline",
    )
    ap.add_argument("--replica-id", default=None)
    ap.add_argument("--num-slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--max-ctx", type=int, default=2048)
    ap.add_argument(
        "--prefill-chunk", type=int, default=512,
        help="continuous engine: prompt tokens prefilled per engine step "
        "(0 = each prompt in one dispatch)",
    )
    ap.add_argument("--ragged", action="store_true",
                    help="continuous engine: one packed dispatch per step")
    ap.add_argument("--speculate", type=int, default=0, metavar="K")
    ap.add_argument("--fuse-steps", default="1", metavar="K|auto")
    ap.add_argument("--draft-model", default=None,
                    metavar="PATH|init:V:D:W:SEED")
    ap.add_argument("--kv-dtype", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--host-cache-bytes", type=int, default=0)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--stall-timeout", type=float, default=120.0,
                    help="continuous engine: dump every thread stack when "
                    "no decode dispatch completes for this long (0 = off)")
    ap.add_argument("--flight-recorder-size", type=int, default=256)
    ap.add_argument("--events-path", default=None)
    ap.add_argument("--requests-log", default=None, metavar="PATH")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="continuous engine: admission queue bound "
                    "(0 = unbounded)")
    ap.add_argument("--request-timeout", type=float, default=None)
    ap.add_argument("--no-supervisor", action="store_true")
    ap.add_argument("--drain-timeout", type=float, default=60.0)
    ap.add_argument("--allow-local-files", action="store_true")
    ap.add_argument("--max-tokens-limit", type=int, default=2048)
    ap.add_argument("--quantize", default=None, choices=["int8"])
    ap.add_argument(
        "--audit-sample-every", type=int, default=0, metavar="N",
        help="continuous engine: audit every Nth finished request, replayed "
        "cold through the plain reference path at an idle point of the "
        "engine loop (greedy byte parity and logit drift; GET /debug/audit; "
        "0 = off)",
    )
    ap.add_argument(
        "--audit-tol-maxdiff", type=float, default=None, metavar="X",
        help="continuous engine: the logit max-abs-diff above which an "
        "audit's drift is a fail verdict (default from the pool format's "
        "round-trip error)",
    )
    ap.add_argument(
        "--audit-tol-kl", type=float, default=None, metavar="X",
        help="continuous engine: the KL above which an audit's drift is a "
        "fail verdict",
    )
    ap.add_argument(
        "--numerics-every", type=int, default=0, metavar="N",
        help="continuous engine: every N engine steps the dispatch carries "
        "the logit probe (oryx_numerics_* gauges; tokens unchanged; 0 = "
        "off; not with --speculate)",
    )
    ap.add_argument(
        "--profile-sample-every", type=int, default=0, metavar="N",
        help="continuous engine: every N engine steps, bracket one dispatch "
        "in a torch.profiler capture and credit its device busy time to "
        "oryx_device_time_seconds_total{kind=} and the step's "
        "/debug/timeline record (0 = off; a failed capture only counts in "
        "oryx_profile_capture_errors_total; on the card a sample of a "
        "CUDA graph replay may miss late kernel records). GET "
        "/debug/profile?steps=K captures on demand either way, and on the "
        "card holds the engine 0.2 s as it stops",
    )
    ap.add_argument(
        "--ttft-slo", type=float, default=None,
        help="an oryx_anomaly_total{kind=\"ttft_slo\"} event when a "
        "request's time to first token exceeds this many seconds; firings "
        "drive the degraded-mode ladder (continuous engine only)",
    )
    ap.add_argument(
        "--queue-depth-slo", type=int, default=None,
        help="an oryx_anomaly_total{kind=\"queue_depth_slo\"} event when "
        "the admission queue exceeds this depth (continuous engine only)",
    )
    ap.add_argument(
        "--degraded-cooldown", type=float, default=30.0,
        help="continuous engine: quiet seconds before the degraded-mode "
        "ladder steps down one level",
    )
    ap.add_argument(
        "--journal", default=None, metavar="PATH",
        help="continuous engine: record the decision journal here, one JSONL "
        "entry a dispatch and a scheduling decision (size-capped, rolls to "
        "PATH.1, the header re-written each generation); "
        "scripts/torch_replay_journal.py replays it; GET /debug/journal "
        "serves the ring",
    )
    ap.add_argument(
        "--journal-max-bytes", type=int, default=64 * 1024 * 1024,
        help="the journal file's size cap before it rolls",
    )
    ap.add_argument(
        "--faults", default=None, metavar="SPEC",
        help="arm the seeded fault points (utils/faults.py), e.g. "
        "'page_alloc_oom:p=0.05,seed=7;engine_crash:after=40'; chaos "
        "testing only ($ORYX_FAULTS also works)",
    )
    ap.add_argument(
        "--shard", default=None, metavar="MODE=N",
        help="tensor-parallel serving over N ranks this process starts "
        "(tp=N or fsdp=N; rank r on cuda:(r %% device_count), gloo where "
        "ranks share a card)",
    )
    args = ap.parse_args(argv)
    if args.quantize and args.shard:
        ap.error("--quantize is single-chip serving; drop --shard")
    if args.engine == "sharded" and not args.shard:
        ap.error("--engine sharded requires --shard tp=N")
    if args.ragged and not args.prefill_chunk:
        ap.error("--ragged requires a nonzero --prefill-chunk")
    if args.speculate < 0:
        ap.error("--speculate must be >= 0")
    if args.fuse_steps == "auto":
        fuse_steps: int | str = "auto"
    else:
        try:
            fuse_steps = int(args.fuse_steps)
        except ValueError:
            ap.error("--fuse-steps must be a positive integer or 'auto'")
        if fuse_steps < 1:
            ap.error("--fuse-steps must be a positive integer or 'auto'")

    from oryx_tpu_torch.serve.builder import shard_pipeline

    try:
        pipe = shard_pipeline(
            args.model_path, args.shard, tokenizer_path=args.tokenizer_path,
            quantize=args.quantize, device=args.device,
        )
    except ValueError as e:
        if args.shard and "--shard" in str(e):
            ap.error(str(e))
        raise
    srv = build_server(
        pipe, model_name=args.model_name, host=args.host, port=args.port,
        batch_window=args.batch_window, max_batch=args.max_batch,
        allow_local_files=args.allow_local_files,
        max_tokens_limit=args.max_tokens_limit,
        engine=args.engine, num_slots=args.num_slots,
        page_size=args.page_size, decode_chunk=args.decode_chunk,
        max_ctx=args.max_ctx, prefill_chunk=args.prefill_chunk or None,
        prefix_cache=not args.no_prefix_cache, ragged=args.ragged,
        speculate=args.speculate, fuse_steps=fuse_steps,
        draft_model=args.draft_model, kv_dtype=args.kv_dtype,
        host_cache_bytes=args.host_cache_bytes,
        audit_tol_maxdiff=args.audit_tol_maxdiff,
        audit_tol_kl=args.audit_tol_kl,
        profile_sample_every=args.profile_sample_every,
        audit_sample_every=args.audit_sample_every,
        numerics_every=args.numerics_every,
        stall_timeout=args.stall_timeout or None,
        flight_recorder_size=args.flight_recorder_size,
        ttft_slo=args.ttft_slo, queue_depth_slo=args.queue_depth_slo,
        events_path=args.events_path, max_queue=args.max_queue or None,
        request_timeout=args.request_timeout,
        degraded_cooldown=args.degraded_cooldown,
        supervise=not args.no_supervisor,
        faults_spec=args.faults or os.environ.get("ORYX_FAULTS"),
        replica_id=args.replica_id, requests_log_path=args.requests_log,
        journal_path=args.journal, journal_max_bytes=args.journal_max_bytes,
    )

    def _drain_and_exit() -> None:
        print("SIGTERM: draining (admission stopped, /readyz now 503)")
        srv.begin_drain()
        if srv.scheduler is not None:
            drained = srv.scheduler.drain(timeout=args.drain_timeout)
            print("drain complete" if drained
                  else f"drain timed out after {args.drain_timeout:g}s")
        srv.shutdown()

    def _on_sigterm(signum, frame):
        # serve_forever() owns this thread: drain from a helper so the
        # handler returns at once.
        threading.Thread(target=_drain_and_exit, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_sigterm)
    print(f"serving {args.model_name} on http://{args.host}:{args.port} "
          f"({pipe.device})")
    srv.serve_forever()


if __name__ == "__main__":
    main()
