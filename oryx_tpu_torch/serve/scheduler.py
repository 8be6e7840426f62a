"""Continuous-batching scheduler over the paged decode path (port of
`oryx_tpu.serve.scheduler.ContinuousScheduler`, the engine core).

A slot array + an admission queue around one pipeline:

  * The device runs one fixed-shape step forever: `paged_decode_chunk` over
    `num_slots` rows, `chunk` tokens per dispatch. Which request owns a
    slot is host state (block tables, lengths, per-slot sampling) edited
    between chunks.
  * A request is admitted the moment a slot AND enough KV pages are free:
    its prompt (text or multimodal, the pipeline's prompt prep) prefills
    into its own pages (`paged_prefill`) and it decodes from the next
    chunk on, mid-flight of everyone else.
  * A finished row's pages return to the free list at the chunk boundary
    and the head of the queue takes the slot.
  * Per-slot sampling state and per-request generators mean mixed
    sampling configs share the step and a row's samples never depend on
    its neighbours, which is what makes EVICTION sound: when the page
    pool runs dry the youngest slot is evicted and requeued, and its
    replay (same generator seed, same prompt) re-emits the same tokens,
    which `_Request.replay` skips so the client stream never repeats.

EOS and the template stop are detected on the device (the step freezes
finished rows); request stop strings and max_tokens are enforced on the
host at harvest, with the trim / stable-prefix text rules of the
pipeline.

Prefix cache (serve/prefix_cache.py, on by default as in the JAX engine):
admission looks up the longest page-aligned cached prefix of a text
prompt's token ids, shares its full pages into the slot's block table,
copies a partly consumed last page (copy-on-write) and prefills only the
suffix; a slot donates its prompt's full pages at activation and prompt +
reply at finish. Cache-only pages are evicted (LRU) before any slot is;
with `host_cache_bytes` they spill to host RAM and reload on a later hit.

KV pool format (`kv_dtype`): "bf16" stores pages densely in the compute
dtype, "int8" stores codes plus one fp32 scale per token row (quantized on
write, dequantized in the paged kernels' page walk); the cache moves codes
and scales verbatim.

Ragged mode (`ragged=True`): `_prefill_step` + `_step_chunk` fuse into
`_ragged_step`, ONE dispatch per engine step (`paged_ragged_step`) whose
packed rows carry every live slot's decode token plus `pf_width` prompt
tokens of the one admitting request.

Speculative decoding (`speculate=k`, ragged only): the step becomes ONE
packed verify forward (`paged_spec_step`) in which every live slot rides
1 + k lanes, its fed token and k drafts from `drafter` (`NgramDrafter` by
default), and advances 1..k+1 tokens. Stop strings are found on the host at
each harvest; rejected drafts leave dead bytes past the slot's length in
its own pages, so rollback frees nothing.

Fused megastep (`fuse_steps=K` or "auto" over FUSE_AUTO_LADDER, ragged
only): when nothing is admitting and the queue is empty, K logical steps
run before one harvest (`paged_fused_steps`, or `paged_fused_spec_steps`
with a drafter that runs on the device); the host then processes them as K
harvests, so finishes, stop strings and counters stay per logical step.

On the card every pure-decode ragged dispatch (K = 1 or a megastep)
replays a CUDA graph of one logical step (`_EngineStepGraph`, one per key,
kept on the scheduler and dropped with its pool), K times back to back;
dispatches with prefill lanes run eagerly.

Observability (utils/metrics.py, utils/trace.py, utils/request_log.py):
the families of `ServingMetrics` under the JAX engine's names, kinds and
ladders; one `Trace` a request in the flight recorder (spans queue_wait,
admission, prompt_prep, prefill, decode_chunk, emission; eviction and
restart events); the optional stall watchdog; the observatories: the step
timeline (utils/timeline.py, one record a dispatch), the page map
(utils/pagemap.py over the allocator's ownership data, `pool_snapshot`),
OOM forensics (utils/forensics.py, one capture per pressure episode and one
per failed allocation), the output auditor (serve/audit.py, replays at
idle points) and the numerics probes (utils/numerics.py, every
`numerics_every` steps); and the cost ledger: prefill
tokens computed vs spliced from the prefix cache, device decode steps apart
from the client's decode tokens, queue/prefill/decode wall time from the
request's own spans, and the refcount-weighted pages-held x time integral
(page-seconds), finalized on every terminal path into
handle.debug["cost"], the trace meta, the oryx_serving_request_*
histograms and one wide event in the request log.

Failure containment: `max_queue` bounds admission (`AdmissionRejected`,
HTTP 429); `request_timeout` (or `timeout_s` on submit) deadlines a
request wherever it is (HTTP 504); `begin_drain()` stops admission and
finishes the residents; `restart()`, driven by the API server's
EngineSupervisor, requeues the residents at the front for eviction-style
replay, rebuilds the pool with its invariant checked and starts a fresh
engine thread.

Threads: `submit` runs on any thread; the engine loop (`_run`) runs on its
own. They share only the queue and the shutdown/drain/supervision flags,
under `_cond`. The loop syncs with the device once per dispatch, at the
harvest.

Degraded mode: serving-SLO anomaly firings (`anomaly` with ttft/queue
depth SLOs) escalate `degraded_mode` 0 -> 3 — 1 sheds the prefix cache,
2 clamps max_new to `degraded_clamp_tokens`, 3 rejects admission with
"shed_load" — and quiet periods of `degraded_cooldown` seconds walk it back
down; each escalation captures a `degraded_escalation` forensic.

Decision journal (serve/journal.py, `journal=`): one entry a scheduling
decision and a dispatch, from which serve/replay.py rebuilds a cold
scheduler and replays the window byte for byte (`replay_feeder`,
`replay_fuse_plan`).

Fault points (utils/faults.py): `engine_crash` at the top of each loop
turn, `prefill_dispatch` / `decode_dispatch` on the host before each
dispatch (a captured CUDA graph never holds one), `page_alloc_oom` in the
allocator, `host_spill_upload` in the cache's reload.

Device time (utils/profiling.py): every `profile_sample_every` dispatches
one is bracketed in a torch.profiler capture (CUPTI on the card; a graph's
replayed kernels are ordinary kernel records there), its busy time lands in
the timeline record's device_us and `oryx_device_time_seconds_total`;
`request_profile(steps)` captures the next K dispatches on demand.

Concurrency (oryx_tpu_torch/concurrency.py): `_cond` is
`named_lock("scheduler._cond")`, the dispatch sites call `hot_dispatch`,
and the engine-owned fields carry `# thread-owned: engine`, so an armed
lock-order sanitizer and race detector (`ORYX_LOCK_SANITIZER=1`) check
this module as they check the JAX scheduler.

Not ported yet: meshes (tp).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import logging
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from oryx_tpu_torch.analysis.sanitizers import (
    hot_dispatch,
    named_lock,
    race_exempt,
)
from oryx_tpu_torch.models import generate as generate_lib
from oryx_tpu_torch.models import oryx, qwen2
from oryx_tpu_torch.ops import paged_kv
from oryx_tpu_torch.ops.cuda import graphs
from oryx_tpu_torch.ops.packing import round_up_bucket
from oryx_tpu_torch.parallel import tp as tp_lib
from oryx_tpu_torch.serve import audit as audit_lib
from oryx_tpu_torch.serve import journal as journal_lib
from oryx_tpu_torch.serve import pipeline as pipeline_lib
from oryx_tpu_torch.serve.prefix_cache import PagedPrefixCache
from oryx_tpu_torch.utils import faults
from oryx_tpu_torch.utils import forensics as forensics_lib
from oryx_tpu_torch.utils import numerics as numerics_lib
from oryx_tpu_torch.utils import pagemap
from oryx_tpu_torch.utils import profiling as profiling_lib
from oryx_tpu_torch.utils import request_log as request_log_lib
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils.anomaly import AnomalyMonitor
from oryx_tpu_torch.utils.metrics import (
    DISPATCH_ROWS_BUCKETS,
    PAGE_SECONDS_BUCKETS,
    PREFILL_CHUNK_BUCKETS,
    REQUEST_SECONDS_BUCKETS,
    REQUEST_TOKEN_BUCKETS,
    SPEC_ACCEPT_BUCKETS,
    TTFT_BUCKETS,
    ServingMetrics,
)
from oryx_tpu_torch.utils.timeline import StepTimeline

# Every line carries the request id (the X-Request-Id and /debug/trace id).
_LOG = logging.getLogger("oryx.serve.scheduler")

# Engine tags for the capture watchdog's graph labels, one per scheduler.
_ENGINE_SEQ = itertools.count()

# The ladder of `fuse_steps="auto"`: K for a pure-decode step is the largest
# rung that fits every live row's remaining budget (the large rung for a
# solo resident, the small one for shared steps); K = 1 is always below it.
FUSE_AUTO_LADDER: tuple[int, ...] = (4, 16)


class AdmissionRejected(RuntimeError):
    """submit() refused the request without queueing it: the bounded queue
    is full ("backpressure"), the engine is draining or closed
    ("draining"), it is dead with nothing to restart it ("engine_dead"),
    or degraded mode 3 sheds load ("shed_load"). Carries the Retry-After hint the HTTP layer forwards
    (429 for load, 503 otherwise)."""

    def __init__(self, message: str, *, reason: str,
                 retry_after_s: float = 1.0):
        super().__init__(message)
        self.reason = reason
        self.retry_after_s = retry_after_s


class RequestHandle:
    """Consumer side of a scheduled request.

    `events` carries ("delta", text), ("end", finish_reason, usage) or
    ("error", message), at most one terminal event. `result()` blocks for
    the terminal event and returns the assembled reply. Setting
    `cancelled` releases the slot at the next harvest or prefill step.
    """

    def __init__(self, request_id: str = "") -> None:
        self.events: queue.Queue[tuple] = queue.Queue()
        self.done = threading.Event()
        self.reply: str | None = None
        self.finish_reason: str = "stop"
        self.usage: tuple[int, int] | None = None
        self.error: str | None = None
        # HTTP mapping: "invalid_request" = rejected at admission (400),
        # "timeout" = deadline exceeded (504), "unavailable" = draining or
        # dead engine (503), "server_error" = anything else (500).
        self.error_kind: str = "server_error"
        self.cancelled = False
        self.streaming = False
        self.debug: dict[str, Any] = {}
        # The X-Request-Id and the span tree /debug/trace?id= serves.
        self.request_id = request_id
        self.trace: trace_lib.Trace | None = None

    def result(self, timeout: float | None = None):
        """(reply, finish_reason, usage) or raises RuntimeError."""
        if not self.done.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self.error is not None:
            raise RuntimeError(self.error)
        return self.reply, self.finish_reason, self.usage


@dataclasses.dataclass
class _Request:
    request: dict[str, Any]
    max_new: int
    sampling: dict[str, Any]
    handle: RequestHandle
    submit_time: float
    stops: list[str]
    # The request's span tree (set by submit).
    trace: trace_lib.Trace | None = None
    # Absolute monotonic deadline (None = none): enforced in the queue,
    # during chunked prefill and at every engine step.
    deadline: float | None = None
    # The request came through a router (stamped into the wide event).
    routed: bool = False
    # Filled at first admission and kept, so an evicted request never
    # re-runs the prompt prep: decoder embeds [1, T_bucket, H] on the
    # pool's device, the real length, the sampling knobs.
    embeds: Any = None
    embeds_p: Any = None  # chunk-padded embeds (pad_embeds_for_chunks)
    # Token ids of a text prompt (the prefix cache's key); None for a
    # multimodal one, which bypasses the cache.
    cache_tokens: Any = None
    length: int = 0
    seed: int = 0
    temp: float = 0.0
    topp: float = 1.0
    topk: int = 0
    # Per placement: the sampling generator (None = greedy), made from
    # `seed` at every placement so a replay redraws the same numbers, and
    # its knobs as [1] device tensors.
    generator: Any = None
    knobs: Any = None
    # Admission prefill state: logical KV tokens already in place, and
    # whether the slot has started decoding.
    prefill_pos: int = 0
    spliced: int = 0  # prompt tokens this placement took from the cache
    activated: bool = False
    ttft_done: bool = False
    # Host text state (survives eviction: replay re-derives the same tokens
    # and `replay` skips re-processing them).
    emitted: list[int] = dataclasses.field(default_factory=list)
    text_done: str = ""
    processed: int = 0  # tokens consumed from the device stream
    replay: int = 0  # tokens to skip after an eviction re-admission
    admit_seq: int = -1  # admission order (eviction picks the youngest)
    evictions: int = 0  # replay re-admissions (eviction, restart) # thread-owned: engine
    # Cost ledger, accumulated across placements (a replay re-pays its
    # prefill). decode_steps counts device work (chunk steps, or the 1 + k
    # verify lanes of a speculative step, rejected drafts included);
    # decode_tokens what the client got. Engine thread only, until the
    # ledger is finalized into handle.debug["cost"].
    cost_prefill_tokens: int = 0  # thread-owned: engine
    cost_cached_tokens: int = 0  # thread-owned: engine
    cost_decode_steps: int = 0  # thread-owned: engine
    cost_decode_tokens: int = 0  # thread-owned: engine
    cost_page_seconds: float = 0.0  # thread-owned: engine
    pages_t: float = 0.0  # last accrual (0 = never held) # thread-owned: engine
    peak_pages: int = 0  # thread-owned: engine
    peak_page_seconds: float = 0.0  # thread-owned: engine
    # Spans that outlive one method: queue_wait opens at submit (and again
    # at eviction), admission when the request reaches the queue head.
    qw_span: int = -1
    adm_span: int = -1
    # Seq of this request's journal `submit` entry (None: no journal),
    # joining its wide event to the decision journal.
    journal_seq: int | None = None


class ContinuousScheduler:
    """Slot map + admission queue + paged KV pool around one pipeline. The
    pool, and every dispatch, lives on the pipeline's device (the card,
    unless the pipeline was built with device="cpu").

    seed: the sampling seed of requests that carry none ("seed" in their
    sampling dict). prefix_cache: share cached prompt prefixes across
    requests. kv_dtype: "bf16" (dense pages in the compute dtype) or
    "int8" (a quantized pool). host_cache_bytes: host RAM the prefix
    cache may spill evicted pages into (0 = no host tier).
    speculate: draft tokens a slot verifies per step (0 = off; needs
    ragged=True). drafter: their proposer (`generate.NgramDrafter()` by
    default). fuse_steps: logical steps per pure-decode dispatch, an int or
    "auto" (needs ragged=True; with speculate, a drafter that runs on the
    device, such as `generate.NeuralDrafter`).

    metrics: the `ServingMetrics` the engine reports into (the API
    server's, so /metrics renders it). tracer: the flight recorder its
    requests' traces land in. stall_timeout: seconds without a decode
    dispatch, while requests are live, before the watchdog dumps every
    thread stack (None = no watchdog). anomaly: the SLO monitor fed each
    TTFT and queue depth. request_timeout: the default per-request
    deadline in seconds. request_log: the wide-event sink (an in-memory
    ring by default); engine_label / replica_id: the engine's identity
    in those events. audit_sample_every: audit
    every Nth finished request (0 = off); audit_tol_maxdiff /
    audit_tol_kl: its drift-vs-fail boundary (defaults from the pool
    format's round-trip error). numerics_every: arm the logit probe every
    N engine steps (0 = off; not with speculate). timeline / forensics:
    the step timeline and OOM ring to record into (fresh ones by default).

    degraded_cooldown: quiet seconds before the degraded ladder steps down;
    degraded_clamp_tokens: the max_new cap of mode 2. journal: a
    `serve.journal.DecisionJournal` to record the decision stream into
    (None = disarmed). profile_sample_every: bracket every Nth dispatch in
    a device-time capture (0 = off; on-demand captures work either way).
    """

    def __init__(
        self,
        pipe,
        *,
        num_slots: int = 4,
        page_size: int = 64,
        chunk: int = 8,
        max_ctx: int = 2048,
        num_pages: int | None = None,
        seed: int = 0,
        autostart: bool = True,
        prefill_chunk: int | None = None,
        max_queue: int | None = None,
        ragged: bool = False,
        prefix_cache: bool = True,
        kv_dtype: str = "bf16",
        host_cache_bytes: int = 0,
        speculate: int = 0,
        drafter: generate_lib.Drafter | None = None,
        fuse_steps: int | str = 1,
        metrics: ServingMetrics | None = None,
        tracer: trace_lib.Tracer | None = None,
        stall_timeout: float | None = None,
        anomaly: AnomalyMonitor | None = None,
        request_timeout: float | None = None,
        request_log: request_log_lib.RequestLog | None = None,
        engine_label: str = "continuous",
        replica_id: str | None = None,
        audit_sample_every: int = 0,
        audit_tol_maxdiff: float | None = None,
        audit_tol_kl: float | None = None,
        numerics_every: int = 0,
        degraded_cooldown: float = 30.0,
        degraded_clamp_tokens: int = 64,
        profile_sample_every: int = 0,
        journal: journal_lib.DecisionJournal | None = None,
        timeline: StepTimeline | None = None,
        forensics: forensics_lib.ForensicRing | None = None,
    ):
        for name, v in (
            ("num_slots", num_slots), ("page_size", page_size),
            ("chunk", chunk), ("max_ctx", max_ctx),
        ):
            if not isinstance(v, int) or v < 1:
                raise ValueError(
                    f"{name} must be a positive integer, got {v!r}"
                )
        if num_pages is not None and (
            not isinstance(num_pages, int) or num_pages < 1
        ):
            raise ValueError(
                f"num_pages must be a positive integer, got {num_pages!r}"
            )
        if prefill_chunk is not None and (
            not isinstance(prefill_chunk, int) or prefill_chunk < 1
        ):
            raise ValueError(
                "prefill_chunk must be a positive integer or None, "
                f"got {prefill_chunk!r}"
            )
        if max_ctx % page_size:
            raise ValueError(f"{max_ctx=} not a multiple of {page_size=}")
        if ragged and prefill_chunk is None:
            raise ValueError(
                "ragged=True fuses chunked prefill into the decode "
                "dispatch; set prefill_chunk (the per-step prompt budget "
                "that sizes the packed buffer's prefill lanes)"
            )
        if not isinstance(speculate, int) or speculate < 0:
            raise ValueError(
                f"speculate must be a non-negative integer (draft "
                f"tokens per slot per step), got {speculate!r}"
            )
        if speculate and not ragged:
            raise ValueError(
                "speculate requires ragged=True: drafts are extra "
                "packed lanes of the fused ragged dispatch (the split "
                "engine has no packed buffer to extend)"
            )
        if fuse_steps != "auto" and (
            isinstance(fuse_steps, bool) or not isinstance(fuse_steps, int)
            or fuse_steps < 1
        ):
            raise ValueError(
                "fuse_steps must be a positive integer (engine steps "
                f"per decode dispatch) or 'auto', got {fuse_steps!r}"
            )
        if fuse_steps != 1 and not ragged:
            raise ValueError(
                "fuse_steps > 1 requires ragged=True: the megastep runs "
                "the fused ragged step K times (the split engine has no "
                "single program to repeat)"
            )
        self.speculate = int(speculate)
        self.drafter = None
        if self.speculate:
            self.drafter = (
                drafter if drafter is not None
                else generate_lib.NgramDrafter()
            )
        device_drafter = self.speculate and (
            self.drafter.device_apply is not None
            and self.drafter.device_params() is not None
        )
        if fuse_steps != 1 and self.speculate and not device_drafter:
            raise ValueError(
                "fuse_steps > 1 with speculate>0 needs a drafter "
                "implementing the device contract (device_params()/"
                "device_apply) so propose->verify can run inside the "
                "fused loop: pass a generate.NeuralDrafter, or drop "
                "fuse_steps"
            )
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(
                f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}"
            )
        if not isinstance(host_cache_bytes, int) or host_cache_bytes < 0:
            raise ValueError(
                "host_cache_bytes must be a non-negative integer "
                f"(0 = host spill tier off), got {host_cache_bytes!r}"
            )
        if not isinstance(numerics_every, int) or numerics_every < 0:
            raise ValueError(
                "numerics_every must be a non-negative integer (steps "
                f"between probe samples; 0 = off), got {numerics_every!r}"
            )
        if not isinstance(profile_sample_every, int) \
                or profile_sample_every < 0:
            raise ValueError(
                "profile_sample_every must be a non-negative integer "
                f"(steps between samples; 0 = off), got "
                f"{profile_sample_every!r}"
            )
        if numerics_every and speculate:
            # The verify step carries no probe: the gauges would stay 0.
            raise ValueError(
                "numerics_every is not supported with speculate>0: the "
                "speculative verify step carries no numerics probe; "
                "drop --numerics-every or --speculate"
            )
        self.numerics_every = numerics_every
        self.kv_dtype = kv_dtype
        self.host_cache_bytes = host_cache_bytes
        self.pipe = pipe
        self.cfg = pipe.cfg
        self.device = pipe.device
        self.num_slots = num_slots
        self.page_size = page_size
        self.chunk = chunk
        self.max_ctx = max_ctx
        self.max_pages = max_ctx // page_size
        self.num_pages = num_pages or num_slots * self.max_pages
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        # Ragged mode: each of a dispatch's `chunk` packed forwards carries
        # pf_width prompt tokens, so a dispatch advances the admission by
        # chunk * pf_width >= prefill_chunk tokens.
        self.ragged = bool(ragged)
        self.pf_width = -(-prefill_chunk // chunk) if ragged else 0
        # Decode tokens a dispatch may write per slot.
        self._win = 1 + self.speculate if self.speculate else chunk
        self.fuse_steps = fuse_steps
        self._fuse_ladder: tuple[int, ...] = (
            FUSE_AUTO_LADDER if fuse_steps == "auto"
            else ((fuse_steps,) if fuse_steps > 1 else ())
        )
        # Replay override (serve/replay.py): the steps_run value a megastep
        # STARTED at -> its journaled K. Live K reads the queue, which is
        # wall-clock-coupled, so a replay applies the captured plan.
        self.replay_fuse_plan: dict[int, int] | None = None  # thread-owned: engine
        self._dtype = oryx.compute_dtype(self.cfg)
        # A drafter with the device contract drafts on the pool's device in
        # every speculative dispatch (K = 1, megasteps, graphs alike), so
        # its proposals never depend on the route: (params, apply, window).
        self._draft = (
            (self.drafter.device_params(self.device),
             self.drafter.device_apply, self.drafter.window)
            if device_drafter else None
        )
        # Engine-step CUDA graphs by key (the card only); inside
        # graphs.routes(False) every dispatch runs eagerly instead, the
        # witness the replays are held against.
        self._graphs: dict[tuple, generate_lib._EngineStepGraph] = {}
        self.graph_owner = f"engine{next(_ENGINE_SEQ)}"
        # Port-only engine counters, outside the registry (the JAX engine
        # has no such families): megastep dispatches by K, the engine-step
        # graphs captured and the seconds their captures took, and the
        # prefix cache's copy-on-write splices. Engine thread only.
        self.engine_stats: dict[str, Any] = {
            "megasteps_total": collections.Counter(),
            "graph_captures_total": 0, "graph_capture_s": 0.0,
            "prefix_cache_cow_pages_total": 0,
        }
        self.metrics = metrics or ServingMetrics()
        self._register_families()
        S = num_slots
        self.allocator = paged_kv.PageAllocator(self.num_pages, page_size)
        # The page map's gauges and free-time histograms; every pool
        # rebuild re-attaches the fresh allocator.
        self.pool_observatory = pagemap.PoolObservatory(
            self.metrics.registry, lambda: self.allocator
        )
        self.pool_observatory.attach(self.allocator)
        self.forensics = forensics or forensics_lib.ForensicRing()
        # One forensic a pool-pressure episode: armed at the first failed
        # grow or admission, cleared by the next allocation that succeeds.
        self._oom_episode = False  # thread-owned: engine
        self.timeline = timeline or StepTimeline()
        # Device-time sampling: every `profile_sample_every` dispatches one
        # is captured; HTTP threads park on-demand captures in
        # _profile_pending, the engine loop adopts them.
        self.profiler = profiling_lib.DeviceTimeSampler(
            self.metrics.registry, every=profile_sample_every,
            device=self.device,
        )
        self._profile_pending = None  # guarded-by: _cond
        self._profile_active = None  # thread-owned: engine
        self._sentinel = self.allocator.sentinel
        self.kv_pages = self._new_pool()
        self.prefix_cache = (
            self._build_prefix_cache() if prefix_cache else None
        )
        # Engine-thread state: one row per slot.
        self.slots: list[_Request | None] = [None] * S
        self.bt = np.full((S, self.max_pages), self._sentinel, np.int32)
        self.tok = np.zeros((S,), np.int32)
        self.lengths = np.zeros((S,), np.int32)
        self.finished = np.ones((S,), bool)  # empty slots ride as finished
        self.temp = np.zeros((S,), np.float32)
        self.top_p = np.ones((S,), np.float32)
        self.top_k = np.zeros((S,), np.int32)
        self.gens: list[torch.Generator | None] = [None] * S
        self.stop_sequences = (
            None if pipe.stop_sequences is None
            else pipe.stop_sequences.to(self.device)
        )
        stop_L = (
            0 if self.stop_sequences is None else self.stop_sequences.shape[1]
        )
        self.recent = np.full((S, stop_L), -2, np.int32)
        self._admit_seq = 0
        self.chunks_run = 0
        # The only state shared with submit() and supervisor threads.
        self._cond = named_lock("scheduler._cond", kind="condition")
        self._queue: collections.deque[_Request] = collections.deque()  # guarded-by: _cond
        self._shutdown = False  # guarded-by: _cond
        self._draining = False  # guarded-by: _cond
        # A dead loop with nobody to revive it (no EngineSupervisor, which
        # calls set_supervised(True), or one that gave up) rejects new work
        # instead of queueing requests that can never complete.
        self._started = False
        self.supervised = False  # guarded-by: _cond
        self.restarts = 0
        self.request_timeout = request_timeout
        # The degraded-mode ladder (0 normal, 1 shed prefix cache, 2 clamp
        # max_new, 3 shed load): read by submit() under _cond, moved by the
        # engine thread.
        self.degraded_cooldown = degraded_cooldown
        self.degraded_clamp_tokens = degraded_clamp_tokens
        self._degraded = 0  # guarded-by: _cond
        self._slo_fired_seen = 0
        self._degraded_changed = time.monotonic()
        self._cache_shed = False
        self.anomaly = anomaly
        self.tracer = tracer or trace_lib.Tracer()
        self.request_log = request_log or request_log_lib.RequestLog()
        self.engine_label = engine_label
        self.replica_id = replica_id
        # The decision journal (None = disarmed: every site is one attribute
        # check). steps_run advances at every recorded dispatch (every
        # logical step of a megastep): the gate a replay feeds on.
        self.journal = journal
        self.steps_run = 0  # thread-owned: engine
        # Replay feeding hook (serve/replay.py), called at the top of every
        # loop turn and admission attempt; None in live serving.
        self.replay_feeder = None  # thread-owned: engine
        if self.journal is not None:
            self.journal.stamp_header(
                num_slots=num_slots, page_size=page_size, chunk=chunk,
                max_ctx=max_ctx, num_pages=self.num_pages, seed=seed,
                prefill_chunk=prefill_chunk,
                prefix_cache=bool(prefix_cache),
                ragged=self.ragged, speculate=self.speculate,
                fuse_steps=fuse_steps,
                draft_model=getattr(self.drafter, "source", None),
                kv_dtype=kv_dtype, host_cache_bytes=host_cache_bytes,
                max_queue=max_queue,
                degraded_clamp_tokens=degraded_clamp_tokens,
                engine=engine_label, replica=replica_id,
            )
            self.journal.seal_header()
            # Fault firings reach the journal through the module's observer
            # hook; the seeded schedule makes them replay.
            faults.add_observer(self._journal_fault)
        # Built unconditionally, so the oryx_audit_* ladders render at zero
        # with sampling off.
        self.auditor = audit_lib.OutputAuditor(
            pipe, page_size=page_size, max_ctx=max_ctx,
            sample_every=audit_sample_every, metrics=self.metrics,
            request_log=self.request_log, anomaly=self.anomaly,
            engine_label=engine_label, replica_id=replica_id,
            kv_dtype=kv_dtype,
            fail_abs_tol=audit_tol_maxdiff, fail_kl_tol=audit_tol_kl,
        )
        # Literal declarations (numerics_lib.NUMERICS_GAUGES lists the
        # same names; the tests hold the two equal).
        reg = self.metrics.registry
        self._numerics_gauges = {
            "finite_frac": reg.gauge(
                "oryx_numerics_logits_finite_frac", raw_name=True
            ),
            "absmax": reg.gauge("oryx_numerics_logits_absmax", raw_name=True),
            "rms": reg.gauge("oryx_numerics_logits_rms", raw_name=True),
            "entropy": reg.gauge(
                "oryx_numerics_logits_entropy", raw_name=True
            ),
            "top1_margin": reg.gauge(
                "oryx_numerics_logits_top1_margin", raw_name=True
            ),
        }
        self._numerics_samples = reg.counter(
            "oryx_numerics_samples_total", raw_name=True
        )
        self.watchdog: trace_lib.StallWatchdog | None = None
        if stall_timeout is not None:
            self.watchdog = trace_lib.StallWatchdog(
                self.tracer, stall_timeout, name="continuous-scheduler"
            ).start()
        self._thread = threading.Thread(
            target=self._run, name="oryx-engine", daemon=True
        )
        if autostart:
            self.start()

    def _register_families(self) -> None:
        """Pre-register the engine's families, as the JAX engine does, so
        their ladders render (at zero) from the first scrape."""
        reg = self.metrics.registry
        reg.counter("prefix_cache_hit_tokens_total")
        reg.counter("prefix_cache_miss_tokens_total")
        reg.counter("prefix_cache_evicted_pages_total")
        reg.gauge("prefix_cache_entries")
        reg.gauge("prefix_cache_pages")
        reg.gauge("oryx_cache_spilled_pages", raw_name=True)
        reg.gauge("oryx_cache_host_bytes", raw_name=True)
        reg.counter("oryx_cache_reload_hit_total", raw_name=True)
        reg.counter("oryx_cache_reload_upload_total", raw_name=True)
        reg.info(
            "oryx_pool_kv_dtype", {"kv_dtype": self.kv_dtype}, raw_name=True
        )
        reg.counter("prefill_tokens_total")
        reg.histogram("prefill_chunk_tokens", PREFILL_CHUNK_BUCKETS)
        reg.counter("dispatches_total", ("kind",))
        reg.histogram("dispatch_rows", DISPATCH_ROWS_BUCKETS)
        reg.gauge("fused_k")
        reg.counter("harvest_total")
        reg.histogram("accepted_tokens_per_step", SPEC_ACCEPT_BUCKETS)
        reg.counter("draft_proposed_total")
        reg.counter("draft_accepted_total")
        reg.counter("admission_rejected_total", ("reason",))
        reg.counter("deadline_exceeded_total")
        reg.counter("engine_restarts_total")
        reg.gauge("degraded_mode")
        reg.histogram("request_prefill_tokens", REQUEST_TOKEN_BUCKETS)
        reg.histogram("request_cached_tokens", REQUEST_TOKEN_BUCKETS)
        reg.histogram("request_decode_steps", REQUEST_TOKEN_BUCKETS)
        reg.histogram("request_decode_tokens", REQUEST_TOKEN_BUCKETS)
        reg.histogram("request_page_seconds", PAGE_SECONDS_BUCKETS)
        reg.histogram("request_queue_seconds", REQUEST_SECONDS_BUCKETS)
        reg.histogram("request_prefill_seconds", REQUEST_SECONDS_BUCKETS)
        reg.histogram("request_decode_seconds", REQUEST_SECONDS_BUCKETS)
        reg.histogram("request_e2e_seconds", REQUEST_SECONDS_BUCKETS)
        reg.histogram("request_peak_pages", REQUEST_TOKEN_BUCKETS)
        reg.counter("oom_forensics_total", ("trigger",))

    # ---- public API (the Engine protocol, serve/engine.py) ---------------

    def start(self) -> None:
        if not self._thread.is_alive():
            self._started = True
            self._thread.start()

    def submit(
        self,
        request: dict[str, Any],
        max_new: int,
        sampling: dict[str, Any] | None = None,
        *,
        streaming: bool = False,
        timeout_s: float | None = None,
        request_id: str | None = None,
        routed: bool = False,
    ) -> RequestHandle:
        """Queue one request ({"question", optional "images", "is_video",
        "history"}); sampling may set temperature, top_p, top_k, seed and
        stop. timeout_s overrides the scheduler's request_timeout for this
        request. request_id: a client-supplied X-Request-Id (already
        sanitized) to use as the trace id; the tracer mints another when
        the flight recorder still holds it. routed: the request came
        through a router. Raises AdmissionRejected, queueing nothing, when
        draining, when the engine is dead for good, when degraded mode 3
        sheds load, or when the bounded queue is full."""
        sampling = sampling or {}
        stops = (
            [self.pipe.conv.stop_str] if self.pipe.conv.stop_str else []
        ) + [s for s in (sampling.get("stop") or []) if s]
        tr = self.tracer.start_trace(
            "request", label=f"chat max_new={max_new}", id=request_id,
        )
        h = RequestHandle(tr.id)
        h.streaming = streaming
        h.trace = tr
        h.debug["request_id"] = tr.id
        now = time.monotonic()
        eff_timeout = (
            timeout_s if timeout_s is not None else self.request_timeout
        )
        req = _Request(
            request=request, max_new=max_new, sampling=sampling,
            handle=h, submit_time=now, stops=stops, trace=tr,
            deadline=(now + eff_timeout) if eff_timeout else None,
            routed=routed,
        )
        req.qw_span = tr.begin("queue_wait")
        if self.journal is not None:
            # The arrival is journaled before the admission verdict: the
            # submit entry is the replayable workload record.
            req.journal_seq = self._journal_submit(req)
            tr.annotate(journal_seq=req.journal_seq)
        with self._cond:
            # The checks and the append are one atomic section: two racing
            # submits never both take the last queue place.
            reject = None
            if self._shutdown or self._draining:
                reject = ("draining", "server is draining; not "
                          "accepting new requests", 1.0)
            elif (
                self._started and not self._thread.is_alive()
                and not self.supervised
            ):
                reject = ("engine_dead", "engine is not running and "
                          "nothing will restart it", 5.0)
            elif self._degraded >= 3:
                reject = ("shed_load", "server is shedding load "
                          "(degraded mode 3); retry shortly", 2.0)
            elif (
                self.max_queue is not None
                and len(self._queue) >= self.max_queue
            ):
                retry = min(
                    30.0, 1.0 + len(self._queue) / max(1, self.num_slots)
                )
                reject = ("backpressure",
                          f"admission queue full ({len(self._queue)} "
                          f">= {self.max_queue})", retry)
            if reject is None:
                self._queue.append(req)
                depth = len(self._queue)
                self.metrics.set_gauge("queue_depth", depth)
                self._cond.notify()
        if reject is not None:
            reason, msg, retry_after = reject
            self.metrics.inc(
                "admission_rejected_total", labels={"reason": reason}
            )
            if self.journal is not None:
                # Not replayed (REPLAYED_KINDS): admission control is
                # load- and timing-coupled.
                self.journal.append(journal_lib.build_journal_event(
                    kind="reject", request_id=tr.id, reason=reason,
                ))
            cost = self._finalize_cost(None, req, observe=False)
            tr.finish(error=msg, rejected=reason, cost=cost)
            self._emit_request_event(
                req, status="rejected", error_kind=reason
            )
            _LOG.info("request %s rejected (%s)", tr.id, reason)
            raise AdmissionRejected(
                msg, reason=reason, retry_after_s=retry_after
            )
        _LOG.info("request %s queued (max_new=%d)", tr.id, max_new)
        if self.anomaly is not None:
            self.anomaly.observe_queue_depth(depth)
        return h

    def cancel(self, handle: RequestHandle) -> None:
        """Cancel a submitted request wherever it lives; the engine loop
        frees its slot and pages at the next harvest or prefill step."""
        handle.cancelled = True

    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def request_profile(self, steps: int, timeout: float = 60.0
                        ) -> dict[str, Any]:
        """On-demand device-time capture (GET /debug/profile, any thread):
        park a request the engine loop adopts at its next turn with work;
        it brackets the next `steps` dispatches in one capture and answers
        with the Chrome trace and the per-kind attribution. Raises
        TimeoutError when the engine ran no dispatch in time (an idle engine
        cannot be profiled) and RuntimeError when a capture is already
        queued or the capture failed."""
        if not isinstance(steps, int) or steps < 1:
            raise ValueError(f"steps must be a positive integer, "
                             f"got {steps!r}")
        holder: dict[str, Any] = {
            "steps": steps, "done": threading.Event(), "result": None,
            "abandoned": False,
        }
        with self._cond:
            pending = self._profile_pending
            if pending is not None and not pending["abandoned"]:
                raise RuntimeError("a profile capture is already queued")
            # An abandoned request (its requester timed out) is replaced.
            self._profile_pending = holder
            self._cond.notify()
        if not holder["done"].wait(timeout):
            with self._cond:
                # The engine drops it instead of adopting it.
                holder["abandoned"] = True
            raise TimeoutError(
                f"no completed profile capture within {timeout:g}s "
                "(engine idle, or a capture already in flight — "
                "profiling needs live dispatches)"
            )
        result = holder["result"]
        if isinstance(result, dict) and "error" in result:
            raise RuntimeError(result["error"])
        return result

    def alive(self) -> bool:
        """The engine loop thread is running (and, on a tensor-parallel
        pipe, its ranks are still in step)."""
        world = self.pipe.tp
        return self._thread.is_alive() and not (world and world.broken)

    def readiness(self) -> tuple[bool, str]:
        """(ready, reason): not draining, loop thread alive and, with a
        watchdog, no stall in flight. The /readyz signal."""
        if self.draining:
            return False, "draining"
        if not self.alive():
            return False, "scheduler loop dead"
        wd = self.watchdog
        if wd is not None and wd.stalled():
            return False, (
                f"scheduler stalled (no decode beat in {wd.deadline_s:g}s)"
            )
        return True, "ok"

    @property
    def draining(self) -> bool:
        with self._cond:
            return self._draining

    @property
    def stopping(self) -> bool:
        """close() or drain() in progress: the supervisor must not restart
        a deliberately stopped engine."""
        with self._cond:
            return self._shutdown or self._draining

    @property
    def degraded_mode(self) -> int:
        with self._cond:
            return self._degraded

    def set_supervised(self, value: bool) -> None:
        """EngineSupervisor attach/detach (read by submit under _cond)."""
        with self._cond:
            self.supervised = value

    def stop(self) -> None:
        """Stop the loop without waiting for resident requests (drain() is
        the graceful twin)."""
        self.close()

    def close(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify()
        if self._thread.is_alive():
            self._thread.join(timeout=30)
        if self.watchdog is not None:
            self.watchdog.stop()
        if not self._thread.is_alive():
            self._release_graphs()
            if self.pipe.tp is not None:
                self.pipe.tp.release(self.kv_pages)
        if self.journal is not None:
            # The journal itself is closed by its owner (build_server, or
            # the replay).
            faults.remove_observer(self._journal_fault)

    def begin_drain(self) -> None:
        """Start drain-on-shutdown: admission stops now (new submits are
        rejected, queued requests error with "draining"), residents run
        to completion, then the loop exits. /readyz flips to 503 at once."""
        with self._cond:
            if self._draining:
                return
            self._draining = True
            self._cond.notify()
        _LOG.info("drain started: admission stopped, finishing resident "
                  "requests")

    def drain(self, timeout: float | None = 60.0) -> bool:
        """begin_drain() and wait for the loop to finish the residents and
        exit; returns whether it drained in time."""
        self.begin_drain()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
        drained = not self._thread.is_alive()
        if drained:
            with self._cond:
                stranded = bool(self._queue)
            if stranded or any(r is not None for r in self.slots):
                # The loop died before (or without) running the drain: the
                # handles would never complete. Error them out (503).
                self.fail_inflight("server draining with engine stopped")
        if drained and self.watchdog is not None:
            self.watchdog.stop()
        return drained

    def fail_inflight(self, msg: str, *, kind: str = "unavailable"
                      ) -> None:
        """Error out every queued and resident request and rebuild the
        pool: for an engine that is dead and staying dead (supervisor give
        up, drain of a dead engine). Never while the loop runs."""
        for r in self._take_queue():
            self._reject_queued(r, msg, kind=kind)
        if self.anomaly is not None:
            self.anomaly.observe_queue_depth(0)
        for s, req in enumerate(self.slots):
            if req is not None:
                self._finish_error(s, msg, kind=kind)
        self._reset_pool()

    def restart(self) -> None:
        """Recover from engine-thread death (the supervisor's entry point):
        requeue every resident at the front for replay (the eviction
        machinery: same prompt, same generator seed, the `processed`
        tokens skipped on re-emission), rebuild the pool with its
        invariant checked, and start a fresh engine thread. No client sees
        an error."""
        if self._thread.is_alive():
            return
        live = sorted(
            ((req.admit_seq, s, req)
             for s, req in enumerate(self.slots) if req is not None),
            reverse=True,
        )
        for _, s, req in live:  # youngest first: the oldest ends at the head
            # The rebuild frees these pages without _clear_slot: bank the
            # page-seconds now.
            self._accrue_page_seconds(s)
            req.replay = req.processed
            req.evictions += 1
            req.activated = False
            req.spliced = 0
            req.prefill_pos = 0
            req.trace.event(
                "engine_restart_replay", slot=s,
                replay_tokens=req.processed,
            )
            req.qw_span = req.trace.begin("queue_wait", requeued=True)
            with self._cond:
                self._queue.appendleft(req)
        with self._cond:
            self.metrics.set_gauge("queue_depth", len(self._queue))
        # A capture the dead thread left running is discarded.
        self._abort_profile()
        self._reset_pool()
        self.restarts += 1
        self.metrics.inc("engine_restarts_total")
        if self.journal is not None:
            # The engine is dead, so steps_run is quiescent: the restart's
            # place in the step stream is what a replay reproduces.
            self.journal.append(journal_lib.build_journal_event(
                kind="restart", step=self.steps_run,
                restarts=self.restarts, requeued=len(live),
            ))
        _LOG.warning(
            "engine thread restarted (#%d): %d request(s) requeued for "
            "replay", self.restarts, len(live),
        )
        self._thread = threading.Thread(
            target=self._run, name="oryx-engine", daemon=True
        )
        self._thread.start()

    def _release_graphs(self) -> None:
        """Free the captured engine steps now, not when a collection finds
        them (which may be while another engine captures)."""
        for graph in self._graphs.values():
            graph.graph.release()
        self._graphs.clear()

    def check_pool_invariant(self) -> None:
        """Every page is free or exactly accounted to its holders (the
        slots' block tables and the prefix cache); raises RuntimeError
        otherwise. Call on a quiesced engine (tests between bursts): the
        cross-thread reads of engine-owned state are declared to the armed
        race detector."""
        with race_exempt("pool-invariant check: caller asserts quiescence"):
            holders = [
                [int(p) for p in self.bt[s] if p != self._sentinel]
                for s in range(self.num_slots)
            ]
            if self.prefix_cache is not None:
                holders.append(self.prefix_cache.held_pages())
            self.allocator.check_invariant(holders)

    # ---- the page map and OOM forensics -----------------------------------

    def pool_snapshot(self) -> dict[str, Any]:
        """The live page-ownership map with its derived summary: the GET
        /debug/pages body (utils/pagemap.summarize over
        PageAllocator.snapshot). Engine-owned state read from a debug
        thread: best-effort, exact on a quiesced engine. The oryx_pool_*
        gauges are refreshed at the same moment, so a scrape right after
        agrees with it. Declared to the armed race detector like the
        pool-invariant check."""
        with race_exempt("pool snapshot: debug read, quiesced by contract"):
            snap = self.allocator.snapshot()
            self.pool_observatory.collect(force=True)
        # The pool's wire format and device bytes, read off the live pool.
        snap["kv_dtype"] = paged_kv.kv_pool_dtype(self.kv_pages)
        snap["kv_pool_bytes"] = int(sum(
            t.numel() * t.element_size()
            for plane in (self.kv_pages["k"], self.kv_pages["v"])
            for t in paged_kv._byte_leaves(plane)
        ))
        snap["summary"] = pagemap.summarize(snap)
        return snap

    def _capture_oom(self, trigger: str, detail: str, *,
                     asking: tuple | None = None) -> None:
        """A forensic capture at a memory-pressure moment (engine thread):
        the pool summary, the top-K residents by pages held with their
        in-flight ledgers, the prefix cache's LRU tail and the timeline
        tail into the ring /debug/oom serves, and one flat oom_pressure
        wide event. `asking` = (slot, request, pages needed): the
        allocation that failed, named even before its request holds a
        slot."""
        summary = pagemap.summarize(self.allocator.snapshot())
        residents = [
            self._forensic_request(s, req)
            for s, req in enumerate(self.slots) if req is not None
        ]
        if asking is not None:
            s, req, need = asking
            if req is not None and all(
                r["request_id"] != req.trace.id for r in residents
            ):
                ent = self._forensic_request(s, req)
                ent["asking_pages"] = int(need)
                residents.append(ent)
        residents.sort(key=lambda r: -r["pages"])
        residents = residents[:forensics_lib.TOP_K]
        cache = None
        cache_lru = []
        if self.prefix_cache is not None:
            pc = self.prefix_cache
            cache = {
                "entries": pc.entries,
                "pages": pc.pages,
                "evictable_pages": pc.evictable_pages(),
                "spilled_pages": pc.spilled_pages,
                "host_bytes": pc.host_bytes,
            }
            for node in sorted(pc.trie.leaves(),
                               key=lambda n: n.stamp)[:forensics_lib.TOP_K]:
                depth = 0
                walk = node
                while walk is not None and walk.parent is not None:
                    depth += 1
                    walk = walk.parent
                cache_lru.append({
                    "leaf_page": node.payload,
                    "depth_pages": depth,
                    "lru_stamp": node.stamp,
                    "refcount": self.allocator.refcount(node.payload),
                })
        record = {
            "kind": "oom_pressure",
            "trigger": trigger,
            "detail": detail,
            "engine": self.engine_label,
            "replica": self.replica_id,
            "degraded_mode": int(self.metrics.get("degraded_mode")),
            "queue_depth": int(self.metrics.get("queue_depth")),
            "live_slots": sum(1 for r in self.slots if r is not None),
            "pool": summary,
            "top_requests": residents,
            "cache": cache,
            "cache_lru": cache_lru,
            "timeline_tail": self.timeline.snapshot(16),
        }
        idx = self.forensics.append(record)
        self.metrics.inc("oom_forensics_total", labels={"trigger": trigger})
        self.request_log.append(request_log_lib.build_oom_event(
            trigger=trigger,
            detail=detail,
            engine=self.engine_label,
            replica=self.replica_id,
            degraded_mode=record["degraded_mode"],
            queue_depth=record["queue_depth"],
            live_slots=record["live_slots"],
            free_pages=summary["free"],
            slot_pages=summary["slot"],
            cache_pages=summary["cache"],
            shared_pages=summary["shared"],
            fragmentation_ratio=summary["fragmentation_ratio"],
            top_request_id=(
                residents[0]["request_id"] if residents else None
            ),
            top_request_pages=residents[0]["pages"] if residents else 0,
            forensic_index=idx,
        ))
        _LOG.warning(
            "memory-pressure forensic #%d captured (%s: %s; free=%d "
            "slot=%d cache=%d shared=%d)", idx, trigger, detail,
            summary["free"], summary["slot"], summary["cache"],
            summary["shared"],
        )

    def _forensic_request(self, s: int, req: _Request) -> dict[str, Any]:
        """One resident's line in a forensic record: identity, pages held
        and the in-flight half of its cost ledger."""
        return {
            "request_id": req.trace.id,
            "slot": s,
            "pages": self._held(s),
            "prompt_tokens": req.length,
            "emitted_tokens": len(req.emitted),
            "spliced_tokens": req.spliced,
            "activated": req.activated,
            "evictions": req.evictions,
            "cost": {
                "prefill_tokens": req.cost_prefill_tokens,
                "cached_tokens": req.cost_cached_tokens,
                "decode_steps": req.cost_decode_steps,
                "decode_tokens": req.cost_decode_tokens,
                "page_seconds": round(req.cost_page_seconds, 6),
                "peak_pages": req.peak_pages,
            },
        }

    # ---- pool and prefix cache --------------------------------------------

    def _pool_kv_dtype(self) -> str | None:
        """init_paged_kv_cache's kv_dtype for the flag value (None = dense
        pages in the compute dtype)."""
        return None if self.kv_dtype == "bf16" else self.kv_dtype

    def _on_ranks(self, fn, *args, **kwargs):
        """A device call: on a tensor-parallel pipe every rank runs it on
        its own shard and pool (parallel/tp.World.call); else a plain
        call. Every decision stays here, on rank 0."""
        world = self.pipe.tp
        if world is None:
            return fn(*args, **kwargs)
        return world.call(fn, *args, **kwargs)

    def _new_pool(self) -> dict:
        return self._place_kv()

    def _place_kv(self) -> dict:
        """A fresh page pool, placed: on a tensor-parallel pipe each rank
        makes a pool of its own KV heads (num_kv_heads / tp; every rank
        addresses the same pages through rank 0's block tables) and the
        old pool's handle is dropped. Applied at construction and in
        `_reset_pool`."""
        args = (qwen2.rank_cfg(self.pipe.params.llm, self.cfg.llm),
                self.num_pages, self.page_size)
        kw = dict(dtype=self._dtype, device=self.device,
                  kv_dtype=self._pool_kv_dtype())
        world = self.pipe.tp
        if world is None:
            return qwen2.init_paged_kv_cache(*args, **kw)
        old = getattr(self, "kv_pages", None)
        if old is not None:
            world.release(old)
        return world.call(qwen2.init_paged_kv_cache, *args, bind=True, **kw)

    def _build_prefix_cache(self) -> PagedPrefixCache:
        """The prefix cache over the CURRENT allocator, its host tier
        wired when host_cache_bytes asks for one."""
        return PagedPrefixCache(
            self.allocator, metrics=self.metrics,
            host_cache_bytes=self.host_cache_bytes,
            spill_fetch=self._spill_fetch,
            spill_upload=self._spill_upload,
        )

    def _spill_fetch(self, page: int):
        """Device -> host byte copy of one pool page (engine thread). On a
        tensor-parallel pipe each rank keeps the blob of its own heads
        (a HostPage under one handle; the host tier counts rank 0's
        bytes)."""
        if self.pipe.tp is None:
            blob = paged_kv.fetch_page(self.kv_pages, int(page))
            return blob, paged_kv.host_blob_bytes(blob)
        held = self.pipe.tp.call(paged_kv.HostPage.fetch, self.kv_pages,
                                 int(page), bind=True)
        return held, paged_kv.host_blob_bytes(held.blob)

    def _spill_upload(self, blob, page: int) -> None:
        """Host -> device byte copy into a freshly allocated pool page
        (engine thread), in place."""
        if self.pipe.tp is None:
            self.kv_pages = paged_kv.upload_page(self.kv_pages, int(page),
                                                 blob)
        else:
            self.pipe.tp.call(blob.upload, self.kv_pages, int(page))

    # ---- queue access (the engine thread is the queue's only consumer) ----

    def _queue_head(self) -> _Request | None:
        with self._cond:
            return self._queue[0] if self._queue else None

    def _pop_head(self) -> None:
        with self._cond:
            self._queue.popleft()
            depth = len(self._queue)
            # Every pop refreshes the gauge.
            self.metrics.set_gauge("queue_depth", depth)
        if self.anomaly is not None:
            self.anomaly.observe_queue_depth(depth)

    def _take_queue(self) -> list[_Request]:
        with self._cond:
            out = list(self._queue)
            self._queue.clear()
            self.metrics.set_gauge("queue_depth", 0)
            return out

    # ---- slot bookkeeping -------------------------------------------------

    def _held(self, s: int) -> int:
        return int((self.bt[s] != self._sentinel).sum())

    @staticmethod
    def _owner_tag(req: _Request | None) -> str | None:
        return None if req is None else f"req:{req.handle.request_id}"

    def _accrue_page_seconds(self, s: int) -> None:
        """Advance slot s's pages-held x time integral to now, weighted by
        refcount (a page shared by k holders charges each 1/k, the prefix
        cache's reference included), so the requests' page-seconds never
        sum past the physical ones. Runs before every page-count change,
        once per decode step and at finalization; also keeps the peak."""
        req = self.slots[s]
        if req is None or not req.pages_t:
            return
        now = time.monotonic()
        held = 0
        weight = 0.0
        for p in self.bt[s]:
            if p != self._sentinel:
                held += 1
                weight += 1.0 / max(1, self.allocator.refcount(int(p)))
        req.cost_page_seconds += weight * (now - req.pages_t)
        req.pages_t = now
        if held > req.peak_pages:
            req.peak_pages = held
            req.peak_page_seconds = req.cost_page_seconds

    def _finalize_cost(self, s: int | None, req: _Request,
                       observe: bool = True) -> dict[str, Any]:
        """Close the request's cost ledger on a terminal path (before its
        slot's pages are freed; s=None for a request that never held a
        slot): the last page-seconds accrual, queue/prefill/decode wall
        time from its spans, the aggregate histograms (not for submit-time
        rejections, `observe=False`). The dict lands in
        handle.debug["cost"] and the trace meta."""
        if s is not None:
            self._accrue_page_seconds(s)
        by = req.trace.span_seconds()
        cost = {
            "prefill_tokens": req.cost_prefill_tokens,
            "cached_tokens": req.cost_cached_tokens,
            "decode_steps": req.cost_decode_steps,
            "decode_tokens": req.cost_decode_tokens,
            "page_seconds": round(req.cost_page_seconds, 6),
            "queue_s": round(by.get("queue_wait", 0.0), 6),
            "prefill_s": round(by.get("prefill", 0.0), 6),
            "decode_s": round(by.get("decode_chunk", 0.0), 6),
            "e2e_s": round(time.monotonic() - req.submit_time, 6),
            "peak_pages": req.peak_pages,
            "peak_page_seconds": round(req.peak_page_seconds, 6),
        }
        req.handle.debug["cost"] = cost
        if not observe:
            return cost
        m = self.metrics
        m.observe("request_prefill_tokens", cost["prefill_tokens"])
        m.observe("request_cached_tokens", cost["cached_tokens"])
        m.observe("request_decode_steps", cost["decode_steps"])
        m.observe("request_decode_tokens", cost["decode_tokens"])
        m.observe("request_page_seconds", cost["page_seconds"])
        m.observe("request_queue_seconds", cost["queue_s"])
        m.observe("request_prefill_seconds", cost["prefill_s"])
        m.observe("request_decode_seconds", cost["decode_s"])
        m.observe("request_e2e_seconds", cost["e2e_s"])
        m.observe("request_peak_pages", cost["peak_pages"])
        return cost

    def _emit_request_event(self, req: _Request, *, status: str,
                            error_kind: str | None = None) -> None:
        """Append the request's wide event on every terminal path, right
        after its trace closes: the finalized ledger, outcome and this
        engine's identity."""
        h = req.handle
        cost = h.debug.get("cost") or {}
        aps = None
        if self.speculate and cost.get("decode_steps"):
            # decode_steps bills 1 + k lanes a verify step: tokens per
            # step is the request's speculation yield.
            steps = cost["decode_steps"] / (1 + self.speculate)
            if steps:
                aps = round(cost.get("decode_tokens", 0) / steps, 4)
        usage = h.usage or (req.length, len(req.emitted))
        self.request_log.append(request_log_lib.build_request_event(
            request_id=req.trace.id,
            engine=self.engine_label,
            replica=self.replica_id,
            routed=req.routed,
            status=status,
            error_kind=error_kind,
            finish_reason=h.finish_reason if status == "ok" else None,
            prompt_tokens=usage[0],
            completion_tokens=usage[1],
            streaming=h.streaming,
            evictions=req.evictions,
            accepted_tokens_per_step=aps,
            journal_seq=req.journal_seq,
            **cost,
        ))
        if self.journal is not None and status != "rejected":
            # The terminal entry (a submit-time rejection wrote its own
            # `reject`): the reply fingerprints are the replay's byte
            # oracle, the cost subset the deterministic half of the ledger.
            self.journal.append(journal_lib.build_journal_event(
                kind="finish",
                step=self._journal_step(),
                request_id=req.trace.id,
                status=status,
                finish_reason=h.finish_reason if status == "ok" else None,
                error_kind=error_kind,
                completion_tokens=len(req.emitted),
                reply_sha256=journal_lib.fingerprint_text(req.text_done),
                tokens_sha256=journal_lib.fingerprint_tokens(req.emitted),
                cost={
                    k: cost.get(k, 0)
                    for k in journal_lib.DETERMINISTIC_COST_KEYS
                },
            ))

    # ---- the decision journal (serve/journal.py) ---------------------------

    def _journal_step(self) -> int | None:
        """steps_run when journaling from the engine thread, else None (the
        counter is the engine thread's; entries from HTTP or supervisor
        threads are timing-coupled, and a replay feeds on engine-thread
        step gates only)."""
        if threading.current_thread() is self._thread:
            return self.steps_run
        return None

    def _journal_submit(self, req: _Request) -> int:
        """One `submit` entry. A JSON-serializable request dict (every HTTP
        request is one) is journaled verbatim as the payload; anything else
        (raw arrays handed to submit()) only as a fingerprint, which marks
        it unreplayable."""
        try:
            canon = json.dumps(req.request, sort_keys=True)
        except (TypeError, ValueError):
            prompt = None
            sha = journal_lib.fingerprint_text(repr(req.request))
        else:
            prompt = req.request
            sha = journal_lib.fingerprint_text(canon)
        return self.journal.append(journal_lib.build_journal_event(
            kind="submit",
            request_id=req.trace.id,
            arrival_seq=self.journal.next_arrival(),
            prompt=prompt,
            prompt_sha256=sha,
            sampling=req.sampling,
            max_new=req.max_new,
            streaming=req.handle.streaming,
        ))

    def _journal_fault(self, site: str, fired: int) -> None:
        """The fault module's observer: one entry a firing, from any thread
        (the journal's lock is a leaf). Attached at construction when the
        journal is armed, detached in close()."""
        if self.journal is not None:
            self.journal.append(journal_lib.build_journal_event(
                kind="fault", step=self._journal_step(),
                site=site, fires=fired,
            ))

    def _free_slot_pages(self, s: int, owner: str | None = None) -> None:
        pages = [int(p) for p in self.bt[s] if p != self._sentinel]
        if pages:
            self.allocator.free(
                pages, owner=owner or self._owner_tag(self.slots[s])
            )
        self.bt[s] = self._sentinel

    def _clear_slot(self, s: int) -> None:
        # Last accrual while the occupant still holds its pages.
        self._accrue_page_seconds(s)
        self._free_slot_pages(s)
        self.slots[s] = None
        self.finished[s] = True
        self.lengths[s] = 0
        self.tok[s] = 0
        self.temp[s] = 0.0
        self.top_p[s] = 1.0
        self.top_k[s] = 0
        self.recent[s] = -2
        self.gens[s] = None

    def _grow_slot(self, s: int, tokens: int,
                   req: _Request | None = None) -> bool:
        """Extend slot s's block table to cover `tokens` logical slots;
        False when the free list cannot. The ask is clamped to max_ctx (the
        table is max_pages wide; near the ceiling the last chunk's overshoot
        steps stay in the row's own discarded tail). `req` is the owner
        (default: the slot's occupant)."""
        tokens = min(tokens, self.max_ctx)
        held = self._held(s)
        need = self.allocator.pages_for(tokens) - held
        if need <= 0:
            return True
        req = req or self.slots[s]
        # Bank the integral at the old page count before it changes.
        self._accrue_page_seconds(s)
        if need > self.allocator.num_free and self.prefix_cache is not None:
            # Cached pages go before live requests, but only when evicting
            # them covers the shortfall (draining the cache for a grow that
            # fails anyway costs later requests their splices).
            shortfall = need - self.allocator.num_free
            if self.prefix_cache.evictable_pages() >= shortfall:
                self.prefix_cache.evict(shortfall)
        if need > self.allocator.num_free:
            # The capacity path (deferral and eviction absorb it): one
            # capture a pressure episode.
            if not self._oom_episode:
                self._oom_episode = True
                self._capture_oom(
                    "pool_pressure",
                    f"free-list shortfall: need {need} page(s), "
                    f"{self.allocator.num_free} free",
                    asking=(s, req, need),
                )
            return False
        try:
            pages = self.allocator.alloc(need, owner=self._owner_tag(req))
        except paged_kv.OutOfPagesError as e:
            # The free list said yes but the allocation refused (an injected
            # exhaustion): a scheduling signal for the defer and eviction
            # machinery, never a crash. alloc is all-or-nothing, so nothing
            # is held; the moment is a forensic.
            self._capture_oom(
                "oom", f"{type(e).__name__}: {e}", asking=(s, req, need),
            )
            return False
        self.bt[s, held:held + need] = pages
        self._oom_episode = False  # pages flowed: the episode is over
        return True

    def _reset_pool(self) -> None:
        """Fresh page pool + allocator + prefix cache + empty slot state,
        after a failed dispatch left the pool in an unknown state (callers
        have errored out every in-flight request). The host tier restarts
        empty with the cache."""
        self.allocator = paged_kv.PageAllocator(
            self.num_pages, self.page_size
        )
        # A fresh allocator has no observer: re-attach it.
        self.pool_observatory.attach(self.allocator)
        if self.prefix_cache is not None:
            self.prefix_cache = self._build_prefix_cache()
        self.kv_pages = self._new_pool()
        self._release_graphs()  # captured on the old pool
        self.bt[:] = self._sentinel
        self._oom_episode = False
        self.slots = [None] * self.num_slots
        self.gens = [None] * self.num_slots
        self.finished[:] = True
        self.lengths[:] = 0
        self.tok[:] = 0
        self.recent[:] = -2
        self.check_pool_invariant()

    # ---- scheduling loop --------------------------------------------------

    def _run(self) -> None:
        with torch.inference_mode():
            while True:
                if self.replay_feeder is not None:
                    # Offline replay: feed the journaled admissions at their
                    # recorded step gates before this turn looks at the
                    # queue.
                    self.replay_feeder(self)
                drain_drop: list[_Request] = []
                with self._cond:
                    if self._shutdown:
                        return
                    if self._draining and self._queue:
                        # Drain: queued requests hold no pages; error them
                        # out so their clients retry elsewhere.
                        drain_drop = list(self._queue)
                        self._queue.clear()
                        self.metrics.set_gauge("queue_depth", 0)
                    idle = not self._queue and all(
                        r is None for r in self.slots
                    )
                    # Decided with the idle check, under one hold: a
                    # request queued after it is served, not stranded.
                    drain_exit = idle and self._draining
                    if idle and not drain_exit and (
                        not self.auditor.pending()
                    ):
                        self._cond.wait(timeout=0.1)
                for r in drain_drop:
                    self._reject_queued(
                        r, "server draining: request not admitted",
                        kind="unavailable",
                    )
                if drain_exit:
                    _LOG.info("drain complete: engine loop exiting")
                    return
                if idle:
                    if self._profile_active is not None:
                        # Traffic drained mid-capture: close it now with the
                        # windows so far, so the process-wide profiler never
                        # records an idle engine and the requester is
                        # answered.
                        self._finish_profile_early()
                    # The ladder decays while idle too: mode 3 sheds load,
                    # so no traffic is exactly when it must walk down.
                    self._update_degraded()
                    if self.watchdog is not None:
                        self.watchdog.set_active(False)
                    # An idle point: run ONE queued audit replay, then look
                    # for live work again, so an arrival never waits behind
                    # a second replay and a replay never meets a live step.
                    self.auditor.run_one()
                    continue
                if self.watchdog is not None:
                    self.watchdog.set_active(True)
                # Fault site: engine-thread death. Outside the containment
                # below, so the exception ends the thread, which is what the
                # API server's supervisor restarts.
                faults.fault_point("engine_crash")
                # A tensor-parallel pipe whose ranks fell out of step (a
                # dead follower, a timed-out collective) ends the thread
                # the same way: no dispatch can be trusted after it.
                world = self.pipe.tp
                if world is not None and world.broken:
                    raise tp_lib.WorldBroken(world.broken)
                # A parked /debug/profile request is adopted only with work
                # to dispatch.
                with self._cond:
                    take = (
                        self._profile_pending
                        if self._profile_active is None else None
                    )
                    if take is not None:
                        self._profile_pending = None
                        if take["abandoned"]:
                            take = None
                if take is not None:
                    self._adopt_profile(take)
                try:
                    self._update_degraded()
                    self._enforce_deadlines()
                    self._admit()
                    if self.ragged:
                        # Prefill lanes and decode lanes ride ONE dispatch.
                        self._ragged_step()
                    else:
                        # Each engine step advances the in-flight admission
                        # by at most one prefill chunk, then runs one decode
                        # chunk for the resident streams.
                        self._prefill_step()
                        if any(
                            r is not None and r.activated for r in self.slots
                        ):
                            self._ensure_capacity()
                            self._step_chunk()
                except Exception as e:  # surface to every in-flight client
                    self._fail_all(f"{type(e).__name__}: {e}")

    def _fail_all(self, msg: str) -> None:
        """A step failed: error out every resident and queued request and
        rebuild the pool, so the engine keeps serving new traffic."""
        for s, req in enumerate(self.slots):
            if req is not None:
                self._finish_error(s, msg)
        for r in self._take_queue():
            self._reject_queued(r, msg)
        if self.anomaly is not None:
            self.anomaly.observe_queue_depth(0)
        # A capture straddling the failure is discarded.
        self._abort_profile()
        self._reset_pool()

    # ---- the degraded-mode ladder -----------------------------------------

    def _update_degraded(self) -> None:
        """Each NEW serving-SLO anomaly firing (ttft_slo, queue_depth_slo)
        escalates one level; `degraded_cooldown` quiet seconds de-escalate
        one. Exported as the degraded_mode gauge."""
        if self.anomaly is None:
            return
        fired = sum(
            self.anomaly.counts.get(k, 0)
            for k in ("ttft_slo", "queue_depth_slo")
        )
        now = time.monotonic()
        with self._cond:
            mode = self._degraded
        if fired > self._slo_fired_seen:
            self._slo_fired_seen = fired
            self._degraded_changed = now
            if mode < 3:
                self._set_degraded(mode + 1)
        elif mode > 0 and now - self._degraded_changed \
                >= self.degraded_cooldown:
            self._degraded_changed = now
            self._set_degraded(mode - 1)

    def _set_degraded(self, mode: int) -> None:
        with self._cond:
            prev, self._degraded = self._degraded, mode
        self.metrics.set_gauge("degraded_mode", mode)
        _LOG.warning(
            "degraded mode %d -> %d (%s)", prev, mode,
            ["normal", "prefix cache shed", "max_tokens clamped",
             "shedding load"][mode],
        )
        if self.journal is not None:
            # Journaled, not replayed: the ladder follows the wall clock;
            # its effect on decisions is the clamped max_new of the admits.
            self.journal.append(journal_lib.build_journal_event(
                kind="degraded", step=self._journal_step(), mode=mode,
            ))
        if mode > prev:
            # An escalation is a capacity incident in progress: the same
            # forensic an OOM gets, while the pressure is visible.
            self._capture_oom(
                "degraded_escalation", f"degraded mode {prev} -> {mode}",
            )
        if mode >= 1 and not self._cache_shed:
            # Shed the prefix cache: its pages go to live requests, and it
            # is not fed until the ladder clears.
            self._cache_shed = True
            if self.prefix_cache is not None:
                self.prefix_cache.clear()
        elif mode == 0:
            self._cache_shed = False

    def _reject_queued(
        self, req: _Request, msg: str, *, kind: str = "server_error"
    ) -> None:
        """Error out a request already taken from the queue and never
        placed (it holds no pages). Its ledger is finalized too (zero
        resources, a real queue_s)."""
        self._fail_handle(req, msg, kind, self._finalize_cost(None, req))
        _LOG.info("request %s dropped: %s", req.trace.id, msg)

    def _fail_handle(self, req: _Request, msg: str, kind: str,
                     cost: dict[str, Any]) -> None:
        """An error's terminal path: trace and wide event closed, then the
        client woken with the error."""
        req.handle.error = msg
        req.handle.error_kind = kind
        req.trace.finish(error=msg, cost=cost)
        self._emit_request_event(req, status="error", error_kind=kind)
        req.handle.events.put(("error", msg))
        req.handle.done.set()

    def _cancel_queued(self, req: _Request) -> None:
        """A client hang-up before admission (no slot, no pages)."""
        self.metrics.inc("cancelled")
        cost = self._finalize_cost(None, req)
        req.trace.finish(cancelled=True, cost=cost)
        self._emit_request_event(req, status="cancelled")
        _LOG.info("request %s cancelled in queue", req.trace.id)

    def _cancel_slot(self, s: int, req: _Request, where: str) -> None:
        """A client hang-up while holding slot s (mid-prefill or
        mid-decode, `where`): its pages return now."""
        self.metrics.inc("cancelled")
        req.handle.debug["cancelled"] = where
        cost = self._finalize_cost(s, req)
        self._clear_slot(s)
        req.trace.finish(cancelled=True, cost=cost)
        self._emit_request_event(req, status="cancelled")
        _LOG.info("request %s cancelled %s", req.trace.id, where)

    def _enforce_deadlines(self) -> None:
        """Cancel every request past its deadline wherever it lives:
        queued (no pages), mid-prefill or decoding (slot pages and cache
        shares freed). Once per engine step."""
        now = time.monotonic()
        expired: list[_Request] = []
        depth = None
        with self._cond:
            if any(
                r.deadline is not None and now > r.deadline
                for r in self._queue
            ):
                keep: collections.deque[_Request] = collections.deque()
                for r in self._queue:
                    if r.deadline is not None and now > r.deadline:
                        expired.append(r)
                    else:
                        keep.append(r)
                self._queue = keep
                depth = len(keep)
                self.metrics.set_gauge("queue_depth", depth)
        for r in expired:
            self.metrics.inc("deadline_exceeded_total")
            self._reject_queued(
                r, "deadline exceeded before admission", kind="timeout"
            )
        if depth is not None and self.anomaly is not None:
            self.anomaly.observe_queue_depth(depth)
        for s, req in enumerate(self.slots):
            if req is None or req.deadline is None or now <= req.deadline:
                continue
            self.metrics.inc("deadline_exceeded_total")
            self._finish_error(
                s,
                f"deadline exceeded after {now - req.submit_time:.2f}s "
                f"({len(req.emitted)} tokens emitted)",
                kind="timeout",
            )

    def _prepare(self, req: _Request) -> None:
        """Prompt prep at the queue head (once per request): decoder
        embeds, length, sampling knobs, and the size checks. Raises
        ValueError for a request that can never be served."""
        gen = self.cfg.generation
        with req.trace.span("prompt_prep"):
            ids, imgs, factors, caps = self.pipe._prepare_request(
                req.request
            )
            req.embeds, req.length = self.pipe._prompt_embeds(
                self.cfg, ids, imgs, factors, caps
            )
            # Text-only prompts key the prefix cache by token ids (ids ==
            # the logical KV stream); multimodal ones bypass it.
            req.cache_tokens = None if imgs else np.asarray(ids, np.int64)
        s_ = req.sampling
        req.temp = float(s_.get("temperature", gen.temperature) or 0.0)
        req.topp = float(s_.get("top_p", gen.top_p) or 1.0)
        req.topk = int(s_.get("top_k", gen.top_k) or 0)
        req.seed = int(s_.get("seed") or self.seed)
        with self._cond:
            mode = self._degraded
        if mode >= 2 and req.max_new > self.degraded_clamp_tokens:
            # Degraded mode 2: a shorter decode budget turns the backlog
            # over faster; the client sees a "length" finish.
            req.max_new = self.degraded_clamp_tokens
            req.handle.debug["clamped_max_tokens"] = (
                self.degraded_clamp_tokens
            )
        if req.length + req.max_new > self.max_ctx:
            raise ValueError(
                f"prompt ({req.length}) + max_tokens ({req.max_new}) "
                f"exceeds max_ctx {self.max_ctx}"
            )
        need = self.allocator.pages_for(req.length + self._win)
        if need > self.num_pages:
            raise ValueError(
                f"prompt needs {need} KV pages but the whole pool holds "
                f"{self.num_pages} (raise num_pages, or lower the prompt "
                "length / max_ctx)"
            )

    def _admit(self) -> None:
        while True:
            if self.replay_feeder is not None:
                # The gates are checked between admissions too: an
                # unchunked prefill dispatches inside this loop.
                self.replay_feeder(self)
            if any(r is not None and not r.activated for r in self.slots):
                # A chunked prefill is in flight: one admission at a time.
                break
            free = [s for s, r in enumerate(self.slots) if r is None]
            if not free:
                break
            req = self._queue_head()
            if req is None:
                break
            if req.handle.cancelled:
                self._pop_head()
                self._cancel_queued(req)
                continue
            if req.embeds is None:
                # The request reached the queue head: queue_wait ends,
                # admission (prompt prep, the wait for pages, the prefill)
                # begins.
                req.trace.end(req.qw_span)
                req.qw_span = -1
                req.adm_span = req.trace.begin("admission")
                try:
                    self._prepare(req)
                except Exception as e:  # the request is rejected, not the engine
                    self._pop_head()
                    self._reject_queued(
                        req, f"{type(e).__name__}: {e}",
                        kind=(
                            "invalid_request" if isinstance(e, ValueError)
                            else "server_error"
                        ),
                    )
                    continue
            s = free[0]
            # FIFO head-of-line: if the head does not fit, nobody jumps it.
            if not self._splice_and_grow(s, req):
                break
            self._pop_head()
            self._place(s, req)
            if self.prefill_chunk is None:
                # Unchunked: the whole prefill now, so the slot activates
                # before the next queue head is examined.
                self._advance_prefill(s, req)

    def _splice_and_grow(self, s: int, req: _Request) -> bool:
        """Splice the longest cached prefix of `req`'s prompt into slot s's
        block table (full pages shared, a partly consumed last page copied
        on write), then grow the table to cover prompt + one decode chunk.
        False, with nothing held, when the pool cannot (the FIFO head then
        waits). At least one suffix token always remains to prefill: the
        admission needs the next-token logit."""
        ps = self.page_size
        # Page-seconds accrue from the moment this placement holds pages.
        req.pages_t = time.monotonic()
        spliced = 0
        cow_pages = 0
        host_reloaded = 0
        matched, pages, host_nodes = 0, [], []
        cache_on = (
            self.prefix_cache is not None and req.cache_tokens is not None
            and not self._cache_shed  # degraded >= 1: no splicing
        )
        if cache_on:
            matched, pages, host_nodes = (
                self.prefix_cache.lookup_tiered(req.cache_tokens)
            )
        limit = max(req.length - 1, 0)
        use = min(matched, limit)
        full = use // ps
        # Feasibility screen before any share or copy: the fresh pages
        # beyond the spliced prefix must be coverable by the free list plus
        # the evictable cache pages, or a head that cannot fit would pay a
        # page copy every engine step while it waits.
        total_need = self.allocator.pages_for(
            min(req.length + self._win, self.max_ctx)
        )
        avail = self.allocator.num_free
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_pages(
                exclude=[int(p) for p in pages[:full]]
            )
        if total_need - full > avail:
            # The admission side of _grow_slot's shortfall: one capture a
            # pressure episode.
            if not self._oom_episode:
                self._oom_episode = True
                self._capture_oom(
                    "pool_pressure",
                    f"admission shortfall: prompt needs "
                    f"{total_need - full} fresh page(s), {avail} coverable",
                    asking=(s, req, total_need - full),
                )
            return False
        if cache_on and host_nodes and full == len(pages):
            # Host-tier hit: the cached prefix continues past the device
            # blocks into spilled ones; reload them onto fresh pages ahead
            # of the suffix prefill (one free page each, evicting colder
            # entries for them, never the matched device prefix, which is
            # still refcount 1). Any failure just shortens the match.
            n_host = min(len(host_nodes), limit // ps - full)
            if n_host > 0:
                short = n_host - self.allocator.num_free
                keep = [int(p) for p in pages[:full]]
                if short > 0 and self.prefix_cache.evictable_pages(
                    exclude=keep
                ) >= short:
                    self.prefix_cache.evict(short, exclude=keep)
                reloaded = self.prefix_cache.reload(
                    req.cache_tokens, host_nodes[:n_host]
                )
                if reloaded:
                    host_reloaded = len(reloaded)
                    pages = pages + reloaded
                    matched = len(pages) * ps
                    use = min(matched, limit)
                    full = use // ps
        if cache_on:
            if full:
                share = [int(p) for p in pages[:full]]
                self.allocator.share(share, owner=self._owner_tag(req))
                self.bt[s, :full] = share
            if use - full * ps > 0:
                # The suffix prefill starts mid-page: the cache (and maybe
                # other slots) still read this page, so the writer gets its
                # own copy, or recomputes the partial page when none is
                # free.
                try:
                    cow = self.allocator.alloc(
                        1, owner=self._owner_tag(req)
                    )[0]
                except paged_kv.OutOfPagesError as e:
                    self._capture_oom(
                        "oom", f"COW alloc: {type(e).__name__}: {e}",
                        asking=(s, req, 1),
                    )
                    use = full * ps
                else:
                    self.kv_pages = self._on_ranks(
                        paged_kv.copy_pages, self.kv_pages,
                        int(pages[full]), cow,
                    )
                    self.bt[s, full] = cow
                    cow_pages = 1
                    self.engine_stats["prefix_cache_cow_pages_total"] += 1
            spliced = use
        req.spliced = spliced
        req.prefill_pos = spliced
        if not self._grow_slot(s, req.length + self._win, req=req):
            self._free_slot_pages(s, owner=self._owner_tag(req))
            req.spliced = 0
            req.prefill_pos = 0
            return False
        self.metrics.inc("prefix_cache_hit_tokens_total", spliced)
        self.metrics.inc(
            "prefix_cache_miss_tokens_total", req.length - spliced
        )
        req.cost_cached_tokens += spliced
        if self.journal is not None and (spliced or host_reloaded):
            # A hit (a miss is an admit with spliced_tokens 0).
            self.journal.append(journal_lib.build_journal_event(
                kind="splice", step=self.steps_run,
                request_id=req.trace.id, slot=s,
                spliced_tokens=spliced,
                shared_pages=full,
                cow_pages=cow_pages,
                host_reload_pages=host_reloaded,
            ))
        return True

    def _place(self, s: int, req: _Request) -> None:
        """Claim slot s for `req` (pages already spliced and grown; the
        prefill starts after the spliced prefix) and start its prefill.
        The slot stays finished on the device, so decode steps skip it,
        until `_activate`."""
        # First admission closes the "admission" span; a re-admission after
        # an eviction or restart the reopened "queue_wait".
        if req.adm_span >= 0:
            req.trace.end(req.adm_span)
            req.adm_span = -1
        if req.qw_span >= 0:
            req.trace.end(req.qw_span)
            req.qw_span = -1
        self.slots[s] = req
        req.activated = False
        self.finished[s] = True
        self.lengths[s] = 0
        self.tok[s] = 0
        req.generator = (
            generate_lib.row_generator(self.device, req.seed)
            if req.temp > 0 else None
        )
        req.knobs = (
            torch.tensor([req.temp], dtype=torch.float32, device=self.device),
            torch.tensor([req.topp], dtype=torch.float32, device=self.device),
            torch.tensor([req.topk], dtype=torch.int32, device=self.device),
        )
        req.admit_seq = self._admit_seq
        self._admit_seq += 1
        if self.journal is not None:
            # max_new is the EFFECTIVE budget (the degraded clamp applied at
            # the queue head): a replay submits with it.
            self.journal.append(journal_lib.build_journal_event(
                kind="admit", step=self.steps_run,
                request_id=req.trace.id, slot=s,
                admit_seq=req.admit_seq, prompt_len=req.length,
                max_new=req.max_new, replay_tokens=req.replay,
                spliced_tokens=req.spliced,
            ))
        _LOG.info(
            "request %s %s slot=%d prompt=%d cached=%d", req.trace.id,
            "re-admitted" if req.replay else "admitted", s, req.length,
            req.spliced,
        )

    def _prefill_step(self) -> None:
        """Advance every admitting slot by at most one prefill chunk; a slot
        whose prefill completes activates and joins the next decode
        chunk."""
        for s, req in enumerate(self.slots):
            if req is None or req.activated:
                continue
            if req.handle.cancelled:
                self._cancel_slot(s, req, "mid-prefill")
                continue
            self._advance_prefill(s, req)

    def _advance_prefill(self, s: int, req: _Request) -> None:
        hot_dispatch("scheduler._advance_prefill")
        # Fault site: a prefill dispatch that fails or stalls (a raise is
        # contained by the loop: requests errored, pool rebuilt).
        faults.fault_point("prefill_dispatch")
        off, L = req.prefill_pos, req.length
        if self.prefill_chunk is None and off == 0:
            emb, end = req.embeds, L
        elif self.prefill_chunk is None:
            # A cached suffix in one dispatch, bucketed as a cold prompt.
            width = round_up_bucket(L - off)
            emb = generate_lib.slice_embeds(
                generate_lib.pad_embeds_for_chunks(req.embeds, width), off,
                width=width,
            )
            end = L
        else:
            width = self.prefill_chunk
            if req.embeds_p is None:
                req.embeds_p = generate_lib.pad_embeds_for_chunks(
                    req.embeds, width
                )
            emb = generate_lib.slice_embeds(req.embeds_p, off, width=width)
            end = min(off + width, L)
        dev = self.device
        # Only the window holding the prompt's last token samples (and
        # draws from the request's generator).
        final = end >= L
        pf = req.trace.begin(
            "prefill", slot=s, start=off, tokens=end - off,
            cached=req.spliced > 0, replay=req.replay > 0,
        )
        sampled = self._profile_dispatch_begin()
        t0_ns = trace_lib.now_ns()
        self.kv_pages, tok0 = self._on_ranks(generate_lib.paged_prefill,
            self.pipe.params.llm, self.cfg.llm, emb,
            torch.tensor([end], device=dev),
            torch.tensor(self.bt[s][None], device=dev),
            self.kv_pages,
            torch.tensor([off], device=dev),
            [req.generator if final else None], *req.knobs,
            attn_impl=self.cfg.attn_impl, compute_dtype=self._dtype,
        )
        tok0 = int(tok0.reshape(-1)[0]) if final else None  # one read
        dt, dev_us = self._profile_dispatch_end(sampled, "prefill", t0_ns)
        req.trace.end(pf)
        req.prefill_pos = end
        req.cost_prefill_tokens += end - off
        self.metrics.inc("prefill_tokens_total", end - off)
        self.metrics.observe(
            "prefill_chunk_tokens", end - off, buckets=PREFILL_CHUNK_BUCKETS
        )
        self.metrics.inc("dispatches_total", labels={"kind": "prefill"})
        self.metrics.observe(
            "dispatch_rows", end - off, buckets=DISPATCH_ROWS_BUCKETS
        )
        # Split prefill dispatches are engine steps too: the timeline's
        # kinds reconcile with dispatches_total on every engine mode.
        live = self._timeline_record(
            dur_s=dt, kind="prefill", rows=end - off, accepted=0,
            device_us=dev_us,
        )
        self._journal_dispatch("prefill", end - off, live, 0)
        if self.watchdog is not None:
            self.watchdog.beat()
        if final:
            self._activate(s, req, tok0)

    def _activate(self, s: int, req: _Request, tok0: int) -> None:
        """Prefill complete: slot s is live from the next decode chunk. The
        slot samples with the REQUEST's generator, never a previous
        occupant's state."""
        req.activated = True
        self.tok[s] = tok0
        self.lengths[s] = req.length
        self.finished[s] = False
        self.temp[s] = req.temp
        self.top_p[s] = req.topp
        self.top_k[s] = req.topk
        self.recent[s] = -2
        self.gens[s] = req.generator
        if not req.ttft_done:
            req.ttft_done = True
            ttft = time.monotonic() - req.submit_time
            self.metrics.observe("ttft_seconds", ttft, buckets=TTFT_BUCKETS)
            req.handle.debug["ttft_s"] = ttft
            if self.anomaly is not None:
                self.anomaly.observe_ttft(ttft, request_id=req.trace.id)
            req.handle.debug["admit_chunk"] = self.chunks_run
        self.metrics.inc("admitted")
        self._donate_prefix(s, req, req.length)
        self._occupancy_gauge()
        # tok0 is the first generated token: process it now (a
        # max_tokens=1 request never occupies a chunk). The decode step
        # re-emits it as its first output (a step emits the token it was
        # FED), so one more replay skip keeps the stream exactly-once.
        self._advance(s, [int(self.tok[s])])
        if self.slots[s] is not None:
            req.replay += 1

    def _donate_prefix(self, s: int, req: _Request, tokens: int) -> None:
        """Index the full-page prefix of slot s's first `tokens` logical
        slots into the prefix cache (the cache takes its own references, so
        the entry outlives the slot): at activation with the prompt, at
        finish with prompt + reply."""
        if (
            self.prefix_cache is None or req.cache_tokens is None
            or self._cache_shed
        ):
            return
        stream = req.cache_tokens
        if tokens > req.length:
            stream = np.concatenate([
                stream, np.asarray(req.emitted, np.int64),
            ])
        full = min(
            min(tokens, len(stream)) // self.page_size, self._held(s)
        )
        if full:
            self.prefix_cache.insert(
                stream[:full * self.page_size],
                [int(p) for p in self.bt[s, :full]],
            )

    def _ensure_capacity(self, horizon: int | None = None) -> None:
        """Every live slot must own pages for lengths + `horizon` (default
        one dispatch window, `_win`) before the next dispatch; under page
        pressure, preempt YOUNGER slots only, and a slot with no younger
        victim preempts itself, so the oldest request always progresses. A
        megastep passes horizon = _win * K: the device writes K windows
        before the host sees any of them."""
        win = self._win if horizon is None else horizon
        order = sorted(
            (s for s, r in enumerate(self.slots) if r is not None),
            key=lambda s: self.slots[s].admit_seq,
        )
        for s in order:
            if self.slots[s] is None or self.finished[s]:
                continue  # freed or evicted by an earlier iteration
            while not self._grow_slot(s, int(self.lengths[s]) + win):
                me = self.slots[s].admit_seq
                younger = [
                    v for v in order
                    if self.slots[v] is not None
                    and self.slots[v].admit_seq > me
                ]
                if younger:
                    self._evict(
                        max(younger, key=lambda v: self.slots[v].admit_seq)
                    )
                elif any(
                    self.slots[v] is not None for v in order if v != s
                ):
                    self._evict(s)  # wait for the older slots' pages
                    break
                else:
                    self._finish_error(
                        s, "page pool exhausted for a single request"
                    )
                    break

    def _evict(self, s: int) -> None:
        """Free slot s and requeue its request at the FRONT; its replay
        re-derives the same stream and skips the `processed` tokens."""
        req = self.slots[s]
        req.replay = req.processed
        req.evictions += 1
        req.activated = False
        req.spliced = 0
        req.prefill_pos = 0
        self._clear_slot(s)
        req.trace.event("evicted", slot=s, replay_tokens=req.processed)
        req.qw_span = req.trace.begin("queue_wait", requeued=True)
        if self.journal is not None:
            self.journal.append(journal_lib.build_journal_event(
                kind="evict", step=self.steps_run, slot=s,
                victim_request_id=req.trace.id,
                admit_seq=req.admit_seq,
                replay_tokens=req.processed,
            ))
        _LOG.info(
            "request %s evicted from slot %d (replay %d tokens)",
            req.trace.id, s, req.processed,
        )
        with self._cond:
            self._queue.appendleft(req)
            self.metrics.set_gauge("queue_depth", len(self._queue))
        self.metrics.inc("evicted")
        self._occupancy_gauge()

    # ---- device-time sampling (utils/profiling.DeviceTimeSampler) ---------

    def _abort_profile(self) -> None:
        """A failed dispatch (or a restart) may leave a capture straddling
        the failure: stop and discard it, so the process-wide profiler
        stays usable, and answer a waiting /debug/profile requester with an
        error."""
        self.profiler.abort()
        act, self._profile_active = self._profile_active, None
        if act is not None:
            act["holder"]["result"] = {
                "error": "engine step failed during the capture",
            }
            act["holder"]["done"].set()

    def _adopt_profile(self, holder: dict[str, Any]) -> None:
        """Begin an on-demand capture over the next `steps` dispatches; a
        profiler that cannot start answers the requester at once."""
        if self.profiler.begin():
            self._profile_active = {
                "holder": holder, "left": int(holder["steps"]),
                "windows": [],
            }
        else:
            holder["result"] = {
                "error": "profiler start failed (see "
                "oryx_profile_capture_errors_total)",
            }
            holder["done"].set()

    def _finish_profile_early(self) -> None:
        """The engine went idle inside an on-demand capture: finish it with
        the windows collected so far (or report that there were none)."""
        act, self._profile_active = self._profile_active, None
        holder = act["holder"]
        if act["windows"]:
            holder["result"] = self.profiler.finish_capture(act["windows"])
        else:
            self.profiler.abort()
            holder["result"] = {
                "error": "engine went idle before any dispatch was "
                "captured (profiling needs live traffic)",
            }
        holder["done"].set()

    def _profile_dispatch_begin(self) -> bool:
        """Right before a dispatch: True when THIS dispatch is a periodic
        sample (capture started). Dispatches inside an on-demand capture
        are never captured twice (the profiler is process-wide); their
        windows are recorded at the end instead."""
        due = self.profiler.tick()
        if self._profile_active is not None:
            return False
        return due and self.profiler.begin()

    def _profile_dispatch_end(self, sampled: bool, kind: str,
                              t0_ns: int) -> tuple[float, int | None]:
        """After the dispatch's harvest: (the window's seconds, the device
        microseconds of a periodic sample or None). Both come from one
        clock (utils/trace.now_ns, the profiler's epoch), so the device
        time never exceeds the window. Inside an on-demand capture the
        window is recorded, and the capture finished (its requester
        answered) at the asked count."""
        act = self._profile_active
        if (sampled or act is not None) and self.device.type == "cuda":
            # The window closes when the dispatch's kernels are done (a
            # prefill chunk that samples nothing has no harvest): an event
            # on the engine's stream, since a device-wide synchronize would
            # invalidate another engine's open graph capture.
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        t1_ns = trace_lib.now_ns()
        dt = (t1_ns - t0_ns) / 1e9
        if act is not None:
            act["windows"].append((kind, t0_ns, t1_ns))
            act["left"] -= 1
            if act["left"] <= 0:
                self._profile_active = None
                holder = act["holder"]
                holder["result"] = self.profiler.finish_capture(
                    act["windows"])
                holder["done"].set()
            return dt, None
        if sampled:
            return dt, self.profiler.end(kind, t0_ns, t1_ns)
        return dt, None

    def _device_state(self) -> tuple:
        """The slot arrays as device tensors for one dispatch."""
        dev = self.device
        return (
            torch.tensor(self.bt, device=dev),
            torch.tensor(self.tok, device=dev),
            torch.tensor(self.lengths, device=dev),
            torch.tensor(self.finished, device=dev),
            torch.tensor(self.recent, device=dev),
            self.gens,
            torch.tensor(self.temp, device=dev),
            torch.tensor(self.top_p, device=dev),
            torch.tensor(self.top_k, device=dev),
            self.stop_sequences,
        )

    def _step_chunk(self) -> None:
        """One split-engine decode dispatch over every slot."""
        hot_dispatch("scheduler._step_chunk")
        # Fault site: a decode dispatch that fails (every in-flight request
        # errors, the pool is rebuilt, serving goes on) or hangs (delay=).
        faults.fault_point("decode_dispatch")
        live = self._live()
        numer = self._numerics_due()
        sampled = self._profile_dispatch_begin()
        t0_ns = trace_lib.now_ns()
        out = self._on_ranks(generate_lib.paged_decode_chunk,
            self.pipe.params.llm, self.cfg.llm, self.kv_pages,
            *self._device_state(),
            chunk=self.chunk, eos=self.cfg.generation.eos_token_id,
            attn_impl=self.cfg.attn_impl, compute_dtype=self._dtype,
            numerics=numer,
        )
        self.kv_pages = out[0]
        toks, _ = self._harvest_chunk(*out[1:6])
        dt, dev_us = self._profile_dispatch_end(sampled, "decode", t0_ns)
        self._record_numerics(out[7] if numer else None)
        self._finish_dispatch("decode", len(live), live, toks, t0_ns, dt,
                              device_us=dev_us)

    def _harvest_chunk(self, tok, lengths, finished, recent, toks,
                       pf_tok0=None):
        """Host copies of a dispatch's outputs (`_fetch`; the per-step
        finished flags are not needed: the host re-derives finishing from
        the tokens). Returns (toks [S, chunk], pf_tok0 as an int or
        None)."""
        host = self._fetch(tok, lengths, finished, recent, toks, pf_tok0)
        self.tok = host[0].astype(np.int32)
        self.lengths = host[1].astype(np.int32)
        self.finished = host[2].astype(bool)
        self.recent = host[3].astype(np.int32)
        return host[4], None if pf_tok0 is None else int(host[5])

    def _fetch(self, *parts) -> list[np.ndarray]:
        """Host copies of device tensors (None skipped), packed into one
        int64 vector on the device and copied in one piece: the engine's
        one sync with the device a dispatch. Each comes back in its
        shape."""
        parts = [x for x in parts if x is not None]
        flat = torch.cat([x.reshape(-1).long() for x in parts]).cpu().numpy()
        host = np.split(flat, np.cumsum([x.numel() for x in parts])[:-1])
        self.metrics.inc("harvest_total")
        return [h.reshape(x.shape) for h, x in zip(host, parts)]

    def _finish_dispatch(self, kind: str, rows: int, live: list[int],
                         toks, t0_ns: int, dt: float, n_new=None,
                         device_us: int | None = None) -> None:
        """Post-dispatch accounting shared by the split, ragged and
        speculative steps: dispatch counters and the rows histogram, the
        watchdog beat, the per-slot harvest, and the decode-step counters
        (skipped when no slot decoded). n_new (speculative): the valid
        tokens of each slot's row of `toks` (the fed token and its accepted
        drafts); a slot's device work is then its 1 + k lanes, rejected
        drafts billed as wasted steps. The dispatch's window (t0_ns, dt)
        lands on every live request as its decode_chunk span."""
        self.chunks_run += 1
        self.metrics.inc("chunks")
        self.metrics.inc("dispatches_total", labels={"kind": kind})
        self.metrics.observe(
            "dispatch_rows", rows, buckets=DISPATCH_ROWS_BUCKETS
        )
        if self.watchdog is not None:
            self.watchdog.beat()
        accepted = self._bill_step(live, toks, n_new, t0_ns, dt, dt)
        self._occupancy_gauge()
        live = self._timeline_record(dur_s=dt, kind=kind, rows=rows,
                                     accepted=accepted, device_us=device_us)
        self._journal_dispatch(kind, rows, live, accepted)

    def _numerics_due(self) -> bool:
        """The probe's cadence: every `numerics_every` engine steps the
        dispatch runs armed (tokens are those of the unarmed step)."""
        return (
            self.numerics_every > 0
            and self.chunks_run % self.numerics_every == 0
        )

    def _record_numerics(self, nstats) -> None:
        """Publish one probe sample after the harvest: the oryx_numerics_*
        gauges and the entropy_collapse / absmax_explosion sentinels. A
        dispatch where nothing decoded reports nothing."""
        if nstats is None:
            return
        stats = numerics_lib.finalize_logit_stats(nstats)
        if stats is None:
            return
        for key, gauge in self._numerics_gauges.items():
            gauge.set(stats[key])
        self._numerics_samples.inc()
        if self.anomaly is not None:
            self.anomaly.observe_numerics(
                entropy=stats["entropy"], absmax=stats["absmax"],
                source_step=self.chunks_run,
            )

    def _timeline_record(self, *, dur_s: float, kind: str, rows: int,
                         accepted: int, device_us: int | None = None) -> int:
        """One step record into the timeline (engine thread); returns the
        live slots it recorded. Queue depth and degraded mode come from the
        registry's gauges, so no telemetry sample takes the scheduler's
        lock."""
        live = sum(1 for r in self.slots if r is not None and r.activated)
        self.timeline.record(
            dur_s=dur_s, kind=kind, rows=rows,
            live_slots=live,
            accepted_tokens=accepted,
            queue_depth=int(self.metrics.get("queue_depth")),
            free_pages=self.allocator.num_free,
            degraded_mode=int(self.metrics.get("degraded_mode")),
            device_us=device_us,
        )
        return live

    def _journal_dispatch(self, kind: str, rows: int, live: int,
                          accepted: int, fused: tuple | None = None
                          ) -> None:
        """One logical step on the journal's step clock: steps_run counts
        every recorded dispatch (every logical step of a megastep, with
        (fused_k, fused_j)), the gate a replay feeds admissions on. No wall
        or device time: the journal keeps what replays."""
        self.steps_run += 1
        if self.journal is not None:
            extra = {} if fused is None else dict(
                fused_k=fused[0], fused_j=fused[1])
            self.journal.append(journal_lib.build_journal_event(
                kind="step", step=self.steps_run, dispatch=kind,
                rows=rows, live_slots=live, accepted_tokens=accepted,
                free_pages=self.allocator.num_free, **extra,
            ))

    def _bill_step(self, live: list[int], toks, n_new, t0_ns: int,
                   dt: float, step_dt: float) -> int:
        """One logical step's harvest: feed each slot live during it its
        tokens (its decode_chunk span over the dispatch window, its ledger's
        device steps), then the per-token latency (`step_dt` a logical
        step) and the decode-step counters. Returns the step's accepted
        tokens (speculating: the tokens emitted; else the useful steps)."""
        lane_steps = 1 + self.speculate if n_new is not None else self.chunk
        useful = 0
        emitted = 0
        for s, tokens in generate_lib.unpack_ragged_rows(toks, live).items():
            req = self.slots[s]
            if req is None:
                continue
            if n_new is not None:
                tokens = tokens[:int(n_new[s])]
                emitted += len(tokens)
                self.metrics.observe(
                    "accepted_tokens_per_step", len(tokens),
                    buckets=SPEC_ACCEPT_BUCKETS,
                )
            req.trace.add_complete(
                "decode_chunk", t0_ns, int(dt * 1e9),
                chunk=self.chunks_run, slot=s,
            )
            req.cost_decode_steps += lane_steps
            self._accrue_page_seconds(s)
            useful += self._advance(s, tokens)
        if live and n_new is not None and self.anomaly is not None:
            self.anomaly.observe_spec_accept(
                emitted / len(live), step=self.chunks_run,
            )
        if live:
            per_tok = emitted / len(live) if n_new is not None else self.chunk
            self.metrics.observe(
                "time_per_output_token_seconds", step_dt / max(1.0, per_tok)
            )
            total = self.num_slots * lane_steps
            self.metrics.inc("decode_steps_total", total)
            self.metrics.inc("decode_steps_useful", useful)
            self.metrics.inc("decode_steps_wasted", total - useful)
        return emitted if n_new is not None else useful

    def _occupancy_gauge(self) -> None:
        live = sum(
            1 for s, r in enumerate(self.slots)
            if r is not None and not self.finished[s]
        )
        self.metrics.set_gauge("slot_occupancy", live / self.num_slots)
        u = self.metrics.get("decode_steps_useful")
        t = self.metrics.get("decode_steps_total")
        if t:
            self.metrics.set_gauge("decode_step_utilization", u / t)

    def _live(self) -> list[int]:
        return [
            s for s, r in enumerate(self.slots)
            if r is not None and r.activated
        ]

    def _ragged_step(self) -> None:
        """The fused engine step (ragged mode): ONE dispatch advances the
        in-flight admission by up to chunk * pf_width prompt tokens AND
        decodes `chunk` tokens for every resident stream. A slot whose
        prefill completes activates after the harvest and joins the next
        dispatch.

        Speculative (`speculate=k`): the dispatch is `paged_spec_step`, one
        packed verify forward of 1 + k lanes a live slot and
        `prefill_chunk` prefill lanes; a slot advances 1..k+1 tokens.

        With fuse_steps, a pure-decode step with an empty queue becomes a
        megastep of K logical steps (`_select_fuse_k`). On the card a
        pure-decode dispatch replays the engine-step graph."""
        hot_dispatch("scheduler._ragged_step")
        for s, req in enumerate(self.slots):
            if req is not None and not req.activated and req.handle.cancelled:
                self._cancel_slot(s, req, "mid-prefill")
        if any(r is not None and r.activated for r in self.slots):
            self._ensure_capacity()  # may evict: recompute below
        live = self._live()
        pf_s, pf_req = next(
            ((s, r) for s, r in enumerate(self.slots)
             if r is not None and not r.activated),
            (None, None),
        )
        if pf_req is None and not live:
            return
        fuse_k = self._select_fuse_k(live, pf_req)
        self.metrics.set_gauge("fused_k", fuse_k)
        if fuse_k > 1:
            self._fused_megastep(fuse_k)
            return
        # Fault sites: the fused dispatch is the admission's prefill work
        # and the residents' decode beat, so both sites keep their meaning.
        # They run on the host before any dispatch, graph replays included.
        if pf_req is not None:
            faults.fault_point("prefill_dispatch")
        faults.fault_point("decode_dispatch")
        numer = self._numerics_due() and bool(live)
        if pf_req is None and self._graph_route():
            self._replay_steps(live, 1, numerics=numer)
            return
        # Per-dispatch prefill budget in tokens: the spec step is one
        # forward of prefill_chunk lanes, the ragged step `chunk` forwards
        # of pf_width lanes.
        win_tokens = (
            self.prefill_chunk if self.speculate
            else self.chunk * self.pf_width
        )
        pf_kw: dict[str, Any] = {}
        pf_span = -1
        pf_rows = 0
        if pf_req is not None:
            pf_off, pf_len = pf_req.prefill_pos, pf_req.length
            pf_span = pf_req.trace.begin(
                "prefill", slot=pf_s, start=pf_off,
                tokens=min(win_tokens, pf_len - pf_off),
                cached=pf_req.spliced > 0, replay=pf_req.replay > 0,
                ragged=True,
            )
            pf_rows = min(
                self.prefill_chunk if self.speculate else self.pf_width,
                pf_len - pf_off,
            )
            pf_kw = dict(
                pf_embeds=generate_lib.pack_prefill_window(
                    pf_req.embeds, pf_off, win_tokens
                ),
                pf_slot=pf_s, pf_off=pf_off, pf_len=pf_len,
                pf_generator=pf_req.generator,
                pf_temp=pf_req.knobs[0], pf_top_p=pf_req.knobs[1],
                pf_top_k=pf_req.knobs[2],
            )
        common = dict(eos=self.cfg.generation.eos_token_id,
                      attn_impl=self.cfg.attn_impl, compute_dtype=self._dtype)
        sampled = self._profile_dispatch_begin()
        t0_ns = trace_lib.now_ns()
        if self.speculate:
            drafts, dlen, proposed = self._drafts(live)
            bt, tok, lengths, finished, _, gens, temp, top_p, top_k, _ = (
                self._device_state())
            out = self._on_ranks(generate_lib.paged_spec_step,
                self.pipe.params.llm, self.cfg.llm, self.kv_pages, bt, tok,
                lengths, finished, gens, temp, top_p, top_k, drafts, dlen,
                **pf_kw, k=self.speculate,
                pf_width=win_tokens if pf_kw else 0, **common,
            )
            self.kv_pages = out[0]
            toks, n_new, acc, pf_tok0 = self._harvest_spec(
                *out[1:7], pf_tok0=out[7])
            dt, dev_us = self._profile_dispatch_end(sampled, "spec", t0_ns)
            self._count_drafts(live, proposed, acc, n_new)
            self._finish_dispatch(
                "spec", len(live) * (1 + self.speculate) + pf_rows, live,
                toks, t0_ns, dt, n_new=n_new, device_us=dev_us,
            )
        else:
            out = self._on_ranks(generate_lib.paged_ragged_step,
                self.pipe.params.llm, self.cfg.llm, self.kv_pages,
                *self._device_state(), **pf_kw,
                chunk=self.chunk, pf_width=self.pf_width if pf_kw else 0,
                numerics=numer, **common,
            )
            self.kv_pages = out[0]
            toks, pf_tok0 = self._harvest_chunk(*out[1:6], pf_tok0=out[7])
            dt, dev_us = self._profile_dispatch_end(sampled, "ragged", t0_ns)
            self._record_numerics(out[8] if numer else None)
            # Decode billing covers only slots live DURING the dispatch.
            self._finish_dispatch(
                "ragged", len(live) + pf_rows, live, toks, t0_ns, dt,
                device_us=dev_us,
            )
        if pf_req is not None:
            pf_req.trace.end(pf_span)
            advanced = min(win_tokens, pf_len - pf_off)
            pf_req.prefill_pos = pf_off + advanced
            pf_req.cost_prefill_tokens += advanced
            self.metrics.inc("prefill_tokens_total", advanced)
            self.metrics.observe(
                "prefill_chunk_tokens", advanced,
                buckets=PREFILL_CHUNK_BUCKETS,
            )
            if pf_req.prefill_pos >= pf_len:
                self._activate(pf_s, pf_req, pf_tok0)

    # ---- speculation and the fused megastep -------------------------------

    def _select_fuse_k(self, live: list[int], pf_req) -> int:
        """K, the logical steps of the next pure-decode dispatch: 1 while
        an admission is in flight, nothing is live or the queue holds a
        request (it must not wait K steps for its slot); else the largest
        rung of the ladder within every live row's remaining budget in
        dispatch windows (a row the host finishes overruns at most one
        window, as at K = 1), aiming at the large rung for a solo resident
        and the small one for shared steps. An armed numerics probe never
        fuses. A replay applies the journaled plan instead."""
        if self.replay_fuse_plan is not None:
            return self.replay_fuse_plan.get(self.steps_run, 1)
        if not self._fuse_ladder or pf_req is not None or not live:
            return 1
        if self.numerics_every:
            return 1  # the megastep carries no probe
        with self._cond:
            if self._queue:
                return 1
        cap = (
            self._fuse_ladder[-1] if len(live) == 1
            else self._fuse_ladder[0]
        )
        for s in live:
            req = self.slots[s]
            rem = max(1, req.replay + req.max_new - len(req.emitted))
            cap = min(cap, -(-rem // self._win))
        return max([1] + [r for r in self._fuse_ladder if r <= cap])

    def _fused_megastep(self, k_steps: int) -> None:
        """ONE dispatch of K logical pure-decode steps and one harvest: the
        pages of K windows exist before it (the device cannot grow a table
        mid-flight; evicting here is decided on host state alone, so a
        replay re-derives it), then `_finish_megastep` processes the
        harvest as K logical steps."""
        hot_dispatch("scheduler._fused_megastep")
        faults.fault_point("decode_dispatch")
        self._ensure_capacity(self._win * k_steps)
        live = self._live()
        if not live:
            return
        if self._graph_route():
            self._replay_steps(live, k_steps)
            return
        common = dict(k_steps=k_steps, eos=self.cfg.generation.eos_token_id,
                      attn_impl=self.cfg.attn_impl, compute_dtype=self._dtype)
        sampled = self._profile_dispatch_begin()
        t0_ns = trace_lib.now_ns()
        bt, tok, lengths, finished, recent, gens, temp, top_p, top_k, stop = (
            self._device_state())
        if self.speculate:
            ctx, clen = (torch.from_numpy(x).to(self.device)
                         for x in self._build_draft_ctx(live))
            out = self._on_ranks(generate_lib.paged_fused_spec_steps,
                self.pipe.params.llm, self.cfg.llm, self.kv_pages, bt, tok,
                lengths, finished, gens, temp, top_p, top_k, self._draft[0],
                ctx, clen, k=self.speculate, draft_apply=self._draft[1],
                **common,
            )
            self.kv_pages = out[0]
            toks, n_new, acc, _ = self._harvest_spec(*out[1:7])
            dt, dev_us = self._profile_dispatch_end(
                sampled, "fused_spec", t0_ns)
            self._count_drafts(live, None, acc, n_new)
            self._finish_megastep("fused_spec", live, toks, k_steps, t0_ns,
                                  dt, n_new, device_us=dev_us)
        else:
            out = self._on_ranks(generate_lib.paged_fused_steps,
                self.pipe.params.llm, self.cfg.llm, self.kv_pages, bt, tok,
                lengths, finished, recent, gens, temp, top_p, top_k, stop,
                chunk=self.chunk, **common,
            )
            self.kv_pages = out[0]
            toks, _ = self._harvest_chunk(*out[1:6])
            dt, dev_us = self._profile_dispatch_end(sampled, "fused", t0_ns)
            self._finish_megastep("fused", live, toks, k_steps, t0_ns, dt,
                                  device_us=dev_us)

    def _finish_megastep(self, kind: str, live: list[int], toks,
                         k_steps: int, t0_ns: int, dt: float,
                         n_new=None, device_us: int | None = None) -> None:
        """Post-megastep accounting: one dispatch (its counters, rows and
        watchdog beat once), then the harvest as K logical steps, step j
        owning columns [j * width, (j + 1) * width) of `toks` (and column j
        of n_new), so finishes, stop strings and the per-step counters keep
        their K = 1 meaning. A row the host finishes at step j drops out of
        steps j+1..: its later columns are filler the sequential engine
        would never have run."""
        width = 1 + self.speculate if n_new is not None else self.chunk
        self.metrics.inc("dispatches_total", labels={"kind": kind})
        self.metrics.observe(
            "dispatch_rows",
            len(live) * (width if n_new is not None else 1),
            buckets=DISPATCH_ROWS_BUCKETS,
        )
        self.engine_stats["megasteps_total"][k_steps] += 1
        if self.watchdog is not None:
            self.watchdog.beat()
        rows = len(live) * (width if n_new is not None else 1)
        accepted = 0
        for j in range(k_steps):
            self.chunks_run += 1
            self.metrics.inc("chunks")
            live_j = [s for s in live if self.slots[s] is not None]
            step_accepted = self._bill_step(
                live_j, toks[:, j * width:(j + 1) * width],
                None if n_new is None else n_new[:, j],
                t0_ns, dt, dt / k_steps,
            )
            accepted += step_accepted
            # The journal's clock advances a LOGICAL step, each entry
            # stamped (fused_k, fused_j), so a replay can rebuild the plan.
            self._journal_dispatch(kind, rows, len(live_j), step_accepted,
                                   fused=(k_steps, j))
        self._occupancy_gauge()
        # One dispatch, one timeline record.
        self._timeline_record(
            dur_s=dt, kind=kind, rows=rows, accepted=accepted,
            device_us=device_us,
        )

    def _graph_route(self) -> bool:
        """Pure-decode dispatches replay engine-step graphs: on the card,
        unless the graph routes are off (graphs.routes(False): the eager
        witness, utils/debug.debug_mode(disable_jit=True)). A
        tensor-parallel pipe takes the eager route: its all-reduces run
        over gloo where ranks share a card, and a CUDA graph cannot capture
        a gloo collective (a failed capture raises by the port's rules)."""
        return (self.device.type == "cuda" and graphs.enabled()
                and self.pipe.tp is None)

    def _engine_graph(self, sampling: bool, numerics: bool = False
                      ) -> generate_lib._EngineStepGraph:
        """The engine-step graph of this scheduler's key, `sampling`
        (whether it draws) and `numerics` (the probe armed: a graph of its
        own, so an armed replay never reuses an unarmed graph or the
        reverse), captured at its first use. Keyed by everything that
        fixes its launches."""
        stop = self.stop_sequences
        key = (
            self.num_slots, self.chunk, self.speculate, self.max_pages,
            self.kv_dtype, self._dtype,
            None if stop is None else tuple(stop.shape),
            None if self._draft is None else (
                self._draft[2], tuple(self._draft[0]["embed"].shape)),
            sampling, numerics,
        )
        graph = self._graphs.get(key)
        if graph is None:
            graph = generate_lib._EngineStepGraph(
                self.pipe.params.llm, self.cfg.llm, self.kv_pages, key,
                num_slots=self.num_slots, max_pages=self.max_pages,
                chunk=self.chunk, k=self.speculate, stop=stop,
                eos=self.cfg.generation.eos_token_id,
                attn_impl=self.cfg.attn_impl, compute_dtype=self._dtype,
                sampling=sampling, draft=self._draft,
                max_steps=max(self._fuse_ladder, default=1),
                device=self.device, numerics=numerics,
                owner=self.graph_owner,
            )
            self._graphs[key] = graph
            self.engine_stats["graph_captures_total"] += 1
            self.engine_stats["graph_capture_s"] += graph.capture_s
        return graph

    def _replay_steps(self, live: list[int], k_steps: int,
                      numerics: bool = False) -> None:
        """A pure-decode dispatch of k_steps logical steps on the graph
        route: the host state copied into the graph, k_steps replays, one
        harvest; `numerics` (k_steps = 1) replays the armed graph."""
        graph = self._engine_graph(any(g is not None for g in self.gens),
                                   numerics)
        # The graph exists (captured above) before any capture begins; the
        # profiler sees its replayed kernels as ordinary kernel records.
        kind = ("spec" if k_steps == 1 else "fused_spec") if self.speculate \
            else ("ragged" if k_steps == 1 else "fused")
        sampled = self._profile_dispatch_begin()
        t0_ns = trace_lib.now_ns()
        host = dict(
            bt=self.bt, tok=self.tok, lengths=self.lengths,
            finished=self.finished, recent=self.recent, temp=self.temp,
            top_p=self.top_p, top_k=self.top_k,
            draws=np.asarray([g is not None for g in self.gens]),
        )
        proposed = None
        if self.speculate and self._draft is None:
            host["drafts"], host["dlen"] = self._propose_drafts(live)
            proposed = int(host["dlen"][live].sum())
        elif self.speculate:
            host["ctx"], host["clen"] = self._build_draft_ctx(live)
        out = graph.run(host, self.gens, k_steps)
        if self.speculate:
            toks, n_new, acc, _ = self._harvest_spec(
                out["tok"], out["lengths"], out["finished"], out["toks"],
                out["n_new"], out["acc"])
            dt, dev_us = self._profile_dispatch_end(sampled, kind, t0_ns)
            self._count_drafts(live, proposed, acc, n_new)
            if k_steps == 1:
                self._finish_dispatch(
                    "spec", len(live) * (1 + self.speculate), live, toks,
                    t0_ns, dt, n_new[:, 0], device_us=dev_us,
                )
            else:
                self._finish_megastep("fused_spec", live, toks, k_steps,
                                      t0_ns, dt, n_new, device_us=dev_us)
            return
        toks, _ = self._harvest_chunk(
            out["tok"], out["lengths"], out["finished"], out["recent"],
            out["toks"])
        dt, dev_us = self._profile_dispatch_end(sampled, kind, t0_ns)
        self._record_numerics(out.get("nstats"))
        if k_steps == 1:
            self._finish_dispatch("ragged", len(live), live, toks, t0_ns, dt,
                                  device_us=dev_us)
        else:
            self._finish_megastep("fused", live, toks, k_steps, t0_ns, dt,
                                  device_us=dev_us)

    def _drafts(self, live: list[int]):
        """(drafts [S, k], draft_len [S]) on the device for one
        speculative dispatch, and the proposals to count (None: the
        device chain's, `_count_drafts` counts them): the device chain
        over the confirmed context for a drafter with the device contract,
        else the host drafter's proposals."""
        dev = self.device
        if self._draft is None:
            drafts, dlen = self._propose_drafts(live)
            return (torch.from_numpy(drafts).to(dev),
                    torch.from_numpy(dlen).to(dev), int(dlen[live].sum()))
        ctx, clen = self._build_draft_ctx(live)
        drafts, dlen = self._draft[1](
            self._draft[0], torch.from_numpy(ctx).to(dev),
            torch.from_numpy(clen).to(dev),
            torch.from_numpy(self.tok).to(dev), self.speculate,
        )
        return drafts, dlen, None

    def _count_drafts(self, live: list[int], proposed, acc,
                      n_new=None) -> None:
        """Draft counters of a dispatch: `proposed` drafts (None: the
        device chain's k for every live row still decoding at each logical
        step, n_new > 0), and the accepted ones of `acc`."""
        if live:
            if proposed is None:
                proposed = self.speculate * int((n_new[live] > 0).sum())
            self.metrics.inc("draft_proposed_total", proposed)
            self.metrics.inc("draft_accepted_total", int(acc[live].sum()))

    def _confirmed_tail(self, s: int, keep: int) -> np.ndarray:
        """The last `keep` tokens of slot s's device-confirmed stream:
        prompt ids (none for a multimodal prompt) + the reply tokens the
        device has fed back. Never the host's whole `emitted`, which runs
        ahead of the device during an eviction replay."""
        req = self.slots[s]
        confirmed = max(0, int(self.lengths[s]) - req.length)
        prompt = (
            req.cache_tokens if req.cache_tokens is not None
            else np.zeros((0,), np.int64)
        )
        reply = np.asarray(req.emitted[:confirmed], np.int64)
        if keep <= 0:
            return np.zeros((0,), np.int64)
        reply = reply[max(0, len(reply) - keep):]
        prompt = np.asarray(prompt, np.int64)
        rest = keep - len(reply)
        prompt = prompt[max(0, len(prompt) - rest):] if rest else prompt[:0]
        return np.concatenate([prompt, reply])

    def _build_draft_ctx(self, live: list[int]):
        """Right-aligned confirmed-stream windows for the device chain:
        `_propose_drafts`' context without the fed token (the chain shifts
        it in). Returns (ctx [S, window] int32, ctx_len [S] int32)."""
        CW = self.drafter.window
        ctx = np.zeros((self.num_slots, CW), np.int32)
        clen = np.zeros((self.num_slots,), np.int32)
        for s in live:
            tail = self._confirmed_tail(s, CW).astype(np.int32)
            if len(tail):
                ctx[s, CW - len(tail):] = tail
            clen[s] = len(tail)
        return ctx, clen

    def _propose_drafts(self, live: list[int]):
        """Host-side proposals for every live slot from its confirmed
        stream plus the pending fed token (only the drafter's `window`
        tail is built). Returns (drafts [S, k] int32, draft_len [S] int32);
        unproposed lanes ride the dispatch masked."""
        k = self.speculate
        win = getattr(self.drafter, "window", None)
        drafts = np.zeros((self.num_slots, k), np.int32)
        dlen = np.zeros((self.num_slots,), np.int32)
        for s in live:
            req = self.slots[s]
            keep = (win - 1 if win is not None else
                    len(req.emitted) + (0 if req.cache_tokens is None
                                        else len(req.cache_tokens)))
            ctx = np.concatenate([
                self._confirmed_tail(s, keep),
                np.asarray([int(self.tok[s])], np.int64),
            ])
            prop = self.drafter.propose(ctx, k)[:k]
            drafts[s, :len(prop)] = prop
            dlen[s] = len(prop)
        return drafts, dlen

    def _harvest_spec(self, tok, lengths, finished, toks, n_new, acc,
                      pf_tok0=None):
        """The speculative twin of `_harvest_chunk`, one copy to the host
        (stop strings are found on the host in this mode, so no stop
        window). Returns (toks, n_new, acc, pf_tok0 as an int or None)."""
        host = self._fetch(tok, lengths, finished, toks, n_new, acc, pf_tok0)
        self.tok = host[0].astype(np.int32)
        self.lengths = host[1].astype(np.int32)
        self.finished = host[2].astype(bool)
        return (*host[3:6], None if pf_tok0 is None else int(host[6]))

    # ---- harvest / text emission -----------------------------------------

    def _advance(self, s: int, tokens: list[int]) -> int:
        """Feed slot s's newly decoded tokens through the host text
        machine; returns the USEFUL steps consumed (replayed steps are
        eviction overhead). Token checks (EOS, max_new) run per token, the
        tokenizer decode and stop trim once per chunk."""
        req = self.slots[s]
        eos = self.cfg.generation.eos_token_id
        tokenizer = self.pipe.tokenizer
        useful = 0
        if req.handle.cancelled:
            self._cancel_slot(s, req, "mid-decode")
            return useful
        chunk_start = len(req.emitted)
        finish = None  # (reason, completion_count)
        for t in tokens:
            if req.replay > 0:
                req.replay -= 1
                continue
            req.processed += 1
            useful += 1
            if t == eos:
                finish = ("stop", len(req.emitted) + 1)
                break
            req.emitted.append(t)
            if len(req.emitted) >= req.max_new:
                finish = ("length", len(req.emitted))
                break
        if len(req.emitted) == chunk_start and finish is None:
            return useful  # pure replay skip: nothing new to decode
        t_emit = trace_lib.now_ns()
        text = tokenizer.decode(req.emitted, skip_special_tokens=True)
        text, hit = pipeline_lib.stop_cut(text, req.stops)
        if hit:
            # The stop completed in THIS chunk; it precedes any EOS/length
            # finish seen later in the same chunk.
            n = pipeline_lib.stop_token_count(
                tokenizer, req.emitted, req.stops, chunk_start
            )
            if finish is None or n <= finish[1]:
                finish = ("stop", n)
        if finish is not None:
            # Tokens past the one completing the finish did nothing for
            # the client.
            useful = min(useful, finish[1] - chunk_start)
        # Ledger: the client-visible completion progress of this step.
        req.cost_decode_tokens += useful
        if finish is not None:
            self._emit_text(req, text.strip())
            req.trace.add_complete(
                "emission", t_emit, chars=len(req.text_done)
            )
            self._finish(s, finish[0], completion=finish[1])
        else:
            self._emit_text(
                req, pipeline_lib.stable_text_prefix(text, req.stops)
            )
            req.trace.add_complete(
                "emission", t_emit, chars=len(req.text_done)
            )
        return useful

    def _emit_text(self, req: _Request, safe: str) -> None:
        if len(safe) > len(req.text_done):
            if req.handle.streaming:
                req.handle.events.put(("delta", safe[len(req.text_done):]))
            req.text_done = safe

    def _finish(self, s: int, reason: str, completion: int) -> None:
        req = self.slots[s]
        cost = self._finalize_cost(s, req)
        # Donate prompt + reply before the slot's references go, capped at
        # the device-confirmed KV length: a token the host emitted but the
        # device never fed back (tok0 of a max_tokens=1 request) has no KV.
        self._donate_prefix(
            s, req, min(req.length + len(req.emitted), int(self.lengths[s]))
        )
        self._clear_slot(s)
        h = req.handle
        h.debug["cached_tokens"] = req.cost_cached_tokens
        h.reply = req.text_done
        h.finish_reason = reason
        h.usage = (req.length, completion)
        h.debug["finish_chunk"] = self.chunks_run
        h.debug["e2e_s"] = time.monotonic() - req.submit_time
        # The trace and the wide event close before the client is woken,
        # so /debug shows a request as finished once its reply is out.
        req.trace.finish(
            finish_reason=reason, prompt_tokens=req.length,
            completion_tokens=completion, cost=cost,
        )
        self._emit_request_event(req, status="ok")
        h.events.put(("end", reason, h.usage))
        h.done.set()
        # Every Nth finished request queues an audit job (host copies; the
        # replay runs later, at an idle point of this thread).
        self.auditor.observe_finished(req)
        _LOG.info("request %s finished (%s, %d tokens)", req.trace.id,
                  reason, completion)
        self.metrics.inc("completed")

    def _finish_error(
        self, s: int, msg: str, *, kind: str = "server_error"
    ) -> None:
        req = self.slots[s]
        cost = self._finalize_cost(s, req)
        self._clear_slot(s)
        self._fail_handle(req, msg, kind, cost)
        _LOG.info("request %s errored: %s", req.trace.id, msg)
