"""Metrics: the JSONL stream of a training run and the serving registry
(port of `oryx_tpu.utils.metrics`).

Two layers:

  * `MetricLogger` - the trainer's structured JSONL writer plus a stdout
    line every `log_every` steps, and TensorBoard scalars where asked
    for; `rank0_print`, a flushed print (the port runs as one process).
  * A dependency-free metrics registry (`Registry`) in the Prometheus
    data model: Counter / Gauge / Histogram families with labels, one
    text-exposition renderer (byte-identical to the JAX package's for the
    same calls), collectors run at scrape time (process, device memory),
    and `TelemetryServer`, serving `/metrics`, `/healthz` and `/readyz`
    over stdlib HTTP. `ServingMetrics` is the serving engines' client.

Family names, kinds, label names and bucket ladders are the JAX package's:
dashboards, scripts/loadgen.py and scripts/check_serving_endpoints.py read
them by name. The device-memory gauges read the CUDA caching allocator.
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import threading
import time
from typing import Any

from oryx_tpu_torch.analysis.sanitizers import named_lock


def rank0_print(*args, **kwargs) -> None:
    """print, flushed: the port trains in one process, which is process 0."""
    print(*args, **kwargs)
    sys.stdout.flush()


class MetricLogger:
    """Every `log_every` steps: one JSON record (the step's metrics,
    steps/s and tokens/s/chip over the window; the port trains on one
    device) appended to `path` and a line on stdout. Non-finite values are
    written as null.

    tensorboard_dir: every record's values also land as TensorBoard scalars
    `train/{key}` (torch.utils.tensorboard's SummaryWriter). Without it
    installed a line says so and training goes on without them."""

    def __init__(self, path: str | None = None, *,
                 log_every: int = 10,
                 tensorboard_dir: str | None = None) -> None:
        self.path = path
        self.log_every = log_every
        self._f = None
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            # fault-boundary: TensorBoard is optional; its absence only
            # disables its scalars, never training
            except Exception as e:
                rank0_print(f"tensorboard disabled: {e!r}")
        self._last_time = time.perf_counter()
        self._last_step = 0
        self._tokens_since = 0
        self._skipped_since = 0

    def log_step(self, step: int, metrics: dict[str, Any]) -> None:
        self._tokens_since += int(metrics.get("num_tokens", 0))
        # Accumulated, not sampled: a skip on a step that is not logged
        # still shows in the next record.
        self._skipped_since += int(metrics.get("skipped", 0))
        if step % self.log_every != 0:
            return
        now = time.perf_counter()
        dt = max(now - self._last_time, 1e-9)
        nsteps = max(step - self._last_step, 1)

        def js(v):
            f = float(v)
            return f if math.isfinite(f) else None

        rec = {
            "step": step,
            **{
                k: js(v) for k, v in metrics.items()
                if k not in ("num_tokens", "skipped")
            },
            "steps_per_sec": nsteps / dt,
            "tokens_per_sec_per_chip": self._tokens_since / dt,
        }
        if "skipped" in metrics:
            rec["skipped"] = self._skipped_since
        self._last_time, self._last_step = now, step
        self._tokens_since = 0
        self._skipped_since = 0
        rank0_print(
            f"step {step}: " + " ".join(
                f"{k}={'nan' if v is None else format(v, '.4g')}"
                for k, v in rec.items() if k != "step"
            )
        )
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self._tb:
            for k, v in rec.items():
                if k != "step" and v is not None:
                    self._tb.add_scalar(f"train/{k}", v, step)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        if self._tb:
            self._tb.close()
            self._tb = None


# ---------------------------------------------------------------------------
# Metrics registry (Prometheus data model, dependency-free)
# ---------------------------------------------------------------------------


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(labelnames: tuple[str, ...],
               labelvalues: tuple[str, ...]) -> str:
    if not labelnames:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"'
        for k, v in zip(labelnames, labelvalues)
    )
    return "{" + inner + "}"


class Counter:
    """Monotone counter (one label combination of a family)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n


class Gauge:
    """Settable gauge (one label combination of a family)."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock):
        self.value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n


class Histogram:
    """Fixed-bucket histogram in the Prometheus cumulative-`le` shape.

    Buckets are upper bounds; +Inf is implicit (the total count)."""

    __slots__ = ("buckets", "counts", "total", "sum", "_lock")

    def __init__(self, buckets: tuple[float, ...], lock=None):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.total = 0
        self.sum = 0.0
        self._lock = lock or named_lock("metrics.family")

    def observe(self, value: float) -> None:
        with self._lock:
            self.total += 1
            self.sum += float(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1

    def render(self, name: str, out: list[str], labels: str = "") -> None:
        # Bucket lines carry the family labels plus le; counts are already
        # cumulative (observe touches every bucket whose bound covers the
        # value).
        with self._lock:
            counts, total, s = list(self.counts), self.total, self.sum
        pre = labels[:-1] + "," if labels else "{"
        for b, c in zip(self.buckets, counts):
            out.append(f'{name}_bucket{pre}le="{b:g}"}} {c}')
        out.append(f'{name}_bucket{pre}le="+Inf"}} {total}')
        out.append(f"{name}_sum{labels} {s:.17g}")
        out.append(f"{name}_count{labels} {total}")


class MetricFamily:
    """One named metric family: a fixed type + label names, holding one
    child (Counter/Gauge/Histogram) per label-values combination. A family
    declared with no label names IS its single child: inc/set/observe
    proxy to it, so unlabeled metrics need no `.labels()` hop."""

    def __init__(self, name: str, mtype: str,
                 labelnames: tuple[str, ...] = (),
                 buckets: tuple[float, ...] | None = None,
                 lock=None):
        self.name = name
        self.mtype = mtype
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(sorted(buckets)) if buckets else None
        self._lock = lock or named_lock("metrics.family")
        self._children: dict[tuple[str, ...], Any] = {}  # guarded-by: _lock
        if not self.labelnames:
            with self._lock:
                self._children[()] = self._make_child()

    def _make_child(self):
        if self.mtype == "counter":
            return Counter(self._lock)
        if self.mtype == "gauge":
            return Gauge(self._lock)
        return Histogram(self.buckets or PER_TOKEN_BUCKETS, self._lock)

    def labels(self, **kv: str):
        """Child for one label-values combination (created on first
        touch). Label names must match the family declaration exactly."""
        if tuple(sorted(kv)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name}: got labels {sorted(kv)}, family declares "
                f"{sorted(self.labelnames)}"
            )
        key = tuple(str(kv[k]) for k in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def children(self) -> dict[tuple[str, ...], Any]:
        """A copy of the label-values -> child map."""
        with self._lock:
            return dict(self._children)

    def _only(self):
        with self._lock:
            return self._children[()]

    # Unlabeled-family conveniences.
    def inc(self, n: float = 1) -> None:
        self._only().inc(n)

    def set(self, value: float) -> None:
        self._only().set(value)

    def observe(self, value: float) -> None:
        self._only().observe(value)

    @property
    def value(self) -> float:
        return self._only().value

    def render(self, out: list[str]) -> None:
        with self._lock:
            children = sorted(self._children.items())
        out.append(f"# TYPE {self.name} {self.mtype}")
        for key, child in children:
            labels = _label_str(self.labelnames, key)
            if self.mtype == "histogram":
                child.render(self.name, out, labels)
            else:
                # Full precision (%g rounds to 6 significant digits, which
                # quantizes large counters and hides increments).
                out.append(f"{self.name}{labels} {child.value:.17g}")


class Registry:
    """Named metric families + text exposition + collectors.

    `prefix` is prepended (with `_`) to every family name unless the
    family is created with `raw_name=True`, for families shared verbatim
    across registries (e.g. `oryx_anomaly_total`). One family per name,
    enforced: re-declaring with a different type/labels/buckets raises,
    so one exposition never carries duplicate families.

    Collectors are zero-arg callables run at the top of `render()`: they
    refresh gauges whose truth lives elsewhere (process RSS, device
    memory), so scrapes see current values without a sampler thread."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._lock = named_lock("registry._lock")
        self._families: dict[str, MetricFamily] = {}  # guarded-by: _lock
        self._info_names: set[str] = set()  # guarded-by: _lock
        self._collectors: list[Any] = []  # guarded-by: _lock

    def full_name(self, name: str, raw_name: bool = False) -> str:
        return name if (raw_name or not self.prefix) \
            else f"{self.prefix}_{name}"

    def declare(self, name: str, mtype: str,
                labelnames: tuple[str, ...] = (),
                buckets: tuple[float, ...] | None = None,
                raw_name: bool = False) -> MetricFamily:
        """The family `name` of kind `mtype`, created on first use; the
        typed methods below are its spellings for literal names."""
        full = self.full_name(name, raw_name)
        with self._lock:
            fam = self._families.get(full)
            if fam is None:
                fam = self._families[full] = MetricFamily(
                    full, mtype, labelnames, buckets
                )
                return fam
        want = (mtype, tuple(labelnames),
                tuple(sorted(buckets)) if buckets else fam.buckets)
        have = (fam.mtype, fam.labelnames, fam.buckets)
        if want != have:
            raise ValueError(
                f"metric family {full!r} re-declared as {want}, "
                f"already registered as {have}"
            )
        return fam

    def counter(self, name: str, labelnames: tuple[str, ...] = (),
                *, raw_name: bool = False) -> MetricFamily:
        return self.declare(name, "counter", labelnames, raw_name=raw_name)

    def gauge(self, name: str, labelnames: tuple[str, ...] = (),
              *, raw_name: bool = False) -> MetricFamily:
        return self.declare(name, "gauge", labelnames, raw_name=raw_name)

    def histogram(self, name: str,
                  buckets: tuple[float, ...],
                  labelnames: tuple[str, ...] = (),
                  *, raw_name: bool = False) -> MetricFamily:
        return self.declare(name, "histogram", labelnames, buckets,
                            raw_name=raw_name)

    def info(self, name: str, labels: dict[str, str],
             *, raw_name: bool = False) -> None:
        """Info metric: a gauge pinned to 1 whose labels carry build /
        deploy identity (git revision, engine, model)."""
        self.declare_info(name, labels, raw_name=raw_name)

    def declare_info(self, name: str, labels: dict[str, str],
                     *, raw_name: bool = False) -> None:
        """`info` for any name. Re-setting an INFO family replaces its
        labels; replacing a non-info family of the same name raises."""
        full = self.full_name(name, raw_name)
        with self._lock:
            if full in self._families and full not in self._info_names:
                raise ValueError(
                    f"metric family {full!r} already registered as a "
                    f"{self._families[full].mtype}; info() would "
                    "silently replace it"
                )
            self._info_names.add(full)
            self._families[full] = fam = MetricFamily(
                full, "gauge",
                tuple(sorted(str(k) for k in labels)),
            )
        fam.labels(**{str(k): str(v) for k, v in labels.items()}).set(1)

    def register_collector(self, fn) -> None:
        with self._lock:
            self._collectors.append(fn)

    def existing(self, name: str,
                 *, raw_name: bool = False) -> MetricFamily | None:
        with self._lock:
            return self._families.get(self.full_name(name, raw_name))

    def get(self, name: str, *, raw_name: bool = False) -> float:
        """Current value of an unlabeled counter/gauge, 0 when never
        registered, or when the name is labeled or a histogram."""
        with self._lock:
            fam = self._families.get(self.full_name(name, raw_name))
        if fam is None or fam.labelnames or fam.mtype == "histogram":
            return 0.0
        return fam.value

    def render(self) -> str:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            # fault-boundary: a broken collector must never break the
            # scrape
            except Exception:
                pass
        with self._lock:
            families = sorted(self._families.items())
        out: list[str] = []
        for _, fam in families:
            fam.render(out)
        return "\n".join(out) + "\n"


# Default latency bucket ladders (seconds): TTFT spans prefill and graph
# captures; per-token latency spans a decode step.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                30.0, 60.0)
PER_TOKEN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5)
# Prefill chunk sizes (tokens per admission dispatch).
PREFILL_CHUNK_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                         256.0, 512.0, 1024.0, 2048.0, 4096.0)
# Valid query rows per device dispatch (the packed ragged buffer's
# occupancy, or a split prefill/decode dispatch's live rows).
DISPATCH_ROWS_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                         256.0, 512.0, 1024.0, 2048.0, 4096.0)
# Tokens a slot advanced per speculative engine step (1 fed token + the
# accepted drafts).
SPEC_ACCEPT_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0,
                       32.0)
# Per-request cost-ledger ladders (the `oryx_serving_request_*` families
# the scheduler observes when a request reaches a terminal state): token
# counts in powers of two; page-seconds (pages held x wall time) from a
# sub-chunk hold to minutes of residency.
REQUEST_TOKEN_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                         256.0, 512.0, 1024.0, 2048.0, 4096.0, 8192.0)
REQUEST_SECONDS_BUCKETS = TTFT_BUCKETS + (120.0, 300.0)
# Lock wait/hold times of the lock-order sanitizer's
# oryx_lock_{wait,hold}_seconds{lock=} histograms: microseconds up to the
# one second that would mean a lock is held across device work.
LOCK_SECONDS_BUCKETS = (1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3,
                        5e-3, 0.025, 0.1, 0.5, 1.0)
PAGE_SECONDS_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                        5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)
# One page's whole tenancy (alloc -> refcount-0 free) and its idle tail,
# fed at free time by the allocator's observer hook (utils/pagemap.py):
# the oryx_page_{lifetime,idle}_seconds ladders.
PAGE_LIFETIME_BUCKETS = (0.001, 0.005, 0.025, 0.1, 0.25, 0.5, 1.0,
                         2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
                         600.0)
# Logit-drift ladders of the output auditor (serve/audit.py): max abs
# diff from exact parity (the fp path's 0) through bf16 noise to "a
# different model", and the same story for the KL.
AUDIT_DIFF_BUCKETS = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 5e-3, 0.025, 0.1,
                      0.5, 1.0, 4.0, 16.0)
AUDIT_KL_BUCKETS = (0.0, 1e-8, 1e-6, 1e-5, 1e-4, 1e-3, 0.01, 0.1, 0.5,
                    1.0, 4.0)

# The per-request cost-ledger keys: what the scheduler writes into
# handle.debug["cost"] and the trace meta at every terminal state, what
# the final SSE chunk carries under "oryx", and what /debug/requests
# shows for every finished request.
REQUEST_COST_KEYS = (
    "prefill_tokens", "cached_tokens", "decode_steps", "decode_tokens",
    "page_seconds", "queue_s", "prefill_s", "decode_s", "e2e_s",
    # The most pages the request held at once, and the page-seconds it
    # had accumulated when it reached that peak.
    "peak_pages", "peak_page_seconds",
)

# The wide-event schema: every field a terminal request's JSONL event
# (utils/request_log.py, /debug/requests?format=jsonl) may carry, a
# superset of REQUEST_COST_KEYS. `build_request_event` rejects any other
# key. `journal_seq` stays null until the decision journal is ported.
REQUEST_EVENT_KEYS = REQUEST_COST_KEYS + (
    "schema",                    # event-schema version (int)
    "ts_unix_s",                 # wall-clock time the request ended
    "request_id",                # == X-Request-Id / the trace id
    "engine",                    # continuous | ...
    "replica",                   # --replica-id, null standalone
    "routed",                    # request arrived via a router
    "status",                    # ok | error | cancelled | rejected
    "error_kind",                # handle.error_kind, null on ok
    "finish_reason",             # stop | length, null unless ok
    "prompt_tokens",
    "completion_tokens",
    "streaming",
    "evictions",                 # replay re-admissions this request paid
    "accepted_tokens_per_step",  # speculation yield, null off spec
    "journal_seq",               # decision-journal join key
)

# The output-audit wide-event schema (kind="audit"): one flat line per
# completed audit through the request-log sink; `audit_index` joins it to
# the full record at /debug/audit.
AUDIT_EVENT_KEYS = (
    "schema", "ts_unix_s",
    "kind",                   # always "audit"
    "request_id",             # the audited request (joins its trace)
    "engine", "replica",
    "verdict",                # pass | drift | fail
    "first_divergence",       # token index of the first mismatch, -1
    "replayed_tokens",        # tokens the replay regenerated
    "positions_checked",      # logit positions compared
    "logit_max_abs_diff",     # max over the checked positions
    "kl",                     # max KL over the checked positions
    "evictions",              # replays the live request paid
    "audit_index",            # index of the full record in /debug/audit
)

# The memory-pressure wide-event schema (kind="oom_pressure"): one flat
# line per captured incident; `forensic_index` joins it to the full
# record at /debug/oom (utils/forensics.py).
OOM_EVENT_KEYS = (
    "schema", "ts_unix_s",
    "kind",                  # always "oom_pressure"
    "trigger",               # oom (an allocation raised) |
                             # pool_pressure (free-list shortfall
                             # episode, defer/evict path) |
                             # degraded_escalation (SLO ladder moved)
    "detail",                # the OutOfPagesError text / ladder step
    "engine", "replica",
    "degraded_mode",
    "queue_depth", "live_slots",
    "free_pages", "slot_pages", "cache_pages", "shared_pages",
    "fragmentation_ratio",
    "top_request_id",        # largest resident by pages held
    "top_request_pages",
    "forensic_index",        # index of the full record in /debug/oom
)

# The decision-journal entry schema (serve/journal.py): every field a
# journal entry may carry, across all entry kinds (`kind` dispatches —
# submit / reject / admit / splice / evict / step / degraded / fault /
# restart / finish). One flat registry, like REQUEST_EVENT_KEYS, so
# build_journal_event validates at the write site; the replay
# (serve/replay.py) depends on these names never drifting from what the
# journal wrote.
JOURNAL_EVENT_KEYS = (
    "schema", "ts_unix_s",
    "kind",                 # the entry's decision kind (see above)
    "seq",                  # monotone per-journal entry index
    "step",                 # engine dispatches completed when recorded
    "request_id",
    # -- submit / reject -------------------------------------------------
    "arrival_seq",          # monotone per-journal submit index
    "prompt",               # text-only request payload (question,
                            # history) — replayable
    "prompt_sha256",        # fingerprint when the payload has media
                            # (sidecar needed; not replayable)
    "prompt_len",           # prompt tokens (stamped at admit)
    "sampling",             # the request's sampling dict, post-clamp
    "max_new",              # effective cap (degraded clamp applied)
    "streaming",
    "reason",               # reject: admission-control reason
    # -- admit / splice / evict ------------------------------------------
    "slot",
    "admit_seq",            # eviction-age order stamp
    "replay_tokens",        # tokens skipped on re-admission / eviction
    "spliced_tokens",       # prefix-cache splice length
    "shared_pages",         # pages shared from the cache
    "cow_pages",            # copy-on-write tail copies
    "host_reload_pages",    # host-tier pages re-uploaded for the splice
    "victim_request_id",    # evict: whose pages were taken
    # -- step -------------------------------------------------------------
    "dispatch",             # prefill | decode | ragged | spec | fused
                            # | fused_spec
    "rows",
    "live_slots",
    "accepted_tokens",
    "free_pages",
    "fused_k",              # megastep: logical steps in this dispatch
    "fused_j",              # megastep: this entry's index within it
                            # (0..fused_k-1; absent on K=1 dispatches)
    # -- degraded / fault / restart ---------------------------------------
    "mode",                 # degraded-mode ladder level
    "site",                 # fault-point site name
    "fires",                # cumulative firings at that site
    "restarts",             # supervisor restart count
    "requeued",             # in-flight requests requeued by the restart
    # -- finish -----------------------------------------------------------
    "status",               # ok | error | cancelled
    "finish_reason",
    "error_kind",
    "completion_tokens",
    "reply_sha256",         # reply TEXT bytes fingerprint
    "tokens_sha256",        # emitted token-id stream fingerprint
    "cost",                 # the deterministic cost-ledger subset
)



# ---------------------------------------------------------------------------
# Quantile helpers (one implementation of the bucket math)
# ---------------------------------------------------------------------------


def histogram_quantile(q: float, buckets: tuple[float, ...] | list[float],
                       counts: list[int],
                       total: int | None = None) -> float:
    """Quantile from a cumulative-`le` histogram (Prometheus shape).

    `buckets` are the finite upper bounds in ascending order; `counts` the
    CUMULATIVE observation count at each bound; `total` the +Inf count
    (defaults to the last cumulative count). Linear interpolation inside
    the covering bucket, the first bucket's lower edge at 0; ranks past
    the last finite bound clamp to that bound. NaN for an empty
    histogram."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    n = total if total is not None else (counts[-1] if counts else 0)
    if n <= 0 or not buckets:
        return float("nan")
    rank = q * n
    prev_bound, prev_count = 0.0, 0
    for b, c in zip(buckets, counts):
        if c >= rank and c > prev_count:
            frac = (rank - prev_count) / (c - prev_count)
            return prev_bound + (float(b) - prev_bound) * frac
        prev_bound, prev_count = float(b), c
    return float(buckets[-1])


def parse_prom_histogram(
    text: str, family: str
) -> tuple[list[float], list[int], int, float] | None:
    """One UNLABELED histogram family from a Prometheus text exposition:
    (finite bounds, cumulative counts, total count, sum), or None when the
    family has no bucket lines."""
    bounds: list[float] = []
    counts: list[int] = []
    total = 0
    for m in re.finditer(
        rf'^{re.escape(family)}_bucket\{{le="([^"]+)"\}} (\d+)$',
        text, re.M,
    ):
        le, c = m.group(1), int(m.group(2))
        if le == "+Inf":
            total = c
        else:
            bounds.append(float(le))
            counts.append(c)
    if not bounds and total == 0:
        return None
    s = 0.0
    if sm := re.search(
        rf"^{re.escape(family)}_sum ([0-9.eE+-]+)$", text, re.M
    ):
        s = float(sm.group(1))
    return bounds, counts, total, s


def inject_exposition_label(text: str, label: str, value: str) -> str:
    """Stamp `label="value"` onto every SAMPLE line of a Prometheus text
    exposition (comment/TYPE lines pass through); a series that already
    carries the label is left alone."""
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?( .+)$")
    esc = _escape_label(str(value))
    out = []
    for line in text.splitlines():
        m = sample.match(line) if line and line[0] != "#" else None
        if m is None:
            out.append(line)
            continue
        name, labels, rest = m.groups()
        if labels:
            if f'{label}="' in labels:
                out.append(line)
                continue
            labels = labels[:-1] + f',{label}="{esc}"}}'
        else:
            labels = f'{{{label}="{esc}"}}'
        out.append(name + labels + rest)
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def sample_quantile(values: list[float], q: float) -> float:
    """Exact quantile of raw samples: linear interpolation between order
    statistics. NaN on an empty list."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    if not values:
        return float("nan")
    vs = sorted(values)
    if len(vs) == 1:
        return float(vs[0])
    pos = q * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return float(vs[lo] + (vs[hi] - vs[lo]) * (pos - lo))


# ---------------------------------------------------------------------------
# Collectors (process / device memory)
# ---------------------------------------------------------------------------


def register_process_collector(reg: Registry) -> None:
    """Process gauges in the standard Prometheus shapes (CPU seconds, RSS,
    open fds, thread count), refreshed at scrape time, under the
    registry's prefix."""
    start = time.time()
    cpu = reg.gauge("process_cpu_seconds_total")
    rss = reg.gauge("process_resident_memory_bytes")
    fds = reg.gauge("process_open_fds")
    thr = reg.gauge("process_threads")
    reg.gauge("process_start_time_seconds").set(start)

    def collect() -> None:
        t = os.times()
        cpu.set(t.user + t.system)
        try:
            with open("/proc/self/statm") as f:
                rss.set(int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE"))
        except (OSError, ValueError):
            pass  # non-Linux: RSS stays at its last (or zero) value
        try:
            fds.set(len(os.listdir("/proc/self/fd")))
        except OSError:
            pass
        thr.set(threading.active_count())

    reg.register_collector(collect)


def register_device_memory_collector(reg: Registry,
                                     ttl_s: float = 1.0) -> None:
    """Card memory at scrape time, from the CUDA caching allocator:

      hbm_live_bytes   - bytes in live tensors
                         (`torch.cuda.memory_allocated()`).
      hbm_bytes_in_use - bytes the allocator holds from the card
                         (`memory_stats()["reserved_bytes.all.current"]`).
      hbm_peak_bytes   - the peak of that
                         (`memory_stats()["reserved_bytes.all.peak"]`).
      hbm_limit_bytes  - the card's total memory (`mem_get_info()`).

    Without a card (or before CUDA is initialized) all four read 0.
    Refreshes at most once per `ttl_s` (0 disables the cache)."""
    live = reg.gauge("hbm_live_bytes")
    in_use = reg.gauge("hbm_bytes_in_use")
    peak = reg.gauge("hbm_peak_bytes")
    limit = reg.gauge("hbm_limit_bytes")
    last = [float("-inf")]

    def collect() -> None:
        import torch

        now = time.monotonic()
        if ttl_s and now - last[0] < ttl_s:
            return
        last[0] = now
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            for g in (live, in_use, peak, limit):
                g.set(0)
            return
        stats = torch.cuda.memory_stats()
        live.set(torch.cuda.memory_allocated())
        in_use.set(stats.get("reserved_bytes.all.current", 0))
        peak.set(stats.get("reserved_bytes.all.peak", 0))
        limit.set(torch.cuda.mem_get_info()[1])

    reg.register_collector(collect)


# ---------------------------------------------------------------------------
# Serving metrics (api_server GET /metrics)
# ---------------------------------------------------------------------------


class ServingMetrics:
    """Thread-safe counters / gauges / histograms for the serving path: a
    name-on-first-touch client of `Registry`, so the scheduler and the
    window batcher never pre-register, while `GET /metrics` renders the
    shared exposition (device-memory gauges included)."""

    def __init__(self, prefix: str = "oryx_serving",
                 registry: Registry | None = None):
        self.prefix = prefix
        self.registry = registry or Registry(prefix=prefix)
        # Pre-created so the latency ladders render (at zero) from the
        # first scrape.
        self.registry.histogram("ttft_seconds", TTFT_BUCKETS)
        self.registry.histogram(
            "time_per_output_token_seconds", PER_TOKEN_BUCKETS
        )
        register_device_memory_collector(self.registry)

    def inc(self, name: str, n: float = 1,
            labels: dict[str, str] | None = None) -> None:
        if labels:
            self.registry.declare(
                name, "counter", tuple(sorted(labels))
            ).labels(**labels).inc(n)
        else:
            self.registry.declare(name, "counter").inc(n)

    def set_gauge(self, name: str, value: float) -> None:
        self.registry.declare(name, "gauge").set(value)

    def set_info(self, name: str, labels: dict[str, str]) -> None:
        """Info metric: a gauge pinned to 1 whose labels carry build /
        deploy identity (git revision, engine, model)."""
        self.registry.declare_info(name, labels)

    def observe(self, name: str, value: float,
                buckets: tuple[float, ...] = PER_TOKEN_BUCKETS) -> None:
        # `buckets` is creation-only (first touch wins).
        fam = self.registry.existing(name)
        if fam is None:
            fam = self.registry.declare(name, "histogram", (), buckets)
        fam.observe(value)

    def get(self, name: str) -> float:
        """Current counter (or gauge) value, 0 when never touched."""
        return self.registry.get(name)

    def by_label(self, name: str) -> dict[str, float]:
        """A one-label counter/gauge family as {label value: value}; empty
        when never touched."""
        fam = self.registry.existing(name)
        if fam is None:
            return {}
        return {key[0]: child.value for key, child in fam.children().items()}

    def histogram_totals(self, name: str) -> tuple[int, float]:
        """(observation count, sum) of an unlabeled histogram; (0, 0.0)
        when never touched."""
        fam = self.registry.existing(name)
        if fam is None:
            return 0, 0.0
        h = fam.children()[()]
        return h.total, h.sum

    def render(self) -> str:
        return self.registry.render()


# ---------------------------------------------------------------------------
# Telemetry HTTP server (/metrics + /healthz + /readyz)
# ---------------------------------------------------------------------------

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


class TelemetryServer:
    """Background stdlib HTTP endpoint around one Registry:

      GET /metrics - the registry's Prometheus text exposition
      GET /healthz - 200 while the process is up (liveness)
      GET /readyz  - 200/503 from `ready_check`, a zero-arg callable
                     returning (ready, reason).

    Binds at construction (port 0 = ephemeral, see `.port`); `start()`
    serves on a daemon thread; `close()` shuts down."""

    def __init__(self, registry: Registry, *, host: str = "127.0.0.1",
                 port: int = 0, ready_check=None):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.registry = registry
        self.ready_check = ready_check
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, code: int, data: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/metrics":
                    self._send(200, outer.registry.render().encode(),
                               PROMETHEUS_CONTENT_TYPE)
                elif self.path == "/healthz":
                    self._send(200, b'{"status": "ok"}\n',
                               "application/json")
                elif self.path == "/readyz":
                    ready, reason = True, "ok"
                    if outer.ready_check is not None:
                        try:
                            ready, reason = outer.ready_check()
                        except Exception as e:
                            ready, reason = False, f"{type(e).__name__}: {e}"
                    body = json.dumps({
                        "ready": bool(ready), "reason": reason,
                    }).encode() + b"\n"
                    self._send(200 if ready else 503, body,
                               "application/json")
                else:
                    self._send(404, b'{"error": "not found"}\n',
                               "application/json")

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._thread = None

    @property
    def port(self) -> int:
        return self._srv.server_address[1]

    def start(self) -> "TelemetryServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True,
            name="telemetry-server",
        )
        self._thread.start()
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
