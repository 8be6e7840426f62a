"""Continuous output auditing: shadow-parity replay off the hot path (port
of `oryx_tpu.serve.audit`).

A sampler picks every Nth FINISHED request (``audit_sample_every``,
0 = off) and replays it cold through the split reference path (the
engine's `generate.paged_prefill` and a single-row decode step,
`audit_decode_step`, with attn_impl="xla", the port's plain attention)
over the auditor's own private page pool, with no prefix-cache splice,
then compares:

  * greedy byte parity: the replayed token stream against the tokens the
    client received, with the first divergence on a mismatch: the
    determinism eviction replay and supervised restart lean on, measured
    continuously in production;
  * logit drift: at K sampled reply positions, the full logit row of the
    reference replay against the row of a second replay under the
    production configuration (the engine's attn_impl: on the card K1 for
    the paged prefill and K3 for the one-row decode; and its pool format:
    with kv_dtype="int8" the twin replays through a private quantized
    pool, and the reference is teacher-forced on the live stream so every
    compared row shares the twin's context): per-position max abs diff
    and KL. Equal programs give exactly 0; a quantized twin drifts, and
    the drift is judged against ``audit_tol_maxdiff`` / ``audit_tol_kl``
    (defaults from utils/quant.roundtrip_error_stats of the pool's own
    format: `drift` within, `fail` above).

Verdicts land in ``oryx_audit_total{verdict=pass|drift|fail}`` and the
``oryx_audit_logit_max_abs_diff`` / ``oryx_audit_kl`` histograms, a
bounded record ring served at ``GET /debug/audit?n=`` (divergence
position, the top-k logit table at the worst position, both streams'
tails), one ``kind="audit"`` wide event per audit through the request-log
sink (utils.metrics.AUDIT_EVENT_KEYS) and the ``audit_drift`` anomaly
detector.

Never perturbs serving:
  * replays run on the engine thread, only at idle points of its loop (no
    queue, no residents), so a replay never interleaves with a live step;
  * the replay uses a PRIVATE page pool and block table: it never
    allocates from the serving allocator, touches the prefix cache or
    writes the engine's pool;
  * it counts only into ``oryx_audit_*``: replies and
    `oryx_serving_dispatches_total` under ``audit_sample_every=1`` are
    those of an unarmed run.

Greedy requests only (temperature 0): sampled picks count in
``oryx_audit_skipped_total{reason="sampled"}``.

Threads: `observe_finished` and `run_one` run on the engine thread; HTTP
handler threads read `to_dict` under the leaf ``_lock``, held only for
ring and counter edits, never across a replay.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from oryx_tpu_torch.analysis.sanitizers import named_lock
from oryx_tpu_torch.models import generate as generate_lib
from oryx_tpu_torch.models import oryx, qwen2
from oryx_tpu_torch.ops.packing import round_up_bucket
from oryx_tpu_torch.utils import request_log as request_log_lib
from oryx_tpu_torch.utils.metrics import (
    AUDIT_DIFF_BUCKETS,
    AUDIT_KL_BUCKETS,
    ServingMetrics,
)

_LOG = logging.getLogger("oryx.serve.audit")

# Tokens of each stream kept in a record's tails.
TAIL_TOKENS = 16
# Top-k logit rows kept in the worst-position table.
TOP_LOGITS = 5


def audit_decode_step(
    params,
    cfg,
    kv_pages: dict,  # the auditor's private pool (written in place)
    block_tables: torch.Tensor,  # [1, max_pages] int32
    tok: torch.Tensor,  # [1] token to feed
    cur_len: torch.Tensor,  # [1] kv tokens held
    *,
    attn_impl: str = "xla",
    compute_dtype=None,
):
    """One single-row greedy decode step that also returns the logit row:
    the replay's inner loop. The step is one iteration of
    `paged_decode_chunk` (cache write, mask, sampler) at one row; the only
    addition is the [1, V] float32 logits the drift comparison reads.
    Returns (kv_pages, next_tok [1], logits [1, V] fp32)."""
    K = block_tables.shape[1] * kv_pages["k"].shape[2]
    slot_ar = torch.arange(K, device=tok.device)[None, :]
    logits, kv_pages = qwen2.forward(
        params, cfg,
        input_ids=generate_lib._feed_ids(cfg, tok)[:, None],
        positions=cur_len.long()[:, None],
        kv_cache=kv_pages, write_slots=cur_len,
        kv_mask=(slot_ar <= cur_len[:, None]).to(torch.int32),
        block_tables=block_tables,
        write_mask=torch.ones((1,), dtype=torch.bool, device=tok.device),
        kv_lengths=cur_len + 1,
        attn_impl=attn_impl, compute_dtype=compute_dtype,
    )
    lg = logits[:, 0]
    nxt = generate_lib.sample_token_rows(
        lg, [None], temperature=torch.zeros(1, device=tok.device),
        top_p=torch.ones(1, device=tok.device),
        top_k=torch.zeros(1, dtype=torch.int32, device=tok.device),
    )
    return kv_pages, nxt, lg.to(torch.float32)


def sample_positions(reply_tokens: int, k: int) -> list[int]:
    """K reply positions (1-based: position i is the logit row that
    produced reply token i) spread evenly over a reply of `reply_tokens`
    tokens. Token 0 is sampled inside the prefill, so the usable range is
    [1, reply_tokens - 1]; a 1-token reply audits parity only.
    Deterministic."""
    hi = reply_tokens - 1
    if hi < 1 or k < 1:
        return []
    return sorted({
        1 + round(i * (hi - 1) / max(1, k - 1)) for i in range(k)
    })


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 arrays under
    the key (k0, k1): the counter-based generator of the reference's
    `jax.random`, in numpy."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = _rotl32(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


# The single-precision erfinv polynomial (Giles) the reference's compiler
# evaluates: one set below w = 5, one above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    """erfinv in float32 by the reference's polynomial, each step rounded
    to float32 from a float64 multiply-add (the fused multiply-add the
    compiled polynomial uses)."""
    x = x.astype(np.float32)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    coef = [np.where(lt, np.float32(a), np.float32(b))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0].astype(np.float32)
    for c in coef[1:]:
        p = (c.astype(np.float64)
             + p.astype(np.float64) * w.astype(np.float64)).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max,
                    p * x).astype(np.float32)


def jax_normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """`jax.random.normal(jax.random.key(seed), shape)` in float32 under
    the reference package's `jax_threefry_partitionable` setting, without
    jax: Threefry bits of the flat index (bits1 ^ bits2), their top 23 bits
    as a uniform in [nextafter(-1, 0), 1), then sqrt(2) * erfinv. The
    uniforms are the reference's bit for bit; erfinv agrees to within
    2 ulp and the normals to within 3."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(
        (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
        (idx >> np.uint64(32)).astype(np.uint32),
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    )
    one = np.float32(1.0)
    frac = (((b0 ^ b1) >> np.uint32(9)) | one.view(np.uint32)).view(
        np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, (frac * (one - lo) + lo).astype(np.float32))
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).reshape(shape)


def drift_fail_tolerances(kv_dtype: str) -> tuple[float, float]:
    """The default (max_abs_diff, kl) boundary between the `drift` and
    `fail` verdicts. A dense pool reproduces the reference bit for bit, so
    the line sits a decade above the pass tolerance. A quantized pool
    drifts: the reference's seeded unit-normal [256, 4, 32] probe
    (`jax_normal(0, ...)`) through the pool format's round trip with one
    scale per token row over the joint head x dim axes
    (`roundtrip_error_stats`, the write path's granularity) gives its
    relative rms error, and the line is that error in logit units with a
    safety factor of 64 (8 for the KL)."""
    if kv_dtype in (None, "bf16", "fp"):
        return 1e-2, 1e-3
    from oryx_tpu_torch.utils import quant as quant_lib

    probe = jax_normal(0, (256, 4, 32)).reshape(256, 4 * 32)
    stats = quant_lib.roundtrip_error_stats(
        torch.from_numpy(probe), axis=-1, fmt=kv_dtype,
    )
    rel = max(stats["rel_rms_err"], 1e-6)
    return 64.0 * rel, 8.0 * rel


def logit_divergence(ref: np.ndarray, cmp: np.ndarray
                     ) -> tuple[float, float]:
    """(max_abs_diff, KL(ref || cmp)) of two logit rows, with an fp64
    softmax so near-identical rows give a clean ~0."""
    a = np.asarray(ref, np.float64)
    b = np.asarray(cmp, np.float64)
    max_abs = float(np.max(np.abs(a - b))) if a.size else 0.0
    pa = np.exp(a - a.max())
    pa /= pa.sum()
    pb = np.exp(b - b.max())
    pb /= pb.sum()
    tiny = np.finfo(np.float64).tiny
    kl = float(np.sum(pa * (np.log(pa + tiny) - np.log(pb + tiny))))
    return max_abs, max(0.0, kl)


def top_logit_table(row: np.ndarray, k: int = TOP_LOGITS) -> list:
    """[[token_id, logit], ...] of the row's top k."""
    row = np.asarray(row, np.float64)
    idx = np.argsort(row)[::-1][:k]
    return [[int(i), round(float(row[i]), 6)] for i in idx]


class OutputAuditor:
    """Seeded shadow-parity auditor around one pipeline. The scheduler
    builds it unconditionally: with sample_every=0 it only pre-registers
    its families (their ladders render at zero) and every observe / run
    call does nothing."""

    def __init__(
        self,
        pipe,
        *,
        page_size: int,
        max_ctx: int,
        sample_every: int = 0,
        positions: int = 8,
        abs_tol: float = 1e-3,
        kl_tol: float = 1e-4,
        keep: int = 64,
        max_pending: int = 8,
        metrics: ServingMetrics | None = None,
        request_log: request_log_lib.RequestLog | None = None,
        anomaly=None,
        engine_label: str = "continuous",
        replica_id: str | None = None,
        kv_dtype: str = "bf16",
        fail_abs_tol: float | None = None,
        fail_kl_tol: float | None = None,
    ):
        if not isinstance(sample_every, int) or sample_every < 0:
            raise ValueError(
                "audit_sample_every must be a non-negative integer "
                f"(audit every Nth finished request; 0 = off), got "
                f"{sample_every!r}"
            )
        self.pipe = pipe
        self.cfg = pipe.cfg
        self.device = pipe.device
        self.page_size = page_size
        self.max_ctx = max_ctx
        self.max_pages = max_ctx // page_size
        self.sample_every = sample_every
        self.positions = max(1, int(positions))
        self.abs_tol = float(abs_tol)
        self.kl_tol = float(kl_tol)
        # The drift-vs-fail boundary (audit_tol_maxdiff / audit_tol_kl).
        d_abs, d_kl = drift_fail_tolerances(kv_dtype)
        self.fail_abs_tol = (
            float(fail_abs_tol) if fail_abs_tol is not None else d_abs
        )
        self.fail_kl_tol = (
            float(fail_kl_tol) if fail_kl_tol is not None else d_kl
        )
        self.metrics = metrics or ServingMetrics()
        self.request_log = request_log
        self.anomaly = anomaly
        self.engine_label = engine_label
        self.replica_id = replica_id
        # The production twin replays under the engine's own attention
        # and pool format when either differs from the plain fp reference;
        # on a quantized pool it is what must reproduce the client's bytes.
        self.kv_dtype = kv_dtype
        self.compare_quant = kv_dtype == "int8"
        self.compare_impl = (
            self.cfg.attn_impl
            if (self.cfg.attn_impl != "xla" or self.compare_quant)
            else None
        )
        reg = self.metrics.registry
        fam = reg.counter("oryx_audit_total", ("verdict",), raw_name=True)
        for verdict in ("pass", "drift", "fail"):
            fam.labels(verdict=verdict)
        reg.counter("oryx_audit_sampled_total", raw_name=True)
        reg.counter(
            "oryx_audit_skipped_total", ("reason",), raw_name=True
        ).labels(reason="sampled")
        reg.counter("oryx_audit_dropped_total", raw_name=True)
        reg.counter("oryx_audit_replayed_tokens_total", raw_name=True)
        reg.gauge("oryx_audit_pending", raw_name=True)
        reg.histogram(
            "oryx_audit_logit_max_abs_diff", AUDIT_DIFF_BUCKETS,
            raw_name=True,
        )
        reg.histogram("oryx_audit_kl", AUDIT_KL_BUCKETS, raw_name=True)
        # Engine-thread state.
        self._finished_seen = 0
        self._pending: deque[dict[str, Any]] = deque()
        self.max_pending = max(1, int(max_pending))
        self._kv = None  # the reference's private pool (built lazily)
        self._kv_prod = None  # the quantized twin's private pool
        self._bt = None
        # Ring and monotone verdict counts, shared with debug threads.
        self._lock = named_lock("audit._lock")
        self._ring: deque[dict[str, Any]] = deque(  # guarded-by: _lock
            maxlen=max(1, int(keep))
        )
        self._total = 0  # guarded-by: _lock
        self._verdicts = {  # guarded-by: _lock
            "pass": 0, "drift": 0, "fail": 0,
        }

    # ---- sampling (engine thread, at a request's finish) -----------------

    def observe_finished(self, req) -> None:
        """Every-Nth sampler over successfully finished requests (the
        scheduler's `_finish` calls it). Captures a self-contained replay
        job of host copies, nothing that pins engine state."""
        if not self.sample_every:
            return
        self._finished_seen += 1
        if self._finished_seen % self.sample_every:
            return
        reg = self.metrics.registry
        reg.counter("oryx_audit_sampled_total", raw_name=True).inc()
        if float(getattr(req, "temp", 0.0) or 0.0) != 0.0:
            reg.counter(
                "oryx_audit_skipped_total", ("reason",), raw_name=True
            ).labels(reason="sampled").inc()
            return
        if len(self._pending) >= self.max_pending:
            # Bounded backlog: a saturated engine never idles. Dropping
            # the oldest keeps the audits closest to current traffic.
            self._pending.popleft()
            reg.counter("oryx_audit_dropped_total", raw_name=True).inc()
        usage = req.handle.usage or (req.length, len(req.emitted))
        self._pending.append({
            "request_id": req.trace.id,
            "embeds": req.embeds.detach().cpu(),  # [1, T, H] host copy
            "length": int(req.length),
            "max_new": int(req.max_new),
            "emitted": list(req.emitted),
            "completion": int(usage[1]),
            "finish_reason": req.handle.finish_reason,
            "evictions": int(req.evictions),
        })
        self._update_pending_gauge()

    def _update_pending_gauge(self) -> None:
        self.metrics.registry.gauge(
            "oryx_audit_pending", raw_name=True
        ).set(len(self._pending))

    def pending(self) -> int:
        """Jobs waiting for an idle point."""
        return len(self._pending)

    # ---- replay (engine thread, idle points only) ------------------------

    def _on_ranks(self, fn, *args, **kwargs):
        """A device call of the replay: on a sharded pipe (tp or fsdp)
        every rank runs it on its own shard and its own private pool, a
        dispatch of `World.call` (the engine thread's, so it never
        interleaves with the engine's); else a plain call. Only rank 0
        decides."""
        world = self.pipe.tp
        if world is None:
            kwargs.pop("bind", None)
            return fn(*args, **kwargs)
        return world.call(fn, *args, **kwargs)

    def _ensure_pool(self):
        """Build the private replay pools on first use: one request's pages
        and an identity block table, outside the serving allocator. On a
        tensor-parallel pipe each rank makes a pool of its own KV heads,
        held under a handle, as the engine's pool is."""
        dtype = oryx.compute_dtype(self.cfg)
        llm_cfg = qwen2.rank_cfg(self.pipe.params.llm, self.cfg.llm)
        if self._kv is None:
            self._kv = self._on_ranks(
                qwen2.init_paged_kv_cache, llm_cfg, self.max_pages,
                self.page_size, dtype=dtype, device=self.device, bind=True,
            )
            self._bt = torch.arange(
                self.max_pages, dtype=torch.int32, device=self.device
            )[None]
        if self.compare_quant and self._kv_prod is None:
            self._kv_prod = self._on_ranks(
                qwen2.init_paged_kv_cache, llm_cfg, self.max_pages,
                self.page_size, dtype=dtype, device=self.device,
                kv_dtype=self.kv_dtype, bind=True,
            )

    def _drop_pools(self) -> None:
        """Forget the private pools (the followers' with the next
        dispatch): a raise mid-replay may have left them half written."""
        world = self.pipe.tp
        for name in ("_kv", "_kv_prod"):
            pool = getattr(self, name)
            if world is not None and pool is not None:
                world.release(pool)
            setattr(self, name, None)
        self._bt = None

    def _replay(self, job: dict[str, Any], attn_impl: str,
                want_positions: list[int], pool: str = "_kv",
                force: list[int] | None = None):
        """One cold replay of `job` under `attn_impl`: `paged_prefill`,
        then one `audit_decode_step` a reply token, consumed as the
        scheduler's `_advance` consumes them (EOS -> "stop", max_new ->
        "length"). `pool` names the private pool ("_kv" the reference's,
        "_kv_prod" the quantized twin's). Returns (emitted tokens, finish
        reason or None at the divergence-guard cap, {position: logits [V]},
        decode steps, the first index where the model's own greedy choice
        departed from `force`).

        force: teacher-forced mode (the quantized pool's reference): feed
        the client's stream instead of the replay's own tokens, so every
        recorded row shares the twin's context."""
        self._ensure_pool()
        eos = self.cfg.generation.eos_token_id
        dtype = oryx.compute_dtype(self.cfg)
        dev = self.device
        L = job["length"]
        emb = job["embeds"]
        width = round_up_bucket(emb.shape[1])
        if width > emb.shape[1]:
            emb = torch.cat([emb, emb.new_zeros(
                (1, width - emb.shape[1], emb.shape[2]))], dim=1)
        kv, tok0 = self._on_ranks(
            generate_lib.paged_prefill, self.pipe.params.llm, self.cfg.llm, emb.to(dev),
            torch.tensor([L], device=dev), self._bt, getattr(self, pool),
            torch.tensor([0], device=dev), [None],
            torch.zeros(1, device=dev), torch.ones(1, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            attn_impl=attn_impl, compute_dtype=dtype,
        )
        setattr(self, pool, kv)
        want = set(want_positions)
        # One token past the live reply exposes any mismatch.
        target = len(job["emitted"]) + 1
        t = int(tok0.reshape(-1)[0])
        choice_div = -1
        if force:
            if t != force[0]:
                choice_div = 0
            t = force[0]
        cur_len = L
        emitted: list[int] = []
        reason: str | None = None
        rows: dict[int, np.ndarray] = {}
        pos = 0
        steps = 0
        while True:
            if t == eos:
                reason = "stop"
                break
            emitted.append(t)
            if len(emitted) >= job["max_new"]:
                reason = "length"
                break
            if len(emitted) >= target:
                break
            kv, nxt, lg = self._on_ranks(
                audit_decode_step, self.pipe.params.llm, self.cfg.llm, getattr(self, pool),
                self._bt, torch.tensor([t], device=dev),
                torch.tensor([cur_len], dtype=torch.int32, device=dev),
                attn_impl=attn_impl, compute_dtype=dtype,
            )
            setattr(self, pool, kv)
            steps += 1
            cur_len += 1
            pos += 1
            if pos in want:
                rows[pos] = lg[0].cpu().numpy()
            t = int(nxt.reshape(-1)[0])
            if force is not None:
                idx = len(emitted)
                if idx < len(force):
                    if t != force[idx] and choice_div < 0:
                        choice_div = idx
                    t = force[idx]
        return emitted, reason, rows, steps, choice_div

    def run_one(self) -> bool:
        """Run ONE queued audit to completion (engine thread, idle point);
        returns whether a job ran. A replay that raises is contained into
        a `fail` verdict: a broken audit path must page, never kill the
        engine loop it rides."""
        if not self._pending:
            return False
        job = self._pending.popleft()
        self._update_pending_gauge()
        t0 = time.monotonic()
        try:
            record = self._audit_one(job)
        # fault-boundary: a failed replay is an audit FAILURE verdict,
        # never an engine-loop exception
        except Exception as e:
            # A raise mid-replay may have left the private pools half
            # written: drop them so the next audit starts from fresh ones.
            self._drop_pools()
            record = {
                "request_id": job["request_id"],
                "verdict": "fail",
                "error": f"{type(e).__name__}: {e}",
                "first_divergence": -1,
                "replayed_tokens": 0,
                "positions": [],
                "logit_max_abs_diff": None,
                "kl": None,
                "evictions": job["evictions"],
                "live_finish_reason": job["finish_reason"],
                "replay_finish_reason": None,
                "live_tail": job["emitted"][-TAIL_TOKENS:],
                "replay_tail": [],
            }
        record["audit_s"] = round(time.monotonic() - t0, 6)
        self._publish(record)
        return True

    def _audit_one(self, job: dict[str, Any]) -> dict[str, Any]:
        live = job["emitted"]
        want = sample_positions(len(live), self.positions)
        # Quantized pool: the fp reference is teacher-forced on the live
        # stream; its own greedy departures are information, not a
        # verdict.
        ref_emitted, ref_reason, ref_rows, ref_steps, ref_choice_div = (
            self._replay(
                job, "xla", want,
                force=live if self.compare_quant else None,
            )
        )
        replayed = ref_steps + 1  # tok0 rides the prefill
        cmp_emitted, cmp_reason = ref_emitted, ref_reason
        cmp_rows = ref_rows
        if self.compare_impl is not None:
            cmp_emitted, cmp_reason, cmp_rows, cmp_steps, _ = (
                self._replay(
                    job, self.compare_impl, want,
                    pool="_kv_prod" if self.compare_quant else "_kv",
                )
            )
            replayed += cmp_steps + 1
        # A live stream that stopped on EOS (its completion counts one past
        # the appended tokens) pins the replay's stop decision too.
        eos_finish = job["completion"] > len(live)

        def diverges(emitted: list[int], reason: str | None) -> int:
            for i, t in enumerate(live):
                if i >= len(emitted) or emitted[i] != t:
                    return i
            if eos_finish and (
                reason != "stop" or len(emitted) != len(live)
            ):
                return len(live)
            return -1

        # On a quantized pool the client's bytes came off the quantized
        # program: the twin must reproduce them, and the fp reference's
        # departures are recorded only. On a dense pool both must.
        if self.compare_quant:
            ref_div = ref_choice_div
            first_div = diverges(cmp_emitted, cmp_reason)
        else:
            ref_div = diverges(ref_emitted, ref_reason)
            first_div = ref_div
            if first_div < 0 and self.compare_impl is not None:
                first_div = diverges(cmp_emitted, cmp_reason)
        max_abs = 0.0
        max_kl = 0.0
        worst = None
        finite = True
        for p in want:
            a, b = ref_rows.get(p), cmp_rows.get(p)
            if a is None or b is None:
                continue
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                finite = False
            d_abs, d_kl = logit_divergence(a, b)
            if worst is None or d_abs > max_abs:
                worst = p
            max_abs = max(max_abs, d_abs)
            max_kl = max(max_kl, d_kl)
        if (
            first_div >= 0 or not finite
            or max_abs > self.fail_abs_tol or max_kl > self.fail_kl_tol
        ):
            verdict = "fail"
        elif max_abs > self.abs_tol or max_kl > self.kl_tol:
            verdict = "drift"
        else:
            verdict = "pass"
        record: dict[str, Any] = {
            "request_id": job["request_id"],
            "verdict": verdict,
            "first_divergence": first_div,
            "replayed_tokens": replayed,
            "positions": want,
            "logit_max_abs_diff": round(max_abs, 9),
            "kl": round(max_kl, 9),
            "evictions": job["evictions"],
            "live_finish_reason": job["finish_reason"],
            "replay_finish_reason": ref_reason,
            "live_tail": live[-TAIL_TOKENS:],
            "replay_tail": ref_emitted[-TAIL_TOKENS:],
        }
        if self.compare_quant and ref_div >= 0:
            record["ref_first_divergence"] = ref_div
        if worst is not None:
            record["top_logits"] = {
                "position": worst,
                "reference": top_logit_table(ref_rows[worst]),
                "production": top_logit_table(cmp_rows[worst]),
            }
        return record

    def _publish(self, record: dict[str, Any]) -> None:
        """Ring, counters, histograms, wide event and anomaly feed: the one
        place a verdict becomes observable, so the ring and
        oryx_audit_total never drift apart."""
        verdict = record["verdict"]
        record.setdefault("ts_unix_s", time.time())
        with self._lock:
            idx = self._total
            record["index"] = idx
            self._ring.append(record)
            self._total += 1
            self._verdicts[verdict] = self._verdicts.get(verdict, 0) + 1
        reg = self.metrics.registry
        reg.counter(
            "oryx_audit_total", ("verdict",), raw_name=True
        ).labels(verdict=verdict).inc()
        reg.counter(
            "oryx_audit_replayed_tokens_total", raw_name=True
        ).inc(record.get("replayed_tokens") or 0)
        if record.get("logit_max_abs_diff") is not None:
            reg.histogram(
                "oryx_audit_logit_max_abs_diff", AUDIT_DIFF_BUCKETS,
                raw_name=True,
            ).observe(record["logit_max_abs_diff"])
        if record.get("kl") is not None:
            reg.histogram(
                "oryx_audit_kl", AUDIT_KL_BUCKETS, raw_name=True,
            ).observe(record["kl"])
        if self.request_log is not None:
            self.request_log.append(request_log_lib.build_audit_event(
                request_id=record["request_id"],
                engine=self.engine_label,
                replica=self.replica_id,
                verdict=verdict,
                first_divergence=record["first_divergence"],
                replayed_tokens=record["replayed_tokens"],
                positions_checked=len(record.get("positions") or []),
                logit_max_abs_diff=record.get("logit_max_abs_diff"),
                kl=record.get("kl"),
                evictions=record.get("evictions", 0),
                audit_index=idx,
            ))
        if self.anomaly is not None:
            self.anomaly.observe_audit(
                verdict, request_id=record["request_id"],
            )
        if verdict != "pass":
            _LOG.warning(
                "output audit %s for request %s (first_divergence=%s "
                "max_abs=%s kl=%s)", verdict, record["request_id"],
                record["first_divergence"],
                record.get("logit_max_abs_diff"), record.get("kl"),
            )
        else:
            _LOG.info(
                "output audit pass for request %s (%d tokens replayed)",
                record["request_id"], record.get("replayed_tokens") or 0,
            )

    # ---- readers ---------------------------------------------------------

    def to_dict(self, n: int | None = None) -> dict[str, Any]:
        """The GET /debug/audit body (less the engine label the server
        adds): monotone totals that reconcile exactly with
        oryx_audit_total, the pending / dropped view and the newest-first
        record ring."""
        with self._lock:
            records = list(self._ring)
            total = self._total
            verdicts = dict(self._verdicts)
        if n is not None:
            records = records[-max(0, int(n)):]
        reg = self.metrics.registry
        return {
            "sample_every": self.sample_every,
            "total": total,
            "verdicts": verdicts,
            "pending": len(self._pending),
            "sampled": reg.get("oryx_audit_sampled_total", raw_name=True),
            "dropped": reg.get("oryx_audit_dropped_total", raw_name=True),
            "records": [dict(r) for r in reversed(records)],
        }
