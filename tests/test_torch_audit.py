"""The port's output auditor (serve/audit.py) against the JAX package's, on
the CPU: the helpers on the same inputs; verdicts, first divergences and
the record ring of both engines (split and ragged, bf16 and int8 pools)
on the same requests; the same synthetic jobs (a tampered stream, an
EOS-stop divergence, an impossible tolerance) through both auditors; the
never-perturb contract; the wide events and the counters (mirrors
tests/test_audit.py)."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve import audit as jaudit  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu.utils.metrics import ServingMetrics as JaxMetrics  # noqa: E402
from oryx_tpu.utils.request_log import RequestLog as JaxLog  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve import audit  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils import quant  # noqa: E402
from oryx_tpu_torch.utils.anomaly import AnomalyMonitor  # noqa: E402
from oryx_tpu_torch.utils.metrics import (  # noqa: E402
    AUDIT_EVENT_KEYS,
    ServingMetrics,
)
from oryx_tpu_torch.utils.request_log import RequestLog  # noqa: E402

from torch_serve_common import CharTokenizer, make_pipes  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
# Fields of a record that must be equal across the packages.
EXACT = ("request_id", "verdict", "first_divergence", "replayed_tokens",
         "positions", "evictions", "live_finish_reason",
         "replay_finish_reason", "live_tail", "replay_tail", "index",
         "ref_first_divergence")
REQS = [("hello there", 6), ("tell me more", 5), ("another one", 8)]
ENGINES = {
    "split": dict(),
    "ragged": dict(ragged=True, prefill_chunk=32),
}


@pytest.fixture(scope="module")
def pipes():
    """The serving tests' input-sensitive weights (x20)."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield make_pipes()
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def plain_pipes(pipes):
    """The JAX audit tests' weights: the tiny init as drawn."""
    cfg = jcfg.oryx_tiny()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        joryx.init_params(cfg, jax.random.key(0)))
    jp = OryxInference(CharTokenizer(),
                       jax.tree_util.tree_map(jnp.asarray, tree), cfg)
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    tp = Pipeline(CharTokenizer(), from_jax_params(tree, tc), tc,
                  device="cpu")
    return jp, tp


def _drain(sched, want, timeout=120.0):
    """Wait until `want` picks reached a verdict or a skip and nothing is
    pending (result() returns before the finish path samples)."""
    reg = sched.metrics.registry
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        skipped = reg.existing(
            "oryx_audit_skipped_total", raw_name=True
        ).labels(reason="sampled").value
        if (sched.auditor.to_dict()["total"] + skipped >= want
                and sched.auditor.pending() == 0):
            return
        time.sleep(0.05)
    raise AssertionError(f"audit backlog never drained: "
                         f"{sched.auditor.to_dict()}")


def _serve(cls, pipe, reqs=REQS, audited=None, **kw):
    """Serve `reqs` (question, cap[, sampling]) in order; wait for
    `audited` audits (default: every request when sampling every one)."""
    sched = cls(pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
                autostart=False, **kw)
    handles = [sched.submit({"question": r[0]}, r[1],
                            r[2] if len(r) > 2 else None,
                            request_id=f"r{i}")
               for i, r in enumerate(reqs)]
    sched.start()
    results = [h.result(timeout=600) for h in handles]
    if kw.get("audit_sample_every"):
        _drain(sched, len(reqs) // kw["audit_sample_every"]
               if audited is None else audited)
    d = sched.auditor.to_dict()
    sched.close()
    return sched, results, d


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert {k: a.get(k) for k in EXACT} == {k: b.get(k) for k in EXACT}
        for k in ("logit_max_abs_diff", "kl"):
            assert a[k] == pytest.approx(b[k], abs=ATOL, rel=RTOL), k
        if "top_logits" in b:
            ta, tb = a["top_logits"], b["top_logits"]
            assert ta["position"] == tb["position"]
            for side in ("reference", "production"):
                assert [i for i, _ in ta[side]] == [i for i, _ in tb[side]]
                np.testing.assert_allclose(
                    [v for _, v in ta[side]], [v for _, v in tb[side]],
                    atol=ATOL, rtol=RTOL)
        else:
            assert "top_logits" not in a


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k", [
    (0, 8), (1, 8), (2, 8), (4, 8), (40, 8), (17, 3), (9, 1), (100, 16),
])
def test_sample_positions_equal_jax(n, k):
    assert audit.sample_positions(n, k) == jaudit.sample_positions(n, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logit_divergence_and_top_table_equal_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(64) * 4
    b = a + rng.standard_normal(64) * 10.0 ** -seed
    for x, y in ((a, a), (a, b)):
        got = audit.logit_divergence(x, y)
        assert got == pytest.approx(jaudit.logit_divergence(x, y),
                                    abs=1e-12, rel=1e-9)
    assert audit.logit_divergence(a, a) == (0.0, 0.0)
    assert audit.top_logit_table(b) == jaudit.top_logit_table(b)
    assert audit.top_logit_table(b, 2) == jaudit.top_logit_table(b, 2)


def test_drift_fail_tolerances_from_the_ports_roundtrip():
    assert audit.drift_fail_tolerances("bf16") == \
        jaudit.drift_fail_tolerances("bf16") == (1e-2, 1e-3)
    got = audit.drift_fail_tolerances("int8")
    probe = audit.jax_normal(0, (256, 4, 32)).reshape(256, 128)
    rel = quant.roundtrip_error_stats(
        torch.from_numpy(probe), axis=-1, fmt="int8")["rel_rms_err"]
    assert got == (pytest.approx(64.0 * rel), pytest.approx(8.0 * rel))
    assert 0 < got[1] < got[0] < 1.0
    # The probe is the JAX package's jax.random draw, so the boundary is
    # its value to fp32 rounding.
    for fmt in ("int8", "fp8_e4m3"):
        got = audit.drift_fail_tolerances(fmt)
        want = jaudit.drift_fail_tolerances(fmt)
        assert got[0] == pytest.approx(want[0], rel=1e-6), fmt
        assert got[1] == pytest.approx(want[1], rel=1e-6), fmt


@pytest.mark.parametrize("seed,shape", [
    (0, (256, 4, 32)), (1, (7, 5)), (123, (3,)), (7, (2, 3, 4)),
])
def test_jax_normal_is_jax_random_normal(seed, shape):
    """The probe without jax: threefry2x32 bits and the uniforms they make
    are jax.random's bit for bit; the normals (its erfinv polynomial in
    float32) within 3 ulp."""
    import jax

    assert (audit.threefry2x32(0, 0, np.zeros(1, np.uint32),
                               np.zeros(1, np.uint32))[0].dtype
            == np.uint32)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = audit.jax_normal(seed, shape)
    assert got.dtype == np.float32 and got.shape == want.shape
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert ulp.max() <= 3
    # The bits behind them, through jax.random.bits (bits1 ^ bits2 of the
    # flat index under the partitionable Threefry).
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    b0, b1 = audit.threefry2x32(
        (seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
        (idx >> np.uint64(32)).astype(np.uint32),
        (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    assert np.array_equal((b0 ^ b1).reshape(shape),
                          np.asarray(jax.random.bits(jax.random.key(seed),
                                                     shape)))


def test_audit_decode_step_is_the_engines_step(pipes):
    """One replay step, on a pool a prefill filled, gives the token of
    `paged_decode_chunk`'s first step at one row, and the fp32 logit row
    the drift comparison reads."""
    from oryx_tpu_torch.models import generate, oryx, qwen2

    _, tp = pipes
    cfg = tp.cfg
    ids, imgs, factors, caps = tp._prepare_request({"question": "hi you"})
    emb, L = tp._prompt_embeds(cfg, ids, imgs, factors, caps)
    dtype = oryx.compute_dtype(cfg)
    outs = []
    for step in ("audit", "chunk"):
        kv = qwen2.init_paged_kv_cache(cfg.llm, 8, 16, dtype=dtype,
                                       device="cpu")
        bt = torch.arange(8, dtype=torch.int32)[None]
        zero = (torch.zeros(1), torch.ones(1),
                torch.zeros(1, dtype=torch.int32))
        kv, tok0 = generate.paged_prefill(
            tp.params.llm, cfg.llm, emb, torch.tensor([L]), bt, kv,
            torch.tensor([0]), [None], *zero, compute_dtype=dtype)
        if step == "audit":
            _, nxt, lg = audit.audit_decode_step(
                tp.params.llm, cfg.llm, kv, bt, tok0.reshape(1),
                torch.tensor([L], dtype=torch.int32), compute_dtype=dtype)
            outs.append(int(nxt[0]))
        else:
            out = generate.paged_decode_chunk(
                tp.params.llm, cfg.llm, kv, bt, tok0.reshape(1),
                torch.tensor([L], dtype=torch.int32),
                torch.zeros(1, dtype=torch.bool),
                torch.full((1, 0), -2, dtype=torch.int32), [None], *zero,
                chunk=2, eos=cfg.generation.eos_token_id,
                compute_dtype=dtype)
            outs.append(int(out[5][0, 1]))
    assert outs[0] == outs[1]
    assert lg.dtype == torch.float32 and lg.shape == (1, cfg.llm.vocab_size)


# ---------------------------------------------------------------------------
# The engines: port vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_audits_equal_jax(pipes, engine, kv_dtype):
    """Every finished request audited: the verdict counts, the record
    ring and the wide events of the port's engine are the JAX engine's.
    The int8 pool's drift-vs-fail boundary is set on both (the defaults
    come from each package's own probe)."""
    jp, tp = pipes
    kw = dict(ENGINES[engine], kv_dtype=kv_dtype, audit_sample_every=1)
    if kv_dtype == "int8":
        kw.update(audit_tol_maxdiff=0.5, audit_tol_kl=0.01)
    js, jres, jd = _serve(JaxScheduler, jp, **kw)
    ts, tres, d = _serve(ContinuousScheduler, tp, **kw)
    assert tres == jres
    assert d["verdicts"] == jd["verdicts"]
    assert (d["total"], d["sampled"], d["dropped"], d["pending"]) == \
        (jd["total"], jd["sampled"], jd["dropped"], jd["pending"]) == \
        (3, 3, 0, 0)
    _assert_records_equal(d["records"], jd["records"])
    if kv_dtype == "bf16":  # equal programs: exact zeros, every pass
        assert d["verdicts"] == {"pass": 3, "drift": 0, "fail": 0}
        assert all(r["logit_max_abs_diff"] == 0.0 for r in d["records"])
    else:  # the quantized twin reproduces the client's bytes
        assert all(r["first_divergence"] == -1 for r in d["records"])
        assert all(r["logit_max_abs_diff"] > 0 for r in d["records"])
    # Ring <-> counters <-> wide events.
    fam = ts.metrics.registry.existing("oryx_audit_total", raw_name=True)
    for verdict, n in d["verdicts"].items():
        assert fam.labels(verdict=verdict).value == n
    events = [e for e in ts.request_log.snapshot() if e.get("kind") == "audit"]
    assert len(events) == 3
    by_index = {r["index"]: r for r in d["records"]}
    for ev in events:
        assert set(ev) <= set(AUDIT_EVENT_KEYS)
        rec = by_index[ev["audit_index"]]
        assert (ev["request_id"], ev["verdict"]) == \
            (rec["request_id"], rec["verdict"])


@pytest.mark.parametrize("engine", list(ENGINES))
def test_armed_engine_never_perturbs(pipes, engine):
    """Replies and dispatch counts with audits and the numerics probe
    armed are those of an unarmed engine; only oryx_audit_* and
    oryx_numerics_* move."""
    _, tp = pipes
    base, bres, _ = _serve(ContinuousScheduler, tp, **ENGINES[engine])
    armed, ares, d = _serve(ContinuousScheduler, tp, audit_sample_every=1,
                            numerics_every=4, **ENGINES[engine])
    assert ares == bres
    assert armed.metrics.by_label("dispatches_total") == \
        base.metrics.by_label("dispatches_total")
    assert armed.timeline.counts_by_kind() == base.timeline.counts_by_kind()
    assert d["total"] == 3 and d["verdicts"]["pass"] == 3
    for name in ("completed", "chunks", "decode_steps_total",
                 "prefill_tokens_total", "harvest_total"):
        assert armed.metrics.get(name) == base.metrics.get(name), name


def test_int8_default_tolerances_zero_fail_as_jax(plain_pipes):
    """An audited int8 burst on the tiny init: no fail verdict, the twin
    reproducing every byte, the drift under the default boundary, the
    verdicts those of the JAX engine."""
    jp, tp = plain_pipes
    reqs = [(f"audited int8 burst {i}", 5, {"temperature": 0.0})
            for i in range(3)]
    kw = dict(kv_dtype="int8", audit_sample_every=1)
    _, jres, jd = _serve(JaxScheduler, jp, reqs, **kw)
    ts, tres, d = _serve(ContinuousScheduler, tp, reqs, **kw)
    assert tres == jres
    assert d["verdicts"]["fail"] == 0 and d["total"] == 3
    assert d["verdicts"] == jd["verdicts"]
    for rec in d["records"]:
        assert rec["first_divergence"] == -1
        assert rec["logit_max_abs_diff"] <= ts.auditor.fail_abs_tol


def test_every_nth_sampling_and_sampled_skip_as_jax(pipes):
    jp, tp = pipes
    reqs = [("hello there", 4), ("what now?", 4,
                                 {"temperature": 0.9, "seed": 3}),
            ("tell me more", 4), ("one more", 4)]
    out = []
    for cls, pipe in ((ContinuousScheduler, tp), (JaxScheduler, jp)):
        sched, _, d = _serve(cls, pipe, reqs, audited=2,
                             audit_sample_every=2)
        skipped = sched.metrics.registry.existing(
            "oryx_audit_skipped_total", raw_name=True
        ).labels(reason="sampled").value
        out.append((d["sampled"], d["total"], skipped, d["verdicts"]))
    assert out[0] == out[1]
    assert out[0][0] == 2 and out[0][1] + out[0][2] == 2
    assert out[0][3]["fail"] == out[0][3]["drift"] == 0


def test_audit_off_by_default_and_families_as_jax(pipes):
    jp, tp = pipes
    texts = []
    for cls, pipe in ((ContinuousScheduler, tp), (JaxScheduler, jp)):
        sched, _, d = _serve(cls, pipe, REQS[:1])
        assert sched.auditor.pending() == 0
        assert d["total"] == 0 and d["sampled"] == 0
        texts.append([ln for ln in sched.metrics.render().splitlines()
                      if "oryx_audit_" in ln])
    assert texts[0] == texts[1]
    assert 'oryx_audit_total{verdict="pass"} 0' in texts[0]


def test_evicted_request_still_audits_pass_as_jax(pipes):
    """A request evicted and replayed mid-flight audits pass: replay
    determinism is the invariant the auditor checks."""
    jp, tp = pipes
    ps = 16
    kw = dict(num_pages=2 * ((120 // ps) + 1) + 1, prefix_cache=False,
              audit_sample_every=1)
    reqs = [("hello there", 64), ("tell me more", 64)]
    js, jres, jd = _serve(JaxScheduler, jp, reqs, **kw)
    ts, tres, d = _serve(ContinuousScheduler, tp, reqs, **kw)
    assert tres == jres
    assert ts.metrics.get("evicted") >= 1
    assert d["verdicts"] == jd["verdicts"] == \
        {"pass": 2, "drift": 0, "fail": 0}
    _assert_records_equal(d["records"], jd["records"])
    assert any(r["evictions"] >= 1 for r in d["records"])


# ---------------------------------------------------------------------------
# Synthetic jobs through both auditors
# ---------------------------------------------------------------------------


def _live_jobs(tp, reqs, **kw):
    """The audit jobs the port's engine captures for `reqs` (its replays
    held back), with the replies they came from."""
    sched = ContinuousScheduler(tp, num_slots=2, page_size=16, chunk=4,
                                max_ctx=512, autostart=False,
                                audit_sample_every=1, **kw)
    sched.auditor.run_one = lambda: False
    handles = [sched.submit({"question": q}, cap, request_id=f"j{i}")
               for i, (q, cap) in enumerate(reqs)]
    sched.start()
    for h in handles:
        h.result(timeout=600)
    end = time.monotonic() + 60
    while sched.auditor.pending() < len(reqs) and time.monotonic() < end:
        time.sleep(0.02)
    sched.close()
    return list(sched.auditor._pending)


def _auditors(pipes, **kw):
    jp, tp = pipes
    return (
        audit.OutputAuditor(tp, page_size=16, max_ctx=512, sample_every=1,
                            metrics=ServingMetrics(),
                            request_log=RequestLog(), **kw),
        jaudit.OutputAuditor(jp, page_size=16, max_ctx=512, sample_every=1,
                             metrics=JaxMetrics(), request_log=JaxLog(),
                             **kw),
    )


def _run_both(pipes, job, **kw):
    aud, jaud = _auditors(pipes, **kw)
    aud._pending.append(dict(job))
    jaud._pending.append({**job, "embeds": job["embeds"].numpy(),
                          "seed": 0})
    assert aud.run_one() and jaud.run_one()
    assert not aud.run_one()
    return aud, jaud


@pytest.fixture(scope="module")
def jobs(pipes):
    return _live_jobs(pipes[1], [("hello there", 6), ("tell me more", 8)])


def test_tampered_stream_fails_as_jax(pipes, jobs):
    job = dict(jobs[0])
    job["emitted"] = list(job["emitted"])
    job["emitted"][3] = (job["emitted"][3] + 1) % 400 + 1
    aud, jaud = _run_both(pipes, job)
    d, jd = aud.to_dict(), jaud.to_dict()
    assert d["verdicts"] == jd["verdicts"] == \
        {"pass": 0, "drift": 0, "fail": 1}
    _assert_records_equal(d["records"], jd["records"])
    rec = d["records"][0]
    assert rec["first_divergence"] == 3
    assert rec["live_tail"] != rec["replay_tail"]
    ev = [e for e in aud.request_log.snapshot() if e.get("kind") == "audit"]
    assert len(ev) == 1 and ev[0]["verdict"] == "fail"


def test_eos_stop_divergence_fails_as_jax(pipes, jobs):
    """A live stream that claims an EOS stop after 3 tokens, where the
    replay continues: fail at the stop position."""
    job = dict(jobs[1])
    job["emitted"] = job["emitted"][:3]
    job["completion"] = 4
    job["finish_reason"] = "stop"
    aud, jaud = _run_both(pipes, job)
    _assert_records_equal(aud.to_dict()["records"],
                          jaud.to_dict()["records"])
    rec = aud.to_dict()["records"][0]
    assert rec["verdict"] == "fail" and rec["first_divergence"] == 3


def test_impossible_tolerance_is_drift_as_jax(pipes, jobs):
    aud, jaud = _run_both(pipes, jobs[0], abs_tol=-1.0)
    assert aud.to_dict()["verdicts"] == jaud.to_dict()["verdicts"] == \
        {"pass": 0, "drift": 1, "fail": 0}
    _assert_records_equal(aud.to_dict()["records"],
                          jaud.to_dict()["records"])


def test_audit_drift_feeds_one_anomaly_an_episode(pipes, jobs):
    mon = AnomalyMonitor(source="serve")
    aud, _ = _auditors(pipes, abs_tol=-1.0, anomaly=mon)
    for _ in range(3):
        aud._pending.append(dict(jobs[0]))
        assert aud.run_one()
    assert mon.counts.get("audit_drift") == 1
    aud.abs_tol = 1e-3  # a pass re-arms the detector
    aud._pending.append(dict(jobs[0]))
    assert aud.run_one()
    aud.abs_tol = -1.0
    aud._pending.append(dict(jobs[0]))
    assert aud.run_one()
    assert mon.counts.get("audit_drift") == 2
    mon.close()


def test_broken_replay_is_contained_and_pool_recovers(pipes, jobs):
    aud, _ = _auditors(pipes)
    aud._pending.append({**jobs[0], "embeds": "not a tensor"})
    assert aud.run_one()
    d = aud.to_dict()
    assert d["verdicts"]["fail"] == 1 and "error" in d["records"][0]
    assert aud._kv is None
    aud._pending.append(dict(jobs[0]))
    assert aud.run_one()
    assert aud.to_dict()["verdicts"]["pass"] == 1


def test_int8_verdict_flips_at_the_tolerance(plain_pipes):
    """The drift-vs-fail boundary is the verdict flip: the same int8-served
    request audits drift (or pass) above its measured drift and fail below
    it, the twin reproducing the bytes both times."""
    job = _live_jobs(plain_pipes[1], [("tolerance flip probe", 6)],
                     kv_dtype="int8")[0]

    def one(**kw):
        aud, _ = _auditors(plain_pipes, kv_dtype="int8", fail_kl_tol=1e9,
                           **kw)
        aud._pending.append(dict(job))
        assert aud.run_one()
        return aud.to_dict()["records"][0]

    rec = one(fail_abs_tol=1e9)
    drift = rec["logit_max_abs_diff"]
    assert rec["first_divergence"] == -1 and drift > 0
    assert one(fail_abs_tol=drift * 0.5)["verdict"] == "fail"
    assert one(fail_abs_tol=drift * 2.0)["verdict"] != "fail"
    assert one(fail_abs_tol=drift * 0.5)["first_divergence"] == -1


def test_bounded_backlog_drops_the_oldest_as_jax(pipes):
    from types import SimpleNamespace

    def req(i, temp=0.0):
        emb = torch.zeros((1, 4, 8))
        return SimpleNamespace(
            trace=SimpleNamespace(id=f"q{i}"), embeds=emb, embeds_np=None,
            length=4, max_new=6, sampling={}, emitted=[1, 2], temp=temp,
            handle=SimpleNamespace(usage=(4, 2), finish_reason="length"),
            evictions=0)

    out = []
    for aud in _auditors(pipes, max_pending=2):
        for i in range(4):
            aud.observe_finished(req(i, temp=0.5 if i == 3 else 0.0))
        d = aud.to_dict()
        out.append((aud.pending(), d["sampled"], d["dropped"],
                    [j["request_id"] for j in aud._pending]))
    assert out[0] == out[1] == (2, 4, 1, ["q1", "q2"])
    with pytest.raises(ValueError, match="audit_sample_every"):
        audit.OutputAuditor(pipes[1], page_size=16, max_ctx=512,
                            sample_every=-1)
    off = audit.OutputAuditor(pipes[1], page_size=16, max_ctx=512)
    off.observe_finished(req(0))
    assert not off.run_one() and off.to_dict()["total"] == 0
