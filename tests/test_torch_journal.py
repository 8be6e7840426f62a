"""The port's decision journal (serve/journal.py) and its cold replay
(serve/replay.py) against the JAX package's: schema, ring, rotation and the
shared rolling sink; byte-exact offline replay across eviction, supervisor
restart, speculation, int8 KV, host-spill reload and prefix-cache COW
splices; the first-divergence report; what-if overrides; armed == unarmed
(mirrors tests/test_journal.py; its tp=2 case is in
tests/test_torch_tp_serving.py). Two cross-package cases on the same weights: the port's
entries equal JAX's field by field for one workload (less wall clocks),
and a journal JAX's engine captured replays through the port's
`run_replay` with no divergence."""

import json
import math
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from oryx_tpu.serve import journal as jjournal  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JSched  # noqa: E402
from oryx_tpu.utils import faults as jfaults  # noqa: E402
from oryx_tpu_torch.serve import journal as journal_lib  # noqa: E402
from oryx_tpu_torch.serve import replay as rj  # noqa: E402
from oryx_tpu_torch.serve.api_server import EngineSupervisor  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils import faults  # noqa: E402
from oryx_tpu_torch.utils.metrics import ServingMetrics  # noqa: E402
from oryx_tpu_torch.utils.request_log import RequestLog  # noqa: E402
from oryx_tpu_torch.utils.rolling_sink import RollingSink  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serve_common import make_pipes  # noqa: E402


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


@pytest.fixture(scope="module")
def pipe(pipes):
    return pipes[1]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ---------------------------------------------------------------------------
# Schema + ring + file (no engine)
# ---------------------------------------------------------------------------


def test_build_journal_event_rejects_undeclared_fields():
    ev = journal_lib.build_journal_event(kind="step", dispatch="decode")
    assert ev["schema"] == journal_lib.JOURNAL_SCHEMA == jjournal.JOURNAL_SCHEMA
    assert ev == jjournal.build_journal_event(kind="step", dispatch="decode")
    with pytest.raises(ValueError, match="undeclared"):
        journal_lib.build_journal_event(**{"kind": "step", "not_a_field": 1})
    with pytest.raises(ValueError, match="undeclared"):
        journal_lib.build_journal_event(**{"BadCase": "x"})
    assert journal_lib.REPLAYED_KINDS == jjournal.REPLAYED_KINDS
    assert journal_lib.DETERMINISTIC_COST_KEYS == \
        jjournal.DETERMINISTIC_COST_KEYS


@pytest.mark.parametrize("payload", [
    "", "hello", "héllo wörld ✓", "x" * 1000,
])
def test_fingerprints_equal_jax(payload):
    assert journal_lib.fingerprint_text(payload) == \
        jjournal.fingerprint_text(payload)
    toks = [ord(c) % 500 for c in payload]
    assert journal_lib.fingerprint_tokens(toks) == \
        jjournal.fingerprint_tokens(toks)


def test_journal_ring_counts_and_debug_shape(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal_lib.DecisionJournal(path, keep=3)
    j.stamp_header(num_slots=2, seed=0)
    j.seal_header()
    for i in range(5):
        seq = j.append(journal_lib.build_journal_event(
            kind="step", step=i, dispatch="decode",
        ))
        assert seq == i
    body = j.to_dict()
    assert body["armed"] is True
    assert body["total"] == 5
    assert body["counts_by_kind"] == {"step": 5}
    assert body["header"]["config"]["num_slots"] == 2
    assert [e["step"] for e in body["entries"]] == [4, 3, 2]
    j.close()
    header, entries = journal_lib.read_journal(path)
    assert header["config"]["seed"] == 0
    assert [e["step"] for e in entries] == [0, 1, 2, 3, 4]
    # The JAX reader reads the port's file the same way.
    assert jjournal.read_journal(path) == (header, entries)
    d = journal_lib.DISARMED.to_dict()
    assert d == jjournal.DISARMED.to_dict()
    assert d["armed"] is False and d["entries"] == []
    assert set(d) == set(body)


def test_journal_rotation_preserves_header(tmp_path):
    path = str(tmp_path / "j.jsonl")
    j = journal_lib.DecisionJournal(path, max_bytes=600)
    j.stamp_header(num_slots=1)
    j.seal_header()
    n = 40
    for i in range(n):
        j.append(journal_lib.build_journal_event(
            kind="step", step=i, dispatch="decode",
        ))
    j.close()
    assert (tmp_path / "j.jsonl.1").exists()
    for p in (tmp_path / "j.jsonl", tmp_path / "j.jsonl.1"):
        first = json.loads(p.read_text().splitlines()[0])
        assert first["kind"] == "header"
    header, entries = journal_lib.read_journal(path)
    assert header["config"]["num_slots"] == 1
    steps = [e["step"] for e in entries]
    assert steps == list(range(steps[0], n))
    assert steps[-1] == n - 1


def test_rolling_sink_shared_semantics(tmp_path):
    path = str(tmp_path / "s.jsonl")
    sink = RollingSink(path, max_bytes=120)
    sink.set_prologue('{"kind": "header"}')
    for i in range(20):
        sink.write(json.dumps({"i": i}))
    live = Path(path).read_text().splitlines()
    rolled = Path(path + ".1").read_text().splitlines()
    assert live[0] == '{"kind": "header"}'
    assert rolled[0] == '{"kind": "header"}'
    seen = [json.loads(x)["i"] for x in rolled[1:] + live[1:]]
    assert seen == list(range(seen[0], 20))
    sink.close()
    with pytest.raises(ValueError, match="closed"):
        sink.write("{}")


# ---------------------------------------------------------------------------
# Live capture -> offline replay
# ---------------------------------------------------------------------------


def _capture(pipe, tmp_path, reqs, *, supervisor=False, faults_spec=None,
             request_log=None, sched_cls=ContinuousScheduler,
             journal_mod=journal_lib, faults_mod=faults, sup_cls=None,
             name="journal.jsonl", **kw):
    """One journaled live run: everything submitted up front (ids
    r0, r1, ...), run to completion, closed. Returns (path, results)."""
    path = str(tmp_path / name)
    j = journal_mod.DecisionJournal(path)
    if faults_spec:
        j.stamp_header(faults_spec=faults_spec)
        faults_mod.configure(faults_spec)
    sup = None
    try:
        sched = sched_cls(
            pipe, autostart=False, journal=j, request_log=request_log, **kw,
        )
        handles = [
            sched.submit({"question": q}, cap, sampling,
                         request_id=f"r{i}")
            for i, (q, cap, sampling) in enumerate(reqs)
        ]
        sched.start()
        if supervisor:
            sup = (sup_cls or EngineSupervisor)(sched, poll_s=0.05)
            sup.start()
        results = [h.result(timeout=600) for h in handles]
    finally:
        if sup is not None:
            sup.stop()
        sched.close()
        j.close()
        faults_mod.configure(None)
    return path, results


def _replay_byte_exact(path, pipe):
    header, entries = journal_lib.read_journal(path)
    res = rj.run_replay(header, entries, pipe=pipe, timeout_s=300)
    div = rj.first_divergence(entries, res["entries"])
    assert div is None, f"replay diverged: {div}"
    matched, total, bad = rj.reply_match(entries, res["entries"])
    assert total == len(
        [e for e in entries if e["kind"] == "finish"]
    ) and matched == total, bad
    assert not res["feed_errors"] and not res["timed_out"]
    assert not res["gave_up"]
    return entries, res["entries"]


def test_replay_eviction(pipe, tmp_path):
    q1, q2 = "hello there", "tell me more"
    chunk, ps = 4, 16
    ids1 = len(pipe._prepare_request({"question": q1})[0])
    ids2 = len(pipe._prepare_request({"question": q2})[0])
    admit1 = math.ceil((ids1 + chunk) / ps)
    admit2 = math.ceil((ids2 + chunk) / ps)
    cap = (admit1 * ps - ids1) + ps
    metrics = ServingMetrics()
    path, _ = _capture(
        pipe, tmp_path, [(q1, cap, None), (q2, cap, None)],
        num_slots=2, page_size=ps, chunk=chunk, max_ctx=512,
        num_pages=admit1 + admit2 + 1, prefix_cache=False,
        metrics=metrics,
    )
    assert metrics.get("evicted") >= 1
    entries, _ = _replay_byte_exact(path, pipe)
    assert any(e["kind"] == "evict" for e in entries)
    readmits = [
        e for e in entries
        if e["kind"] == "admit" and e.get("replay_tokens")
    ]
    assert readmits


def test_replay_supervisor_restart(pipe, tmp_path):
    path, results = _capture(
        pipe, tmp_path,
        [("hello there", 10, None), ("what now then", 10, None)],
        num_slots=2, page_size=16, chunk=4, max_ctx=512,
        supervisor=True, faults_spec="engine_crash:after=2",
    )
    assert all(r[1] == "length" for r in results)
    entries, _ = _replay_byte_exact(path, pipe)
    assert any(e["kind"] == "fault" and e["site"] == "engine_crash"
               for e in entries)
    assert any(e["kind"] == "restart" for e in entries)


def test_replay_speculative(pipe, tmp_path):
    path, _ = _capture(
        pipe, tmp_path,
        [("hello there", 8, None),
         ("tell me more about that", 8, None)],
        num_slots=2, page_size=16, chunk=4, max_ctx=512,
        prefill_chunk=32, ragged=True, speculate=2,
    )
    entries, _ = _replay_byte_exact(path, pipe)
    steps = [e for e in entries if e["kind"] == "step"]
    assert steps and all(e["dispatch"] in ("spec", "ragged")
                         for e in steps)
    assert any((e.get("accepted_tokens") or 0) >= 1 for e in steps)


def test_replay_int8_kv(pipe, tmp_path):
    path, _ = _capture(
        pipe, tmp_path,
        [("hello there", 8, None), ("what now?", 8, None)],
        num_slots=2, page_size=16, chunk=4, max_ctx=512,
        kv_dtype="int8",
    )
    _replay_byte_exact(path, pipe)
    header, _ = journal_lib.read_journal(path)
    assert header["config"]["kv_dtype"] == "int8"


def test_replay_prefix_cache_cow(pipe, tmp_path):
    ps = 16
    base = ("You are a meticulous multimodal assistant. Always answer "
            "with care and keep replies short. Describe it")
    L = len(pipe._prepare_request({"question": base})[0])
    q = base + "x" * ((-L) % ps)
    path, _ = _capture(
        pipe, tmp_path, [(q, 6, None), (q, 6, None)],
        num_slots=1, page_size=ps, chunk=4, max_ctx=512,
    )
    entries, _ = _replay_byte_exact(path, pipe)
    splices = [e for e in entries if e["kind"] == "splice"]
    assert splices and any(e.get("cow_pages") for e in splices)
    assert any(e.get("spliced_tokens", 0) > 0 for e in splices)


def test_replay_host_spill_reload(pipe, tmp_path):
    ps, chunk = 8, 4
    pA = "spill tier prompt " * 3
    pB = "completely different filler text " * 3
    idsA = len(pipe._prepare_request({"question": pA})[0])
    idsB = len(pipe._prepare_request({"question": pB})[0])
    capA, capB = 6, 6
    pagesA = math.ceil((idsA + capA + chunk) / ps)
    pagesB = math.ceil((idsB + capB + chunk) / ps)
    path, _ = _capture(
        pipe, tmp_path,
        [(pA, capA, None), (pB, capB, None), (pA, capA, None)],
        num_slots=1, page_size=ps, chunk=chunk, max_ctx=256,
        num_pages=max(pagesA, pagesB) + 2,
        host_cache_bytes=1 << 24,
    )
    entries, _ = _replay_byte_exact(path, pipe)
    splices = [e for e in entries if e["kind"] == "splice"]
    assert any((e.get("host_reload_pages") or 0) > 0 for e in splices), (
        f"scenario did not exercise the host reload path: {splices}"
    )


def test_replay_fused_megasteps_follow_the_journaled_plan(pipe, tmp_path):
    """A fuse_steps="auto" capture journals each megastep's K on its
    (fused_k, fused_j) step entries; the replay applies that plan."""
    path, _ = _capture(
        pipe, tmp_path, [("hello there", 24, None)],
        num_slots=2, page_size=16, chunk=4, max_ctx=512,
        prefill_chunk=32, ragged=True, fuse_steps="auto",
    )
    entries, _ = _replay_byte_exact(path, pipe)
    fused = [e for e in entries if e.get("fused_k")]
    assert fused and {e["dispatch"] for e in fused} == {"fused"}
    assert [e["fused_j"] for e in fused[:fused[0]["fused_k"]]] == \
        list(range(fused[0]["fused_k"]))


# ---------------------------------------------------------------------------
# Divergence report + what-if + never-perturb
# ---------------------------------------------------------------------------


def test_first_divergence_report_shape(pipe, tmp_path):
    path, _ = _capture(
        pipe, tmp_path, [("hello there", 5, None)],
        num_slots=1, page_size=16, chunk=4, max_ctx=512,
    )
    header, entries = journal_lib.read_journal(path)
    tampered = [dict(e) for e in entries]
    victim = next(e for e in tampered if e["kind"] == "step")
    victim["free_pages"] = (victim["free_pages"] or 0) + 7
    div = rj.first_divergence(entries, tampered)
    assert div is not None
    assert set(div) == {"index", "seq", "kind", "field", "live",
                        "replay"}
    assert div["kind"] == "step" and div["field"] == "free_pages"
    assert div["replay"] == div["live"] + 7
    assert div["seq"] == victim["seq"]
    div2 = rj.first_divergence(entries, entries[:-1])
    assert div2 is not None and div2["field"] == "<missing>"
    assert rj.first_divergence(entries, entries) is None


def test_whatif_rows_and_report_schema(pipe, tmp_path):
    path, _ = _capture(
        pipe, tmp_path,
        [("hello there", 6, None), ("hello there again", 6, None)],
        num_slots=2, page_size=16, chunk=4, max_ctx=512,
    )
    header, entries = journal_lib.read_journal(path)
    res = rj.run_replay(
        header, entries, pipe=pipe,
        overrides={"prefix_cache": False}, timeout_s=300,
    )
    rows = rj.whatif_rows(entries, res["entries"])
    report = {
        "bench": "replay_whatif", "schema": rj.WHATIF_SCHEMA,
        "journal": path, "overrides": {"prefix_cache": False},
        "baseline": rj.summarize(entries),
        "current": rj.summarize(res["entries"]),
        "rows": rows,
    }
    assert rj.validate_whatif_report(report) == []
    by_series = {r["series"]: r for r in rows}
    assert (by_series["requests_finished"]["baseline"]
            == by_series["requests_finished"]["current"] == 2)
    assert by_series["spliced_tokens"]["current"] == 0
    bad = rj.validate_whatif_report({"rows": [{}]})
    assert any("missing" in p for p in bad)
    assert rj.parse_overrides("kv_dtype=int8,prefix_cache=false", {
        "prefix_cache": True}) == {"kv_dtype": "int8", "prefix_cache": False}


def test_journal_observes_never_perturbs(pipe, tmp_path):
    reqs = [("hello there", 6, None), ("what now?", 6, None)]
    kw = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
    m_armed = ServingMetrics()
    path, armed = _capture(pipe, tmp_path, reqs, metrics=m_armed, **kw)
    m_plain = ServingMetrics()
    sched = ContinuousScheduler(pipe, autostart=False, metrics=m_plain, **kw)
    handles = [sched.submit({"question": q}, cap, s) for q, cap, s in reqs]
    sched.start()
    plain = [h.result(timeout=600) for h in handles]
    sched.close()
    assert [r[0] for r in armed] == [r[0] for r in plain]
    assert sched.journal is None
    for series in ("decode_steps_total", "prefill_tokens_total"):
        assert m_armed.get(series) == m_plain.get(series), series
    assert m_armed.by_label("dispatches_total") == \
        m_plain.by_label("dispatches_total")


def test_journal_seq_joins_wide_events(pipe, tmp_path):
    rlog = RequestLog(None, keep=16)
    path, _ = _capture(
        pipe, tmp_path, [("hello there", 5, None)],
        num_slots=1, page_size=16, chunk=4, max_ctx=512,
        request_log=rlog,
    )
    header, entries = journal_lib.read_journal(path)
    submit = next(e for e in entries if e["kind"] == "submit")
    ev = rlog.snapshot(1)[0]
    assert ev["journal_seq"] == submit["seq"]
    assert ev["request_id"] == submit["request_id"]


def test_replay_cli_exit_codes(pipe, tmp_path, capsys):
    """main: 0 when the journal reproduces, 2 on a divergence (a tampered
    reply fingerprint), a what-if report written with --override."""
    path, _ = _capture(
        pipe, tmp_path, [("hello there", 5, None)],
        num_slots=1, page_size=16, chunk=4, max_ctx=512,
    )
    assert rj.main([path, "--device", "cpu"], pipe=pipe) == 0
    lines = Path(path).read_text().splitlines()
    out = []
    for ln in lines:
        e = json.loads(ln)
        if e.get("kind") == "finish":
            e["tokens_sha256"] = "0" * 64
        out.append(json.dumps(e))
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join(out) + "\n")
    assert rj.main([str(bad), "--device", "cpu"], pipe=pipe) == 2
    report = tmp_path / "whatif.json"
    assert rj.main([path, "--device", "cpu", "--override",
                    "prefix_cache=false", "--out", str(report)],
                   pipe=pipe) == 0
    assert rj.validate_whatif_report(json.loads(report.read_text())) == []
    assert "FIRST DIVERGENCE" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Across the packages, on the same weights
# ---------------------------------------------------------------------------

WORKLOADS = {
    "split": dict(num_slots=2, page_size=16, chunk=4, max_ctx=512),
    "ragged": dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
                   prefill_chunk=32, ragged=True),
}
REQS = [("hello there", 6, None), ("hello there again", 7, None),
        ("what now?", 5, None)]


@pytest.mark.parametrize("mode", sorted(WORKLOADS))
def test_entries_equal_jax_field_by_field(pipes, tmp_path, mode):
    """One workload through both engines on the same weights: the same
    header geometry and the same entries in the same order, field by
    field, less the wall clock."""
    from oryx_tpu.serve.api_server import EngineSupervisor as JSup

    jp, tp = pipes
    jpath, jres = _capture(
        jp, tmp_path, REQS, sched_cls=JSched, journal_mod=jjournal,
        faults_mod=jfaults, sup_cls=JSup, name="jax.jsonl",
        **WORKLOADS[mode])
    tpath, tres = _capture(tp, tmp_path, REQS, name="port.jsonl",
                           **WORKLOADS[mode])
    assert [r[0] for r in tres] == [r[0] for r in jres]
    jh, je = jjournal.read_journal(jpath)
    th, te = journal_lib.read_journal(tpath)
    assert th["config"] == jh["config"]

    def clean(entries):
        return [{k: v for k, v in e.items() if k != "ts_unix_s"}
                for e in entries]

    assert [e["kind"] for e in te] == [e["kind"] for e in je]
    for a, b in zip(clean(te), clean(je)):
        assert a == b, (a, b)


def test_jax_journal_replays_through_the_port(pipes, tmp_path):
    """A journal JAX's engine captured (an eviction, a crash and restart,
    the prefix cache on) replays cold through the port's run_replay on the
    same weights with no divergence."""
    from oryx_tpu.serve.api_server import EngineSupervisor as JSup

    jp, tp = pipes
    path, _ = _capture(
        jp, tmp_path, REQS, sched_cls=JSched, journal_mod=jjournal,
        faults_mod=jfaults, sup_cls=JSup, supervisor=True,
        faults_spec="engine_crash:after=3",
        num_slots=2, page_size=16, chunk=4, max_ctx=512, num_pages=14,
    )
    entries, _ = _replay_byte_exact(path, tp)
    kinds = {e["kind"] for e in entries}
    assert {"fault", "restart", "finish"} <= kinds
