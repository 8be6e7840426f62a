"""Offline incident replay of the engine decision journal (port of the
reference's `scripts/replay_journal.py`; the CLI is
`scripts/torch_replay_journal.py`).

Reads a journal captured with ``journal_path=`` (serve/journal.py),
rebuilds a COLD scheduler from the header's flags/seed/pool geometry on the
pipeline it is given, feeds the journaled admission stream at its recorded
step gates, and checks that the incident reproduces bit for bit:

  * byte-identical reply tokens per request (the finish entries'
    reply/token fingerprints),
  * decision-for-decision stream equality over REPLAYED_KINDS
    (admit/splice/evict/step/fault/restart/finish),
  * cost-ledger equality (the DETERMINISTIC_COST_KEYS subset).

On mismatch `first_divergence` names the seq, decision kind, first
differing field and both values. By contract submit arrivals,
admission-control rejects and degraded transitions are timing-coupled and
NOT compared; live cancellations and deadline expiries are load-coupled
too and may legitimately diverge.

What-if mode: overrides (`parse_overrides`) replay the IDENTICAL workload
under altered flags (kv_dtype, prefill_chunk, speculate,
host_cache_bytes, ...) and `whatif_rows` diffs cost and goodput instead of
asserting equality.

The pipeline is an argument, so the same code replays a tiny CPU journal
and a full-width journal on the card; it must be the capturing server's
model (same weights, tokenizer and device) or the reply fingerprints
cannot reproduce.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from collections import deque
from pathlib import Path
from typing import Any

from oryx_tpu_torch.serve import journal as journal_lib
from oryx_tpu_torch.utils import faults

# Per-entry fields left out of the comparison: `seq` is a global counter
# shared with the kinds that are not replayed, `ts_unix_s` the wall clock.
VOLATILE_FIELDS = ("seq", "ts_unix_s")

# Header-config keys that are ContinuousScheduler constructor kwargs, in
# constructor spelling: the cold-rebuild set and (with faults_spec) the
# override whitelist.
GEOMETRY_KEYS = (
    "num_slots", "page_size", "chunk", "max_ctx", "num_pages", "seed",
    "prefill_chunk", "prefix_cache", "ragged", "speculate", "kv_dtype",
    "host_cache_bytes", "degraded_clamp_tokens", "fuse_steps",
)
OVERRIDE_KEYS = GEOMETRY_KEYS + ("faults_spec",)

WHATIF_SCHEMA = 1
WHATIF_ROW_KEYS = (
    "series", "baseline", "current", "direction", "rel_tol", "verdict",
    "note",
)


@dataclasses.dataclass
class Row:
    """One compared series of the what-if table (the reference's
    bench_compare row)."""

    series: str
    baseline: Any
    current: Any
    direction: str  # "higher" | "lower" | "equal" | "info"
    rel_tol: float
    verdict: str = "ok"  # ok | improved | regression | info
    note: str = ""


def judge(row: Row) -> Row:
    """Fill `verdict` from the values, direction and tolerance (the
    reference's bench_compare verdict logic)."""
    b, c = row.baseline, row.current
    if row.direction == "info" or b is None or c is None:
        row.verdict = "info"
        return row
    if row.direction == "equal":
        row.verdict = "ok" if c == b else "regression"
        return row
    b, c = float(b), float(c)
    if b == 0.0:
        # No baseline signal: only a strict worsening from zero in the
        # "lower is better" sense regresses.
        worse = c > 0 if row.direction == "lower" else False
        row.verdict = "regression" if worse else "ok"
        return row
    change = (c - b) / abs(b)
    if row.direction == "lower":
        change = -change
    if change < -row.rel_tol:
        row.verdict = "regression"
    elif change > row.rel_tol:
        row.verdict = "improved"
    else:
        row.verdict = "ok"
    return row


class CharTokenizer:
    """The character tokenizer of the tiny self-test engines (ids are code
    points capped at 500): a journal captured through it replays to the
    same token ids."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def build_tiny_pipe(device="cuda"):
    """The tiny config at a seeded random init (generator seed 0) with the
    character tokenizer: the default pipeline of the CLI."""
    import torch

    from oryx_tpu_torch import config as cfg_lib
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = cfg_lib.oryx_tiny()
    dev = torch.device(device)
    params = oryx.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev)
    return Pipeline(CharTokenizer(), params, cfg, device=dev)


# ---------------------------------------------------------------------------
# Workload plan
# ---------------------------------------------------------------------------


def plan_feed(entries: list[dict[str, Any]],
              payloads: dict[str, Any] | None = None,
              ) -> tuple[list[dict[str, Any]], list[tuple[str, str]]]:
    """The feed plan: one item per replayable submit, in arrival order.

    A submit journaled by fingerprint only (media arrays, which are not
    JSON) replays from `payloads`, a sidecar of request id -> the request
    dict, whose fingerprint must be the journaled one.

    Each item carries the journaled payload/sampling/streaming, the
    EFFECTIVE max_new (the first admit entry's budget, with the degraded
    clamp applied at the live queue head, else the requested value), and
    `feed_step`: the engine step at which the live run first admitted it
    (validation rejects never admit; they gate on their finish step).
    Returns (plan, skipped), skipped listing (request_id, reason) for
    submits a replay cannot carry."""
    rejected = {
        e.get("request_id") for e in entries if e["kind"] == "reject"
    }
    first_admit: dict[str, dict[str, Any]] = {}
    finish_step: dict[str, int] = {}
    for e in entries:
        rid = e.get("request_id")
        if e["kind"] == "admit" and rid not in first_admit:
            first_admit[rid] = e
        elif e["kind"] == "finish" and rid not in finish_step:
            finish_step[rid] = int(e.get("step") or 0)
    submits = sorted(
        (e for e in entries if e["kind"] == "submit"),
        key=lambda e: e["arrival_seq"],
    )
    plan: list[dict[str, Any]] = []
    skipped: list[tuple[str, str]] = []
    for e in submits:
        rid = e["request_id"]
        if rid in rejected:
            skipped.append(
                (rid, "admission-control reject (timing-coupled, "
                      "excluded by contract)")
            )
            continue
        prompt = e.get("prompt")
        if prompt is None:
            prompt = (payloads or {}).get(rid)
            if prompt is None:
                raise ValueError(
                    f"request {rid} journaled a prompt fingerprint, not a "
                    "payload (a non-JSON submit, such as media arrays): "
                    "replay it with its payload in the sidecar"
                )
            if journal_lib.fingerprint_text(repr(prompt)) != \
                    e.get("prompt_sha256"):
                raise ValueError(
                    f"request {rid}: the sidecar payload's fingerprint is "
                    "not the journaled one"
                )
        admit = first_admit.get(rid)
        if admit is None and rid not in finish_step:
            skipped.append(
                (rid, "no admit or finish entry (capture ended "
                      "mid-flight or the journal rotated past it)")
            )
            continue
        plan.append({
            "request_id": rid,
            "prompt": prompt,
            "sampling": e.get("sampling") or {},
            "max_new": int(
                admit["max_new"] if admit is not None else e["max_new"]
            ),
            "streaming": bool(e.get("streaming")),
            "feed_step": int(
                admit["step"] if admit is not None else finish_step[rid]
            ),
        })
    return plan, skipped


# ---------------------------------------------------------------------------
# Replay run
# ---------------------------------------------------------------------------


def run_replay(header: dict[str, Any], entries: list[dict[str, Any]], *,
               pipe, overrides: dict[str, Any] | None = None,
               timeout_s: float = 300.0,
               payloads: dict[str, Any] | None = None) -> dict[str, Any]:
    """Cold-rebuild the scheduler the header describes (plus override
    deltas) on `pipe`, replay the journaled admission stream (`payloads`:
    the sidecar of `plan_feed`), and return
    {"entries": the replay's journal entries, "skipped", "feed_errors",
    "timed_out", "gave_up"}.

    The feeder runs on the engine thread at the top of every loop turn
    (scheduler.replay_feeder): it submits pending requests once
    `steps_run` reaches their recorded gate, or, under overrides that
    finish the resident work in fewer steps, once the engine is idle (in a
    faithful replay an idle engine has already reached the next gate,
    because the step clock only advances on dispatches)."""
    from oryx_tpu_torch.serve.api_server import EngineSupervisor
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = dict(header.get("config") or {})
    if overrides:
        cfg.update(overrides)
    plan, skipped = plan_feed(entries, payloads)
    kw = {k: cfg[k] for k in GEOMETRY_KEYS if k in cfg}
    if cfg.get("draft_model"):
        # The draft model is part of the recorded machine: device-side
        # speculation replays only with the same weights.
        from oryx_tpu_torch.models import generate as generate_lib

        kw["drafter"] = generate_lib.NeuralDrafter.from_spec(
            cfg["draft_model"])
    journal = journal_lib.DecisionJournal(
        None, keep=max(4096, 4 * len(entries) + 8 * len(plan)),
    )
    # The seeded fault schedule is part of the recorded configuration: arm
    # it before construction so the hit counts start from zero as the live
    # process's did.
    faults.configure(cfg.get("faults_spec") or None)
    sched = ContinuousScheduler(
        pipe, autostart=False, journal=journal,
        engine_label=str(cfg.get("engine") or "continuous"),
        replica_id=cfg.get("replica"),
        # No max_queue, timeouts or SLO watchers: admission control,
        # deadlines and the degraded ladder are excluded by contract.
        **kw,
    )
    pending = deque(plan)
    handles: dict[str, Any] = {}
    feed_errors: list[tuple[str, str]] = []

    def feeder(s) -> None:
        while pending:
            item = pending[0]
            if s.steps_run < item["feed_step"]:
                idle = s.queue_len() == 0 and all(
                    r is None for r in s.slots
                )
                if not idle:
                    return
            # Pop only once the handle is booked: the waiting loop below
            # reads `pending` and `handles` from another thread, and an
            # item in neither would end the replay before it ran.
            try:
                handles[item["request_id"]] = s.submit(
                    item["prompt"], item["max_new"], item["sampling"],
                    streaming=item["streaming"],
                    request_id=item["request_id"],
                )
            except Exception as e:  # AdmissionRejected under overrides
                feed_errors.append(
                    (item["request_id"], f"{type(e).__name__}: {e}")
                )
            pending.popleft()

    sched.replay_feeder = feeder
    # The journal records the K each megastep chose (fused_k on its
    # fused_j == 0 step entry); a replay applies that plan. A fuse_steps
    # override drops it: the what-if runs the overridden policy.
    if not (overrides and "fuse_steps" in overrides):
        plan_k = {
            int(e["step"]) - 1: int(e["fused_k"])
            for e in entries
            if e.get("kind") == "step" and e.get("fused_j") == 0
        }
        if plan_k:
            sched.replay_fuse_plan = plan_k
    sched.start()
    # The supervisor is part of the recorded machine: a journaled
    # engine_crash must revive and restart-replay as the live one did.
    sup = EngineSupervisor(sched, poll_s=0.05)
    sup.start()
    timed_out = False
    try:
        deadline = time.monotonic() + timeout_s
        while pending or not all(
            h.done.is_set() for h in handles.values()
        ):
            if sup.gave_up:
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.02)
    finally:
        gave_up = sup.gave_up
        sup.stop()
        sched.close()
        faults.configure(None)
    return {
        "entries": journal.snapshot(),
        "skipped": skipped,
        "feed_errors": feed_errors,
        "timed_out": timed_out,
        "gave_up": gave_up,
    }


# ---------------------------------------------------------------------------
# Comparison
# ---------------------------------------------------------------------------


def replayed_stream(entries: list[dict[str, Any]]
                    ) -> list[tuple[int | None, dict[str, Any]]]:
    """The comparison view of a journal: REPLAYED_KINDS only, volatile
    fields dropped, as (original seq, cleaned entry) pairs."""
    out = []
    for e in entries:
        if e.get("kind") not in journal_lib.REPLAYED_KINDS:
            continue
        clean = {k: v for k, v in e.items() if k not in VOLATILE_FIELDS}
        out.append((e.get("seq"), clean))
    return out


def first_divergence(live_entries: list[dict[str, Any]],
                     replay_entries: list[dict[str, Any]]
                     ) -> dict[str, Any] | None:
    """None when the two decision streams are equal; else the first point
    of divergence: {index (into the replayed stream), seq (the LIVE
    journal's), kind, field, live, replay}. A stream ending early reports
    field "<missing>" with the absent side None."""
    live = replayed_stream(live_entries)
    rep = replayed_stream(replay_entries)
    for i in range(min(len(live), len(rep))):
        lseq, a = live[i]
        _, b = rep[i]
        if a == b:
            continue
        if a.get("kind") != b.get("kind"):
            field = "kind"
        else:
            field = next(
                k for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)
            )
        return {
            "index": i, "seq": lseq, "kind": a.get("kind"),
            "field": field, "live": a.get(field), "replay": b.get(field),
        }
    if len(live) != len(rep):
        i = min(len(live), len(rep))
        seq, e = (live[i] if len(live) > len(rep) else rep[i])
        return {
            "index": i,
            "seq": seq if len(live) > len(rep) else None,
            "kind": e.get("kind"), "field": "<missing>",
            "live": e if len(live) > len(rep) else None,
            "replay": e if len(rep) > len(live) else None,
        }
    return None


def _finishes(entries: list[dict[str, Any]]) -> dict[str, dict[str, Any]]:
    return {e["request_id"]: e for e in entries if e["kind"] == "finish"}


def reply_match(live_entries: list[dict[str, Any]],
                replay_entries: list[dict[str, Any]]
                ) -> tuple[int, int, list[str]]:
    """(matched, total, mismatched request ids) over the live finish
    entries' reply-bytes and token-stream fingerprints."""
    live, rep = _finishes(live_entries), _finishes(replay_entries)
    bad = [
        rid for rid, e in live.items()
        if (r := rep.get(rid)) is None
        or r.get("reply_sha256") != e.get("reply_sha256")
        or r.get("tokens_sha256") != e.get("tokens_sha256")
    ]
    return len(live) - len(bad), len(live), sorted(bad)


# ---------------------------------------------------------------------------
# What-if diffing
# ---------------------------------------------------------------------------


def summarize(entries: list[dict[str, Any]]) -> dict[str, Any]:
    """Aggregate cost/goodput view of one journal: the quantities the
    what-if table compares."""
    fin = [e for e in entries if e["kind"] == "finish"]
    steps = [e for e in entries if e["kind"] == "step"]
    cost = {
        k: sum((e.get("cost") or {}).get(k) or 0 for e in fin)
        for k in journal_lib.DETERMINISTIC_COST_KEYS
    }
    dispatches = len(steps)
    return {
        "requests_finished": len(fin),
        "requests_ok": sum(1 for e in fin if e.get("status") == "ok"),
        "completion_tokens": sum(
            e.get("completion_tokens") or 0 for e in fin
        ),
        **{f"{k}_total": v for k, v in cost.items()},
        "peak_pages_max": max(
            ((e.get("cost") or {}).get("peak_pages") or 0 for e in fin),
            default=0,
        ),
        "dispatches": dispatches,
        "evictions": sum(1 for e in entries if e["kind"] == "evict"),
        "splices": sum(1 for e in entries if e["kind"] == "splice"),
        "spliced_tokens": sum(
            e.get("spliced_tokens") or 0
            for e in entries if e["kind"] == "splice"
        ),
        "faults": sum(1 for e in entries if e["kind"] == "fault"),
        "restarts": sum(1 for e in entries if e["kind"] == "restart"),
        "tokens_per_dispatch": (
            cost["decode_tokens"] / dispatches if dispatches else 0.0
        ),
        "accepted_per_dispatch": (
            sum(e.get("accepted_tokens") or 0 for e in steps)
            / dispatches if dispatches else 0.0
        ),
    }


# (series, direction, rel_tol): goodput rows judge "higher is better",
# resource rows "lower"; workload-identity rows are informational.
_WHATIF_SERIES = (
    ("requests_finished", "info", 0.0),
    ("requests_ok", "info", 0.0),
    ("completion_tokens", "info", 0.0),
    ("decode_tokens_total", "info", 0.0),
    ("prefill_tokens_total", "info", 0.0),
    ("cached_tokens_total", "higher", 0.05),
    ("spliced_tokens", "higher", 0.05),
    ("decode_steps_total", "lower", 0.05),
    ("dispatches", "lower", 0.05),
    ("tokens_per_dispatch", "higher", 0.05),
    ("accepted_per_dispatch", "higher", 0.05),
    ("peak_pages_max", "lower", 0.05),
    ("evictions", "lower", 0.0),
    ("splices", "info", 0.0),
    ("faults", "info", 0.0),
    ("restarts", "lower", 0.0),
)


def whatif_rows(live_entries: list[dict[str, Any]],
                replay_entries: list[dict[str, Any]]
                ) -> list[dict[str, Any]]:
    """Rows with baseline = the live journal, current = the overridden
    replay, judged by `judge`."""
    base, cur = summarize(live_entries), summarize(replay_entries)
    matched, total, _ = reply_match(live_entries, replay_entries)
    rows = [
        vars(judge(Row(series=series, baseline=base[series],
                       current=cur[series], direction=direction,
                       rel_tol=tol)))
        for series, direction, tol in _WHATIF_SERIES
    ]
    rows.append(vars(Row(
        series="reply_bytes_identical",
        baseline=f"{total}/{total}", current=f"{matched}/{total}",
        direction="info", rel_tol=0.0, verdict="info",
        note="overrides may legally change sampling numerics",
    )))
    return rows


def validate_whatif_report(report: dict[str, Any]) -> list[str]:
    """Schema check of the what-if report; [] when valid."""
    problems = []
    for key in ("bench", "schema", "journal", "overrides", "rows",
                "baseline", "current"):
        if key not in report:
            problems.append(f"missing key {key!r}")
    if report.get("bench") != "replay_whatif":
        problems.append("bench != 'replay_whatif'")
    if report.get("schema") != WHATIF_SCHEMA:
        problems.append(f"schema != {WHATIF_SCHEMA}")
    for i, row in enumerate(report.get("rows") or []):
        missing = [k for k in WHATIF_ROW_KEYS if k not in row]
        if missing:
            problems.append(f"row {i} missing {missing}")
    if not report.get("rows"):
        problems.append("empty rows")
    return problems


def print_diff_table(rows: list[dict[str, Any]]) -> None:
    w = 58

    def fmt(v):
        if isinstance(v, bool):
            return str(v)
        if isinstance(v, (int, float)):
            return f"{v:g}"
        return "-" if v is None else str(v)

    print(f"{'series':<{w}} {'baseline':>12} {'current':>12} "
          f"{'tol':>6}  verdict")
    print("-" * (w + 42))
    for r in rows:
        print(f"{r['series'][:w]:<{w}} {fmt(r['baseline']):>12} "
              f"{fmt(r['current']):>12} {r['rel_tol']:>6g}  "
              f"{r['verdict'].upper()}"
              + (f" ({r['note']})" if r.get("note") else ""))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def parse_overrides(spec: str, base: dict[str, Any]) -> dict[str, Any]:
    """`k=v,k=v` against the OVERRIDE_KEYS whitelist, each value coerced
    to the header field's type."""
    out: dict[str, Any] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if not eq or key not in OVERRIDE_KEYS:
            raise SystemExit(
                f"unknown override {key!r} (allowed: "
                + ", ".join(OVERRIDE_KEYS) + ")"
            )
        out[key] = _coerce(val, base.get(key))
    return out


def _coerce(val: str, current: Any) -> Any:
    low = val.lower()
    if low in ("none", "null", ""):
        return None
    if isinstance(current, bool) or low in ("true", "false"):
        return low in ("1", "true", "yes", "on")
    try:
        return int(val)
    except ValueError:
        return val


def main(argv=None, *, pipe=None) -> int:
    """Replay a journal file: 0 when it reproduces (or a what-if ran), 2
    on a divergence, a timeout, a supervisor give-up or a feed error (1
    for a what-if that timed out). `pipe` overrides the pipeline the
    flags describe."""
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("journal", help="journal file from journal_path (a "
                    "rotated PATH.1 sibling is merged automatically)")
    ap.add_argument("--override", default=None, metavar="K=V[,K=V...]",
                    help="what-if mode: replay under altered flags and "
                    "diff cost/goodput instead of asserting equality "
                    "(keys: " + ", ".join(OVERRIDE_KEYS) + ")")
    ap.add_argument("--model-path", default=None,
                    help="replay against weights written by "
                    "serve/builder.py (default: the tiny config at a "
                    "seeded init with the character tokenizer)")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the device the replay runs on (cpu for the "
                    "plain twins)")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="replay wall-clock budget in seconds")
    ap.add_argument("--out", default=None,
                    help="write the replay/what-if report JSON here")
    args = ap.parse_args(argv)

    header, entries = journal_lib.read_journal(args.journal)
    cfg = header.get("config") or {}
    print(f"journal: {args.journal}")
    print(f"  schema {header.get('schema')}  model "
          f"{cfg.get('model')!r}  engine {cfg.get('engine')!r}  "
          f"entries {len(entries)}")
    print("  geometry: " + " ".join(
        f"{k}={cfg.get(k)}" for k in GEOMETRY_KEYS if k in cfg
    ))
    if cfg.get("faults_spec"):
        print(f"  faults: {cfg['faults_spec']}")
    if pipe is None:
        if args.model_path:
            from oryx_tpu_torch.serve.builder import load_pipeline

            pipe = load_pipeline(args.model_path,
                                 tokenizer_path=args.tokenizer_path,
                                 device=args.device)
        else:
            pipe = build_tiny_pipe(args.device)
    overrides = (
        parse_overrides(args.override, cfg) if args.override else None
    )
    if overrides:
        print("  overrides: " + " ".join(
            f"{k}={v}" for k, v in overrides.items()
        ))
    result = run_replay(header, entries, pipe=pipe, overrides=overrides,
                        timeout_s=args.timeout)
    for rid, why in result["skipped"]:
        print(f"  skipped {rid}: {why}")
    for rid, err in result["feed_errors"]:
        print(f"  feed error {rid}: {err}")
    if result["timed_out"]:
        print(f"REPLAY TIMED OUT after {args.timeout:g}s", file=sys.stderr)
    if result["gave_up"]:
        print("REPLAY SUPERVISOR GAVE UP (crash loop)", file=sys.stderr)

    if overrides:
        rows = whatif_rows(entries, result["entries"])
        print()
        print_diff_table(rows)
        report = {
            "bench": "replay_whatif", "schema": WHATIF_SCHEMA,
            "journal": str(args.journal), "overrides": overrides,
            "baseline": summarize(entries),
            "current": summarize(result["entries"]),
            "rows": rows,
            "skipped": result["skipped"],
            "feed_errors": result["feed_errors"],
        }
        problems = validate_whatif_report(report)
        if problems:
            print("INTERNAL: invalid what-if report: "
                  + "; ".join(problems), file=sys.stderr)
            return 2
        if args.out:
            Path(args.out).write_text(json.dumps(report, indent=2))
            print(f"\nwrote {args.out}")
        return 1 if (result["timed_out"] or result["gave_up"]) else 0

    div = first_divergence(entries, result["entries"])
    matched, total, bad = reply_match(entries, result["entries"])
    n_live = len(replayed_stream(entries))
    print(f"\nreplayed decisions: {n_live} live vs "
          f"{len(replayed_stream(result['entries']))} replay")
    print(f"reply bytes identical: {matched}/{total}"
          + (f"  (mismatched: {', '.join(bad)})" if bad else ""))
    if args.out:
        Path(args.out).write_text(json.dumps({
            "bench": "replay_faithful", "schema": WHATIF_SCHEMA,
            "journal": str(args.journal),
            "replies_matched": matched, "replies_total": total,
            "divergence": div,
            "skipped": result["skipped"],
            "feed_errors": result["feed_errors"],
        }, indent=2))
        print(f"wrote {args.out}")
    if div is not None:
        print("\nFIRST DIVERGENCE:", file=sys.stderr)
        for k in ("index", "seq", "kind", "field", "live", "replay"):
            print(f"  {k:>7}: {div[k]!r}", file=sys.stderr)
        return 2
    if result["timed_out"] or result["gave_up"] or result["feed_errors"]:
        return 2
    print("\nREPLAY OK: byte-identical replies, "
          "decision-for-decision equal, cost ledgers equal")
    return 0
