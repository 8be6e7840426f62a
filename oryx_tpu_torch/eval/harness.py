"""Benchmark evaluation harness: multiple-choice / open-ended QA over media
(port of `oryx_tpu.eval.harness`):

    python -m oryx_tpu_torch.eval.harness --model-path DIR --task f.jsonl \
        [--media-root M] [--device cpu] ...

The reference evaluates through the external lmms-eval harness (VideoMME,
MLVU, MVBench, NextQA, ...): an adapter wraps the inference stack and the
harness aggregates accuracy, optionally splitting the dataset across ranks
with each rank running an independent replica. This module is that harness
over the port's `Pipeline`: a task is a JSON/JSONL (or CSV, e.g. NextQA's
annotations) file of records

    {"id": ..., "question": ..., "options": ["...", ...] | null,
     "answer": "B" | "<free text>", "image": path|[paths] | "video": dir}

multiple-choice records are scored by option-letter match (lmms-eval's MCQ
protocol: the prompt lists lettered options, the reply's first letter in
range counts); open-ended records by normalized exact match. A video is a
directory of frames (data/media.py).

`--shard tp=N` evaluates through a tensor-parallel pipeline over N ranks
this process starts (parallel/), `--shard fsdp=N` through one whose ranks
each hold a shard of every layer, gathered as the layer runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import string
import sys
import time
from typing import Any, Sequence

from oryx_tpu_torch.data import media
from oryx_tpu_torch.serve.pipeline import Pipeline

LETTERS = string.ascii_uppercase

MCQ_SUFFIX = "Answer with the option's letter from the given choices directly."


def load_task(path: str) -> list[dict[str, Any]]:
    """Load a task file: .jsonl (one record per line), .json (list), or
    .csv (header row → dict per row; NextQA ships its MC annotations as
    CSV)."""
    with open(path, newline="") as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        if path.endswith(".csv"):
            import csv

            return list(csv.DictReader(f))
        recs = json.load(f)
    if not isinstance(recs, list):
        raise ValueError(f"{path}: expected a list of records")
    return recs


def format_question(rec: dict[str, Any]) -> str:
    opts = rec.get("options")
    if not opts:
        return rec["question"]
    lines = [rec["question"]] + [
        f"{LETTERS[i]}. {o}" for i, o in enumerate(opts)
    ]
    lines.append(MCQ_SUFFIX)
    return "\n".join(lines)


def _norm(s: str) -> str:
    return re.sub(r"\s+", " ", s.strip().lower().strip(".,!?\"'"))


def parse_choice(
    reply: str, num_options: int, options: Sequence[str] | None = None
) -> str | None:
    """Extract the chosen option letter from a model reply.

    Ordered by confidence (the lmms-eval MCQ protocol shape): a bare
    letter reply; "answer is X" / "(X)" / "X." forms; unique option-text
    containment; finally a standalone letter — but never the bare English
    articles "A"/"I" inside prose, which are words, not choices."""
    up = reply.strip().upper()
    valid = LETTERS[:num_options]
    if re.fullmatch(rf"\(?([{valid}])\)?[.,:)]?", up):
        return re.fullmatch(rf"\(?([{valid}])\)?[.,:)]?", up).group(1)
    m = re.search(rf"ANSWER\s*(?:IS|:)?\s*\(?([{valid}])\b", up)
    if m:
        return m.group(1)
    m = re.search(rf"\(([{valid}])\)|\b([{valid}])[.,:)]", up)
    if m:
        return m.group(1) or m.group(2)
    if options:
        nr = _norm(reply)
        hits = [
            i for i, o in enumerate(options)
            if _norm(str(o))
            and re.search(rf"\b{re.escape(_norm(str(o)))}\b", nr)
        ]
        if len(hits) == 1:
            return LETTERS[hits[0]]
    # Standalone letter anywhere — excluding the article/pronoun words.
    for m in re.finditer(rf"\b([{valid}])\b", up):
        if m.group(1) not in ("A", "I"):
            return m.group(1)
    return None


def score_record(rec: dict[str, Any], reply: str) -> bool:
    opts = rec.get("options")
    ans = rec["answer"]
    if opts:
        if isinstance(ans, int):
            ans = LETTERS[ans]
        return parse_choice(reply, len(opts), opts) == str(ans).strip().upper()
    return _norm(reply) == _norm(str(ans))


def eval_length_proxy(rec: dict[str, Any]) -> int:
    """Cheap per-record length proxy WITHOUT loading media. Delegates to
    train/data.length_estimate (the single owner of the per-visual token
    allowances) over a synthesized training-shaped record, so eval batch
    grouping can never drift from the training sampler's notion of
    length."""
    from oryx_tpu_torch.train.data import length_estimate

    return length_estimate({
        "conversations": [{"value": format_question(rec)}],
        "image": rec.get("image"),
        "video": rec.get("video"),
    })


def _modality_key(rec: dict[str, Any]) -> str:
    """Batch-composition key: video / multi-image / image / text rows
    have wildly different visual-buffer shapes — keeping them apart means
    batches share patch buckets, not just sequence buckets. Text-only
    gets its own bucket on top of train/data.record_modality (training
    records always carry media; eval ones may not)."""
    if not rec.get("video") and not rec.get("image"):
        return "text"
    from oryx_tpu_torch.train.data import record_modality

    return record_modality(rec)


@dataclasses.dataclass
class EvalResult:
    accuracy: float
    num_correct: int
    num_total: int
    seconds: float
    records: list[dict[str, Any]]

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def evaluate(
    pipe: Pipeline,
    records: Sequence[dict[str, Any]],
    *,
    media_root: str = "",
    num_frames: int = 64,
    max_new_tokens: int = 16,
    process_index: int = 0,
    process_count: int = 1,
    log_every: int = 25,
    batch_size: int = 8,
    length_group: bool = True,
    scoring: str = "generate",
) -> EvalResult:
    """Run the inference stack over a record shard and score it.

    Dataset sharding mirrors the reference's accelerate-split eval: record
    i belongs to process i mod process_count; the
    caller merges per-process results (accuracy is weighted by num_total).
    Records are batched `batch_size` at a time through `pipe.chat_batch`
    (one ViT/compressor/decode program per batch). Host memory holds the
    whole batch's raw frames at once (batch_size × num_frames ×
    native-resolution); lower batch_size for high-res long-video tasks.

    length_group (default on) sorts the shard by (modality, length proxy)
    before batching — chat_batch pads every row to the batch-max bucket,
    so mixed-length batches otherwise pay worst-row padding (the
    training side's LengthGroupedSampler, applied to eval). Record
    ORDER in the output changes but ids/scoring don't.

    scoring="loglikelihood" (lmms-eval's second model API): MCQ records
    are scored by the option LETTER with the highest teacher-forced
    log-probability (`pipe.score_options` — one visual prefill + one
    tiny forward per option, no sampling variance); records without
    options still generate. "generate" (default) decodes a reply and
    parses the letter, the lmms-eval `generate_until` protocol.
    """
    if scoring not in ("generate", "loglikelihood"):
        raise ValueError(f"scoring={scoring!r}: generate|loglikelihood")
    t0 = time.perf_counter()
    out: list[dict[str, Any]] = []
    correct = 0
    # Fallback ids use the GLOBAL record index so merged per-process
    # results stay distinguishable.
    mine = [
        (i, r, eval_length_proxy(r)) for i, r in enumerate(records)
        if i % process_count == process_index
    ]
    if length_group:
        mine.sort(key=lambda t: (_modality_key(t[1]), t[2]))
    pad_waste = 0  # proxy tokens spent on per-batch padding
    batch_size = max(1, batch_size)
    for b0 in range(0, len(mine), batch_size):
        group = mine[b0 : b0 + batch_size]
        requests = []
        for gi, rec, _ in group:
            frames, is_video = media.load_record_media(
                rec, media_root=media_root, num_frames=num_frames
            )
            requests.append({
                "question": format_question(rec),
                "images": frames,
                "is_video": is_video,
            })
        if scoring == "loglikelihood":
            replies: list[str | None] = [None] * len(group)
            open_idx = [
                i for i, (_, rec, _) in enumerate(group)
                if not rec.get("options")
            ]
            # Only the decoded (optionless) rows pay batch padding here;
            # MCQ rows score per-record with no padded batch at all.
            open_prox = [group[i][2] for i in open_idx]
            if open_prox:
                pad_waste += sum(max(open_prox) - p for p in open_prox)
            if open_idx:  # optionless records still BATCH their decode
                open_replies = pipe.chat_batch(
                    [requests[i] for i in open_idx],
                    max_new_tokens=max_new_tokens,
                )
                for i, r in zip(open_idx, open_replies):
                    replies[i] = r
            for i, (req, (_, rec, _)) in enumerate(zip(requests, group)):
                opts = rec.get("options")
                if opts:
                    scores = pipe.score_options(
                        req["question"], LETTERS[: len(opts)],
                        images=req["images"], is_video=req["is_video"],
                    )
                    replies[i] = LETTERS[int(scores.argmax())]
        else:
            proxies = [p for _, _, p in group]
            pad_waste += sum(max(proxies) - p for p in proxies)
            replies = pipe.chat_batch(
                requests, max_new_tokens=max_new_tokens
            )
        for (gi, rec, _), reply in zip(group, replies):
            ok = score_record(rec, reply)
            correct += ok
            row = {"id": rec.get("id", gi), "reply": reply, "correct": ok}
            if rec.get("meta"):
                # Adapter-provided tags (duration, question_type, ...)
                # ride along for per-category accuracy breakdowns.
                row["meta"] = rec["meta"]
            out.append(row)
        n = len(out)
        if log_every and (n % log_every < len(group) or n == len(mine)):
            print(f"[eval] {n}/{len(mine)} acc={correct / n:.4f}", flush=True)
    dt = time.perf_counter() - t0
    if log_every and mine:
        print(f"[eval] pad_waste={pad_waste} proxy tokens "
              f"(length_group={'on' if length_group else 'off'})",
              flush=True)
    acc = correct / max(len(mine), 1)
    return EvalResult(acc, correct, len(mine), dt, out)


def merge_results(results: Sequence[EvalResult]) -> EvalResult:
    """Merge per-process shard results (the reference's accelerate-split
    eval aggregation): accuracy re-derived from summed counts, wall time =
    max over processes (they run concurrently), records concatenated."""
    if not results:
        raise ValueError("no results to merge")
    correct = sum(r.num_correct for r in results)
    total = sum(r.num_total for r in results)
    return EvalResult(
        accuracy=correct / max(total, 1),
        num_correct=correct,
        num_total=total,
        seconds=max(r.seconds for r in results),
        records=[rec for r in results for rec in r.records],
    )


def breakdown(result: EvalResult, key: str) -> dict[str, dict[str, Any]]:
    """Per-category accuracy over a meta tag (lmms-eval's per-split
    reporting: VideoMME by `duration`, MLVU/NextQA by question type).
    Records without the tag land under "<untagged>"."""
    groups: dict[str, list[int]] = {}
    for r in result.records:
        cat = str((r.get("meta") or {}).get(key, "<untagged>"))
        g = groups.setdefault(cat, [0, 0])
        g[0] += bool(r["correct"])
        g[1] += 1
    return {
        cat: {"accuracy": c / max(n, 1), "n": n}
        for cat, (c, n) in sorted(groups.items())
    }


def _print_summary(result: EvalResult, by: list[str] | None = None) -> None:
    rec: dict[str, Any] = {
        "accuracy": result.accuracy, "n": result.num_total,
        "seconds": round(result.seconds, 1),
    }
    for key in by or []:
        rec[f"by_{key}"] = breakdown(result, key)
    print(json.dumps(rec))


def _write_output(result: EvalResult, path: str) -> None:
    outdir = os.path.dirname(os.path.abspath(path))
    os.makedirs(outdir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(result.to_dict(), f, indent=2)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    # Merge mode is parsed by a dedicated pre-parser so --merge=FILE and
    # abbreviations work, and any flag it doesn't know is an error rather
    # than silently dropped.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--merge", nargs="+", default=None)
    pre.add_argument("--output", default=None)
    pre.add_argument("--by", nargs="+", default=None)
    pre_args, rest = pre.parse_known_args(argv)
    if pre_args.merge is not None:
        if rest:
            raise SystemExit(
                f"unrecognized arguments with --merge: {rest}"
            )
        merged = merge_results([
            EvalResult(**json.load(open(p))) for p in pre_args.merge
        ])
        _print_summary(merged, by=pre_args.by)
        if pre_args.output:
            _write_output(merged, pre_args.output)
        return

    ap = argparse.ArgumentParser(
        description="Oryx benchmark eval (PyTorch/CUDA port)")
    ap.add_argument(
        "--merge", nargs="+", default=None, metavar="RESULTS_JSON",
        help="merge per-process result files (from --output) and exit",
    )
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument(
        "--task", required=True, help="task .json/.jsonl/.csv file"
    )
    ap.add_argument(
        "--format", default="native",
        help="task record format: native|videomme|mlvu|mvbench|nextqa",
    )
    ap.add_argument("--media-root", default="")
    ap.add_argument(
        "--by", nargs="+", default=None, metavar="META_KEY",
        help="per-category accuracy breakdown over adapter meta tags "
        "(e.g. --by duration task_type)",
    )
    ap.add_argument("--num-frames", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--output", default=None, help="results json path")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument(
        "--no-length-group", action="store_true",
        help="keep dataset order instead of sorting batches by "
        "(modality, length) — more padding, reproducible order",
    )
    ap.add_argument(
        "--scoring", default="generate",
        choices=["generate", "loglikelihood"],
        help="MCQ protocol: decode-and-parse the letter (generate) or "
        "pick the letter with the highest teacher-forced log-prob "
        "(loglikelihood; lmms-eval's second model API)",
    )
    ap.add_argument("--process-index", type=int, default=0)
    ap.add_argument("--process-count", type=int, default=1)
    ap.add_argument(
        "--shard", default=None, metavar="MODE=N",
        help="multi-chip serving (tp=N or fsdp=N) for models that exceed "
        "one chip",
    )
    ap.add_argument(
        "--quantize", default=None, choices=["int8"],
        help="weight-only int8 for single-chip serving",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.quantize and args.shard:
        ap.error("--quantize is single-chip serving; drop --shard")

    from oryx_tpu_torch.eval.adapters import adapt
    from oryx_tpu_torch.serve import builder

    pipe = builder.shard_pipeline(
        args.model_path, args.shard, tokenizer_path=args.tokenizer_path,
        quantize=args.quantize, device=args.device,
    )
    records = adapt(args.format, load_task(args.task))
    result = evaluate(
        pipe, records,
        media_root=args.media_root, num_frames=args.num_frames,
        max_new_tokens=args.max_new_tokens, batch_size=args.batch_size,
        process_index=args.process_index, process_count=args.process_count,
        length_group=not args.no_length_group,
        scoring=args.scoring,
    )
    _print_summary(result, by=args.by)
    if args.output:
        _write_output(result, args.output)


if __name__ == "__main__":
    main()
