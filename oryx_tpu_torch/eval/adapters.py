"""Benchmark-format adapters: VideoMME / MLVU / MVBench / NExT-QA ->
harness records (port of `oryx_tpu.eval.adapters`, host code, copied).

The reference evaluates through lmms-eval task configs, each of which maps
a benchmark's native record layout onto the same prompt shape (question +
lettered options + "answer with the letter"). These adapters do that
mapping onto `eval.harness`'s record schema:

    {"id", "question", "options": [...], "answer": "B", "video"|"image"}

so `python -m oryx_tpu_torch.eval.harness --task f.json --format videomme
...` runs the benchmark from its published annotation file (the port reads
a video as a directory of frames: point `video_root` at extracted frames).
"""

from __future__ import annotations

import os
import re
import string
from typing import Any, Callable

LETTERS = string.ascii_uppercase

_OPT_PREFIX = re.compile(r"^\(?([A-Z])[.):]\s*")


def _strip_option(opt: str) -> str:
    """Drop a leading "A. " / "(B) " letter prefix from an option string."""
    return _OPT_PREFIX.sub("", str(opt).strip())


def _answer_letter(answer: Any, options: list[str]) -> str:
    """Normalize an answer (letter, index, or full option text) to a letter."""
    if isinstance(answer, int):
        return LETTERS[answer]
    a = str(answer).strip()
    if len(a) == 1 and a.upper() in LETTERS[: len(options)]:
        return a.upper()
    m = _OPT_PREFIX.match(a)
    if m and m.group(1) in LETTERS[: len(options)]:
        return m.group(1)
    stripped = [_strip_option(o).lower() for o in options]
    key = _strip_option(a).lower()
    if key in stripped:
        return LETTERS[stripped.index(key)]
    raise ValueError(f"cannot map answer {answer!r} onto options {options!r}")


def from_videomme(
    recs: list[dict[str, Any]], *, video_root: str = "", video_ext: str = ".mp4"
) -> list[dict[str, Any]]:
    """Video-MME annotations: lettered `options` strings, letter `answer`,
    videos addressed by `videoID`."""
    out = []
    for r in recs:
        opts = [_strip_option(o) for o in r["options"]]
        vid = r.get("videoID") or r.get("video_id") or r["video"]
        video = vid if vid.endswith(video_ext) else vid + video_ext
        out.append({
            "id": r.get("question_id", vid),
            "question": r["question"],
            "options": opts,
            "answer": _answer_letter(r["answer"], [str(o) for o in r["options"]]),
            "video": os.path.join(video_root, video) if video_root else video,
            "meta": {
                k: r[k]
                for k in ("duration", "domain", "sub_category", "task_type")
                if k in r
            },
        })
    return out


def from_mlvu(
    recs: list[dict[str, Any]], *, video_root: str = ""
) -> list[dict[str, Any]]:
    """MLVU annotations: `candidates` option texts, full-text `answer`,
    `video` relative path, `question_type` task tag."""
    out = []
    for i, r in enumerate(recs):
        opts = [str(c) for c in r["candidates"]]
        video = r["video"]
        out.append({
            "id": r.get("question_id", i),
            "question": r["question"],
            "options": opts,
            "answer": _answer_letter(r["answer"], opts),
            "video": os.path.join(video_root, video) if video_root else video,
            "meta": {
                k: r[k] for k in ("question_type", "duration") if k in r
            },
        })
    return out


# MVBench annotations are MLVU-shaped (`candidates` + full-text `answer`,
# `video` relative to the per-task video dir) — same mapping applies.
from_mvbench = from_mlvu


def from_nextqa(
    recs: list[dict[str, Any]], *, video_root: str = "", video_ext: str = ".mp4"
) -> list[dict[str, Any]]:
    """NExT-QA multiple-choice annotations (the CSV rows of val.csv /
    test.csv): option texts in columns a0..a4, integer `answer` index,
    videos addressed by numeric `video` id."""
    out = []
    for r in recs:
        opts = [str(r[f"a{i}"]) for i in range(5) if f"a{i}" in r]
        vid = str(r["video"])
        video = vid if vid.endswith(video_ext) else vid + video_ext
        out.append({
            "id": f"{vid}_{r.get('qid', len(out))}",
            "question": r["question"],
            "options": opts,
            # CSV rows arrive as strings; the answer column is the index.
            "answer": LETTERS[int(r["answer"])],
            "video": os.path.join(video_root, video) if video_root else video,
            "meta": {k: r[k] for k in ("type", "frame_count") if k in r},
        })
    return out


ADAPTERS: dict[str, Callable[..., list[dict[str, Any]]]] = {
    "videomme": from_videomme,
    "mlvu": from_mlvu,
    "mvbench": from_mvbench,
    "nextqa": from_nextqa,
}


def adapt(
    fmt: str, recs: list[dict[str, Any]], *, video_root: str = ""
) -> list[dict[str, Any]]:
    """Apply a named adapter; fmt="native" returns records unchanged."""
    if fmt in (None, "", "native"):
        return recs
    if fmt not in ADAPTERS:
        raise ValueError(f"unknown format {fmt!r}; have {sorted(ADAPTERS)}")
    return ADAPTERS[fmt](recs, video_root=video_root)
