"""The port's eval harness and adapters (oryx_tpu_torch/eval/) against the
JAX package on the CPU:

  * the MCQ formatting, parsing, scoring, task loading, length proxy,
    modality key, merge and breakdown, and every adapter: the same outputs
    as JAX's on the same inputs (tests/test_eval.py's cases);
  * `evaluate` over the port's `Pipeline` against JAX's `evaluate` over
    `OryxInference` on the same weights (tests/torch_serve_common.py), in
    both scoring modes, over image, video, text-only and open-ended
    records: the records (replies, letters, `correct`, `meta`), accuracy
    and the printed `[eval]` lines (pad_waste included) byte-equal;
  * `main` on the committed smoke benchmark (assets/smoke_eval) from a
    tiny `save_pretrained` directory, the tokenizer through the builder's
    seam: its result file's records equal JAX's `evaluate` on the same
    weights; `--merge`, `--by`, `--output`, `--quantize int8`, and
    `--shard fsdp=N` raising.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oryx_tpu.eval import adapters as jadapters  # noqa: E402
from oryx_tpu.eval import harness as jharness  # noqa: E402
from oryx_tpu_torch.data import media  # noqa: E402
from oryx_tpu_torch.eval import adapters, harness  # noqa: E402
from oryx_tpu_torch.serve import builder  # noqa: E402
from torch_serve_common import CharTokenizer, image, make_pipes  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "smoke_eval")


@pytest.fixture(scope="module")
def pipes():
    return make_pipes()


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


# ---- host functions, against JAX's ---------------------------------------------


@pytest.mark.parametrize("rec", [
    {"question": "What?", "options": ["cat", "dog"], "answer": "B"},
    {"question": "Describe.", "answer": "a cat"},
])
def test_format_question(rec):
    q = harness.format_question(rec)
    assert q == jharness.format_question(rec)
    if rec.get("options"):
        assert "A. cat" in q and "B. dog" in q and harness.MCQ_SUFFIX in q
    else:
        assert q == "Describe."


@pytest.mark.parametrize("reply,expect", [
    ("B", "B"), ("B.", "B"), ("(A)", "A"), ("The answer is C", "C"),
    ("Zebra", None), ("", None),
])
def test_parse_choice(reply, expect):
    assert harness.parse_choice(reply, 4) == expect
    assert jharness.parse_choice(reply, 4) == expect


def test_parse_choice_prose_article_not_a_choice():
    opts = ["dog on a rug", "cat on a mat", "bird", "fish"]
    for lib in (harness, jharness):
        assert lib.parse_choice("A cat on a mat is shown", 4, opts) == "B"
        assert lib.parse_choice("A dog maybe", 2, ["x", "y"]) is None


def test_natural_frame_sort(tmp_path):
    for i in (1, 2, 10, 11):
        _png(tmp_path / f"frame_{i}.png",
             np.full((4, 4, 3), i, dtype=np.uint8))
    frames = media.load_video_frames(str(tmp_path), 4)
    assert [int(f[0, 0, 0]) for f in frames] == [1, 2, 10, 11]


def test_score_record_mcq_and_open():
    cases = [
        ({"question": "?", "options": ["x", "y"], "answer": "B"}, "B. y"),
        ({"question": "?", "options": ["x", "y"], "answer": "B"}, "A"),
        ({"question": "?", "options": ["x", "y"], "answer": 1},
         "the answer is B"),
        ({"question": "?", "answer": "A Cat."}, " a cat"),
        ({"question": "?", "answer": "A Cat."}, "a dog"),
    ]
    got = [harness.score_record(r, reply) for r, reply in cases]
    assert got == [True, False, True, True, False]
    assert got == [jharness.score_record(r, reply) for r, reply in cases]


def test_load_task_json_jsonl_csv(tmp_path):
    recs = [{"id": 1, "question": "q", "answer": "a"}]
    pj = tmp_path / "t.json"
    pj.write_text(json.dumps(recs))
    pl = tmp_path / "t.jsonl"
    pl.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    pc = tmp_path / "t.csv"
    pc.write_text("id,question,answer\n1,q,a\n")
    for p in (pj, pl, pc):
        assert harness.load_task(str(p)) == jharness.load_task(str(p))
    assert harness.load_task(str(pj)) == harness.load_task(str(pl)) == recs
    (tmp_path / "bad.json").write_text("{}")
    with pytest.raises(ValueError, match="list of records"):
        harness.load_task(str(tmp_path / "bad.json"))


def test_modality_key_and_proxy():
    recs = [{"video": "v.mp4"}, {"image": ["a", "b"]}, {"image": "a"},
            {"question": "q"}]
    assert [harness._modality_key(r) for r in recs] == \
        ["video", "multi_image", "image", "text"]
    assert [harness._modality_key(r) for r in recs] == \
        [jharness._modality_key(r) for r in recs]
    proxies = [{"question": "q", "answer": "x"},
               {"question": "q " * 50, "answer": "x"},
               {"question": "q", "answer": "x", "video": "v.mp4"},
               {"question": "q", "options": ["a", "b"], "image": ["x", "y"]}]
    got = [harness.eval_length_proxy(r) for r in proxies]
    assert got == [jharness.eval_length_proxy(r) for r in proxies]
    assert got[0] < got[1] < got[2]


def test_adapters_videomme():
    recs = [{
        "question_id": "q1", "videoID": "vid001", "question": "What?",
        "options": ["A. cat", "B. dog", "C. bird", "D. fish"],
        "answer": "B", "duration": "short", "domain": "x",
    }]
    out = adapters.adapt("videomme", recs, video_root="/data/videos")
    assert out == jadapters.adapt("videomme", recs, video_root="/data/videos")
    r = out[0]
    assert r["video"] == "/data/videos/vid001.mp4"
    assert r["options"] == ["cat", "dog", "bird", "fish"]
    assert r["answer"] == "B" and r["meta"]["duration"] == "short"


def test_adapters_mlvu_text_answer():
    recs = [{
        "question": "Pick.", "candidates": ["red", "green", "blue"],
        "answer": "green", "video": "clips/v.mp4", "question_type": "topic",
    }]
    r = adapters.adapt("mlvu", recs)[0]
    assert r == jadapters.adapt("mlvu", recs)[0]
    assert r["answer"] == "B" and r["video"] == "clips/v.mp4"


def test_adapters_mvbench_and_unknown():
    recs = [{"question": "?", "candidates": ["x", "y"], "answer": "x",
             "video": "v.mp4"}]
    assert adapters.adapt("mvbench", recs) == jadapters.adapt("mvbench", recs)
    assert adapters.adapt("mvbench", recs)[0]["answer"] == "A"
    assert adapters.adapt("native", recs) == recs
    with pytest.raises(ValueError) as te:
        adapters.adapt("nope", recs)
    with pytest.raises(ValueError) as je:
        jadapters.adapt("nope", recs)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="cannot map answer"):
        adapters.adapt("mlvu", [dict(recs[0], answer="z")])


def test_adapters_nextqa_csv(tmp_path):
    csv_path = tmp_path / "val.csv"
    csv_path.write_text(
        "video,frame_count,width,height,question,answer,qid,type,"
        "a0,a1,a2,a3,a4\n"
        "3238737531,1528,640,480,how do the two man play the instrument,"
        "1,6,CH,roll the handle,tap their feet,strum the string,"
        "hit with sticks,pat with hand\n"
    )
    recs = harness.load_task(str(csv_path))
    out = adapters.adapt("nextqa", recs, video_root="/data/nextqa")
    assert out == jadapters.adapt("nextqa", recs, video_root="/data/nextqa")
    r = out[0]
    assert r["id"] == "3238737531_6" and r["answer"] == "B"
    assert r["options"][2] == "strum the string"
    assert r["video"] == "/data/nextqa/3238737531.mp4"
    assert r["meta"]["type"] == "CH"


def test_breakdown_by_meta():
    rows = [
        {"id": 0, "correct": True, "meta": {"duration": "short"}},
        {"id": 1, "correct": False, "meta": {"duration": "short"}},
        {"id": 2, "correct": True, "meta": {"duration": "long"}},
        {"id": 3, "correct": False},
    ]
    by = harness.breakdown(harness.EvalResult(0.5, 2, 4, 1.0, rows),
                           "duration")
    assert by == jharness.breakdown(jharness.EvalResult(0.5, 2, 4, 1.0, rows),
                                    "duration")
    assert by["short"] == {"accuracy": 0.5, "n": 2}
    assert by["<untagged>"]["n"] == 1


def test_merge_results():
    a = harness.EvalResult(0.5, 2, 4, 10.0, [{"id": 0}, {"id": 2}])
    b = harness.EvalResult(1.0, 3, 3, 12.0, [{"id": 1}])
    m = harness.merge_results([a, b])
    want = jharness.merge_results([
        jharness.EvalResult(**a.to_dict()), jharness.EvalResult(**b.to_dict())
    ])
    assert m.to_dict() == want.to_dict()
    assert m.num_correct == 5 and m.num_total == 7 and m.seconds == 12.0
    with pytest.raises(ValueError):
        harness.merge_results([])


def test_merge_cli(tmp_path, capsys):
    paths = []
    for i, r in enumerate((harness.EvalResult(0.5, 1, 2, 3.0, [{"id": 0}]),
                           harness.EvalResult(1.0, 2, 2, 4.0, [{"id": 1}]))):
        paths.append(str(tmp_path / f"{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(r.to_dict(), f)
    lines = []
    for lib in (harness, jharness):
        lib.main(["--merge", *paths])
        lines.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert lines[0] == lines[1]
    out = json.loads(lines[0])
    assert out["n"] == 4 and out["accuracy"] == pytest.approx(0.75)


def test_merge_cli_equals_form_and_output(tmp_path, capsys):
    a = harness.EvalResult(1.0, 2, 2, 1.0, [{"id": 0}, {"id": 1}])
    pa = str(tmp_path / "a.json")
    with open(pa, "w") as f:
        json.dump(a.to_dict(), f)
    out_path = str(tmp_path / "nested" / "merged.json")
    harness.main([f"--merge={pa}", "--output", out_path])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["n"] == 2
    with open(out_path) as f:
        assert len(json.load(f)["records"]) == 2
    with pytest.raises(SystemExit):
        harness.main(["--merge", pa, "--bogus-flag"])


# ---- evaluate over the port's Pipeline, against JAX's -------------------------------


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("media")
    _png(d / "a.png", image(1))
    _png(d / "b.png", image(2, 28, 42))
    os.makedirs(d / "clip")
    for f in range(3):
        _png(d / "clip" / f"frame_{f}.png", image(10 + f, 28, 28))
    return d


def _records():
    return [
        {"id": "i0", "question": "Which animal?",
         "options": ["cat", "dog", "bird"], "answer": "A", "image": "a.png",
         "meta": {"kind": "image"}},
        {"id": "i1", "question": "Which color?", "options": ["red", "blue"],
         "answer": "B", "image": ["a.png", "b.png"]},
        {"id": "v0", "question": "What moves?",
         "options": ["a boat", "a car", "a gull", "nothing"], "answer": "C",
         "video": "clip", "meta": {"kind": "video"}},
        {"id": "t0", "question": "why? " * 12, "options": ["x", "y"],
         "answer": 0},
        {"id": "o0", "question": "Say something.", "answer": "anything"},
        {"id": "o1", "question": "Name it.", "answer": "Cat.",
         "image": "b.png"},
    ]


@pytest.mark.parametrize("scoring", ["generate", "loglikelihood"])
def test_evaluate_matches_jax(pipes, media_dir, capsys, scoring):
    jpipe, tpipe = pipes
    kw = dict(media_root=str(media_dir), num_frames=2, max_new_tokens=4,
              batch_size=3, log_every=2, scoring=scoring)
    got = harness.evaluate(tpipe, _records(), **kw)
    tlines = [x for x in capsys.readouterr().out.splitlines()
              if x.startswith("[eval]")]
    want = jharness.evaluate(jpipe, _records(), **kw)
    jlines = [x for x in capsys.readouterr().out.splitlines()
              if x.startswith("[eval]")]
    assert json.dumps(got.records) == json.dumps(want.records)
    assert (got.accuracy, got.num_correct, got.num_total) == \
        (want.accuracy, want.num_correct, want.num_total)
    assert tlines == jlines and any("pad_waste=" in x for x in tlines)
    if scoring == "loglikelihood":
        by_id = {r["id"]: r["reply"] for r in got.records}
        assert by_id["i0"] in "ABC" and by_id["t0"] in "AB"
    # Deterministic: a second call gives the same records.
    again = harness.evaluate(tpipe, _records(), **kw)
    assert json.dumps(again.records) == json.dumps(got.records)


def test_evaluate_shards_and_meta(pipes, media_dir):
    _, tpipe = pipes
    recs = _records()[:4]
    kw = dict(media_root=str(media_dir), num_frames=2, max_new_tokens=2,
              log_every=0)
    whole = harness.evaluate(tpipe, recs, **kw)
    assert whole.num_total == 4 and 0.0 <= whole.accuracy <= 1.0
    shards = [harness.evaluate(tpipe, recs, process_index=i, process_count=2,
                               **kw) for i in range(2)]
    assert sum(s.num_total for s in shards) == 4
    merged = harness.merge_results(shards)
    assert sorted(r["id"] for r in merged.records) == \
        sorted(r["id"] for r in whole.records)
    by_id = {r["id"]: r for r in whole.records}
    assert by_id["i0"]["meta"] == {"kind": "image"}
    assert "meta" not in by_id["i1"]
    assert harness.breakdown(whole, "kind")["video"]["n"] == 1
    with pytest.raises(ValueError, match="scoring"):
        harness.evaluate(tpipe, recs, scoring="bogus")


def test_length_grouping_cuts_padding(pipes, capsys):
    """Alternating short/long text records: dataset order puts one of each
    in every batch of 2; sorting pairs them (JAX's case) and scoring is
    unchanged."""
    _, tpipe = pipes
    records = [{"id": i, "question": ("why? " * (40 if i % 2 else 1)).strip(),
                "options": ["cat", "dog"], "answer": "A"} for i in range(8)]

    def run(length_group):
        res = harness.evaluate(tpipe, records, batch_size=2,
                               max_new_tokens=2, log_every=1,
                               length_group=length_group)
        out = capsys.readouterr().out
        return res, int(out.split("pad_waste=")[1].split()[0])

    plain, waste_plain = run(False)
    grouped, waste_grouped = run(True)
    assert waste_grouped == 0 < waste_plain
    assert grouped.num_total == plain.num_total == 8
    by_id = lambda r: {rec["id"]: rec["correct"] for rec in r.records}  # noqa: E731
    assert by_id(grouped) == by_id(plain)


def test_score_options_with_image_matches_jax(pipes):
    jpipe, tpipe = pipes
    img = image(2, 30, 40)
    got = tpipe.score_options("what?", ["A", "B", "C"], images=[img])
    want = jpipe.score_options("what?", ["A", "B", "C"], images=[img])
    assert got.shape == (3,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


# ---- the committed smoke benchmark through main -----------------------------


def test_committed_task_schema():
    task = os.path.join(ASSETS, "task.jsonl")
    records = harness.load_task(task)
    assert records == jharness.load_task(task)
    assert len(records) == 8
    assert {r["meta"]["kind"] for r in records} == {"image", "video"}
    for r in records:
        assert r["answer"] in "ABCD" and len(r["options"]) == 4
        frames, is_video = media.load_record_media(r, media_root=ASSETS,
                                                   num_frames=4)
        assert len(frames) == (4 if is_video else 1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, pipes):
    """The pipes' weights as a save_pretrained directory."""
    _, tpipe = pipes
    d = str(tmp_path_factory.mktemp("model"))
    builder.save_pretrained(d, tpipe.cfg, tpipe.params)
    return d


@pytest.mark.parametrize("scoring", ["generate", "loglikelihood"])
def test_smoke_eval_main_matches_jax(tmp_path, capsys, monkeypatch, pipes,
                                     model_dir, scoring):
    jpipe, _ = pipes
    monkeypatch.setattr(builder, "load_tokenizer",
                        lambda path: CharTokenizer())
    out = tmp_path / "result.json"
    harness.main([
        "--model-path", model_dir, "--task",
        os.path.join(ASSETS, "task.jsonl"), "--media-root", ASSETS,
        "--num-frames", "4", "--max-new-tokens", "4", "--by", "kind",
        "--output", str(out), "--scoring", scoring, "--device", "cpu",
    ])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n"] == 8 and set(summary["by_kind"]) == {"image", "video"}
    result = json.loads(out.read_text())
    assert result["num_total"] == 8
    assert {r["id"] for r in result["records"]} == \
        {f"smoke-{i}" for i in range(8)}
    want = jharness.evaluate(
        jpipe, jharness.load_task(os.path.join(ASSETS, "task.jsonl")),
        media_root=ASSETS, num_frames=4, max_new_tokens=4, log_every=0,
        scoring=scoring)
    assert result["records"] == want.records
    assert result["accuracy"] == want.accuracy


def test_main_quantize_int8_and_shard(tmp_path, capsys, monkeypatch,
                                      model_dir):
    monkeypatch.setattr(builder, "load_tokenizer",
                        lambda path: CharTokenizer())
    base = ["--model-path", model_dir, "--task",
            os.path.join(ASSETS, "task.jsonl"), "--media-root", ASSETS,
            "--num-frames", "2", "--max-new-tokens", "2", "--device", "cpu"]
    harness.main(base + ["--quantize", "int8"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n"] == 8
    # tp=N and fsdp=N run in test_torch_tp_serving / test_torch_fsdp_serving;
    # with int8 weights either is an argument error.
    with pytest.raises(SystemExit):
        harness.main(base + ["--shard", "fsdp=2", "--quantize", "int8"])
    with pytest.raises(SystemExit):
        harness.main(base + ["--shard", "tp=2", "--quantize", "int8"])


def test_main_without_card_raises(monkeypatch, model_dir):
    """The entry point serves on the card unless --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(builder, "load_tokenizer",
                        lambda path: CharTokenizer())
    with pytest.raises(RuntimeError, match="cuda"):
        harness.main(["--model-path", model_dir, "--task",
                      os.path.join(ASSETS, "task.jsonl")])


def test_eval_result_fields_are_jax():
    """EvalResult is JAX's dataclass field for field (merge reads the JSON
    either package writes)."""
    assert [f.name for f in dataclasses.fields(harness.EvalResult)] == \
        [f.name for f in dataclasses.fields(jharness.EvalResult)]
