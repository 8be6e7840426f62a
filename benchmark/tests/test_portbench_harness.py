"""The benchmark's data and arithmetic: its files keep the contract's
names, units and cross-references, new cells are found by name, the
traffic repeats per seed, the counts match hand counts, the statistics
cover every sample, and the idle share comes from a busy union."""

from __future__ import annotations

import json
import math
import shutil

import numpy as np
import pytest

from benchmark import count
from benchmark.harness import spec, stats
from benchmark.harness import trace as trace_lib
from benchmark.traffic import mix, sft

BENCH = spec.load_spec()


# ---- BENCHMARK.json ----------------------------------------------------------

def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert spec.NAME_RE.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_units_and_sources(metric):
    assert spec.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    allowed = (("host_clock", "device_trace") if metric in BENCH["end_to_end"]
               else ("device_trace", "program_span", "program_counter",
                     "host_clock"))
    assert metric["source"] in allowed


def test_every_name_is_unique():
    for key in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_cells_report_what_they_move(metric):
    """Each cell a per-layer metric lists reports the end-to-end metric it
    moves, and the metric has its reader."""
    moved = next(m for m in BENCH["end_to_end"]
                 if m["name"] == metric["moves"])
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        assert "workloads" not in moved or cell in moved["workloads"]
    assert callable(spec.metric_reader(metric["name"]))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_reports_setup_another_metric_and_a_layer(cell):
    e2e, layer = spec.cell_metrics(BENCH, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert layer
    w = spec.workload(cell["name"])
    assert w["config"] == cell["config"] and w["chips"] == cell["chips"]


def test_contract_limits():
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) <= 64 << 10
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert not any(k.endswith(("_dim", "_rank", "_size")) or "width"
                       in k for k in c["reduced"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_dropped_workload_file_is_found(tmp_path, monkeypatch):
    """A new cell is a new file: the harness finds it by name with no
    edit."""
    bench = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR / "workloads", bench / "workloads")
    w = json.loads((bench / "workloads" / "oryx-7b.video-qa.json")
                   .read_text())
    w["driver"] = "serve_open"
    w["traffic"]["rate_per_s"] = 0.44
    (bench / "workloads" / "oryx-7b.video-qa-open.json").write_text(
        json.dumps(w))
    monkeypatch.setattr(spec, "BENCH_DIR", bench)
    assert spec.workload("oryx-7b.video-qa-open")["traffic"][
        "rate_per_s"] == 0.44


# ---- traffic -----------------------------------------------------------------

def _vqa():
    return spec.workload("oryx-7b.video-qa")["traffic"]


def test_visual_qa_traffic_repeats_per_seed():
    specs = mix.visual_qa_specs(_vqa(), 40)
    a, b = mix.materialize(specs, 2**33 + 5), mix.materialize(specs, 2**33 + 5)
    c = mix.materialize(specs, 2**33 + 6)
    for x, y in zip(a, b):
        assert x["request"]["question"] == y["request"]["question"]
        assert all(np.array_equal(i, j) for i, j in zip(
            x["request"].get("images", []), y["request"].get("images", [])))
    assert [x["request"]["question"] for x in a] != \
        [x["request"]["question"] for x in c]


def test_every_seed_gets_the_same_work_in_another_order():
    specs = mix.visual_qa_specs(_vqa(), 40)

    def work(items):
        return sorted((it["kind"], it["max_new"],
                       tuple(im.shape for im in it["request"]["images"]))
                      for it in items)
    assert work(mix.materialize(specs, 1)) == work(mix.materialize(specs, 9))
    kinds = [s["kind"] for s in specs]
    assert kinds.count("image") == 20 and kinds.count("video") == 10
    g1 = mix.poisson_gaps(50, 3.0, 20.0, mix.rng(1, 3))
    g2 = mix.poisson_gaps(50, 3.0, 20.0, mix.rng(2, 3))
    assert sorted(g1) == pytest.approx(sorted(g2))
    assert g1.sum() == pytest.approx(20.0)
    assert list(g1) != list(g2)


def test_text_traffic_fits_the_context():
    t = spec.workload("oryx-7b.chat-backlog")
    specs = mix.text_specs(t["traffic"], 300)
    assert specs == mix.text_specs(t["traffic"], 300)
    for s in specs:
        assert s["prompt_bytes"] + s["max_new"] <= t["engine"]["max_ctx"]
    items = mix.materialize(specs[:20], 77)
    for s, it in zip(sorted(specs[:20], key=str), items):
        assert len(it["request"]["question"]) + mix.TEMPLATE_TOKENS <= 1024


def test_sft_records_repeat_per_seed():
    t = spec.workload("oryx-34b-l2.sft")["traffic"]
    t = dict(t, records=30)
    a, b = sft.Records(t, 123456789012), sft.Records(t, 123456789012)
    assert a.records == b.records
    for r in a.records[:5]:
        assert all(np.array_equal(x, y)
                   for x, y in zip(a.media(r), b.media(r)))
    assert sft.Records(t, 5).records != a.records


# ---- counts ------------------------------------------------------------------

def test_attention_bounds_by_hand():
    # K1 at the tower: one 1024-patch image, 16 heads of 72.
    pairs = count.segment_pairs([1] * 1024 + [0] * 1024, [1] * 1024 + [0] * 1024)
    assert pairs == 1024 * 1024
    flops = 4 * 16 * 72 * 1024 * 1024
    nbytes = 2 * 72 * (2 * 1024 * 16 + 2 * 1024 * 16)
    assert count.attention_fwd_bound(16, 16, 72, 1024, 1024, pairs) == \
        pytest.approx(max(flops / 989e12, nbytes / 3.35e12))
    # K1-lse + K5 at a decoder row of 4 tokens, 56 / 8 heads of 128.
    pairs = count.causal_pairs(4)
    assert pairs == 1 + 2 + 3 + 4
    q, kv = 2 * 128 * 4 * 56, 2 * 128 * 4 * 8
    lse = 4 * 4 * 56
    nbytes = (2 * q + 2 * kv + lse) + (4 * q + 4 * kv + 2 * lse)
    assert count.attention_train_bound(56, 8, 128, 4, 4, pairs) == \
        pytest.approx(max(14 * 56 * 128 * 10 / 989e12, nbytes / 3.35e12))


def test_model_flops_by_hand():
    llm = spec.config("oryx-7b")["oryx"]["llm"]
    # Qwen2-7B: 7.07e9 parameters with embeddings (7.6e9 published incl.
    # the untied head).
    assert count.llm_params(llm) == pytest.approx(7.615e9, rel=2e-3)
    per_layer = count.llm_layer_params(llm)
    assert count.prefill_flops(llm, 10) == pytest.approx(
        2 * 28 * per_layer * 10 + 4 * 28 * 28 * 128 * 55
        + 2 * 3584 * 152064)
    assert count.decode_flops(llm, 100) == pytest.approx(
        2 * count.llm_dense_params(llm) + 4 * 28 * 28 * 128 * 100)
    assert count.sum_range(3, 6) == 3 + 4 + 5


# ---- statistics and the trace ------------------------------------------------

def test_tail_and_rate_cover_every_sample():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == pytest.approx(np.percentile(xs, 90))
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.mean([1.0, 2.0, 6.0]) == 3.0


def test_idle_share_is_one_minus_the_busy_union():
    t0 = 1_000
    recs = [("a", t0 + 0, t0 + 100), ("b", t0 + 50, t0 + 150),
            ("c", t0 + 400, t0 + 500)]
    assert trace_lib.busy_s(recs) == pytest.approx(250e-9)
    gaps = trace_lib.idle_gaps(recs, t0, t0 + 1000)
    assert gaps[0] == (t0 + 500, t0 + 1000)
    assert sum(e - s for s, e in gaps) == 750
    read = spec.metric_reader("idle_share.serve")
    assert read({"busy_s": 0.25, "window_s": 1.0}) == pytest.approx(75.0)


@pytest.mark.parametrize("name", [
    "flash_fwd_bf16", "flash_bwd_dq_bf16", "paged_split",
    "sm90_xmma_gemm_bf16", "q8_large", "vectorized_elementwise_kernel"])
def test_kernel_families(name):
    fam = trace_lib.family(name)
    assert fam == {"flash_fwd_bf16": "K1", "flash_bwd_dq_bf16": "K5",
                   "paged_split": "K3/K4", "sm90_xmma_gemm_bf16":
                   "cuBLAS GEMM", "q8_large": "q8"}.get(
                       name, "elementwise/other")


def test_readers_return_nothing_without_records():
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])({}) is None


def test_roofline_reader_is_bound_over_device_time():
    read = spec.metric_reader("k1_vit_roofline")
    assert read({"k1_fwd_s": 2.0, "k1_bound_s": 0.5}) == 25.0
    assert math.isclose(spec.metric_reader("mfu.serve")(
        {"model_flops": 989e12, "window_s": 2.0}), 50.0)
