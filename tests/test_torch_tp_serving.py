"""Tensor-parallel serving in the port (parallel/, `Pipeline(mesh=)`, the
`sharded` engine, `--shard tp=N`) against the JAX package's tp=2 mesh and
its unsharded pipeline, at tp = 2 over gloo in two CPU processes, in fp32,
on the tiny config (4 q / 2 kv heads: one kv head a rank).

Mirrors tests/test_serve.py (the tp case of the sharded-serving parity,
the sharded restore, the sharded cached session), tests/test_engine.py
(the sharded engine's refusals and construction), the tp2 cases of
tests/test_ragged_attention.py, test_fused_decode.py, test_speculative.py
and test_journal.py; adds prefill logits, the quantized pool's bytes under
tp, the four entry points, the followers' sampled tokens and a dead
follower. A model with unmerged LoRA adapters (whole on each rank, the
residuals taken on the rank's columns of B or rows of A) serves through
`chat_batch`, the ragged engine and the auditor as JAX's tp=2 mesh and
its unsharded pipeline do; a LoRA fit on the same two ranks exports its
adapters from rank 0 and resumes from its rank checkpoints bit for bit.
The port's ranks live in one rank-0 process for the module
(tests/torch_tp_common.py); this process holds jax and never joins them."""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen2  # noqa: E402
from oryx_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JSched  # noqa: E402
from oryx_tpu.utils import quant as jquant  # noqa: E402

from torch_tp_common import (  # noqa: E402
    GEOM,
    CharTokenizer,
    RankZero,
    as_numpy_tree,
)

IMG = np.random.default_rng(5).integers(0, 255, size=(40, 56, 3),
                                        dtype=np.uint8)
FRAMES = [np.random.default_rng(i).integers(0, 255, size=(32, 32, 3),
                                            dtype=np.uint8) for i in (6, 7)]
MIX = [
    {"question": "what is this?", "images": [IMG]},
    {"question": "hello there"},
    {"question": "what happens?", "images": FRAMES, "is_video": True},
]
REQS = [("hello there", 12), ("hello there friend", 12)]
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
LORA = jcfg.LoraConfig(enable=True, r=4, alpha=8.0, targets=LORA_TARGETS)


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def model():
    cfg = jcfg.oryx_tiny()
    tree = as_numpy_tree(_scaled(joryx.init_params(cfg, jax.random.key(0))))
    return cfg, tree


@pytest.fixture(scope="module")
def jpipes(model):
    cfg, tree = model
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mesh = jbuild_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
    return (OryxInference(CharTokenizer(), params, cfg),
            OryxInference(CharTokenizer(), params, cfg, mesh=mesh,
                          sharding_mode="tp"))


@pytest.fixture(scope="module")
def ranks(model):
    cfg, tree = model
    d = RankZero()
    try:
        shards = d.run("job_pipeline", "tp", tree, cfg.to_dict())
        yield d, shards
    finally:
        d.close()


@pytest.fixture(scope="module")
def adapted(model, ranks):
    """The scaled tiny model with nonzero adapters on all seven decoder
    projections (lora_b drawn x0.5), its JAX pipelines unsharded and on
    the tp=2 mesh, and the port's tp=2 pipe over it (key "lora")."""
    import dataclasses

    cfg, tree = model
    cj = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, lora=LORA))
    t = joryx.enable_lora(jax.tree_util.tree_map(jnp.asarray, tree), cj,
                          jax.random.key(1))
    rng = np.random.default_rng(1)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        if str(getattr(path[-1], "key", "")) == "lora_b":
            return (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    tree_l = jax.tree_util.tree_map_with_path(f, t)
    params = jax.tree_util.tree_map(jnp.asarray, tree_l)
    mesh = jbuild_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
    d, _ = ranks
    d.run("job_pipeline", "lora", tree_l, cj.to_dict())
    return (cj, tree_l, OryxInference(CharTokenizer(), params, cj),
            OryxInference(CharTokenizer(), params, cj, mesh=mesh,
                          sharding_mode="tp"))


def _solo(jpipe, reqs):
    return [jpipe.chat(q, max_new_tokens=cap) for q, cap in reqs]


def test_ranks_backend_devices_and_shards(ranks, model):
    """Two ranks on the CPU take gloo (the stated rule: NCCL only when
    every rank has a card of its own); each holds half the q heads'
    rows and half o_proj's input columns."""
    d, shards = ranks
    cfg, _ = model
    assert d.info == {"backend": "gloo", "size": 2,
                      "devices": ["cpu", "cpu"]}
    width = cfg.llm.num_heads * cfg.llm.head_dim
    assert shards == {"tp": 2, "q_rows": width // 2, "o_cols": width // 2}


def test_sharded_serving_matches_unsharded(ranks, jpipes):
    """chat_batch over images, text and video: the port's tp=2 pipeline
    == JAX's tp=2 mesh == JAX unsharded, byte for byte; streaming and
    chat agree on the tp pipe."""
    d, _ = ranks
    ref, jtp = jpipes
    want = ref.chat_batch(MIX, max_new_tokens=8)
    assert jtp.chat_batch(MIX, max_new_tokens=8) == want
    assert d.run("job_chat_batch", "tp", MIX, {"max_new_tokens": 8}) == want
    q = "hello there friend"
    chat = d.run("job_chat", "tp", q, {"max_new_tokens": 8})
    assert chat == ref.chat(q, max_new_tokens=8)
    assert "".join(d.run("job_stream", "tp", q,
                         {"max_new_tokens": 8})) == chat


def test_prefill_logits_within_tolerance(ranks, model, jpipes):
    cfg, tree = model
    d, _ = ranks
    ids = [min(ord(c), 500) for c in "tell me about the picture"]
    got = d.run("job_prefill_logits", "tp", ids)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want, _ = jqwen2.forward(params["llm"], cfg.llm,
                             input_ids=jnp.asarray([ids], jnp.int32))
    want = np.asarray(want[0, -1], np.float32)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)


def test_adapted_model_serves_as_jax_on_tp(ranks, adapted, jpipes):
    """A model with unmerged adapters at tp=2: chat_batch over images,
    text and video == JAX's tp=2 mesh == JAX unsharded, byte for byte,
    and the adapters change the replies; the prefill logits are JAX's
    adapted model's."""
    d, _ = ranks
    cj, tree_l, ref, jtp = adapted
    want = ref.chat_batch(MIX, max_new_tokens=8)
    assert jtp.chat_batch(MIX, max_new_tokens=8) == want
    assert d.run("job_chat_batch", "lora", MIX,
                 {"max_new_tokens": 8}) == want
    assert want != jpipes[0].chat_batch(MIX, max_new_tokens=8)
    ids = [min(ord(c), 500) for c in "tell me about the picture"]
    got = d.run("job_prefill_logits", "lora", ids)
    params = jax.tree_util.tree_map(jnp.asarray, tree_l)
    with jax.default_matmul_precision("highest"):
        logits, _ = jqwen2.forward(params["llm"], cj.llm,
                                   input_ids=jnp.asarray([ids], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(logits[0, -1], np.float32),
                               atol=2e-4, rtol=2e-3)


def test_adapted_checkpoint_serves_on_tp(ranks, adapted, tmp_path):
    """A save_pretrained directory that keeps the adapters, read by each
    rank off the file (CheckpointParams, the entry points' --shard
    route): the adapters whole on each rank, chat == JAX's unsharded
    adapted pipeline."""
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve import builder

    d, _ = ranks
    cj, tree_l, ref, _ = adapted
    tc = OryxConfig.from_dict(cj.to_dict())
    model_dir = str(tmp_path / "adapted")
    builder.save_pretrained(model_dir, tc, from_jax_params(tree_l, tc))
    shapes = d.run("job_pipeline_dir", "lora_dir", model_dir, cj.to_dict())
    r = LORA.r
    assert shapes["llm.layers.0.q_proj.lora_b"] == (
        r, cj.llm.num_heads * cj.llm.head_dim)
    assert shapes["llm.layers.0.o_proj.lora_a"] == (
        cj.llm.num_heads * cj.llm.head_dim, r)
    q = "hello there friend"
    assert d.run("job_chat", "lora_dir", q, {"max_new_tokens": 8}) == \
        ref.chat(q, max_new_tokens=8)


def test_adapted_ragged_engine_and_audit_on_tp(ranks, adapted):
    """The ragged engine and the auditor (every request replayed) over the
    adapted tp pipe: replies == JAX's unsharded pipeline, every verdict
    passes, both ranks' digests equal."""
    d, _ = ranks
    _, _, ref, _ = adapted
    want = _solo(ref, REQS)
    out = d.run("job_engine", "lora", REQS,
                {"ragged": True, "prefill_chunk": 32})
    assert out["replies"] == want
    assert out["dispatches"].get("ragged", 0) > 0
    reqs = REQS[:1]
    audited = d.run("job_audit", "lora", reqs,
                    dict(GEOM, audit_sample_every=1))
    assert [r[0] for r in audited["replies"]] == want[:1]
    assert audited["audits"]["total"] == 1
    assert audited["audits"]["verdicts"]["pass"] == 1, audited["audits"]
    assert len(set(audited["digests"])) == 1


_FITS: dict = {}


def _lora_fit(d, tmp_path, name, steps, resume=False, ckpt=None):
    """A LoRA Trainer on the module's two ranks (mesh tp=2, adapters on
    the seven targets), 3 steps of one training batch: job_fit's result,
    the trainer kept under `name`."""
    import dataclasses

    from oryx_tpu_torch import config as tcfg
    from torch_train_common import cfgs, make_batches

    cj, _ = cfgs(impl="xla", tune="lora", lr=1e-3, lora=LORA)
    with jax.default_matmul_precision("highest"):
        b = make_batches()[1]
    data = [{k: v[0] for k, v in b.items()}] * 3
    ct = tcfg.OryxConfig.from_dict(dataclasses.replace(
        cj, mesh=JMeshConfig(tp=2), train=dataclasses.replace(
            cj.train, log_every=1, checkpoint_every=100,
            checkpoint_dir=str(ckpt or tmp_path / name))).to_dict())
    tree = as_numpy_tree(_lora_tree(cj))
    return d.run("job_fit", name, tree, ct.to_dict(), "fsdp", data, steps,
                 resume), ct, tree


def _lora_tree(cj):
    from torch_train_common import make_tree

    if "tree" not in _FITS:
        _FITS["tree"] = joryx.enable_lora(
            jax.tree_util.tree_map(jnp.asarray, make_tree()), cj,
            jax.random.key(2))
    return _FITS["tree"]


def _straight(d, tmp_path):
    if "straight" not in _FITS:
        _FITS["straight"] = _lora_fit(d, tmp_path, "lstraight", 3)
    return _FITS["straight"]


def test_lora_tp_fit_exports_peft_from_rank_zero(ranks, tmp_path):
    """A LoRA fit at tp=2: the PEFT directory rank 0 writes from its
    gathered leaves is byte-equal to the one one process writes from the
    same adapters, and to JAX's exporter's."""
    import os

    import torch

    from oryx_tpu.models import import_hf as jimport
    from oryx_tpu_torch.models import import_hf as timport
    from oryx_tpu_torch.models.convert import from_jax_params

    d, _ = ranks
    (got, ct, tree) = _straight(d, tmp_path)
    files = d.run("job_lora_export", "lstraight", str(tmp_path / "tp"))
    model = from_jax_params(tree, ct)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.from_numpy(got["params"][n]))
    adapters = [n for n in got["params"] if "lora_b" in n]
    assert adapters and all(
        not np.array_equal(got["params"][n], _leaf(tree, n))
        for n in adapters)
    one = str(tmp_path / "one")
    timport.export_lora_dir(model.llm, ct.train.lora, one)
    assert files == {n: open(os.path.join(one, n), "rb").read()
                     for n in sorted(os.listdir(one))}
    from oryx_tpu_torch.models.convert import to_jax_layout

    jdir = str(tmp_path / "jax")
    jimport.export_lora_dir(jax.tree_util.tree_map(
        jnp.asarray, to_jax_layout(model)["llm"]), LORA, jdir)
    assert files == {n: open(os.path.join(jdir, n), "rb").read()
                     for n in sorted(os.listdir(jdir))}


def _leaf(tree, name):
    """The whole leaf `name` (the port's state-dict name) of a JAX tree:
    a decoder layer's slice of the stacked leaf, the kernel transposed."""
    parts = name.split(".")
    layer = int(parts[2])
    node = tree
    for k in [parts[0], parts[1]] + parts[3:]:
        node = node[k]
    return np.asarray(node)[layer]


def test_lora_tp_resume_continues_identically(ranks, tmp_path):
    """Two LoRA steps at tp=2, the final rank checkpoints, then a fresh
    Trainer on the same directory resumes and takes step 3: its loss,
    grad norm and every leaf (the adapters included) are the
    uninterrupted run's bits."""
    d, _ = ranks
    straight, _, _ = _straight(d, tmp_path)
    ckpt = tmp_path / "resume"
    first, _, _ = _lora_fit(d, tmp_path, "lfirst", 2, ckpt=ckpt)
    assert first["step"] == 2
    resumed, _, _ = _lora_fit(d, tmp_path, "lresumed", 3, resume=True,
                              ckpt=ckpt)
    assert resumed["start"] == 2 and resumed["step"] == 3
    assert resumed["history"] == straight["history"][-1:]
    for n, t in straight["params"].items():
        assert np.array_equal(resumed["params"][n], t), n


def test_sharded_engine_builds_on_tp_mesh(ranks, jpipes):
    """The sharded engine on the tp pipe: each rank's pool holds its one
    KV head; the split engine's replies == JAX's solo pipeline; both
    ranks sampled the same tokens."""
    d, _ = ranks
    ref, _ = jpipes
    out = d.run("job_engine", "tp", REQS, {})
    assert out["heads"] == 1
    assert out["replies"] == _solo(ref, REQS)
    assert out["dispatches"].get("decode", 0) > 0
    assert len(set(out["digests"])) == 1


def test_sharded_engine_requires_tp_mesh(ranks):
    """JAX's three refusals: no mesh (tests/test_torch_engine.py), a mesh
    without a tp width, KV heads that do not divide; and the port's own,
    at the pipeline: every head count must divide."""
    d, _ = ranks
    bad = jcfg.oryx_tiny()
    import dataclasses

    bad = dataclasses.replace(
        bad, llm=dataclasses.replace(bad.llm, num_kv_heads=1))
    out = d.run("job_engine_refusals", "tp", bad.to_dict())
    assert "tp axis" in out["tp_axis"]
    assert "do not divide" in out["divide"]
    bad_tree = as_numpy_tree(joryx.init_params(bad, jax.random.key(0)))
    err = d.run("job_bad_pipeline", bad_tree, bad.to_dict())
    assert err is not None and "num_kv_heads" in err


def test_scheduler_ragged_tp2_mesh_parity(ranks, jpipes):
    """The ragged engine on the head-sharded pool == JAX's tp=2 ragged
    engine == JAX's solo pipeline."""
    d, _ = ranks
    ref, jtp = jpipes
    want = _solo(ref, REQS)
    sched = JSched(jtp, autostart=False, ragged=True, prefill_chunk=32,
                   **GEOM)
    try:
        hs = [sched.submit({"question": q}, cap) for q, cap in REQS]
        sched.start()
        assert [h.result(timeout=600)[0] for h in hs] == want
    finally:
        sched.close()
    out = d.run("job_engine", "tp", REQS,
                {"ragged": True, "prefill_chunk": 32})
    assert out["replies"] == want
    assert out["dispatches"].get("ragged", 0) > 0


def test_fused_parity_tp2_mesh(ranks, jpipes):
    d, _ = ranks
    ref, _ = jpipes
    reqs = [("hello there", 32), ("hello there friend", 32)]
    out = d.run("job_engine", "tp", reqs,
                {"ragged": True, "prefill_chunk": 8, "fuse_steps": 4})
    assert out["replies"] == _solo(ref, reqs)
    assert out["dispatches"].get("fused", 0) > 0
    assert len(set(out["digests"])) == 1


def test_spec_parity_tp2_mesh(ranks, jpipes):
    d, _ = ranks
    ref, _ = jpipes
    reqs = [("hello there", 5), ("hello there friend", 5)]
    out = d.run("job_engine", "tp", reqs,
                {"ragged": True, "prefill_chunk": 32, "speculate": 3})
    assert out["replies"] == _solo(ref, reqs)
    assert out["dispatches"].get("spec", 0) > 0


@pytest.mark.parametrize("prefill_chunk", [16, None],
                         ids=["chunked", "single-shot"])
def test_prefix_cache_int8_spill_reload_tp2(ranks, jpipes, prefill_chunk):
    """The split engine with the prefix cache over an int8 pool and a host
    tier small enough to spill and reload: the tp pipe's replies equal
    JAX's ContinuousScheduler on its tp=2 pipe with the same kv_dtype,
    host tier and geometry (and the port's one-device int8 engine).
    With a single-shot suffix prefill after a prefix hit, JAX's engine
    leaves its own dense model on the second request (ROADMAP Queue 3),
    so there the witness is JAX's unsharded `chat`."""
    import torch

    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    d, _ = ranks
    ref, jtp = jpipes
    reqs = [("spill tier prompt " * 3, 6),
            ("completely different filler text " * 3, 6),
            ("spill tier prompt " * 3, 6)]
    kw = dict(num_slots=1, page_size=8, chunk=4, max_ctx=256, num_pages=29,
              kv_dtype="int8", host_cache_bytes=1 << 24,
              prefill_chunk=prefill_chunk)

    def replies(sched):
        try:
            hs = [sched.submit({"question": q}, cap) for q, cap in reqs]
            sched.start()
            return [h.result(timeout=600)[0] for h in hs]
        finally:
            sched.close()

    if prefill_chunk:
        want = replies(JSched(jtp, autostart=False, **kw))
    else:
        want = _solo(ref, reqs)
    out = d.run("job_engine", "tp", reqs, kw)
    assert out["replies"] == want
    assert out["host_reload"]
    cfg = jcfg.oryx_tiny()
    tree = as_numpy_tree(_scaled(joryx.init_params(cfg, jax.random.key(0))))
    tc = OryxConfig.from_dict(cfg.to_dict())
    pipe = Pipeline(CharTokenizer(), from_jax_params(tree, tc), tc,
                    device="cpu")
    with torch.inference_mode():
        assert replies(ContinuousScheduler(pipe, autostart=False,
                                           **kw)) == want


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_generate_paged_on_tp_mesh(ranks, model, jpipes, ragged):
    """`generate_paged(mesh=)`: every rank runs the paged loop over its
    own heads' fresh pool; the tokens, counts and finished flags equal
    JAX's `generate_paged(mesh=)` on its tp=2 mesh (and the port's
    one-device call) on the same weights and inputs."""
    import torch

    from oryx_tpu.models import generate as jgen
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.models.convert import from_jax_params

    d, _ = ranks
    cfg, tree = model
    _, jtp = jpipes
    ids = [[min(ord(c), 500) for c in "hello there friend"],
           [min(ord(c), 500) for c in "tell me more"] + [0] * 6]
    lengths = [18, 12]
    kw = dict(max_new_tokens=8, page_size=16, chunk=4, ragged=ragged)
    emb = np.asarray(tree["llm"]["embed"]["weight"], np.float32)[
        np.asarray(ids)]
    with jax.default_matmul_precision("highest"):
        want = jgen.generate_paged(
            jtp.params["llm"], cfg.llm, cfg.generation,
            inputs_embeds=jnp.asarray(emb),
            lengths=jnp.asarray(lengths, jnp.int32), mesh=jtp.mesh, **kw)
    got = d.run("job_generate_paged", "tp", ids, lengths, kw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len({tuple(r) for r in got[0].tolist()}) == 2  # rows differ
    tc = OryxConfig.from_dict(cfg.to_dict())
    params = from_jax_params(tree, tc)
    with torch.inference_mode():
        one = generate_lib.generate_paged(
            params.llm, tc.llm, tc.generation,
            inputs_embeds=torch.from_numpy(emb), lengths=lengths,
            device="cpu", **kw)
    for a, b in zip(got, one):
        np.testing.assert_array_equal(a, b.numpy())


def test_replay_tp2_mesh(ranks, tmp_path):
    """The journal is pipeline-agnostic: a replay against the same tp
    pipe reproduces the decisions and the bytes."""
    d, _ = ranks
    div, (matched, total, bad), kinds = d.run(
        "job_journal", "tp", str(tmp_path / "j.jsonl"),
        [("hello there", 5), ("hello there friend", 5)], GEOM)
    assert div is None, div
    assert matched == total == 2 and not bad
    assert "step" in kinds


def test_sharded_pipe_cached_session_matches_unsharded(ranks, jpipes):
    """ChatSession's KV prefix cache (and the pipe's shared cache) on the
    tp pipe: asked and streamed turns == JAX's unsharded uncached
    session."""
    from oryx_tpu.serve.pipeline import ChatSession as JSession

    d, _ = ranks
    ref, _ = jpipes
    qs = ["what is this?", "and why?"]
    jsession = JSession(ref, images=[IMG], cache=False)
    want = [jsession.ask(q, max_new_tokens=6) for q in qs]
    asked, streamed = d.run("job_session", "tp", IMG, qs,
                            {"max_new_tokens": 6})
    assert asked == want
    jsession = JSession(ref, images=[IMG], cache=False)
    jsession.history = [(q, a) for q, a in zip(qs, want)]
    assert streamed == [jsession.ask(q, max_new_tokens=6) for q in qs]


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_quantized_pool_bytes_under_tp(ranks, fmt):
    """Given the same K rows, the tp=2 pool's codes (both ranks' heads)
    and scales are byte-equal to the one-device pool's and to JAX's
    quantizer: each rank takes the row amax over all heads
    (all_reduce(MAX)) before it encodes."""
    import torch

    from oryx_tpu_torch.ops import paged_kv

    d, _ = ranks
    rows = np.random.default_rng(3).normal(size=(10, 2, 16)).astype(
        np.float32)
    rows[:, 1] *= 5.0  # the second head holds every row's amax
    codes, scale = d.run("job_pool_rows", rows, fmt)
    plane = paged_kv.init_quant_pages(1, 3, 4, 2, 16, fmt=fmt,
                                      device="cpu")[0]
    paged_kv.scatter_rows(plane, torch.arange(10), torch.from_numpy(rows))
    one_codes = plane.q.reshape(-1, 2, 16)[:10].view(torch.uint8)
    np.testing.assert_array_equal(codes, one_codes.to(torch.int32).numpy())
    np.testing.assert_array_equal(scale,
                                  plane.scale.reshape(-1)[:10].numpy())
    jcodes, jscale = jquant.quantize_kv_rows(jnp.asarray(rows), fmt)
    np.testing.assert_array_equal(
        codes, np.asarray(jcodes).view(np.uint8).astype(np.int32))
    np.testing.assert_array_equal(scale, np.asarray(jscale))


def test_entry_points_serve_tp2(ranks, tmp_path, model, jpipes):
    """`--shard tp=2` through serve/cli, eval/harness, gradio_app and
    api_server (`--engine sharded`): each answers as the unsharded JAX
    pipeline over the same weights does; a cuda request on the CPU ranks
    raises."""
    import os

    from oryx_tpu.eval import harness as jharness
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve import builder

    from torch_serve_common import png_uri  # noqa: F401 (PIL present)
    from PIL import Image

    d, _ = ranks
    cfg, tree = model
    ref, _ = jpipes
    tc = OryxConfig.from_dict(cfg.to_dict())
    model_dir = str(tmp_path / "model")
    builder.save_pretrained(model_dir, tc, from_jax_params(tree, tc))
    img_path = str(tmp_path / "img.png")
    Image.fromarray(IMG).save(img_path)
    assets = os.path.join(os.path.dirname(__file__), "..", "assets",
                          "smoke_eval")
    task = os.path.join(assets, "task.jsonl")
    out = d.run("job_entry_points", model_dir, task, assets, img_path)
    from oryx_tpu_torch.data import media

    img = media.load_image(img_path)
    assert out["cli"] == ref.chat("what is this?", images=[img],
                                  max_new_tokens=6) + "\n"
    want = jharness.evaluate(
        ref, jharness.load_task(task), media_root=assets, num_frames=2,
        max_new_tokens=2, log_every=0)
    assert out["harness"]["n"] == want.num_total
    assert out["harness"]["accuracy"] == want.accuracy
    assert out["gradio"] == (2, ref.chat("hello there", max_new_tokens=6))
    assert out["api"][0] == "sharded"
    assert out["api"][1] == ref.chat("hello there", max_new_tokens=6)
    assert "ranks run on cpu, not cuda" in out["cuda_on_cpu_ranks"]
    assert "torch.cuda.is_available() is False" in out["cuda_pipeline"]


@pytest.mark.parametrize("entry", ["api_server", "cli", "gradio_app",
                                   "harness"])
def test_shard_without_a_card_raises_the_cuda_error(monkeypatch, tmp_path,
                                                   entry):
    """Every entry point defaults to `--device cuda`: on a host with no
    card, `--shard tp=2` raises the error the same command without
    `--shard` raises, and starts no rank (nothing serves on the CPU)."""
    import torch

    from oryx_tpu_torch.eval import harness
    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.serve import api_server, cli, gradio_app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = {"api_server": api_server.main, "cli": cli.main,
            "gradio_app": gradio_app.main, "harness": harness.main}[entry]
    extra = {"cli": ["--question", "hi"],
             "harness": ["--task", str(tmp_path / "task.jsonl")]}
    argv = ["--model-path", str(tmp_path / "none")] + extra.get(entry, [])
    for shard in ([], ["--shard", "tp=2"]):
        with pytest.raises(RuntimeError,
                           match=r"torch\.cuda\.is_available\(\) is False"):
            main(argv + shard)
        assert tp_lib.current() is None


def test_dead_follower_reports_dead_within_timeout(model):
    """A follower that dies makes the sharded engine report dead (its
    world broken) within the collective timeout: nothing hangs."""
    cfg, tree = model
    d = RankZero()
    try:
        d.run("job_pipeline", "tp", tree, cfg.to_dict())
        out = d.run("job_kill_follower_then_engine", "tp", REQS,
                    timeout=400)
    finally:
        d.close()
    assert not out["alive"] and out["broken"]
    assert out["errors"] and out["seconds"] < out["timeout_s"]
