"""fsdp serving in the port (`--shard fsdp=N`, `Pipeline(mesh=,
sharding_mode="fsdp")`): each rank holds its slice of every decoder and
ViT layer leaf (the embed axis, sharding.serving_shardings) and gathers a
layer's weights as it runs (parallel/zero.serving_gatherer); the pool is
whole on every rank, as JAX keeps it, and every rank runs each dispatch
on the whole batch. Against JAX's fsdp=8 mesh and the unsharded
pipelines, at fsdp = 2 over gloo in two CPU processes, fp32, the tiny
config: chat_batch over images, text and video, chat and its stream, the
continuous engine (ragged, over the pool), and the four entry points.
Replies are compared byte for byte. The port's ranks live in one rank-0
process (tests/torch_tp_common.py); this process holds jax."""

import os

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402

from torch_tp_common import CharTokenizer, RankZero, as_numpy_tree  # noqa
from test_torch_tp_serving import IMG, MIX, REQS, _scaled, _solo  # noqa


@pytest.fixture(scope="module")
def model():
    cfg = jcfg.oryx_tiny()
    tree = as_numpy_tree(_scaled(joryx.init_params(cfg, jax.random.key(0))))
    return cfg, tree


@pytest.fixture(scope="module")
def jpipes(model):
    cfg, tree = model
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    mesh = jbuild_mesh(JMeshConfig(fsdp=8))
    return (OryxInference(CharTokenizer(), params, cfg),
            OryxInference(CharTokenizer(), params, cfg, mesh=mesh,
                          sharding_mode="fsdp"))


@pytest.fixture(scope="module")
def ranks(model):
    cfg, tree = model
    d = RankZero(shape=(1, 2, 1, 1))
    try:
        d.run("job_pipeline", "fsdp", tree, cfg.to_dict(), "mesh", "fsdp")
        yield d
    finally:
        d.close()


def test_each_rank_holds_half_of_every_layer(ranks, model):
    """A layer leaf with an embed axis is split on it (q_proj by input
    columns, o_proj by output rows); norms, biases, the embedding, the
    head and the compressor stay whole."""
    cfg, _ = model
    shapes = ranks.run("job_shapes", "fsdp")
    H, Hv = cfg.llm.hidden_size, cfg.vision.hidden_size
    q = cfg.llm.num_heads * cfg.llm.head_dim
    assert shapes["llm.layers.0.q_proj.weight"] == (q, H // 2)
    assert shapes["llm.layers.1.o_proj.weight"] == (H // 2, q)
    assert shapes["vit.layers.0.fc1.weight"] == (
        cfg.vision.intermediate_size, Hv // 2)
    assert shapes["llm.layers.0.q_proj.bias"] == (q,)
    assert shapes["llm.embed.weight"] == (cfg.llm.vocab_size, H)
    assert shapes["llm.final_norm.weight"] == (H,)


def test_fsdp_serving_matches_unsharded(ranks, jpipes):
    """chat_batch over images, text and video: the port's fsdp=2 pipeline
    == JAX's fsdp=8 mesh == JAX unsharded, byte for byte; chat and its
    stream agree."""
    ref, jfsdp = jpipes
    want = ref.chat_batch(MIX, max_new_tokens=8)
    assert jfsdp.chat_batch(MIX, max_new_tokens=8) == want
    assert ranks.run("job_chat_batch", "fsdp", MIX,
                     {"max_new_tokens": 8}) == want
    q = "hello there friend"
    chat = ranks.run("job_chat", "fsdp", q, {"max_new_tokens": 8})
    assert chat == ref.chat(q, max_new_tokens=8)
    assert "".join(ranks.run("job_stream", "fsdp", q,
                             {"max_new_tokens": 8})) == chat


@pytest.mark.parametrize("ragged", [False, True])
def test_fsdp_engine_matches_jax(ranks, jpipes, ragged):
    """The continuous engine over the fsdp pipe (every dispatch on every
    rank, the pool whole on each): replies == JAX's solo pipeline's; both
    ranks sampled the same tokens."""
    ref, _ = jpipes
    out = ranks.run("job_engine", "fsdp", REQS,
                    {"ragged": ragged, "prefill_chunk": 32}, "continuous")
    assert out["replies"] == _solo(ref, REQS)
    assert out["heads"] == 2  # every KV head on every rank
    assert len(set(out["digests"])) == 1


def test_entry_points_serve_fsdp2(ranks, tmp_path, model, jpipes):
    """`--shard fsdp=2` through serve/cli, eval/harness, gradio_app and
    api_server (`--engine continuous`): each answers as the unsharded JAX
    pipeline over the same weights does."""
    from PIL import Image

    from oryx_tpu.eval import harness as jharness
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.data import media
    from oryx_tpu_torch.models.convert import from_jax_params
    from oryx_tpu_torch.serve import builder

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
    out = ranks.run("job_entry_points", model_dir, task, assets, img_path,
                    "fsdp=2", "continuous")
    img = media.load_image(img_path)
    assert out["cli"] == ref.chat("what is this?", images=[img],
                                  max_new_tokens=6) + "\n"
    want = jharness.evaluate(
        ref, jharness.load_task(task), media_root=assets, num_frames=2,
        max_new_tokens=2, log_every=0)
    assert out["harness"]["n"] == want.num_total
    assert out["harness"]["accuracy"] == want.accuracy
    assert out["gradio"] == (2, ref.chat("hello there", max_new_tokens=6))
    assert out["api"] == ("continuous",
                          ref.chat("hello there", max_new_tokens=6))
