"""The port's Trainer under sequence parallelism (ring attention over the
sp ranks, ZeRO-3 over fsdp x sp: parallel/zero.py, ops/ring_attention.py)
against JAX's Trainer on its 8-device CPU mesh, from the same weights and
a batch of four rows:

  * sp=2 on two ranks under attn_impl "ring" and "ring_flash" against
    JAX's fsdp=4 x sp=2: each rank holds half of every row's stream and
    the ring carries the other half;
  * four ranks, fsdp=2 x sp=2 (two rows a data rank), where `embed`
    shards over the combined fsdp x sp width (a quarter a rank), as JAX's
    mesh_rules place it, under "ring_flash" and "ring";
  * the packed visual buffer over dp x fsdp x sp: each rank's ViT runs on
    its 1/W of the patches.

Compared: every step's loss and grad_norm, and every leaf after the last
step. Tolerance: atol 2e-4, rtol 2e-3. The helpers are
tests/test_torch_train_parallel.py's.
"""

import pytest

pytest.importorskip("torch")

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.train import data as jdata  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402

from test_torch_train_parallel import (  # noqa: E402, F401
    STEPS, _compare, _configs, _jax_fit, numpy_packing, tree)
from torch_tp_common import RankZero  # noqa: E402
from torch_train_common import COLLATE, datasets  # noqa: E402


@pytest.fixture(scope="module")
def two():
    d = RankZero(shape=(1, 1, 1, 2))
    try:
        yield d
    finally:
        d.close()


@pytest.fixture(scope="module")
def data():
    """Four image records in one batch, three steps of it."""
    ds = datasets(jdata)
    return [jdata.collate([ds[i] for i in range(4)], **COLLATE)] * STEPS


JAX_SP_MESH = jcfg.MeshConfig(fsdp=4, sp=2)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_sequence_parallel_matches_jax(two, tree, data, tmp_path, impl):
    """sp=2: each rank holds half of every row's stream and the ring
    carries the other half; JAX runs fsdp=4 x sp=2."""
    cj, ct = _configs(tmp_path, impl, impl, 1,
                      JAX_SP_MESH, tcfg.MeshConfig(sp=2))
    got = two.run("job_fit", impl, tree, ct.to_dict(), "fsdp", data, STEPS)
    _compare(got, _jax_fit(tmp_path, impl, cj, tree, "fsdp", data), tree, ct)
    H = ct.llm.hidden_size
    P = data[0]["patches"].shape[0]
    for rep in got["reports"]:
        assert rep["param_shapes"]["llm.embed.weight"] == (512, H // 2)
        assert rep["vit_rows"] == P // 2  # the buffer over sp as well


def test_four_ranks_shard_over_the_combined_width(tree, data, tmp_path):
    """fsdp=2 x sp=2: `embed` shards over fsdp x sp (a quarter a rank, JAX's
    mesh_rules), and the numbers are JAX's fsdp=4 x sp=2 run's."""
    cj, ct = _configs(tmp_path, "four", "ring_flash", 1,
                      JAX_SP_MESH, tcfg.MeshConfig(fsdp=2, sp=2))
    d = RankZero(shape=(1, 2, 1, 2))
    try:
        got = d.run("job_fit", "four", tree, ct.to_dict(), "fsdp", data,
                    STEPS)
    finally:
        d.close()
    _compare(got, _jax_fit(tmp_path, "ring_flash", cj, tree, "fsdp", data),
             tree, ct)
    H, Hv = ct.llm.hidden_size, ct.vision.hidden_size
    assert len(got["reports"]) == 4
    P = data[0]["patches"].shape[0]
    for rep in got["reports"]:
        assert rep["vit_rows"] == P // 4
        assert rep["param_shapes"]["llm.embed.weight"] == (512, H // 4)
        assert rep["param_shapes"]["vit.layers.0.fc1.weight"] == (
            ct.vision.intermediate_size, Hv // 4)
        assert rep["mu_shapes"]["llm.layers.0.q_proj.weight"] == (
            ct.llm.num_heads * ct.llm.head_dim, H // 4)


def test_four_ranks_encode_a_quarter_of_the_visual_buffer_under_ring(
        tree, data, tmp_path):
    """fsdp=2 x sp=2 under attn_impl "ring" (the plain segment attention in
    the ViT, the xla ring in the decoder): each rank encodes a quarter of
    the packed visual buffer, and the numbers are JAX's fsdp=4 x sp=2
    run's, the encoder's leaves included."""
    cj, ct = _configs(tmp_path, "four_ring", "ring", 1,
                      JAX_SP_MESH, tcfg.MeshConfig(fsdp=2, sp=2))
    d = RankZero(shape=(1, 2, 1, 2))
    try:
        got = d.run("job_fit", "four_ring", tree, ct.to_dict(), "fsdp",
                    data, STEPS)
    finally:
        d.close()
    _compare(got, _jax_fit(tmp_path, "ring", cj, tree, "fsdp", data), tree,
             ct)
    P = data[0]["patches"].shape[0]
    assert [r["vit_rows"] for r in got["reports"]] == [P // 4] * 4
