"""The port's meshes (parallel/mesh.py) against the JAX package's (mirrors
tests/test_mesh.py): a dense 2x2x2 mesh over eight ranks and its product
check, the hybrid layout with a sum over each slice, and `--shard`
parsing (tp=N and fsdp=N); plus the multi-host helpers' refusals. Rank 0 is a process of
its own (tests/torch_tp_common.RankZero); this process never joins the
ranks."""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from oryx_tpu.parallel import mesh as jmesh  # noqa: E402
from oryx_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

from torch_tp_common import RankZero  # noqa: E402


@pytest.fixture(scope="module")
def eight():
    d = RankZero(shape=(2, 2, 2, 1))
    try:
        yield d, d.run("job_mesh_checks")
    finally:
        d.close()


def test_build_mesh_shape_and_validation(eight):
    d, out = eight
    assert d.info["size"] == 8 and d.info["backend"] == "gloo"
    assert tuple(out["names"]) == mesh_lib.AXES == jmesh.AXES
    assert out["shape"] == {"dp": 2, "fsdp": 2, "tp": 2, "sp": 1}
    if jax.device_count() >= 8:
        m = jmesh.build_mesh(JMeshConfig(dp=2, fsdp=2, tp=2, sp=1))
        assert out["shape"] == dict(m.shape)
    # JAX's product check, with JAX's message.
    assert out["dp3"] == "mesh 3x1x1x1=3 != 8 devices"


def test_hybrid_mesh_layout_and_execution(eight):
    """2 'slices' x (dp=1, fsdp=4): slice-major dp axis, each slice a
    contiguous block of ranks, and a sum over each fsdp group stays in
    its slice."""
    _, out = eight
    assert out["hybrid_shape"] == {"dp": 2, "fsdp": 4, "tp": 1, "sp": 1}
    assert out["hybrid_ranks"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # Rank 0's slice holds rows 0..3 of arange(16).reshape(8, 2).
    assert out["sums"] == [0 + 2 + 4 + 6, 1 + 3 + 5 + 7]
    assert "not divisible" in out["hybrid_bad"]
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.build_hybrid_mesh(mesh_lib.MeshConfig(dp=3), num_slices=2)


def test_parse_shard_arg(eight):
    _, out = eight
    assert mesh_lib.parse_shard_arg(None) == (None, "tp")
    for bad in ("tp8", "tp=x", "dp=2", "tp=0", "tp="):
        with pytest.raises(ValueError, match="--shard expects"):
            mesh_lib.parse_shard_arg(bad)
        with pytest.raises(ValueError, match="--shard expects"):
            jmesh.parse_shard_arg(bad)
    assert out["tp8"] == ({"dp": 1, "fsdp": 1, "tp": 8, "sp": 1}, "tp")
    # fsdp=N lays an fsdp mesh over the same ranks.
    assert out["fsdp8"] == ({"dp": 1, "fsdp": 8, "tp": 1, "sp": 1}, "fsdp")
    for bad in ("fsdp=0", "fsdp="):
        with pytest.raises(ValueError, match="--shard expects"):
            mesh_lib.parse_shard_arg(bad)


def test_multi_host_helpers_refuse_what_they_cannot_know():
    """initialize_distributed takes its address, size, rank and backend
    explicitly; process_batch_slice without a process group is the whole
    batch, and refuses an indivisible one as JAX's does."""
    with pytest.raises(ValueError, match="coordinator_address"):
        mesh_lib.initialize_distributed(backend="gloo")
    with pytest.raises(TypeError):
        mesh_lib.initialize_distributed("localhost:1", 1, 0)  # no backend
    assert mesh_lib.process_batch_slice(8) == (0, 8)
    assert mesh_lib.process_batch_slice(8) == jmesh.process_batch_slice(8)


def test_host_barrier_meets_in_order_and_times_out(tmp_path):
    """The barrier of ranks that share a card (parallel/tp._HostBarrier):
    two ranks (threads here) pass it together, turn after turn; a rank
    that never comes makes it raise within its timeout, and `alive` is
    polled while it waits."""
    import threading
    import time

    from oryx_tpu_torch.parallel import tp

    path = str(tmp_path / "barrier")
    tp._HostBarrier.create(path, 2)
    order = []

    def rank(r):
        b = tp._HostBarrier(path, r, 2)
        for turn in range(50):
            order.append((turn, r))
            b.wait(10.0)

    ts = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    # No rank starts turn k + 1 before both finished turn k's arrival.
    turns = [t for t, _ in order]
    assert sorted(turns) == turns[:2 * 50] and len(turns) == 100
    polled = []
    tp._HostBarrier.create(str(tmp_path / "b2"), 2)
    lone = tp._HostBarrier(str(tmp_path / "b2"), 0, 2)
    t0 = time.monotonic()
    with pytest.raises(tp.WorldBroken, match="timed out"):
        lone.wait(0.2, lambda: polled.append(1))
    assert time.monotonic() - t0 < 5 and polled


def test_backend_rule_nccl_only_with_a_card_a_rank():
    """The stated rule, never a caught NCCL error: NCCL when every rank
    has a card of its own; gloo when all ranks share one card or run on
    the CPU; any other layout is refused, naming it. Rank r's default
    device is cuda:(r % device_count); "cuda" without a card raises."""
    import torch

    from oryx_tpu_torch.parallel import tp

    cuda = [torch.device("cuda", i) for i in range(4)]
    cpu = torch.device("cpu")
    assert tp.choose_backend(cuda[:2]) == "nccl"
    assert tp.choose_backend(cuda) == "nccl"
    assert tp.choose_backend([cuda[0], cuda[0]]) == "gloo"
    assert tp.choose_backend([cpu] * 2) == "gloo"
    for mixed in ([cuda[0], cuda[1], cuda[0]], [cuda[0], cpu]):
        with pytest.raises(ValueError, match="cuda:0, "):
            tp.choose_backend(mixed)
        with pytest.raises(ValueError, match="a card of its own"):
            tp.start(len(mixed), mixed)
    assert tp.current() is None
    assert tp.default_devices(3, "cpu") == [cpu] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tp.default_devices(2, "cuda")
