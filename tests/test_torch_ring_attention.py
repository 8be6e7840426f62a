"""The port's ring attention (ops/ring_attention.py) over two ranks on the
CPU against JAX's `ring_attention` on the 8-device CPU mesh (mirrors
tests/test_ring_attention.py case by case): impl "xla" and "flash" (the K1
and K5 plain twins on the CPU, Pallas interpret mode in JAX), causal and
not, a padding mask, and the gradients through each ring backward; the
causal liveness table. The same numpy-seeded q/k/v go to both packages.
Rank 0 is a process of its own (tests/torch_tp_common.RankZero).

Tolerance: atol 2e-4, rtol 2e-3, on rows with a visible key.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from oryx_tpu.ops.ring_attention import ring_attention as jring  # noqa: E402
from oryx_tpu_torch.ops import ring_attention as tring  # noqa: E402

from torch_tp_common import RankZero  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def two():
    d = RankZero(shape=(1, 1, 1, 2))
    try:
        yield d
    finally:
        d.close()


def _mesh():
    devs = np.asarray(jax.devices()).reshape(-1)
    return Mesh(devs.reshape(len(devs), 1), ("sp", "unused"))


def _qkv(seed, B, T, Hq, Hk, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, T, Hq, D), (B, T, Hk, D), (B, T, Hk, D)))


def _jax(q, k, v, grad=False, **kw):
    mesh = _mesh()
    if "kv_mask" in kw:
        kw["kv_mask"] = jnp.asarray(kw["kv_mask"])
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        out = np.asarray(jring(*args, mesh=mesh, **kw))
        if not grad:
            return out, None
        grads = jax.grad(
            lambda q, k, v: jnp.sum(jring(q, k, v, mesh=mesh, **kw) ** 2),
            argnums=(0, 1, 2))(*args)
    return out, [np.asarray(g) for g in grads]


def _check(two, seed, shape, grad=False, lengths=None, **kw):
    q, k, v = _qkv(seed, *shape)
    if lengths is not None:
        T = shape[1]
        kw["kv_mask"] = (np.arange(T)[None, :]
                         < np.asarray(lengths)[:, None]).astype(np.int32)
    got = two.run("job_ring", q, k, v, kw, grad)
    want, wgrads = _jax(q, k, v, grad=grad, **dict(kw))
    rows = lengths or [shape[1]] * shape[0]
    for b, n in enumerate(rows):
        np.testing.assert_allclose(got["out"][b, :n], want[b, :n], **TOL)
    if grad:
        for a, w in zip(got["grads"], wgrads):
            np.testing.assert_allclose(a, w, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(two, causal):
    _check(two, 0, (2, 128, 4, 2, 16), causal=causal)


def test_ring_with_padding_mask_matches_jax(two):
    _check(two, 1, (2, 64, 4, 4, 16), lengths=[64, 37], causal=True)


def test_ring_grad_matches_jax(two):
    _check(two, 2, (1, 64, 2, 2, 8), grad=True, causal=True)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_matches_jax(two, causal):
    _check(two, 3, (2, 128, 4, 2, 16), causal=causal, impl="flash")


def test_ring_flash_padding_mask_matches_jax(two):
    _check(two, 4, (2, 64, 4, 4, 16), lengths=[64, 37], causal=True,
           impl="flash")


def test_ring_flash_grad_matches_jax(two):
    _check(two, 5, (1, 64, 2, 2, 8), grad=True, causal=True, impl="flash")


def test_ring_flash_grad_with_mask_matches_jax(two):
    """The flash backward against the global lse on padded rows (a row
    whose keys are all masked past the length still meets key 0)."""
    _check(two, 6, (2, 64, 4, 2, 8), grad=True, lengths=[64, 37],
           causal=True, impl="flash")


def test_live_table_is_the_contiguous_causal_split():
    """Rank i of a contiguous causal split sees i + 1 live blocks (its own
    and the earlier ranks'), JAX's cond on min(kv_pos) <= max(q_pos)."""
    pos = np.tile(np.arange(64), (2, 1))
    for sp in (1, 2, 4):
        for i in range(sp):
            live = tring.live_table(pos, sp, i)
            assert live == tuple(s <= i for s in range(sp))
    with pytest.raises(ValueError, match="does not divide"):
        tring.live_table(pos[:, :63], 2, 0)


def test_ring_of_one_is_plain_attention():
    """A ring of one rank (no world) is plain attention, as JAX's ring on
    a one-device sp axis."""
    import torch

    from oryx_tpu_torch.ops.attention import attention

    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 2, 32, 4, 2, 8))
    for impl in ("xla", "flash"):
        got = tring.ring_attention(q, k, v, ring=tring.Ring(), causal=True,
                                   impl=impl)
        want = attention(q, k, v, causal=True)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("impl", ["ring", "ring_flash"])
def test_ring_config_forward_matches_jax(impl):
    """A ring config runs the whole model: the visual encode takes JAX's
    branch (the ViT's plain segment attention, the compressor's plain
    path) and the decoder the ring of one rank; logits equal JAX's
    `oryx.forward` on a one-device mesh."""
    import torch
    from jax.sharding import Mesh as JMesh

    from oryx_tpu.data import native_loader
    from oryx_tpu.models import oryx as joryx
    from oryx_tpu_torch.models import oryx as toryx
    from oryx_tpu_torch.models.convert import from_jax_params
    from torch_train_common import cfgs, make_batches, make_tree

    native_loader.is_available, keep = (lambda: False), \
        native_loader.is_available
    try:
        batch = {k: v[0] for k, v in make_batches()[1].items()}
    finally:
        native_loader.is_available = keep
    tree = make_tree()
    cj, ct = cfgs(impl=impl)
    fields = {k: v for k, v in batch.items() if k != "labels"}
    mesh = JMesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1, 1),
                 ("dp", "fsdp", "tp", "sp"))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(joryx.forward(
            jax.tree_util.tree_map(jnp.asarray, tree), cj, mesh=mesh,
            **{k: jnp.asarray(v) for k, v in fields.items()}))
    model = from_jax_params(tree, ct)
    with torch.no_grad():
        got = toryx.forward(model, ct, **{
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in fields.items()}).numpy()
    valid = batch["attn_mask"].astype(bool)
    np.testing.assert_allclose(got[valid], want[valid], **TOL)
