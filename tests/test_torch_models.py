"""The port's model modules against the JAX package on the CPU, with the
same weights (JAX init -> numpy -> `from_jax_params`): qwen2.forward without
a cache and over the dense cache (prefill + three decode steps),
oryx_vit.forward, compressor.forward at side factors 1, 2 and 4, and
embed_spliced; under attn_impl "xla" and "pallas" (the JAX kernel in
interpret mode, the port's plain twin on CPU tensors).

The weights are made input-sensitive before both packages see them:
kernels and tables scaled x10, biases and norm weights randomized, so a
transposed or dropped parameter cannot hide behind the zero-bias,
unit-norm init.

Tolerance (fp32): atol=2e-4, rtol=2e-3 (the tests/test_qwen2.py bar).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import compressor as jcomp  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.models import oryx_vit as jvit  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen  # noqa: E402
from oryx_tpu.models import splice as jsplice  # noqa: E402
from oryx_tpu.ops import packing as jpack  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import compressor as tcomp  # noqa: E402
from oryx_tpu_torch.models import oryx as toryx  # noqa: E402
from oryx_tpu_torch.models import oryx_vit as tvit  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen  # noqa: E402
from oryx_tpu_torch.models import splice as tsplice  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
IMPLS = ["xla", "pallas"]
CFG_J = jcfg.oryx_tiny()
CFG_T = tcfg.OryxConfig.from_dict(CFG_J.to_dict())


def input_sensitive(tree, seed=0):
    """Numpy copy of a JAX param tree with kernels/tables x10 and random
    biases and norm weights."""
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "weight" and np.all(a == 1):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 10

    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def weights():
    tree = input_sensitive(joryx.init_params(CFG_J, jax.random.key(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, from_jax_params(tree, CFG_T)


@pytest.fixture(autouse=True)
def full_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture
def packed(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
            for h, w in ((40, 56), (60, 30), (28, 42))]
    return imgs


def _pack(imgs, factors):
    return jpack.pack_raw_images(
        imgs, patch_size=14, base_grid=CFG_J.vision.base_grid,
        side_factors=factors,
    )


def _t(x):
    return torch.from_numpy(np.array(x))


def test_converted_state_covers_every_leaf(weights):
    jp, tp = weights
    n_jax = sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(jp)
    )
    assert n_jax == sum(p.numel() for p in tp.parameters())
    assert not any(p.requires_grad for p in tp.parameters())


def test_init_params_shapes_match_jax():
    tp = toryx.init_params(CFG_T, torch.Generator().manual_seed(0),
                           device="cpu")
    jp = joryx.init_params(CFG_J, jax.random.key(0))
    assert sum(p.numel() for p in tp.parameters()) == sum(
        np.asarray(x).size for x in jax.tree_util.tree_leaves(jp)
    )
    w = tp.llm.layers[0].q_proj.weight
    assert w.std().item() == pytest.approx(0.02, rel=0.2)
    assert torch.all(tp.llm.final_norm.weight == 1)


@pytest.mark.parametrize("impl", IMPLS)
def test_qwen2_forward_no_cache(weights, impl):
    jp, tp = weights
    rng = np.random.default_rng(2)
    lens = np.asarray([17, 9])
    T = 17
    ids = rng.integers(1, CFG_J.llm.vocab_size, size=(2, T)).astype(np.int32)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    want, _ = jqwen.forward(
        jp["llm"], CFG_J.llm, input_ids=jnp.asarray(ids),
        kv_mask=jnp.asarray(mask), attn_impl=impl,
    )
    got, _ = tqwen.forward(
        tp.llm, CFG_T.llm, input_ids=_t(ids).long(), kv_mask=_t(mask),
        attn_impl=impl,
    )
    keep = mask.astype(bool)
    np.testing.assert_allclose(np.asarray(want)[keep], got.numpy()[keep],
                               **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_qwen2_dense_cache_prefill_and_decode(weights, impl):
    """Prefill into the dense cache, then three single-token decode steps
    (the generate loop's calls), feeding both packages the same tokens."""
    jp, tp = weights
    cl, ct = CFG_J.llm, CFG_T.llm
    rng = np.random.default_rng(3)
    B, T, S = 2, 12, 32
    lens = np.asarray([12, 7], np.int32)
    ids = rng.integers(1, cl.vocab_size, size=(B, T)).astype(np.int32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    jcache = jqwen.init_kv_cache(cl, B, S, dtype=jnp.float32)
    tcache = tqwen.init_kv_cache(ct, B, S, dtype=torch.float32, device="cpu")

    def step(ids, pos, kv_mask, slots):
        nonlocal jcache
        want, jcache = jqwen.forward(
            jp["llm"], cl, input_ids=jnp.asarray(ids),
            positions=jnp.asarray(pos), kv_cache=jcache,
            write_slots=jnp.asarray(slots), kv_mask=jnp.asarray(kv_mask),
            attn_impl=impl,
        )
        got, _ = tqwen.forward(
            tp.llm, ct, input_ids=_t(ids).long(), positions=_t(pos).long(),
            kv_cache=tcache, write_slots=_t(slots),
            kv_mask=_t(kv_mask), attn_impl=impl,
        )
        return np.asarray(want), got.numpy()

    slot = np.arange(S)[None]
    want, got = step(ids, pos, (slot < lens[:, None]).astype(np.int32),
                     np.zeros(B, np.int32))
    keep = np.arange(T)[None] < lens[:, None]
    np.testing.assert_allclose(want[keep], got[keep], **TOL)
    tok = want[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    cur = lens.copy()
    for _ in range(3):
        want, got = step(tok[:, None], cur[:, None],
                         (slot <= cur[:, None]).astype(np.int32), cur)
        np.testing.assert_allclose(want, got, **TOL)
        tok = want[:, 0].argmax(-1).astype(np.int32)
        cur = cur + 1
    for name in ("k", "v"):
        for b in range(B):
            np.testing.assert_allclose(
                np.asarray(jcache[name])[:, b, : cur[b]],
                tcache[name][:, b, : cur[b]].numpy(), **TOL,
            )


@pytest.mark.parametrize("impl", IMPLS)
def test_oryx_vit_forward(weights, impl, packed):
    jp, tp = weights
    pk = _pack(packed, 1)
    want = jvit.forward(
        jp["vit"], CFG_J.vision, jnp.asarray(pk.patches),
        jnp.asarray(pk.segment_ids), jnp.asarray(pk.pos_coords),
        attn_impl=impl,
    )
    got = tvit.forward(
        tp.vit, CFG_T.vision, _t(pk.patches), _t(pk.segment_ids),
        _t(pk.pos_coords), attn_impl=impl,
    )
    keep = pk.segment_ids > 0
    np.testing.assert_allclose(np.asarray(want)[keep], got.numpy()[keep],
                               **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("factor", [1, 2, 4])
def test_compressor_forward(weights, factor, impl, packed):
    jp, tp = weights
    pk = _pack(packed, factor)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal(
        (pk.segment_ids.shape[0], CFG_J.vision.hidden_size)
    ).astype(np.float32)
    want = jcomp.forward(
        jp["compressor"], CFG_J.compressor, CFG_J.vision, jnp.asarray(feats),
        jnp.asarray(pk.region_ids), jnp.asarray(pk.q_region_ids),
        attn_impl=impl,
    )
    got = tcomp.forward(
        tp.compressor, CFG_T.compressor, CFG_T.vision, _t(feats),
        _t(pk.region_ids), _t(pk.q_region_ids), attn_impl=impl,
    )
    # Pad queries are zero in both; valid ones carry the function.
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)
    assert np.abs(got.numpy()[: pk.num_queries]).max() > 0.1


def test_embed_spliced(weights, packed):
    jp, tp = weights
    pk = _pack(packed, 2)
    ids = [np.asarray([3, -200, 5], np.int32),
           np.asarray([-200, -200, 9, 10], np.int32)]
    batch = jsplice.build_mm_batch(ids, jsplice.query_slots(pk))
    rng = np.random.default_rng(5)
    vis = rng.standard_normal(
        (pk.q_region_ids.shape[0], CFG_J.llm.hidden_size)
    ).astype(np.float32)
    want = jsplice.embed_spliced(
        jp["llm"]["embed"]["weight"], jnp.asarray(vis),
        jnp.asarray(batch.token_ids), jnp.asarray(batch.visual_idx),
        jnp.asarray(batch.is_visual),
    )
    got = tsplice.embed_spliced(
        tp.llm.embed.weight, _t(vis), _t(batch.token_ids),
        _t(batch.visual_idx), _t(batch.is_visual),
    )
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_visual_mixed_factors(weights, impl, packed):
    """ViT + compressor under one config, mixed 1x/4x/16x in one pack."""
    jp, tp = weights
    pk = _pack(packed, [1, 2, 4])
    cj = dataclasses.replace(CFG_J, attn_impl=impl)
    ct = dataclasses.replace(CFG_T, attn_impl=impl)
    arrs = [pk.patches, pk.segment_ids, pk.pos_coords, pk.region_ids,
            pk.q_region_ids]
    want = joryx.encode_visual(jp, cj, *[jnp.asarray(a) for a in arrs])
    got = toryx.encode_visual(tp, ct, *[_t(a) for a in arrs])
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **TOL)


def test_from_jax_params_keeps_bf16():
    """A bf16 JAX tree (ml_dtypes arrays in numpy) converts exactly."""
    cfg = jcfg.oryx_tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, joryx.init_params(cfg, jax.random.key(1), jnp.bfloat16)
    )
    tp = from_jax_params(tree, tcfg.OryxConfig.from_dict(cfg.to_dict()))
    assert all(p.dtype == torch.bfloat16 for p in tp.parameters())
    want = np.asarray(tree["llm"]["layers"]["q_proj"]["kernel"][1], np.float32)
    got = tp.llm.layers[1].q_proj.weight.float().numpy().T
    np.testing.assert_array_equal(want, got)


def test_sample_token_greedy_and_seeded():
    """temperature 0 is argmax (first max on ties, as jnp.argmax); sampling
    is reproducible from a seeded generator and stays inside top-k/top-p."""
    from oryx_tpu_torch.models.generate import sample_token

    rng = np.random.default_rng(6)
    logits = torch.from_numpy(rng.standard_normal((5, 50)).astype(np.float32))
    logits[0, 3] = logits[0, 7] = logits[0].max() + 1
    greedy = sample_token(logits, None, temperature=0.0, top_p=1.0, top_k=0)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1))
    )

    def draw(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return sample_token(logits, g, temperature=1.0, **kw)

    assert torch.equal(draw(3, top_p=1.0, top_k=0), draw(3, top_p=1.0, top_k=0))
    top3 = torch.topk(logits, 3, dim=-1).indices
    for seed in range(5):
        s = draw(seed, top_p=1.0, top_k=3)
        assert all(int(s[b]) in top3[b].tolist() for b in range(5))
        # A tiny nucleus keeps only the top token (both, on row 0's tie).
        s = draw(seed, top_p=1e-6, top_k=0).long()
        assert torch.equal(logits[torch.arange(5), s], logits.max(-1).values)
