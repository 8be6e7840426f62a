"""The serving half of the port's sharding rules (parallel/sharding.py)
against the JAX package's: `param_specs` leaf by leaf through the name map
of models/convert.py (tiny and oryx_7b, every mode), `paged_kv_spec`; the
rank's slices (whole module, seeded init); the model's row-parallel sums,
run as two ranks in two threads of this process (qwen2, the ViT, the
compressor, and the quantized pool's row amax) against the whole model;
and the refusals (heads that do not divide, a leaf split over tp and fsdp
at once). The training half: fsdp placements over the combined fsdp x sp
width, `opt_state_specs`, `batch_spec` / `batch_field_spec` and
`cast_params_for_compute` against JAX's."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.parallel import sharding as jsharding  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import oryx, qwen2  # noqa: E402
from oryx_tpu_torch.ops import paged_kv  # noqa: E402
from oryx_tpu_torch.parallel import sharding  # noqa: E402


class _Mesh:
    """A mesh's axes (the rules read nothing else)."""
    mesh_dim_names = ("dp", "fsdp", "tp", "sp")

    def __init__(self, tp=2, fsdp=1, sp=1, dp=1):
        self.shape = (dp, fsdp, tp, sp)


class _Peers:
    """Two ranks as two threads: `all_reduce` meets at a barrier and
    reduces in rank order, as gloo's two-rank sum does."""

    def __init__(self, n=2):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots = [None] * n

    def rank(self, r):
        peers = self

        class Rank:
            size = peers.n
            rank = r

            def all_reduce(self, x, op="sum"):
                wide = torch.float32 if x.is_floating_point() else x.dtype
                peers.slots[r] = x.to(wide)
                peers.barrier.wait()
                stack = torch.stack(peers.slots)
                out = stack.sum(0) if op == "sum" else stack.amax(0)
                peers.barrier.wait()
                return out.to(x.dtype)

        return Rank()


def _on_two_ranks(fn):
    """[fn(rank 0), fn(rank 1)] run in lockstep threads."""
    peers = _Peers()
    out, errs = [None, None], []

    def run(r):
        try:
            out[r] = fn(peers.rank(r), r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)
            peers.barrier.abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    if errs:
        raise errs[0]
    return out


def _jax_specs(tree, mode):
    flat = jax.tree_util.tree_flatten_with_path(
        jsharding.param_specs(tree, mode),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {jsharding._path_str(p): tuple(s) for p, s in flat}


@pytest.mark.parametrize("preset", ["oryx_tiny", "oryx_7b"])
@pytest.mark.parametrize("mode", ["zero2", "fsdp", "ddp"])
def test_param_specs_match_jax_leaf_by_leaf(preset, mode):
    """Every port parameter's spec is JAX's for its leaf (layer axis
    dropped, linear kernels reversed), except the ViT o_proj pair, where
    JAX's `?_proj` patterns shadow the o_proj rules it declares: the port
    applies those declared rules."""
    jc = getattr(jcfg, preset)()
    jtree = jax.eval_shape(lambda: joryx.init_params(jc, jax.random.key(0)))
    want = _jax_specs(jtree, mode)
    model = oryx.empty_model(getattr(tcfg, preset)())
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    got = sharding.param_specs(model, mode)
    assert len(got) == len(list(model.parameters()))
    rules = jsharding.mesh_rules(mode)
    declared = dict(jsharding.LOGICAL_RULES)
    for name, spec in got.items():
        path, stacked = sharding.jax_path(name, name in linear)
        jspec = want[path]
        if path.startswith("vit/layers/o_proj/"):
            jspec = tuple(None if a is None else rules.get(a)
                          for a in declared[path])
            assert jspec != want[path]  # the shadowing is still there
        jspec = jspec[1:] if stacked else jspec
        if name in linear:
            jspec = tuple(reversed(jspec))
        assert spec == jspec, (name, path)


def test_paged_kv_spec_matches_jax():
    if jax.device_count() >= 2:
        from oryx_tpu.parallel.mesh import build_mesh

        jm = build_mesh(JMeshConfig(tp=2), devices=jax.devices()[:2])
        assert sharding.paged_kv_spec(_Mesh(tp=2)) == tuple(
            jsharding.paged_kv_spec(jm))
    assert sharding.paged_kv_spec(_Mesh(tp=1)) is None
    assert sharding.paged_kv_spec(None) is None


def test_rank_slices_are_contiguous_heads_and_columns():
    cfg = tcfg.oryx_tiny()
    model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    whole = model.state_dict()
    for r in range(2):
        place = sharding.param_shardings(_Mesh(), model, "zero2", rank=r)
        state = sharding.shard_params(model, place)
        q = "llm.layers.0.q_proj.weight"
        n = whole[q].shape[0] // 2
        assert torch.equal(state[q], whole[q][r * n:(r + 1) * n])
        o = "llm.layers.0.o_proj.weight"
        assert torch.equal(state[o], whole[o][:, r * n:(r + 1) * n])
        # Row-parallel biases stay whole; a column split's bias splits.
        for name in ("vit.layers.0.o_proj.bias", "vit.layers.0.fc2.bias",
                     "compressor.projector.fc2.bias", "llm.embed.weight"):
            assert torch.equal(state[name], whole[name]), name
        b = "compressor.projector.fc1.bias"
        m = whole[b].shape[0] // 2
        assert torch.equal(state[b], whole[b][r * m:(r + 1) * m])


def test_seeded_shards_are_slices_of_the_seeded_init():
    cfg = tcfg.oryx_tiny()
    whole = oryx.init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu").state_dict()
    for r in range(2):
        place = sharding.param_shardings(_Mesh(), oryx.empty_model(cfg),
                                         "zero2", rank=r)
        got = sharding.seeded_shard(cfg, place, 7, device="cpu",
                                    dtype=torch.float32)
        want = sharding.shard_params(whole, place)
        assert got.keys() == want.keys()
        for name in got:
            assert torch.equal(got[name], want[name]), name


def _ranks_model(cfg, model, world, r):
    place = sharding.param_shardings(_Mesh(), model, "zero2", rank=r)
    return sharding.local_model(cfg, sharding.shard_params(model, place),
                                world)


def test_row_parallel_forwards_sum_to_the_whole_model():
    """The decoder (dense cache), the ViT and the compressor at tp = 2:
    each rank's heads and columns, the row-parallel partials summed,
    equal the whole model's outputs."""
    cfg = tcfg.oryx_tiny()
    model = oryx.init_params(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(1, 400, (2, 9)))
    P = 12
    patches = torch.from_numpy(rng.normal(size=(P, 3 * cfg.vision.patch_size
                                                 ** 2)).astype(np.float32))
    seg = torch.tensor([1] * 8 + [2] * 4)
    coords = torch.from_numpy(rng.uniform(0, 4, (P, 2)).astype(np.float32))
    region = torch.tensor([1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 5, 5])
    q_region = torch.tensor([1, 2, 3, 4, 5, 0])

    def run(m):
        with torch.inference_mode():
            logits, _ = qwen2.forward(m.llm, cfg.llm, input_ids=ids)
            vis = oryx.encode_visual(m, cfg, patches, seg, coords, region,
                                     q_region)
        return logits, vis

    want = run(model)
    got = _on_two_ranks(lambda w, r: run(_ranks_model(cfg, model, w, r)))
    for out in got:
        for a, b in zip(out, want):
            torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-4)
    # Both ranks hold the same (whole) logits, bit for bit.
    assert torch.equal(got[0][0], got[1][0])


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
def test_quantized_rows_take_the_amax_over_every_rank(fmt):
    """A row's scale is the max over all heads: each rank's codes are the
    one-device pool's codes of its heads only with the all-reduced amax
    (without it, the rank that lacks the row's largest head encodes
    differently)."""
    rows = torch.from_numpy(np.random.default_rng(4).normal(
        size=(6, 2, 8)).astype(np.float32))
    rows[:, 1] *= 4.0
    one = paged_kv.init_quant_pages(1, 2, 4, 2, 8, fmt=fmt,
                                    device="cpu")[0]
    paged_kv.scatter_rows(one, torch.arange(6), rows)

    def write(world, r):
        plane = paged_kv.init_quant_pages(1, 2, 4, 1, 8, fmt=fmt,
                                          device="cpu")[0]
        paged_kv.scatter_rows(plane, torch.arange(6),
                              rows[:, r:r + 1].contiguous(), world)
        return plane

    planes = _on_two_ranks(write)
    for r, plane in enumerate(planes):
        assert torch.equal(plane.q.view(torch.uint8)[:, :, 0],
                           one.q.view(torch.uint8)[:, :, r])
        assert torch.equal(plane.scale, one.scale)
    alone = paged_kv.init_quant_pages(1, 2, 4, 1, 8, fmt=fmt,
                                      device="cpu")[0]
    paged_kv.scatter_rows(alone, torch.arange(6), rows[:, :1].contiguous())
    assert not torch.equal(alone.scale, one.scale)


def test_shard_paged_kv_keeps_a_sink_and_refuses_indivisible_heads():
    cfg = tcfg.oryx_tiny()
    pool = qwen2.init_paged_kv_cache(cfg.llm, 3, 4, dtype=torch.float32,
                                     device="cpu", kv_dtype="int8")
    pool["k"].q.view(torch.uint8)[:] = 7
    mine = sharding.shard_paged_kv(pool, _Mesh(), rank=1)
    L, P, ps, h, D = mine["k"].shape
    assert (P, h) == (3, cfg.llm.num_kv_heads // 2)
    assert torch.all(mine["k"].q.view(torch.uint8) == 7)
    # Writes through the sink-checked path land (a plane with no sink
    # behind it would raise).
    paged_kv.scatter_rows(mine["k"][0], torch.tensor([0]),
                          torch.ones((1, h, D)))
    assert sharding.shard_paged_kv(pool, _Mesh(tp=1)) is pool
    with pytest.raises(ValueError, match="do not divide"):
        sharding.shard_paged_kv(pool, _Mesh(tp=4), rank=0)


def test_divisibility_and_training_half_refusals():
    cfg = tcfg.oryx_tiny()
    with pytest.raises(ValueError, match="llm.num_kv_heads = 2"):
        sharding.check_divisible(cfg, 4)
    odd = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, num_heads=3))
    with pytest.raises(ValueError, match="vision.num_heads = 3"):
        sharding.check_divisible(odd, 2)
    sharding.check_divisible(tcfg.oryx_7b(), 2)
    # The training half places fsdp; a leaf with a heads/mlp dim and an
    # embed dim is cut on both under fsdp x tp (rank 3 of (1, 2, 2, 1):
    # fsdp index 1, tp index 1), one without a heads/mlp dim on embed only.
    assert sharding.param_shardings(
        _Mesh(fsdp=2, tp=1), oryx.empty_model(cfg), "fsdp",
        rank=1)["llm.embed.weight"] == sharding.Placement(1, 2, 1)
    place = sharding.param_shardings(_Mesh(fsdp=2, tp=2),
                                     oryx.empty_model(cfg), "fsdp", rank=3)
    assert place["llm.layers.0.q_proj.weight"] == sharding.Placement(
        1, 2, 1, (0, 2, 1))
    assert place["llm.embed.weight"] == sharding.Placement(1, 2, 1)
    whole = torch.arange(64 * 64.0).view(64, 64)
    assert torch.equal(place["llm.layers.0.q_proj.weight"].take(whole),
                       whole[32:, 32:])


# ---- the training half -------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2, 1, 1), (2, 2, 1, 1), (1, 2, 1, 2),
                                   (1, 1, 1, 4)])
def test_fsdp_placement_cuts_embed_over_fsdp_times_sp(shape):
    """Each rank's chunk of a leaf's embed dim is its index in its
    (fsdp, sp) group (dp replicas hold the same chunk); leaves without an
    embed axis stay whole; zero2 and ddp keep every leaf whole."""
    dp, fsdp, tp, sp = shape
    model = oryx.empty_model(tcfg.oryx_tiny())
    mesh = _Mesh(dp=dp, fsdp=fsdp, tp=tp, sp=sp)
    width = fsdp * sp
    seen = set()
    for r in range(dp * fsdp * sp):
        place = sharding.param_shardings(mesh, model, "fsdp", rank=r)
        embed = place["llm.embed.weight"]
        assert (embed.dim, embed.parts) == (1, width)
        seen.add((r // width, embed.index))
        assert place["llm.layers.0.q_proj.weight"].dim == 1
        assert place["llm.layers.0.o_proj.weight"].dim == 0
        assert not place["llm.final_norm.weight"].split
        assert not place["llm.layers.0.q_proj.bias"].split
        for mode in ("zero2", "ddp"):
            assert not any(p.split for p in sharding.param_shardings(
                mesh, model, mode, rank=r).values())
    assert seen == {(d, i) for d in range(dp) for i in range(width)}
    assert sharding.axis_group(shape, 0, ("fsdp", "sp")) == list(
        range(width))


@pytest.mark.parametrize("mode", ["fsdp", "zero2", "ddp"])
def test_opt_state_specs_match_jax(mode):
    """A moment's spec is its parameter's in both packages (JAX's
    opt_state_specs over optax's tree, the port's over AdamW's), and the
    counts are replicated; the parameters' specs are JAX's leaf by leaf
    (test_param_specs_match_jax_leaf_by_leaf), so the moments' are too."""
    from oryx_tpu.train import optimizer as jopt
    from oryx_tpu_torch.train import optimizer as topt

    jc = jcfg.oryx_tiny()
    jtree = joryx.init_params(jc, jax.random.key(0))
    jstate = jopt.make_optimizer(jc.train, jtree).init(jtree)
    jspecs = jsharding.opt_state_specs(jstate, jtree, mode)
    pspecs = _jax_specs(jtree, mode)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    moments = 0
    for path, spec in flat[0]:
        keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
        for kind in ("mu", "nu"):
            if kind in keys:
                leaf = "/".join(keys[keys.index(kind) + 1:])
                if leaf in pspecs:
                    assert tuple(spec) == pspecs[leaf], (kind, leaf)
                    moments += 1
    assert moments == 2 * len(pspecs)

    model = oryx.init_params(tcfg.oryx_tiny(), torch.Generator(),
                             device="cpu")
    tx = topt.make_optimizer(tcfg.oryx_tiny().train, model)
    specs = sharding.opt_state_specs(tx.init(model), model, mode)
    want = sharding.param_specs(model, mode)
    assert specs["count"] == {g: () for g in topt.GROUPS}
    for kind in ("mu", "nu"):
        assert specs[kind] == {n: want[n] for n in tx.trainable()}


def test_batch_specs_match_jax():
    from oryx_tpu_torch.train.step import BATCH_FIELDS

    assert sharding.batch_spec() == tuple(jsharding.batch_spec())
    assert sharding.VISUAL_BATCH_FIELDS == jsharding.VISUAL_BATCH_FIELDS
    for name in BATCH_FIELDS:
        assert sharding.batch_field_spec(name) == tuple(
            jsharding.batch_field_spec(name)), name


@pytest.mark.parametrize("mode", ["fsdp", "zero2", "ddp"])
def test_cast_params_for_compute_matches_jax(mode):
    """The compute-dtype cast of every leaf, bit for bit (off a mesh JAX's
    sharding constraint passes the cast through)."""
    from oryx_tpu_torch.models.convert import from_jax_params, to_jax_layout

    jc = jcfg.oryx_tiny()
    jtree = joryx.init_params(jc, jax.random.key(3))
    want = jsharding.cast_params_for_compute(jtree, jax.numpy.bfloat16, mode)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jtree),
                            tcfg.oryx_tiny())
    got = sharding.cast_params_for_compute(model, torch.bfloat16, mode)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    flat_got = jax.tree_util.tree_flatten_with_path(
        to_jax_layout(model, got))[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        b = np.asarray(flat_want[path], np.float32)
        assert np.array_equal(a, b), jax.tree_util.keystr(path)
