"""Sequence-packed text training in the port (`train/data.py::
collate_packed_text`, `models/qwen2.forward(segment_ids=)`,
`models/oryx.forward(text_segment_ids=)`, `train/step.py`,
`train/trainer.validate_train_batch`) against the JAX package on the CPU,
tiny fp32 config, the same weights and the same numpy-seeded samples.

The collated arrays are byte-equal to JAX's; logits, losses and steps
within atol 2e-4, rtol 2e-3. The packed mask (causal in slot order, segment
equality, pad rows with no key) runs through the plain attention and
through the kernel's twin, and on the JAX side through `attn_impl="xla"`
and the Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu.constants import IGNORE_INDEX  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen2  # noqa: E402
from oryx_tpu.train import data as jdata  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu.train import step as jstep  # noqa: E402
from oryx_tpu.train import trainer as jtrainer  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params,
    to_jax_layout,
)
from oryx_tpu_torch.train import data as tdata  # noqa: E402
from oryx_tpu_torch.train import optimizer as topt  # noqa: E402
from oryx_tpu_torch.train import step as tstep  # noqa: E402
from oryx_tpu_torch.train.trainer import validate_train_batch  # noqa: E402
from torch_train_common import (  # noqa: E402
    TOL,
    assert_moments,
    assert_trees,
    cfgs,
    make_tree,
    port_model,
    tbatch,
)

BASE_GRID = 8


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tree():
    return make_tree()


def examples(lengths, seed=0, vocab=512):
    """Text samples for both packages (the same numpy arrays): random ids,
    the back half supervised."""
    rng = np.random.default_rng(seed)
    out = {"jax": [], "port": []}
    for n in lengths:
        ids = rng.integers(3, vocab, size=n).astype(np.int64)
        labels = np.full(n, IGNORE_INDEX, np.int64)
        labels[n // 2:] = ids[n // 2:]
        out["jax"].append(jdata.Example(ids, labels, [], "image", 1))
        out["port"].append(tdata.Example(ids, labels, [], "image", 1))
    return out


def both(fn_name, lengths, seed=0, **kw):
    ex = examples(lengths, seed)
    return (getattr(jdata, fn_name)(ex["jax"], **kw),
            getattr(tdata, fn_name)(ex["port"], **kw))


def assert_bytes(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("lengths,kw", [
    ((11, 7, 5), dict(bucket=32)),
    ((20, 20, 20, 4), dict(bucket=32)),
    ((9, 6, 31, 2, 17), dict(bucket=32, num_rows=4)),
    ((3, 64), dict(bucket=64, num_rows=2, max_len=64,
                   base_grid=BASE_GRID, buckets=(64, 128))),
])
def test_collate_packed_text_is_byte_equal(lengths, kw):
    want, got = both("collate_packed_text", lengths, **kw)
    assert_bytes(got, want)


@pytest.mark.parametrize("case", ["long", "rows", "max_len", "images"])
def test_collate_packed_text_errors_match_jax(case):
    ex = examples((20, 20, 20))
    kw = dict(bucket=32)
    if case == "long":
        kw["bucket"] = 16
    elif case == "rows":
        kw["num_rows"] = 2
    elif case == "max_len":
        kw["max_len"] = 16
    else:
        img = np.zeros((14, 14, 3), np.uint8)
        ex = {"jax": [jdata.Example(np.asarray([5, 6]), np.asarray([5, 6]),
                                    [img], "image", 1)],
              "port": [tdata.Example(np.asarray([5, 6]), np.asarray([5, 6]),
                                     [img], "image", 1)]}
    with pytest.raises(ValueError) as want:
        jdata.collate_packed_text(ex["jax"], **kw)
    with pytest.raises(ValueError) as got:
        tdata.collate_packed_text(ex["port"], **kw)
    assert str(got.value) == str(want.value)


def test_packed_microbatches_are_byte_equal():
    want, got = both("collate_microbatches", (11, 7, 5, 9, 6, 4),
                     grad_accum_steps=2, packed_text=True, pack_bucket=32,
                     pack_num_rows=2, base_grid=BASE_GRID)
    assert got["token_ids"].shape == (2, 2, 32)
    assert_bytes(got, want)


def _forward_port(model, ct, packed, impl="xla"):
    with torch.no_grad():
        return tqwen2.forward(
            model.llm, ct.llm,
            input_ids=torch.from_numpy(packed["token_ids"]),
            positions=torch.from_numpy(packed["positions"]),
            kv_mask=torch.from_numpy(packed["attn_mask"]),
            segment_ids=torch.from_numpy(packed["text_segment_ids"]),
            attn_impl=impl,
        )[0].numpy()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_packed_logits_match_jax_and_unpacked(tree, impl):
    """Packed logits (2 rows, one all-pad row from num_rows) equal JAX's
    at the same impl, and each sample's span equals the sample run alone."""
    cj, ct = cfgs(impl=impl)
    lengths = (11, 7, 5, 9)
    packed = both("collate_packed_text", lengths, bucket=16, num_rows=4)[1]
    model = from_jax_params(tree, ct)
    got = _forward_port(model, ct, packed, impl)
    want = np.asarray(jqwen2.forward(
        jax.tree_util.tree_map(jnp.asarray, tree["llm"]), cj.llm,
        input_ids=jnp.asarray(packed["token_ids"]),
        positions=jnp.asarray(packed["positions"]),
        kv_mask=jnp.asarray(packed["attn_mask"]),
        segment_ids=jnp.asarray(packed["text_segment_ids"]),
        attn_impl=impl)[0])
    live = packed["attn_mask"] > 0
    np.testing.assert_allclose(got[live], want[live], **TOL)
    assert np.isfinite(got).all()
    segs = packed["text_segment_ids"]
    seen = 0
    for r in range(segs.shape[0]):
        for s in range(1, int(segs[r].max()) + 1):
            span = segs[r] == s
            seen += 1
            with torch.no_grad():
                solo = tqwen2.forward(
                    model.llm, ct.llm,
                    input_ids=torch.from_numpy(
                        packed["token_ids"][r, span][None]),
                    attn_impl=impl)[0].numpy()[0]
            np.testing.assert_allclose(got[r, span], solo, **TOL)
    assert seen == len(lengths)


def _loss(model, ct, host):
    mb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in host.items()}
    with torch.no_grad(), tstep.compute_params(model, torch.float32):
        loss, m = tstep.microbatch_loss(model, ct, mb)
    return float(loss), int(m["num_tokens"])


def test_packed_loss_matches_padded(tree):
    """The packed and the padded collations supervise the same tokens: the
    same mean CE (and JAX's)."""
    cj, ct = cfgs()
    model = from_jax_params(tree, ct)
    ex = examples((11, 7, 5, 13))
    padded = tdata.collate(ex["port"], base_grid=BASE_GRID)
    packed = tdata.collate_packed_text(ex["port"], bucket=32,
                                       base_grid=BASE_GRID)
    lpad, npad = _loss(model, ct, padded)
    lpack, npack = _loss(model, ct, packed)
    assert npad == npack
    np.testing.assert_allclose(lpack, lpad, rtol=1e-5)
    jl, _ = jstep.microbatch_loss(
        jax.tree_util.tree_map(jnp.asarray, tree), cj,
        {k: jnp.asarray(v) for k, v in packed.items()})
    np.testing.assert_allclose(lpack, float(jl), **TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_packed_microbatch_train_step_matches_jax(tree, impl):
    """3 steps over two packed microbatches (accum 2, an all-pad row in
    each): loss, grad_norm, num_tokens, moments and params vs JAX."""
    cj, ct = cfgs(impl=impl, accum=2, lr=1e-4)
    host = tdata.collate_microbatches(
        examples((11, 7, 5, 9, 6, 4))["port"], 2, packed_text=True,
        pack_bucket=16, pack_num_rows=3, base_grid=BASE_GRID)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.make_optimizer(cj.train, jp)
    jb = jax.tree_util.tree_map(jnp.asarray, host)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=tx.init(jp))
    model = port_model(tree, ct)
    ttx = topt.make_optimizer(ct.train, model)
    tstate = tstep.init_state(model, ttx)
    for it in range(3):
        jstate, jm = jstep.train_step(jstate, jb, cfg=cj, tx=tx)
        tstate, tm = tstep.train_step(tstate, tbatch(host), ct, ttx)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL, err_msg=f"loss {it}")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), **TOL)
        assert int(tm["num_tokens"]) == int(jm["num_tokens"])
    assert_moments(model, tstate.opt_state, jstate.opt_state)
    assert_trees(to_jax_layout(model), jstate.params, "params")


def test_segment_ids_rejected_with_a_cache_or_ring(tree):
    _, ct = cfgs()
    model = from_jax_params(tree, ct)
    ids = torch.zeros((1, 8), dtype=torch.int64)
    segs = torch.ones((1, 8), dtype=torch.int32)
    cache = tqwen2.init_kv_cache(ct.llm, 1, 16, torch.float32, device="cpu")
    for kw in (dict(kv_cache=cache), dict(attn_impl="ring")):
        with pytest.raises(ValueError, match="segment_ids"):
            tqwen2.forward(model.llm, ct.llm, input_ids=ids,
                           segment_ids=segs, **kw)


@pytest.mark.parametrize("impl", ["xla", "pallas", "ring", "ring_flash"])
def test_validate_train_batch_matches_jax(impl):
    cj, ct = cfgs(impl=impl)
    _, host = both("collate_packed_text", (5, 7), bucket=16)
    plain = {k: v for k, v in host.items() if k != "text_segment_ids"}
    validate_train_batch(ct, plain)
    jtrainer.validate_train_batch(cj, plain)
    if impl.startswith("ring"):
        with pytest.raises(ValueError) as want:
            jtrainer.validate_train_batch(cj, host)
        with pytest.raises(ValueError) as got:
            validate_train_batch(ct, host)
        assert str(got.value) == str(want.value)
    else:
        validate_train_batch(ct, host)
        jtrainer.validate_train_batch(cj, host)


def test_trainer_fits_packed_batches(tree, tmp_path):
    """Trainer.fit on packed text batches (the batch check, the segment
    ids through the step), its losses equal train_step's, and each step
    records its model FLOPs as JAX's telemetry counts them."""
    from oryx_tpu.train import telemetry as jtel
    from oryx_tpu_torch.train.trainer import Trainer

    cj, ct = cfgs(checkpoint_dir=str(tmp_path / "ckpt"))
    host = tdata.collate_packed_text(examples((11, 7, 5, 9))["port"],
                                     bucket=16, num_rows=3,
                                     base_grid=BASE_GRID)
    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu")
    t.fit(iter([host] * 2), num_steps=2, resume=False, prefetch=0)
    model = port_model(tree, ct)
    ttx = topt.make_optimizer(ct.train, model)
    state = tstep.init_state(model, ttx)
    for h in t.history:
        state, m = tstep.train_step(
            state, {k: v[None] for k, v in tbatch(host).items()}, ct, ttx)
        assert h["loss"] == pytest.approx(m["loss"].item(), rel=1e-6)
        assert h["model_flops"] == jtel.batch_flops(cj, host)
        assert "mfu" not in h  # no peak on the CPU
    t.close()
