"""LoRA in the port (`models/qwen2.add_lora_params` / `merge_lora_params`,
`utils/quant.linear`'s residual, `train/optimizer.trainable_mask('lora')`,
the Trainer's set-up, `models/import_hf`'s PEFT merge and export,
`serve/builder.load_from_hf(lora_path=)`) against the JAX package on the
CPU, tiny fp32 config, the same weights and adapters (JAX tree -> numpy ->
`from_jax_params`, which carries lora_a / lora_b / lora_scale).

Tolerance: atol 2e-4, rtol 2e-3 unless bytes are pinned (the PEFT files).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import import_hf as jimport  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen2  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu.train import step as jstep  # noqa: E402
from oryx_tpu.utils import quant as jquant  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import import_hf as timport  # noqa: E402
from oryx_tpu_torch.models import oryx as toryx  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import (  # noqa: E402
    from_jax_params,
    to_jax_layout,
)
from oryx_tpu_torch.serve import builder  # noqa: E402
from oryx_tpu_torch.train import optimizer as topt  # noqa: E402
from oryx_tpu_torch.train import step as tstep  # noqa: E402
from oryx_tpu_torch.train.trainer import Trainer, setup_lora  # noqa: E402
from oryx_tpu_torch.utils import quant as tquant  # noqa: E402
from torch_train_common import (  # noqa: E402
    TOL,
    assert_moments,
    assert_trees,
    cfgs,
    flat,
    make_batches,
    make_tree,
    port_model,
    tbatch,
)

TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
           "down_proj")
LORA = dict(enable=True, r=4, alpha=8.0, targets=TARGETS)


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


def lora_cfgs(impl="xla", **train):
    train.setdefault("lora", jcfg.LoraConfig(**LORA))
    return cfgs(impl=impl, tune="lora", **train)


def with_adapters(tree, cj, b_scale=0.05, seed=1):
    """JAX's enable_lora on `tree`, lora_b drawn nonzero (x b_scale) so the
    adapters change the function, as numpy."""
    t = joryx.enable_lora(jax.tree_util.tree_map(jnp.asarray, tree), cj,
                          jax.random.key(seed))
    rng = np.random.default_rng(seed)

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        if str(getattr(path[-1], "key", "")) == "lora_b" and b_scale:
            return (b_scale * rng.standard_normal(a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, t)


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def batches():
    return make_batches()


def jax_logits(tree, cj, ids):
    return np.asarray(jqwen2.forward(
        jax.tree_util.tree_map(jnp.asarray, tree["llm"]), cj.llm,
        input_ids=jnp.asarray(ids))[0])


def port_logits(model, ct, ids):
    with torch.no_grad():
        return tqwen2.forward(model.llm, ct.llm,
                              input_ids=torch.from_numpy(ids))[0].numpy()


IDS = np.random.default_rng(3).integers(0, 500, (2, 9)).astype(np.int32)


def test_zero_init_is_identity(tree):
    """B = 0: the adapted model computes the base model's logits, in both
    packages; the port's init is its own draw, from a torch.Generator."""
    cj, ct = lora_cfgs()
    model = from_jax_params(tree, ct)
    base = port_logits(model, ct, IDS)
    toryx.enable_lora(model, ct, torch.Generator().manual_seed(5))
    a = model.llm.layers[0].q_proj.lora_a
    assert a.shape == (64, 4) and float(a.abs().max()) > 0
    assert float(model.llm.layers[1].down_proj.lora_b.abs().max()) == 0
    np.testing.assert_allclose(port_logits(model, ct, IDS), base, **TOL)
    jt = with_adapters(tree, cj, b_scale=0)
    np.testing.assert_allclose(jax_logits(jt, cj, IDS), base, **TOL)


def test_adapted_logits_match_jax(tree):
    cj, ct = lora_cfgs()
    jt = with_adapters(tree, cj)
    model = from_jax_params(jt, ct)
    got = port_logits(model, ct, IDS)
    np.testing.assert_allclose(got, jax_logits(jt, cj, IDS), **TOL)
    assert not np.allclose(got, jax_logits(tree, cj, IDS), **TOL)
    # The leaves come back in JAX's layout.
    assert_trees(to_jax_layout(model), jt, "leaves", atol=0, rtol=0)


def test_lora_mask_matches_jax(tree):
    cj, ct = lora_cfgs()
    jt = with_adapters(tree, cj)
    model = from_jax_params(jt, ct)
    mask = topt.trainable_mask(model, "lora")
    jmask = flat(jopt.trainable_mask(jt, "lora"))
    got = flat(to_jax_layout(model, {
        n: torch.full_like(p, float(mask[n]))
        for n, p in model.named_parameters()}))
    assert set(got) == set(jmask)
    for k, v in jmask.items():
        assert np.all(got[k] == float(v)), k
    trainable = {n for n, m in mask.items() if m}
    assert all(n.endswith(("lora_a", "lora_b")) or n.startswith("compressor.")
               for n in trainable)
    assert not any(n.endswith("lora_scale") for n in trainable)
    # Weight decay sees the adapters at their stacked JAX rank.
    p = dict(model.named_parameters())
    for n in ("llm.layers.0.q_proj.lora_a", "llm.layers.1.down_proj.lora_b"):
        assert topt._jax_ndim(n, p[n]) == 3


@pytest.mark.parametrize("impl,accum", [("xla", 1), ("pallas", 2)])
def test_lora_train_step_matches_jax(tree, batches, impl, accum):
    """3 steps of tune='lora' (weight decay on, to cover the adapters'
    decay rank): loss, grad_norm (every leaf, lora_scale and the frozen
    base included), every gradient leaf at the start (accum 1), the Adam
    moments and the params."""
    cj, ct = lora_cfgs(impl=impl, accum=accum, weight_decay=0.1, lr=1e-4,
                       loss_chunk=32)
    jt = with_adapters(tree, cj)
    batch = batches[accum]
    jp = jax.tree_util.tree_map(jnp.asarray, jt)
    tx = jopt.make_optimizer(cj.train, jp)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    model = port_model(jt, ct)
    if accum == 1:
        jgrads = jax.jit(jax.grad(
            lambda p: jstep.microbatch_loss(
                p, cj, jax.tree_util.tree_map(lambda x: x[0], jb))[0]
        ))(jp)
        tgrads, _, _ = tstep.gradients(model, ct, tbatch(batch))
        names = [n for n, _ in model.named_parameters()]
        by_name = dict(zip(names, tgrads))
        assert float(by_name["llm.layers.0.q_proj.lora_scale"].abs().max()) > 0
        assert_trees(to_jax_layout(model, by_name), jgrads, "grad")
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=tx.init(jp))
    ttx = topt.make_optimizer(ct.train, model)
    tstate = tstep.init_state(model, ttx)
    for it in range(3):
        jstate, jm = jstep.train_step(jstate, jb, cfg=cj, tx=tx)
        tstate, tm = tstep.train_step(tstate, tbatch(batch), ct, ttx)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   **TOL, err_msg=f"loss {it}")
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), **TOL)
    assert_moments(model, tstate.opt_state, jstate.opt_state)
    assert_trees(to_jax_layout(model), jstate.params, "params")
    # Frozen leaves stayed bitwise; every adapter moved.
    start = from_jax_params(jt, ct).state_dict()
    for n, p in model.named_parameters():
        moved = not np.array_equal(p.detach().numpy(), start[n].numpy())
        if n.endswith(("lora_a", "lora_b")):
            assert moved, n
        elif not n.startswith("compressor."):
            assert not moved, n


def test_merge_equals_adapted_forward(tree):
    """merge_lora (in place) gives the adapted forward's logits, and JAX's
    merged kernels."""
    cj, ct = lora_cfgs()
    jt = with_adapters(tree, cj)
    model = from_jax_params(jt, ct)
    adapted = port_logits(model, ct, IDS)
    toryx.merge_lora(model)
    assert not any("lora" in n for n, _ in model.named_parameters())
    np.testing.assert_allclose(port_logits(model, ct, IDS), adapted, **TOL)
    merged = joryx.merge_lora(jax.tree_util.tree_map(jnp.asarray, jt))
    assert_trees(to_jax_layout(model), merged, "merged")


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(
        os.listdir(d))}


def test_peft_export_is_byte_equal_and_merges_both_ways(tmp_path, tree):
    cj, ct = lora_cfgs()
    lora = ct.train.lora
    jt = with_adapters(tree, cj)
    model = from_jax_params(jt, ct)
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jimport.export_lora_dir(jax.tree_util.tree_map(jnp.asarray, jt["llm"]),
                            cj.train.lora, dj)
    timport.export_lora_dir(model.llm, lora, dt)
    fj, ft = _files(dj), _files(dt)
    assert list(fj) == ["adapter_config.json", "adapter_model.safetensors"]
    assert ft == fj
    # Each package merges the other's directory into the base weights.
    base = jax.tree_util.tree_map(jnp.asarray, tree["llm"])
    want = jimport.merge_lora_dir(base, dt, cj.llm)
    got = timport.merge_lora_dir(from_jax_params(tree, ct).llm, dj, ct.llm)
    assert_trees(to_jax_layout(got), want, "merged from PEFT")
    with pytest.raises(ValueError, match="lora.r"):
        timport.export_lora(model.llm, dataclasses.replace(lora, r=8))
    with pytest.raises(ValueError, match="no LoRA adapters"):
        timport.export_lora(from_jax_params(tree, ct).llm, lora)


def test_merge_lora_refuses_what_jax_refuses(tree):
    _, ct = lora_cfgs()
    llm = from_jax_params(tree, ct).llm
    a = np.zeros((4, 64), np.float32)
    key = "base_model.model.model.layers.{}.self_attn.q_proj.lora_{}.weight"
    for sd, match in (
        ({key.format(0, "A"): a}, "incomplete"),
        ({key.format(5, "A"): a, key.format(5, "B"): a.T}, "out of range"),
        ({"base_model.model.lm_head.lora_A.weight": a}, "unsupported"),
        ({}, "no LoRA weights"),
    ):
        with pytest.raises(ValueError, match=match):
            timport.merge_lora(llm, sd, ct.llm, scaling=2.0)


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]


def test_load_from_hf_merges_the_adapter_as_jax(tmp_path, tree):
    """JAX's HF checkpoint + JAX's PEFT directory: the port's
    load_from_hf(lora_path=) decoder equals JAX's builder steps
    (import_qwen2, then merge_lora_dir)."""
    cj, ct = lora_cfgs()
    jt = with_adapters(tree, cj)
    d, dl = str(tmp_path / "hf"), str(tmp_path / "adapter")
    jimport.save_hf_checkpoint(tree, cj.llm, cj.vision, d)
    jimport.export_lora_dir(jax.tree_util.tree_map(jnp.asarray, jt["llm"]),
                            cj.train.lora, dl)
    _, got, _ = builder.load_from_hf(d, d, ct, lora_path=dl,
                                     tokenizer=CharTokenizer(), device="cpu")
    want = jimport.merge_lora_dir(
        jimport.import_qwen2(jimport.load_safetensors_dir(d), cj.llm), dl,
        cj.llm)
    assert_trees(to_jax_layout(got.llm), want, "load_from_hf")


def test_int8_base_with_adapters_matches_jax(tree):
    """JAX's quantize_params keeps the adapters in float beside the int8
    kernels; the port's converted model (Q8Linear with adapters, the MLP
    grouped) and its own quantize_params give JAX's logits."""
    cj, ct = lora_cfgs()
    wide = dataclasses.replace(cj, llm=dataclasses.replace(
        cj.llm, vocab_size=1024, hidden_size=128, intermediate_size=512,
        num_heads=8, head_dim=16))
    wt = tcfg.OryxConfig.from_dict(wide.to_dict())
    base = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * 3,
        joryx.init_params(wide, jax.random.key(0)))
    jt = with_adapters(base, wide)
    qtree = jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, jt))
    want = jax_logits(qtree, wide, IDS)
    model = from_jax_params(qtree, wt)
    layer = model.llm.layers[0]
    assert isinstance(layer.gate_proj, tquant.Q8Linear)
    assert "lora_a" in layer.gate_proj._parameters
    np.testing.assert_allclose(port_logits(model, wt, IDS), want, **TOL)
    q = tquant.quantize_params(from_jax_params(jt, wt))
    np.testing.assert_allclose(port_logits(q, wt, IDS), want, **TOL)


def test_trainer_refusals(tree):
    _, ct = lora_cfgs()
    with pytest.raises(ValueError, match="requires train.lora.enable"):
        setup_lora(dataclasses.replace(ct, train=dataclasses.replace(
            ct.train, lora=dataclasses.replace(ct.train.lora,
                                               enable=False))),
                   from_jax_params(tree, ct))
    with pytest.raises(ValueError, match="empty lora.targets"):
        setup_lora(dataclasses.replace(ct, train=dataclasses.replace(
            ct.train, lora=dataclasses.replace(ct.train.lora, targets=()))),
                   from_jax_params(tree, ct))
    with pytest.raises(ValueError, match="unknown LoRA target"):
        setup_lora(dataclasses.replace(ct, train=dataclasses.replace(
            ct.train, lora=dataclasses.replace(ct.train.lora,
                                               targets=("input_norm",)))),
                   from_jax_params(tree, ct))
    # Adapters on q/v only, config on all seven: refused.
    cj_qv, _ = lora_cfgs(lora=jcfg.LoraConfig(**dict(
        LORA, targets=("q_proj", "v_proj"))))
    narrow = from_jax_params(with_adapters(tree, cj_qv), ct)
    with pytest.raises(ValueError, match="silently narrower"):
        Trainer(ct, params=narrow, device="cpu")
    # No adapters: the Trainer attaches them (seed + 1), B = 0.
    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu")
    names = [n for n, _ in t.state.params.named_parameters()]
    assert sum(n.endswith("lora_a") for n in names) == 2 * len(TARGETS)
    assert t.tx.trainable() == [
        n for n in names
        if n.endswith(("lora_a", "lora_b")) or n.startswith("compressor.")]
    t.close()


def test_merge_in_memory_equals_merge_of_the_export(tmp_path, tree):
    """merge_lora of the in-memory adapters and merge_lora_dir of their
    PEFT export give the same bits (one product, on the same operands)."""
    cj, ct = lora_cfgs()
    jt = with_adapters(tree, cj)
    d = str(tmp_path / "adapter")
    timport.export_lora_dir(from_jax_params(jt, ct).llm, ct.train.lora, d)
    want = toryx.merge_lora(from_jax_params(jt, ct)).llm.state_dict()
    got = timport.merge_lora_dir(from_jax_params(tree, ct).llm, d,
                                 ct.llm).state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_save_pretrained_keeps_the_adapters(tmp_path, tree):
    """A model with adapters written by save_pretrained loads back with
    them (load_pretrained_model registers their shells), byte-equal."""
    cj, ct = lora_cfgs()
    model = from_jax_params(with_adapters(tree, cj), ct)
    d = str(tmp_path / "m")
    builder.save_pretrained(d, ct, model)
    _, back, _ = builder.load_pretrained_model(d, tokenizer=CharTokenizer(),
                                               device="cpu")
    want, got = model.state_dict(), back.state_dict()
    assert got.keys() == want.keys()
    assert sum(k.endswith("lora_a") for k in got) == 2 * len(TARGETS)
    for k in want:
        assert torch.equal(got[k], want[k]), k
