"""The port's model builder (`oryx_tpu_torch/serve/builder.py`) on the CPU:
`save_pretrained` -> `load_pretrained_model` round trips exactly (fp32,
bf16, a training state, an int8 model), `dtype=` casts, `quantize="int8"`
on load gives the JAX package's codes for the same numpy weights,
`load_pipeline` gives the JAX pipeline's greedy tokens (float and int8),
and the error paths raise as JAX's do; with a mesh (tp or fsdp) the
weights stay on disk for each rank to cut its slices.
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.utils import quant as jquant  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.data import native_loader as tnative  # noqa: E402
from oryx_tpu_torch.models import oryx as toryx  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve import builder  # noqa: E402
from oryx_tpu_torch.utils import quant as tquant  # noqa: E402
from oryx_tpu_torch.utils import safetensors as tst  # noqa: E402


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def _quantizable(cfg):
    """tests/test_quant.py's `_quantizable_cfg`."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=1024, hidden_size=128, intermediate_size=512,
        num_heads=8, head_dim=16))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """(JAX cfg, port cfg, numpy tree x20, the port's model of it, the
    directory save_pretrained wrote it to)."""
    cfg = _quantizable(jcfg.oryx_tiny())
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32) * (20 if a.ndim >= 2 else 1),
        joryx.init_params(cfg, jax.random.key(0)))
    ct = tcfg.OryxConfig.from_dict(cfg.to_dict())
    model = from_jax_params(tree, ct)
    d = str(tmp_path_factory.mktemp("saved") / "m")
    builder.save_pretrained(d, ct, model, step=7)
    return cfg, ct, tree, model, d


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    """Both packages on the numpy preprocessing path (pixels byte-equal)."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(tnative, "is_available", lambda: False)


def _assert_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_round_trip_exact(tmp_path, dtype):
    ct = tcfg.oryx_tiny()
    model = toryx.init_params(ct, device="cpu", dtype=dtype)
    d = str(tmp_path / "m")
    # A training state holding the model saves the same.
    builder.save_pretrained(d, ct, types.SimpleNamespace(params=model))
    assert set(os.listdir(d)) == {builder.CONFIG_NAME, builder.WEIGHTS_NAME}
    tok, got, cfg = builder.load_pretrained_model(
        d, tokenizer=CharTokenizer(), dtype=dtype, device="cpu")
    _assert_equal(got, model)
    assert cfg == ct and isinstance(tok, CharTokenizer)


def test_dtype_casts_and_metadata(saved):
    _, ct, _, model, d = saved
    assert tst.load_metadata(os.path.join(d, builder.WEIGHTS_NAME))[
        "step"] == "7"
    _, got, _ = builder.load_pretrained_model(
        d, tokenizer=CharTokenizer(), dtype=torch.bfloat16, device="cpu")
    for k, t in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], t.to(torch.bfloat16)), k


def test_quantize_on_load_gives_jax_codes(saved):
    cfg, ct, tree, _, d = saved
    want = from_jax_params(
        jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree)), ct)
    _, got, _ = builder.load_pretrained_model(
        d, tokenizer=CharTokenizer(), quantize="int8", device="cpu")
    assert isinstance(got.llm.embed, tquant.Q8Embedding)
    _assert_equal(got, want)
    # An int8 model saves and loads as it is.
    d8 = d + "_int8"
    builder.save_pretrained(d8, ct, got)
    _, again, _ = builder.load_pretrained_model(
        d8, tokenizer=CharTokenizer(), device="cpu")
    _assert_equal(again, got)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_load_pipeline_tokens_equal_jax(saved, quantize):
    cfg, _, tree, _, d = saved
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    if quantize:
        params = jquant.quantize_params(params)
    jp = OryxInference(CharTokenizer(), params, cfg)
    tp = builder.load_pipeline(d, tokenizer=CharTokenizer(), device="cpu",
                               quantize=quantize)
    img = np.random.default_rng(0).integers(0, 255, (40, 56, 3), np.uint8)
    for kw in ({}, {"images": [img]}):
        with jax.default_matmul_precision("highest"):
            want = jp.chat("hello there", max_new_tokens=8, **kw)
        assert tp.chat("hello there", max_new_tokens=8, **kw) == want


class _Tp2Mesh:
    """A tp=2 mesh's axes, for the paths that read only its shape."""
    mesh_dim_names = ("dp", "fsdp", "tp", "sp")
    shape = (1, 1, 2, 1)


@pytest.mark.parametrize("case", [
    "quantize", "no_config", "no_checkpoint", "mesh", "sharding_mode",
    "pipeline_shard", "lora",
])
def test_error_paths(tmp_path, saved, case):
    _, ct, _, _, d = saved
    tok = CharTokenizer()
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    if case == "quantize":
        with pytest.raises(ValueError, match="int8 or None"):
            builder.load_pretrained_model(d, tokenizer=tok, quantize="int4",
                                          device="cpu")
    elif case == "no_config":
        with pytest.raises(FileNotFoundError,
                           match="not found; pass cfg= explicitly"):
            builder.load_pretrained_model(empty, tokenizer=tok, device="cpu")
    elif case == "no_checkpoint":
        with open(os.path.join(empty, builder.CONFIG_NAME), "w") as f:
            f.write(ct.to_json())
        with pytest.raises(FileNotFoundError,
                           match="no safetensors checkpoint under"):
            builder.load_pretrained_model(empty, tokenizer=tok, device="cpu")
    elif case == "mesh":
        # int8 with a mesh raises as JAX's; without, every rank reads its
        # own slices later (parallel/sharding.CheckpointParams).
        mesh = _Tp2Mesh()
        with pytest.raises(ValueError, match="single-chip serving"):
            builder.load_pretrained_model(d, tokenizer=tok, mesh=mesh,
                                          quantize="int8", device="cpu")
        _, src, _ = builder.load_pretrained_model(d, tokenizer=tok,
                                                  mesh=mesh, device="cpu")
        assert src.path == d
    elif case == "sharding_mode":
        # fsdp serving: the weights stay on disk until each rank cuts its
        # layers' slices; the layer leaves split, the rest whole.
        _, src, _ = builder.load_pretrained_model(
            d, tokenizer=tok, mesh=_Tp2Mesh(), sharding_mode="fsdp",
            device="cpu")
        assert src.path == d
        fsdp2 = _Tp2Mesh()
        fsdp2.shape = (1, 2, 1, 1)
        place = builder.serving_param_shardings(fsdp2, toryx.empty_model(ct),
                                                "fsdp")
        assert place["llm.layers.0.q_proj.weight"].parts == 2
        assert not place["llm.embed.weight"].split
        with pytest.raises(ValueError, match="unknown serving sharding"):
            builder.serving_param_shardings(_Tp2Mesh(), None, "ddp")
    elif case == "pipeline_shard":
        with pytest.raises(ValueError, match="--shard expects"):
            builder.load_pipeline(d, tokenizer=tok, shard="fsdp=0",
                                  device="cpu")
        with pytest.raises(ValueError, match="--shard expects"):
            builder.load_pipeline(d, tokenizer=tok, shard="tp8",
                                  device="cpu")
    else:
        # An HF checkpoint with a lora_path that holds no PEFT adapter
        # (JAX's merge_lora_dir raises the same).
        hf = str(tmp_path / "hf")
        builder.export_hf(hf, ct, saved[3])
        with pytest.raises(FileNotFoundError, match="adapter_config.json"):
            builder.load_from_hf(hf, hf, ct, lora_path=empty, tokenizer=tok,
                                 device="cpu")


def test_config_json_is_the_configs(saved):
    _, ct, _, _, d = saved
    with open(os.path.join(d, builder.CONFIG_NAME)) as f:
        assert tcfg.OryxConfig.from_dict(json.load(f)) == ct
