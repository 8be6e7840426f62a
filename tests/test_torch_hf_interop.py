"""The port's HF interop (`oryx_tpu_torch/models/import_hf.py`,
`utils/safetensors.py`, the projector npz of `utils/checkpoint.py`)
against the JAX package's `oryx_tpu.models.import_hf`, the `safetensors`
package and HF transformers, on the CPU.

Files cross both ways: the port's safetensors writer and reader against
the `safetensors` package; JAX's `save_hf_checkpoint` into the port's
`load_from_hf`, the port's `export_hf` into JAX's importers; the projector
npz both ways. Imports equal `from_jax_params` of JAX's import of the same
state dict exactly, and exports equal JAX's arrays. An in-process HF
Qwen2ForCausalLM imported by the port gives HF's logits.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.models import import_hf as jimport  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.utils import checkpoint as jckpt  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import import_hf as timport  # noqa: E402
from oryx_tpu_torch.models import oryx as toryx  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params, to_jax_layout  # noqa: E402
from oryx_tpu_torch.serve import builder  # noqa: E402
from oryx_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from oryx_tpu_torch.utils import safetensors as tst  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, port cfg, numpy tree, the port's model of it)."""
    cfg = jcfg.oryx_tiny()
    tree = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        joryx.init_params(cfg, jax.random.key(0)))
    ct = tcfg.OryxConfig.from_dict(cfg.to_dict())
    return cfg, ct, tree, from_jax_params(tree, ct)


def _assert_models_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k


def _assert_trees_equal(a, b):
    la = jax.tree_util.tree_leaves_with_path(a)
    lb = dict(jax.tree_util.tree_leaves_with_path(b))
    assert len(la) == len(lb)
    for path, x in la:
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(lb[path], np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "a.f32": torch.randn((3, 5), generator=g),
        "b.bf16": torch.randn((7,), generator=g).to(torch.bfloat16),
        "c.i64": torch.arange(-4, 5, dtype=torch.int64).reshape(3, 3),
        "d.scalar": torch.tensor(2.5),
    }


def _shard(write, d, tensors):
    """Two shard files and their index, written by `write(tensors, path)`."""
    names = sorted(tensors)
    parts = {"model-00001-of-00002.safetensors": names[:2],
             "model-00002-of-00002.safetensors": names[2:]}
    for fname, keys in parts.items():
        write({k: tensors[k] for k in keys}, os.path.join(d, fname))
    with open(os.path.join(d, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": {
            k: fname for fname, keys in parts.items() for k in keys}}, f)


def _check_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


@pytest.mark.parametrize("layout", ["file", "sharded"])
@pytest.mark.parametrize("writer", ["port", "package"])
def test_safetensors_cross_the_package(tmp_path, layout, writer):
    """F32, BF16, I64 (and a 0-d tensor): what one side writes the other
    reads, as one file or a sharded directory with its index."""
    st_torch = pytest.importorskip("safetensors.torch")
    write = tst.save_file if writer == "port" else st_torch.save_file
    tensors = _tensors()
    if layout == "file":
        path = str(tmp_path / "model.safetensors")
        write(tensors, path)
        _check_same(st_torch.load_file(path), tensors)
        _check_same(tst.load_file(path), tensors)
    else:
        _shard(write, str(tmp_path), tensors)
        for fname in os.listdir(tmp_path):
            if fname.endswith(".safetensors"):
                st_torch.load_file(str(tmp_path / fname))
        _check_same(tst.load_safetensors_dir(str(tmp_path)), tensors)


def test_safetensors_dir_without_files_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no .safetensors files"):
        tst.load_safetensors_dir(str(tmp_path))


def test_imports_equal_jax_import(tiny):
    cfg, ct, tree, _ = tiny
    llm_sd = jimport.export_qwen2(tree["llm"], cfg.llm)
    vit_sd = jimport.export_siglip(tree["vit"], cfg.vision)
    want = from_jax_params(
        {"llm": jimport.import_qwen2(llm_sd, cfg.llm),
         "vit": jimport.import_siglip(vit_sd, cfg.vision),
         "compressor": tree["compressor"]}, ct)
    _assert_models_equal(timport.import_qwen2(llm_sd, ct.llm, device="cpu"),
                         want.llm)
    _assert_models_equal(
        timport.import_siglip(vit_sd, ct.vision, device="cpu"), want.vit)
    # bf16 as the dtype casts every leaf.
    lb = timport.import_qwen2(llm_sd, ct.llm, torch.bfloat16, device="cpu")
    assert torch.equal(lb.embed.weight, want.llm.embed.weight.bfloat16())


def test_exports_equal_jax_export(tiny):
    cfg, ct, tree, model = tiny
    for got, want in (
        (timport.export_qwen2(model.llm, ct.llm),
         jimport.export_qwen2(tree["llm"], cfg.llm)),
        (timport.export_siglip(model.vit, ct.vision),
         jimport.export_siglip(tree["vit"], cfg.vision)),
    ):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_jax_checkpoint_loads_in_port(tmp_path, tiny):
    """JAX's save_hf_checkpoint -> the port's load_from_hf with the
    projector: JAX's params exactly."""
    cfg, ct, tree, model = tiny
    d = str(tmp_path / "hf")
    jimport.save_hf_checkpoint(tree, cfg.llm, cfg.vision, d)
    tok, got, _ = builder.load_from_hf(
        d, d, ct, projector_path=os.path.join(d, "mm_projector"),
        tokenizer=CharTokenizer(), device="cpu")
    _assert_models_equal(got, model)
    assert isinstance(tok, CharTokenizer)


def test_port_checkpoint_loads_in_jax(tmp_path, tiny):
    """The port's export_hf -> JAX's importers and load_projector_only: the
    port's params."""
    cfg, ct, _, _ = tiny
    model = toryx.init_params(ct, device="cpu")
    d = str(tmp_path / "hf")
    builder.export_hf(d, ct, model)
    sd = jimport.load_safetensors_dir(d)
    params = {
        "llm": jimport.import_qwen2(sd, cfg.llm),
        "vit": jimport.import_siglip(sd, cfg.vision),
        "compressor": jax.tree_util.tree_map(
            jnp.zeros_like, joryx.init_params(cfg, jax.random.key(1))[
                "compressor"]),
    }
    params = jckpt.load_projector_only(os.path.join(d, "mm_projector"),
                                       params)
    _assert_trees_equal(params, to_jax_layout(model))


@pytest.mark.parametrize("bias", [True, False])
def test_llm_hf_config_matches_jax(bias):
    llm = dataclasses.replace(jcfg.tiny_llm(), attention_bias=bias)
    want = jimport.llm_hf_config(llm)
    assert timport.llm_hf_config(
        tcfg.LLMConfig(**dataclasses.asdict(llm))) == want


def test_projector_npz_crosses_both_ways(tmp_path, tiny):
    cfg, ct, tree, model = tiny
    # JAX writes, the port reads.
    jckpt.save_projector_only(str(tmp_path / "j"), tree)
    fresh = toryx.init_params(ct, torch.Generator().manual_seed(5),
                              device="cpu")
    tckpt.load_projector_only(str(tmp_path / "j"), fresh)
    _assert_models_equal(fresh.compressor, model.compressor)
    # The port writes, JAX reads.
    other = toryx.init_params(ct, torch.Generator().manual_seed(6),
                              device="cpu")
    tckpt.save_projector_only(str(tmp_path / "t.npz"), other)
    got = jckpt.load_projector_only(str(tmp_path / "t"), tree)
    _assert_trees_equal(got["compressor"], to_jax_layout(other)["compressor"])
    assert not os.path.exists(str(tmp_path / "t.npz.tmp"))


def test_import_gives_hf_logits():
    """An in-process HF Qwen2ForCausalLM (built as in tests/test_qwen2.py),
    imported by the port: HF's logits."""
    transformers = pytest.importorskip("transformers")
    llm = tcfg.tiny_llm(vocab_size=128)
    torch.manual_seed(0)
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=llm.vocab_size, hidden_size=llm.hidden_size,
        intermediate_size=llm.intermediate_size,
        num_hidden_layers=llm.num_layers, num_attention_heads=llm.num_heads,
        num_key_value_heads=llm.num_kv_heads, head_dim=llm.head_dim,
        rope_theta=llm.rope_theta, rms_norm_eps=llm.rms_norm_eps,
        max_position_embeddings=llm.max_position_embeddings,
        tie_word_embeddings=False, attention_dropout=0.0,
    )).eval()
    model = timport.import_qwen2(hf.state_dict(), llm, device="cpu")
    ids = torch.from_numpy(
        np.random.default_rng(0).integers(0, llm.vocab_size, (2, 11)))
    with torch.no_grad():
        want = hf(ids).logits
        got, _ = tqwen2.forward(model, llm, input_ids=ids)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
