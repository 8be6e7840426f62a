"""The port's weight-only int8 (`oryx_tpu_torch/utils/quant.py`'s weight half,
`ops/cuda/q8_linear.py`'s plain twin) against the JAX package's
`oryx_tpu.utils.quant`, on the CPU.

Codes and scales are byte-equal to JAX's in fp32 and bf16; the leaf rule
and the byte count match; int8 trees carried across with `from_jax_params`
(the same codes on both sides) give JAX's logits within fp32 tolerance and
JAX's greedy tokens through `Pipeline`, sessions, scoring and both serving
engines. Same weights on both sides: the JAX init scaled x20 so greedy
replies depend on the inputs; fp32, JAX matmuls at "highest" precision.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.models import qwen2 as jqwen2  # noqa: E402
from oryx_tpu.serve import pipeline as jpipeline  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu.utils import quant as jquant  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.models.oryx import empty_model  # noqa: E402
from oryx_tpu_torch.ops.cuda import q8_linear  # noqa: E402
from oryx_tpu_torch.serve import pipeline as tpipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402
from oryx_tpu_torch.utils import quant as tquant  # noqa: E402

ATOL, RTOL = 2e-4, 2e-3
# tests/test_quant.py::test_oryx_7b_int8_fits_one_v5e's walk over
# eval_shape: int8 codes, fp32 scales, bf16 elsewhere.
ORYX_7B_INT8_BYTES = 8_059_815_072


class CharTokenizer:
    """Characters -> code points (capped at 500, below the vocab)."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def _quantizable(cfg):
    """tests/test_quant.py's `_quantizable_cfg`: oryx_tiny widened so its
    embedding and MLP kernels cross MIN_QUANT_SIZE."""
    return dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=1024, hidden_size=128, intermediate_size=512,
        num_heads=8, head_dim=16))


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def trees():
    """(JAX cfg, port cfg, float numpy tree, JAX int8 tree)."""
    cfg = _quantizable(jcfg.oryx_tiny())
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    qtree = jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    return cfg, tcfg.OryxConfig.from_dict(cfg.to_dict()), tree, qtree


@pytest.fixture(scope="module")
def pipes(trees):
    """The JAX and port pipelines over the same int8 codes."""
    cfg, ct, _, qtree = trees
    return (jpipeline.OryxInference(CharTokenizer(), qtree, cfg),
            tpipeline.Pipeline(CharTokenizer(), from_jax_params(qtree, ct),
                               ct, device="cpu"))


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _port_dtype(jdt):
    return torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32


def _as_port(a, jdt):
    """A JAX-side array as a port tensor of the same dtype and bits."""
    return torch.from_numpy(
        np.array(jnp.asarray(a, jdt).astype(jnp.float32))).to(
            _port_dtype(jdt))


@pytest.mark.parametrize("shape", [(64, 128), (3, 40, 72)],
                         ids=["2d", "stacked"])
@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_codes_and_scales_byte_equal_jax(shape, jdt):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal(shape) * 0.05, jdt)
    want = jquant.quantize_array(w)
    q, scale = tquant.quantize_array(_as_port(w, jdt))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(want.scale))


def _jax_quantized_paths(tree, path=()):
    if isinstance(tree, dict):
        out = set()
        for k, v in tree.items():
            out |= _jax_quantized_paths(v, path + (k,))
        return out
    return {".".join(path[:-1])} if isinstance(tree, jquant.Q8Weight) else set()


def _port_quantized_paths(model):
    return {
        ".".join(p for p in name.split(".") if not p.isdigit())
        for name, mod in model.named_modules()
        if isinstance(mod, (tquant.Q8Linear, tquant.Q8Embedding))
    }


def test_leaf_choice_and_bytes_match_jax(trees):
    cfg, ct, tree, qtree = trees
    model = from_jax_params(tree, ct)
    qm = tquant.quantize_params(model)
    want = _jax_quantized_paths(qtree)
    assert _port_quantized_paths(qm) == want
    # tests/test_quant.py:58's cases: embedding and MLP in, q_proj (below
    # MIN_QUANT_SIZE at this width), norms and biases out.
    assert {"llm.embed", "llm.layers.gate_proj"} <= want
    assert isinstance(qm.llm.layers[0].q_proj, torch.nn.Linear)
    assert qm.llm.layers[0].q_proj.bias is model.llm.layers[0].q_proj.bias
    # State derived from the float weights is not carried over.
    model.llm.__dict__["_decode_graphs"] = {}
    assert "_decode_graphs" not in tquant.quantize_params(model).llm.__dict__
    assert tquant.quantized_bytes(qm) == jquant.quantized_bytes(qtree)
    assert tquant.quantized_bytes(model) == jquant.quantized_bytes(tree)
    # The same codes as JAX's, leaf by leaf.
    carried = from_jax_params(qtree, ct).state_dict()
    for name, t in qm.state_dict().items():
        assert torch.equal(t, carried[name]), name


def test_oryx_7b_int8_bytes():
    """Built in bf16 on the meta device: no memory."""
    model = empty_model(tcfg.oryx_7b(), torch.bfloat16)
    assert tquant.quantized_bytes(tquant.quantize_params(model)) == (
        ORYX_7B_INT8_BYTES)
    assert tquant.quantized_bytes(model) == 16_101_804_768


def test_gathers_and_stacked_scales_match_jax(trees):
    """tests/test_quant.py:27 and :176: an embedding gather dequantizes
    rows as the product does, and layer i of a stacked weight uses layer
    i's scales."""
    _, ct, _, qtree = trees
    model = from_jax_params(qtree, ct)
    ids = np.array([3, 7, 511])
    emb = qtree["llm"]["embed"]["weight"]
    got = tquant.embed_rows(model.llm.embed, torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(emb[jnp.asarray(ids)]))
    np.testing.assert_array_equal(
        model.llm.embed.dequantize(torch.float32).numpy(),
        np.asarray(emb.astype(jnp.float32)))
    stacked = qtree["llm"]["layers"]["gate_proj"]["kernel"]
    for i, layer in enumerate(model.llm.layers):
        want = np.asarray(stacked[i]).T
        deq = q8_linear.dequantize_weight(layer.gate_proj.q,
                                          layer.gate_proj.scale,
                                          torch.float32)
        np.testing.assert_array_equal(deq.numpy(), want)
    assert not hasattr(model.llm.embed, "weight")
    assert not hasattr(model.llm.layers[0].gate_proj, "weight")


@pytest.mark.parametrize("tied", [False, True], ids=["lm_head", "tied"])
def test_logits_match_jax(tied):
    cfg = _quantizable(jcfg.oryx_tiny())
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, tie_word_embeddings=tied))
    ct = tcfg.OryxConfig.from_dict(cfg.to_dict())
    qtree = jquant.quantize_params(joryx.init_params(cfg, jax.random.key(1)))
    model = from_jax_params(qtree, ct)
    assert isinstance(model.llm.embed, tquant.Q8Embedding)
    ids = np.random.default_rng(0).integers(0, 1024, (2, 9))
    want, _ = jqwen2.forward(qtree["llm"], cfg.llm, input_ids=jnp.asarray(ids))
    got, _ = tqwen2.forward(model.llm, ct.llm, input_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _image(h=40, w=56, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), np.uint8)


def test_pipeline_chat_and_stream_tokens_equal_jax(pipes):
    jp, tp = pipes
    for kw in ({}, {"images": [_image()]}):
        want = jp.chat("hello there, what is this?", max_new_tokens=8, **kw)
        assert tp.chat("hello there, what is this?", max_new_tokens=8,
                       **kw) == want
    streamed = "".join(tp.chat_stream("hello there", max_new_tokens=6))
    assert streamed == jp.chat("hello there", max_new_tokens=6)


def test_session_and_scoring_equal_jax(pipes):
    jp, tp = pipes
    img = _image(seed=1)
    cached = tpipeline.ChatSession(tp, images=[img], cache=True)
    plain = tpipeline.ChatSession(tp, images=[img], cache=False)
    ref = jpipeline.ChatSession(jp, images=[img], cache=True)
    for q in ("what is this?", "and then?"):
        want = ref.ask(q, max_new_tokens=5)
        assert cached.ask(q, max_new_tokens=5) == want
        assert plain.ask(q, max_new_tokens=5) == want
    opts = ["A", "B", "C", "D"]
    np.testing.assert_allclose(
        np.asarray(tp.score_options("pick one", opts)),
        np.asarray(jp.score_options("pick one", opts)), atol=ATOL, rtol=RTOL)


def _serve(sched, reqs):
    handles = [sched.submit(r, cap, None) for r, cap in reqs]
    sched.start()
    out = [h.result(timeout=600) for h in handles]
    sched.close()
    return out


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_engines_equal_jax(pipes, ragged):
    jp, tp = pipes
    reqs = [({"question": "what is this?", "images": [_image()]}, 6),
            ({"question": "hello there"}, 9),
            ({"question": "count to five"}, 4)]
    geom = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
                ragged=ragged, prefill_chunk=32 if ragged else None)
    want = _serve(JaxScheduler(jp, autostart=False, **geom), reqs)
    sched = ContinuousScheduler(tp, autostart=False, **geom)
    assert _serve(sched, reqs) == want
    sched.check_pool_invariant()


@pytest.mark.parametrize("M", [1, 4, 20, 100])
def test_q8_twin_matches_jax(M):
    """x @ Q8Weight.astype(x.dtype) (+ bias) at K, N not multiples of 16;
    on CPU tensors `q8_linear` is the twin."""
    rng = np.random.default_rng(M)
    K, N = 72, 100
    w = jnp.asarray(rng.standard_normal((K, N)) * 0.05, jnp.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    qw = jquant.quantize_array(w)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnp.asarray(x) @ qw.astype(jnp.float32) + b)
    q = torch.from_numpy(np.asarray(qw.q).T.copy())
    scale = torch.from_numpy(np.asarray(qw.scale)[0].copy())
    got = q8_linear.q8_linear(torch.from_numpy(x), q, scale,
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, q8_linear.q8_linear_reference(
        torch.from_numpy(x), q, scale, torch.from_numpy(b)))


@pytest.mark.parametrize("M", [1, 4, 20, 100])
def test_q8_tied_twin_matches_jax(M):
    """The tied head, h @ embed.astype(h.dtype).T over an int8 table (one
    scale per column), at V, H not multiples of 16; on CPU tensors
    `q8_linear(column_scale=True)` is the twin, and `quant.linear` on a
    Q8Embedding takes it."""
    rng = np.random.default_rng(100 + M)
    V, H = 100, 72
    table = jnp.asarray(rng.standard_normal((V, H)) * 0.05, jnp.float32)
    x = rng.standard_normal((M, H)).astype(np.float32)
    qt = jquant.quantize_array(table)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jnp.asarray(x) @ qt.astype(jnp.float32).T)
    emb = tquant.Q8Embedding(torch.from_numpy(np.asarray(qt.q).copy()),
                             torch.from_numpy(np.asarray(qt.scale)[0].copy()))
    got = q8_linear.q8_linear(torch.from_numpy(x), emb.q, emb.scale,
                              column_scale=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    assert torch.equal(got, tquant.linear(torch.from_numpy(x), emb))
