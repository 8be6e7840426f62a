"""`Pipeline.chat_batch` of the port against `OryxInference.chat_batch` of
the JAX package on one mixed request list (text only, one image, two
images, a 4-frame video): greedy replies, finish reasons and token counts
identical. Under attn_impl="xla" on both sides, and "pallas" (the JAX kernel
in interpret mode vs the port's plain twin on CPU tensors).

Same weights on both sides (JAX init made input-sensitive, converted with
`from_jax_params`); fp32, JAX matmuls at "highest" precision.
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
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402


class CharTokenizer:
    """Shared stand-in tokenizer: characters -> code points (capped at
    500, below the tiny vocab of 512)."""

    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def weights():
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            from_jax_params(tree, tcfg.OryxConfig.from_dict(cfg.to_dict())))


def _requests():
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    return [
        {"question": "hi there"},
        {"question": "what is this?", "images": [img(40, 56)]},
        {"question": "compare them", "images": [img(60, 30), img(28, 28)]},
        {"question": "what happens?", "images": [img(42, 42) for _ in range(4)],
         "is_video": True},
    ]


def _both(weights, impl, requests, **kw):
    jp, tp = weights
    cj = dataclasses.replace(jcfg.oryx_tiny(), attn_impl=impl)
    ct = tcfg.OryxConfig.from_dict(cj.to_dict())
    with jax.default_matmul_precision("highest"):
        want = OryxInference(CharTokenizer(), jp, cj).chat_batch(requests, **kw)
    got = Pipeline(CharTokenizer(), tp, ct, device="cpu").chat_batch(
        requests, **kw
    )
    return want, got


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_chat_batch_mixed_equal(weights, impl, monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    want, got = _both(
        weights, impl, _requests(), max_new_tokens=10,
        return_finish_reasons=True, return_token_counts=True,
    )
    assert got == want
    replies = got[0]
    assert len(set(replies)) == len(replies)  # rows really differ
    assert all(n == 10 for _, n in got[2])


def test_chat_batch_text_only_equal(weights):
    reqs = [{"question": "one"}, {"question": "a longer second question"}]
    want, got = _both(weights, "xla", reqs, max_new_tokens=6,
                      return_token_counts=True)
    assert got == want


def test_chat_batch_stop_string_and_row_caps_equal(weights, monkeypatch):
    """Request stop strings and per-row output caps trim the same way."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    reqs = _requests()[:2]
    kw = dict(max_new_tokens=8, per_row_max=[3, 8], return_finish_reasons=True)
    want, got = _both(weights, "xla", reqs, **kw)
    assert got == want
    first = got[0][1]
    if len(first) > 1:  # a stop at the reply's second character cuts it
        want, got = _both(weights, "xla", reqs, stop=[first[1]], **kw)
        assert got == want
