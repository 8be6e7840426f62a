"""Shared inputs of the port's training tests (tests/test_torch_train.py,
tests/test_torch_trainer.py): synthetic records and media, the tiny configs
of both packages, an input-sensitive JAX init, batches collated by the JAX
package, and leaf-by-leaf comparisons in the JAX tree layout."""

import dataclasses

import numpy as np
import torch

import jax

from oryx_tpu import config as jcfg
from oryx_tpu.models import oryx as joryx
from oryx_tpu.train import data as jdata
from oryx_tpu_torch import config as tcfg
from oryx_tpu_torch.models.convert import from_jax_params, to_jax_layout
from oryx_tpu_torch.train import optimizer as topt
from oryx_tpu_torch.train.trainer import prepare_params

TOL = dict(atol=2e-4, rtol=2e-3)
BUCKETS = (64, 128, 256, 512)
COLLATE = dict(patch_size=14, base_grid=8, buckets=BUCKETS)


class ByteTok:
    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))


def records():
    """Four single-image records and two 4-frame videos, media by id."""
    recs = []
    for i in range(4):
        recs.append({
            "id": f"img{i}", "image": f"img{i}.png",
            "conversations": [
                {"from": "human", "value": "<image>\nDescribe it."},
                {"from": "gpt", "value": f"Picture {i}: " + "red " * (i + 1)},
            ],
        })
    for i in range(2):
        recs.append({
            "id": f"vid{i}", "video": f"vid{i}.mp4",
            "conversations": [
                {"from": "human", "value": "<image>\nWhat happens?"},
                {"from": "gpt", "value": "Boats " * (i + 2)},
            ],
        })
    return recs


def media(rec):
    rng = np.random.default_rng(sum(map(ord, rec["id"])))
    if rec.get("video"):
        return [rng.integers(0, 256, (28, 42, 3), np.uint8) for _ in range(4)]
    h, w = ((40, 56), (28, 28), (56, 42), (30, 60))[int(rec["id"][-1])]
    return [rng.integers(0, 256, (h, w, 3), np.uint8)]


def datasets(lib, template="plain"):
    return lib.SupervisedDataset(records(), ByteTok(), template=template,
                                 max_patches_per_image=64,
                                 media_loader=media)


def cfgs(impl="xla", tune="full", accum=1, lr=1e-5, **train):
    base = jcfg.oryx_tiny()
    cj = dataclasses.replace(
        base, attn_impl=impl,
        train=dataclasses.replace(
            base.train, tune=tune, grad_accum_steps=accum, learning_rate=lr,
            num_train_steps=10, warmup_ratio=0.1, **train,
        ),
    )
    return cj, tcfg.OryxConfig.from_dict(cj.to_dict())


def make_tree():
    """Input-sensitive JAX init as numpy (kernels x10 would saturate the
    loss; x3 keeps gradients informative)."""
    rng = np.random.default_rng(0)
    cj, _ = cfgs()

    def f(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if name == "weight" and np.all(a == 1):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a * 3

    return jax.tree_util.tree_map_with_path(
        f, joryx.init_params(cj, jax.random.key(0))
    )


def make_batches():
    """{1: a batch of two images, 2: two microbatches (two images | two
    videos)}, collated by the JAX package, with the leading accum axis."""
    ds = datasets(jdata)
    one = jdata.collate([ds[i] for i in range(2)], **COLLATE)
    two = jdata.collate_microbatches([ds[i] for i in (0, 1, 4, 5)], 2,
                                     **COLLATE)
    return {1: {k: v[None] for k, v in one.items()}, 2: two}


def flat(tree_):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree_)[0]}


def assert_trees(got: dict, want: dict, what: str, **tol):
    g, w = flat(got), flat(want)
    assert set(g) == set(w), (what, set(g) ^ set(w))
    for k in w:
        np.testing.assert_allclose(g[k], w[k], **(tol or TOL),
                                   err_msg=f"{what} {k}")


def port_model(tree_, cfg):
    model = from_jax_params(tree_, cfg)
    return prepare_params(model, topt.trainable_mask(model, cfg.train.tune),
                          torch.float32)


def tbatch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()}


def assert_moments(model, tstate, jstate, **tol):
    """The port's mu/nu against the Adam states inside the optax tree,
    matched by leaf path (MaskedNode entries are frozen leaves)."""
    jm = {"mu": {}, "nu": {}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jstate)[0]:
        s = jax.tree_util.keystr(path)
        for kind in ("mu", "nu"):
            if f".{kind}" in s and hasattr(leaf, "shape") and leaf.ndim:
                jm[kind][s.split(f".{kind}", 1)[1]] = np.asarray(leaf)
    for kind in ("mu", "nu"):
        got = flat(to_jax_layout(model, tstate[kind]))
        assert set(got) == set(jm[kind]), set(got) ^ set(jm[kind])
        for k, v in jm[kind].items():
            np.testing.assert_allclose(got[k], v, **(tol or TOL),
                                       err_msg=f"{kind} {k}")
