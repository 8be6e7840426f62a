"""The port's config tree is field-for-field the JAX package's: every preset
and every scripts/configs/*.json loads into both to equal dicts."""

import dataclasses
import glob
import os

import pytest

pytest.importorskip("torch")

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(glob.glob(os.path.join(ROOT, "scripts", "configs", "*.json")))

PRESETS = [
    "qwen2_7b", "yi_34b", "qwen2_5_7b", "qwen2_5_32b", "tiny_llm",
    "tiny_vision", "oryx_7b", "oryx_34b", "oryx_1_5_7b", "oryx_1_5_32b",
    "oryx_tiny",
]


@pytest.mark.parametrize("name", PRESETS)
def test_preset_fields_equal(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert type(j).__name__ == type(t).__name__
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_config_files_found():
    assert len(CONFIG_FILES) >= 5


@pytest.mark.parametrize(
    "path", CONFIG_FILES, ids=[os.path.basename(p) for p in CONFIG_FILES]
)
def test_config_file_loads_equal(path):
    text = open(path).read()
    j = jcfg.OryxConfig.from_json(text)
    t = tcfg.OryxConfig.from_json(text)
    assert j.to_dict() == t.to_dict()
    # And the port round-trips its own serialization.
    assert tcfg.OryxConfig.from_json(t.to_json()) == t


def test_field_order_equal():
    """Same field names in the same order at every level of the tree."""
    def names(tp):
        out = []
        for f in dataclasses.fields(tp):
            out.append(f.name)
            hint = tcfg._FIELD_TYPES.get((tp, f.name))
            if hint is not None:
                out.append(names(hint))
        return out

    def jnames(tp):
        out = []
        for f in dataclasses.fields(tp):
            out.append(f.name)
            hint = jcfg._FIELD_TYPES.get((tp, f.name))
            if hint is not None:
                out.append(jnames(hint))
        return out

    assert names(tcfg.OryxConfig) == jnames(jcfg.OryxConfig)


@pytest.mark.parametrize("policy", ["none", "bogus"])
def test_bad_remat_policy_rejected_like_jax(policy):
    with pytest.raises(ValueError):
        jcfg.TrainConfig(remat_policy=policy)
    with pytest.raises(ValueError):
        tcfg.TrainConfig(remat_policy=policy)


def test_unknown_key_rejected():
    with pytest.raises(ValueError, match="unknown config key"):
        tcfg.OryxConfig.from_dict({"llm": {"nope": 1}})
