"""The port's model-FLOPs accounting (`oryx_tpu_torch/utils/flops.py`)
against the JAX package's `oryx_tpu.utils.flops` and
`oryx_tpu.train.telemetry.batch_flops`: equal on every configuration under
scripts/configs/ and on collated batches (plain, packed, stacked
microbatches); the card's peak from its device name."""

import glob
import json

import numpy as np
import pytest

pytest.importorskip("torch")

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.train import telemetry as jtel  # noqa: E402
from oryx_tpu.utils import flops as jflops  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.utils import flops as tflops  # noqa: E402

CONFIGS = sorted(glob.glob("scripts/configs/*.json"))


def _cfgs(path):
    with open(path) as f:
        text = f.read()
    return jcfg.OryxConfig.from_json(text), tcfg.OryxConfig.from_json(text)


def test_every_config_is_listed():
    assert len(CONFIGS) >= 7
    assert "scripts/configs/oryx_7b_sft_lora.json" in CONFIGS


@pytest.mark.parametrize("path", CONFIGS)
def test_counts_equal_jax(path):
    cj, ct = _cfgs(path)
    n = tflops.count_llm_params(ct.llm)
    assert n == jflops.count_llm_params(cj.llm)
    for batch, seq, patches in ((1, 2048, 0), (4, 2048, 8192),
                                (4, 4096, 0), (2, 8192, 4096)):
        kw = dict(batch=batch, seq_len=seq, patch_tokens=patches)
        assert tflops.train_step_flops(ct, n, **kw) == \
            jflops.train_step_flops(cj, n, **kw)


def test_oryx_7b_counts():
    """The decoder of oryx_7b: 7.62 B parameters with embeddings."""
    _, ct = _cfgs("scripts/configs/oryx_7b_sft_lora.json")
    assert tflops.count_llm_params(ct.llm) == 7_615_616_512


@pytest.mark.parametrize("shape,segs", [
    ((4, 2048), 8192), ((2, 3, 512), 1024), ((4, 4096), 0),
])
def test_batch_flops_equal_jax(shape, segs):
    cj, ct = _cfgs("scripts/configs/oryx_7b_sft_lora.json")
    batch = {"token_ids": np.zeros(shape, np.int32)}
    if segs:
        batch["segment_ids"] = np.zeros(shape[:-2] + (segs,), np.int32)
    assert tflops.batch_flops(ct, batch) == jtel.batch_flops(cj, batch)


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("cpu", None),
    ("", None),
    ("NVIDIA A100-SXM4-80GB", None),
])
def test_chip_peak_flops(name, peak):
    assert tflops.chip_peak_flops(name) == peak


def test_configs_parse_the_same():
    for path in CONFIGS:
        cj, ct = _cfgs(path)
        assert json.loads(cj.to_json()) == json.loads(ct.to_json())
