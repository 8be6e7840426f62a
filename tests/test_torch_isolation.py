"""The port stands alone and never runs on the CPU by accident.

* Importing every module of `oryx_tpu_torch`, and `chip_smoke`, loads
  neither jax nor any part of `oryx_tpu` (checked in a fresh interpreter).
* No `.py` file of the port, nor chip_smoke.py, has a jax/oryx_tpu import
  (checked with `ast`).
* The entry points default to the CUDA device and raise on a host without
  a card instead of carrying on on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "oryx_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "oryx_tpu")


def test_import_loads_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import oryx_tpu_torch\n"
        "for m in pkgutil.walk_packages(oryx_tpu_torch.__path__, "
        "'oryx_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'oryx_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('oryx_tpu_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=env, cwd=str(ROOT / "tests"),
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20  # every module was imported


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pipeline_without_device_raises_without_card(no_card):
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = config.oryx_tiny()
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [1]

    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(Tok(), params, cfg)
    # The CPU is used only when asked for.
    assert Pipeline(Tok(), params, cfg, device="cpu").device.type == "cpu"


def test_init_params_without_device_raises_without_card(no_card):
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx, qwen2

    cfg = config.oryx_tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        oryx.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        qwen2.init_params(cfg.llm)


def test_mm_generate_without_device_raises_without_card(no_card):
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx

    cfg = config.oryx_tiny()
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        oryx.mm_generate(params, cfg, packed=None, batch=None)


def test_ring_config_serves_with_the_device_kernel_path():
    """A ring-trained config decodes with the dense path: the kernel on a
    CUDA device, the plain attention on the CPU - keyed on the device."""
    import dataclasses

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="ring_flash")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [1]

    assert Pipeline(Tok(), params, cfg, device="cpu").cfg.attn_impl == "xla"
