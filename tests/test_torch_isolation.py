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


def test_generate_paged_without_device_raises_without_card(no_card):
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import generate, qwen2

    cfg = config.oryx_tiny()
    params = qwen2.init_params(cfg.llm, torch.Generator().manual_seed(0),
                               device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        generate.generate_paged(
            params, cfg.llm, cfg.generation,
            inputs_embeds=torch.zeros((1, 4, cfg.llm.hidden_size)),
            lengths=[4], max_new_tokens=2,
        )
    with pytest.raises(RuntimeError, match="cuda"):
        qwen2.init_paged_kv_cache(cfg.llm, 4, 16)


def test_scheduler_serves_on_its_pipelines_device():
    """The engine's pool and dispatches live on the pipeline's device; a
    pipeline is on the card unless built with device="cpu"."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = config.oryx_tiny()
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [1]

    sched = ContinuousScheduler(
        Pipeline(Tok(), params, cfg, device="cpu"), autostart=False,
        page_size=16, max_ctx=64,
    )
    assert sched.kv_pages["k"].device.type == "cpu"
    sched.close()


def test_paged_kernel_launch_needs_cuda_tensors():
    """The kernel entry raises on CPU tensors; only the public wrappers
    take the plain twin, and only for tensors that lie on the CPU."""
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    k = paged_kv.init_paged_pool(1, 2, 4, 1, 8, dtype=torch.float32,
                                 device="cpu")[0]
    bt = torch.zeros((1, 1), dtype=torch.int32)
    n = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pa._launch("paged_decode", torch.zeros((1, 1, 8)), k, k, bt, (n,),
                   1.0)
    out = pa.ragged_decode_attention(torch.ones((1, 1, 8)), k, k, bt, n)
    assert out.device.type == "cpu" and pa.LAUNCHES == {}


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


def test_trainer_without_device_raises_without_card(no_card):
    from oryx_tpu_torch import config
    from oryx_tpu_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(config.oryx_tiny())


def test_offline_entry_points_are_walked():
    """The import walk above and the ast check cover the slice's modules."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"train/telemetry.py", "train/cli.py", "eval/__init__.py",
            "eval/adapters.py", "eval/harness.py"} <= names


def test_train_cli_without_device_raises_without_card(no_card, tmp_path,
                                                      monkeypatch):
    """python -m oryx_tpu_torch.train.cli trains on the card unless
    --device cpu: without one it raises before a step."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.train import cli

    class Tok:
        def encode(self, text, add_special_tokens=False):
            return [1]

    monkeypatch.setattr(builder, "load_tokenizer", lambda path: Tok())
    (tmp_path / "cfg.json").write_text(config.oryx_tiny().to_json())
    (tmp_path / "data.json").write_text("[]")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", str(tmp_path / "cfg.json"),
                  "--data", str(tmp_path / "data.json"),
                  "--tokenizer-path", "unused"])


def test_flash_kernel_launches_need_cuda_tensors():
    """K1-lse, K5a and K5b raise on CPU tensors; autograd through
    flash_attention takes the plain twins only for tensors on the CPU."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    args, flags = fa._prepare(q, q, q, None, None, None, None, None, True,
                              None)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa._mha_forward(*args, **flags, with_lse=True)
    for launch in (fa._mha_backward_dq, fa._mha_backward_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            launch(*args[:3], args[0], lse, lse, *args[3:], **flags)
    fa.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None and q.grad.device.type == "cpu"
    assert not (fa.LAUNCHES_LSE or fa.LAUNCHES_DQ or fa.LAUNCHES_DKV)


def test_concurrency_plane_and_front_door_modules_are_walked():
    """The import walk and the ast check cover the concurrency plane, the
    router, the inference CLI, the Gradio gate, the debug helpers and the
    native loader; the router's entry point is a module of the port."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"concurrency.py", "analysis/__init__.py",
            "analysis/sanitizers.py", "serve/router.py", "serve/cli.py",
            "serve/gradio_app.py", "utils/debug.py",
            "data/native_loader.py"} <= names
    res = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.serve.router", "--help"],
        capture_output=True, text=True, timeout=120, cwd=str(ROOT),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert res.returncode == 0 and "--replica" in res.stdout, res.stderr


def test_parallel_modules_are_walked():
    """The import walk and the ast check cover parallel/ (meshes, the
    sharding rules, the tensor-parallel ranks); a follower rank's main
    imports nothing of jax either."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if p.is_relative_to(PORT)}
    assert {"parallel/__init__.py", "parallel/mesh.py",
            "parallel/sharding.py", "parallel/tp.py"} <= names
    from oryx_tpu_torch.parallel import tp

    code = tp._FOLLOWER.replace(
        "sys.exit(tp._follower_main(sys.argv[1:]))",
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'oryx_tpu')))")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=str(ROOT),
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


def test_serve_cli_without_device_raises_without_card(no_card, tmp_path):
    """python -m oryx_tpu_torch.serve.cli answers on the card unless
    --device cpu: without one it raises before loading a weight."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.serve import cli

    (tmp_path / "oryx_config.json").write_text(config.oryx_tiny().to_json())
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--model-path", str(tmp_path), "--question", "q"])


def test_native_loader_never_loads_the_library_in_native():
    """The port's native loader builds its own library under _build/; a
    library file left in native/ is never the one it opens."""
    from oryx_tpu_torch.data import native_loader

    assert native_loader.library_path().parent == PORT / "_build"
    if native_loader.is_available():
        assert Path(native_loader._lib._name).parent == PORT / "_build"
