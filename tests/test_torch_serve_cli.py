"""The port's inference CLI (oryx_tpu_torch/serve/cli.py) against the JAX
package's serve/cli.py on the CPU: the same weights through the HF route
(the JAX tiny init written as HF safetensors + projector npz, read back by
each package's `load_from_hf`; the port's pipeline saved and loaded through
its own `--model-path` directory), the same stand-in tokenizer and media,
and the same stdout for one-shot questions (text, images, a frame
directory) and for the interactive REPL fed on stdin (`:reset` and `:q`
included). Then `--quantize int8` against the port's int8 pipeline, the
refusals (`--shard`, missing `--question`), the argument surface, and the
Gradio gate's message."""

import io
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import import_hf as jimport  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve import builder as jbuilder  # noqa: E402
from oryx_tpu.serve import cli as jcli  # noqa: E402
from oryx_tpu.serve import gradio_app as jgradio  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.serve import builder  # noqa: E402
from oryx_tpu_torch.serve import cli  # noqa: E402
from oryx_tpu_torch.serve import gradio_app  # noqa: E402

from torch_serve_common import CharTokenizer, _scaled, image  # noqa: E402


@pytest.fixture(autouse=True)
def seams(monkeypatch):
    """The stand-in tokenizer, the numpy packing path on the JAX side and
    full matmul precision."""
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda *a, **k: CharTokenizer()))
    monkeypatch.setattr(builder, "load_tokenizer",
                        lambda path: CharTokenizer())
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(JAX pipeline from the HF dir, the port's model directory)."""
    import transformers

    d = str(tmp_path_factory.mktemp("hf"))
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    jimport.save_hf_checkpoint(tree, cfg.llm, cfg.vision, d)
    proj = os.path.join(d, "mm_projector")
    orig = transformers.AutoTokenizer.from_pretrained
    transformers.AutoTokenizer.from_pretrained = staticmethod(
        lambda *a, **k: CharTokenizer())
    try:
        with jax.default_matmul_precision("highest"):
            tok, params, _ = jbuilder.load_from_hf(d, d, cfg,
                                                   projector_path=proj)
    finally:
        transformers.AutoTokenizer.from_pretrained = orig
    jpipe = OryxInference(tok, params, cfg)
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    _, model, _ = builder.load_from_hf(d, d, tc, projector_path=proj,
                                       tokenizer=CharTokenizer(),
                                       device="cpu")
    model_dir = str(tmp_path_factory.mktemp("port_model"))
    builder.save_pretrained(model_dir, tc, model)
    return jpipe, model_dir


@pytest.fixture(scope="module")
def media_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("media")
    for i in range(2):
        Image.fromarray(image(i + 1, 40, 56)).save(d / f"img{i}.png")
    os.makedirs(d / "frames")
    for f in range(4):
        Image.fromarray(image(10 + f, 28, 42)).save(
            d / "frames" / f"frame_{f}.png")
    return d


def _run(main, argv, monkeypatch, capsys, stdin=""):
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out


def _both(weights, argv, monkeypatch, capsys, stdin=""):
    jpipe, model_dir = weights
    monkeypatch.setattr(jbuilder, "load_pipeline",
                        lambda *a, **k: jpipe)
    want = _run(jcli.main, ["--model-path", "unused", *argv], monkeypatch,
                capsys, stdin)
    got = _run(cli.main, ["--model-path", model_dir, "--tokenizer-path",
                          "unused", "--device", "cpu", *argv],
               monkeypatch, capsys, stdin)
    return got, want


@pytest.mark.parametrize("media", ["text", "image", "images", "video"])
def test_one_shot_equals_jax(weights, media_dir, media, monkeypatch, capsys):
    argv = {"text": [],
            "image": ["--image", str(media_dir / "img0.png")],
            "images": ["--image", str(media_dir / "img0.png"),
                       "--image", str(media_dir / "img1.png")],
            "video": ["--video", str(media_dir / "frames"),
                      "--num-frames", "4"]}[media]
    got, want = _both(weights, ["--question", "what is this?",
                                "--max-new-tokens", "6", *argv],
                      monkeypatch, capsys)
    assert got == want
    assert got.endswith("\n") and got.count("\n") == 1 and got.strip()


def test_interactive_equals_jax(weights, media_dir, monkeypatch, capsys):
    """The REPL over ChatSession(shared=True): a first --question, two
    turns, a `:reset`, a turn after it, a blank line and `:q`."""
    stdin = "tell me more\nand then?\n:reset\n\nwhat now?\n:q\nnever read\n"
    got, want = _both(
        weights, ["--interactive", "--question", "what is this?",
                  "--image", str(media_dir / "img0.png"),
                  "--max-new-tokens", "5"],
        monkeypatch, capsys, stdin)
    assert got == want
    assert got.count("assistant: ") == 4
    assert got.startswith("user: what is this?\nassistant: ")
    assert "never read" not in got
    # End of input ends the REPL as :q does.
    got, want = _both(weights, ["--interactive", "--max-new-tokens", "4"],
                      monkeypatch, capsys, "hello there")
    assert got == want and got.count("assistant: ") == 1


def test_quantize_int8_equals_the_int8_pipeline(weights, media_dir,
                                                monkeypatch, capsys):
    _, model_dir = weights
    argv = ["--model-path", model_dir, "--tokenizer-path", "unused",
            "--device", "cpu", "--quantize", "int8", "--question", "hi?",
            "--image", str(media_dir / "img1.png"), "--max-new-tokens", "5"]
    got = _run(cli.main, argv, monkeypatch, capsys)
    from oryx_tpu_torch.data import media

    pipe = builder.load_pipeline(model_dir, tokenizer=CharTokenizer(),
                                 quantize="int8", device="cpu")
    want = pipe.chat("hi?", images=[media.load_image(
        str(media_dir / "img1.png"))], max_new_tokens=5)
    assert got == want + "\n"


def test_refusals_and_argument_surface(weights, monkeypatch, capsys):
    _, model_dir = weights
    with pytest.raises(SystemExit):
        cli.main(["--model-path", model_dir, "--question", "q",
                  "--shard", "fsdp=2", "--quantize", "int8",
                  "--device", "cpu"])
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["--model-path", model_dir])  # no --question
        with pytest.raises(SystemExit):
            main(["--model-path", model_dir, "--question", "q",
                  "--quantize", "int8", "--shard", "tp=2"])
    port = {a.dest: (a.default, a.choices, a.required)
            for a in cli.build_argparser()._actions}
    assert port.pop("device") == ("cuda", None, False)
    import argparse

    seen = {}

    def capture(self, *a, **k):
        seen.update({x.dest: (x.default, x.choices, x.required)
                     for x in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jcli.main([])
    assert port == seen


def test_gradio_gate_message_equals_jax(monkeypatch):
    """Without gradio (an import of it fails, as on machines without it)
    both apps raise the same actionable message."""
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError) as got:
        gradio_app.build_app(object())
    with pytest.raises(RuntimeError) as want:
        jgradio.build_app(object())
    assert str(got.value) == str(want.value).replace(
        "oryx_tpu.serve.cli", "oryx_tpu_torch.serve.cli")
    assert isinstance(got.value.__cause__, ImportError)
