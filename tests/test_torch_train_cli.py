"""The port's training entry point (oryx_tpu_torch/train/cli.py) and
`data/media.load_record_media` against the JAX package on the CPU:

  * `build_argparser` has every option of JAX's, with its default, type,
    choices and required flag (the port adds `--device`);
  * both CLIs from the same weights through the HF route (`--hf-llm`,
    `--hf-vision`, `--projector`), the same records, media and stand-in
    tokenizer, 2 steps (JAX on the 8-device CPU mesh its own test uses):
    the JSONL records carry the same keys, loss and grad norm within
    tolerance; the port's `--output-dir` loads back through
    `load_pretrained_model`;
  * `--init-from`, the telemetry flags, TensorBoard and `$ORYX_FAULTS`
    through the port's CLI; the multi-process flags, one alone raising,
    all three as two processes (fsdp=2) against the same fit by two ranks
    of one process and JAX's CLI;
  * `load_record_media` equals JAX's on images, image lists, a frame
    directory and a text record.

Tolerance: atol 2e-4, rtol 2e-3 (tests/test_qwen2.py).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import media as jmedia  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import import_hf as jimport  # noqa: E402
from oryx_tpu.train import cli as jcli  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.data import media as tmedia  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve import builder  # noqa: E402
from oryx_tpu_torch.train import cli  # noqa: E402
from oryx_tpu_torch.utils import faults  # noqa: E402
from torch_train_common import TOL, make_tree  # noqa: E402

SPANS = ["data", "h2d", "step_dispatch", "device_sync", "checkpoint_save"]
TIMING = ("data_s", "dispatch_s", "sync_s", "steps_per_sec",
          "tokens_per_sec_per_chip")


class FakeTok:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


@pytest.fixture(autouse=True)
def seams(monkeypatch):
    """The stand-in tokenizer for both packages (JAX's own CLI test patches
    AutoTokenizer the same way), the numpy packing path on the JAX side,
    and a disarmed fault registry afterwards."""
    import transformers

    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        staticmethod(lambda *a, **k: FakeTok()))
    monkeypatch.setattr(builder, "load_tokenizer", lambda path: FakeTok())
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield
    faults.reset()


def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Four image records (sizes vary) and two videos as 4-frame
    directories, with their media."""
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(0)
    recs = []
    for i, (h, w) in enumerate(((28, 28), (40, 56), (56, 42), (30, 60))):
        _png(d / f"img{i}.png", rng.integers(0, 255, (h, w, 3), np.uint8))
        recs.append({"id": f"img{i}", "image": f"img{i}.png",
                     "conversations": [
                         {"from": "human", "value": "<image>\nwhat?"},
                         {"from": "gpt", "value": "thing " * (i + 1)}]})
    for i in range(2):
        os.makedirs(d / f"vid{i}")
        for f in range(4):
            _png(d / f"vid{i}" / f"frame_{f}.png",
                 rng.integers(0, 255, (28, 42, 3), np.uint8))
        recs.append({"id": f"vid{i}", "video": f"vid{i}",
                     "conversations": [
                         {"from": "human", "value": "<image>\nwhat happens?"},
                         {"from": "gpt", "value": "boats " * (i + 2)}]})
    (d / "data.json").write_text(json.dumps(recs))
    return d


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """The input-sensitive tiny init written in the HF layout both
    packages read (LLM + vision safetensors, projector npz)."""
    d = str(tmp_path_factory.mktemp("hf"))
    cfg = jcfg.oryx_tiny()
    jimport.save_hf_checkpoint(make_tree(), cfg.llm, cfg.vision, d)
    return d


def _cfg_file(tmp_path, name, mesh=jcfg.MeshConfig(dp=2, fsdp=4), **train):
    """The run's config file; JAX's 8-device mesh unless `mesh` (the port
    trains over as many ranks as its mesh names)."""
    base = jcfg.oryx_tiny()
    cfg = dataclasses.replace(
        base, mesh=mesh,
        train=dataclasses.replace(base.train, **{
            "global_batch_size": 4, "num_train_steps": 2,
            "learning_rate": 1e-3, "warmup_ratio": 0.0, "log_every": 1,
            "checkpoint_every": 100,
            "checkpoint_dir": str(tmp_path / name), **train}),
    )
    path = tmp_path / f"{name}.json"
    path.write_text(cfg.to_json())
    return cfg, str(path)


def _args(cfg_path, data_dir, metrics, *extra):
    return ["--config", cfg_path, "--data", str(data_dir / "data.json"),
            "--media-root", str(data_dir), "--tokenizer-path", "unused",
            "--metrics-path", str(metrics), "--video-frames", "4", *extra]


def _records(path):
    return [json.loads(x) for x in open(path).read().splitlines()]


# ---- the argument surface ------------------------------------------------------


def _surface(ap):
    return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                     a.required, a.nargs)
            for a in ap._actions if a.dest != "help"}


def test_argparser_has_every_jax_option():
    port, ref = _surface(cli.build_argparser()), \
        _surface(jcli.build_argparser())
    assert set(port) - set(ref) == {"device"}
    assert port["device"][1] == "cuda"
    for dest, want in ref.items():
        assert port[dest] == want, dest


def test_train_cli_argparser():
    args = cli.build_argparser().parse_args([
        "--config", "c.json", "--data", "d.json",
        "--tokenizer-path", "tok", "--num-steps", "5",
    ])
    assert args.sharding == "fsdp" and args.num_steps == 5
    assert args.device == "cuda"


@pytest.mark.parametrize("flags", [
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"],
])
def test_multi_process_flags_raise(flags):
    """The three rendezvous flags go together; one alone raises before
    anything is read."""
    with pytest.raises(ValueError, match="go together"):
        cli.main(["--config", "unused.json", "--data", "unused.json",
                  "--tokenizer-path", "unused", "--device", "cpu", *flags])


# ---- the CLI against JAX's CLI -----------------------------------------------


_JAX_RUN: dict = {}


def _weights(hf_dir):
    return ["--hf-llm", hf_dir, "--hf-vision", hf_dir,
            "--projector", os.path.join(hf_dir, "mm_projector")]


def _jax_records(tmp_path_factory, data_dir, hf_dir):
    """JAX's CLI from the HF weights on its 8-device mesh (once a module):
    (config, its JSONL records)."""
    if not _JAX_RUN:
        d = tmp_path_factory.mktemp("jax_cli")
        cfg, jpath = _cfg_file(d, "j")
        jcli.main(_args(jpath, data_dir, d / "j.jsonl", *_weights(hf_dir)))
        _JAX_RUN.update(cfg=cfg, records=_records(d / "j.jsonl"))
    return _JAX_RUN["cfg"], _JAX_RUN["records"]


def _assert_records(tr, jr):
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [1, 2]
    for a, b in zip(tr, jr):
        assert set(a) == set(b)
        for k in set(b) - set(TIMING) - {"step"}:
            np.testing.assert_allclose(a[k], b[k], **TOL, err_msg=k)


def test_cli_matches_jax_cli_from_hf_weights(tmp_path, tmp_path_factory,
                                             data_dir, hf_dir):
    cfg, jr = _jax_records(tmp_path_factory, data_dir, hf_dir)
    _, tpath = _cfg_file(tmp_path, "t", mesh=jcfg.MeshConfig())
    out = tmp_path / "model"
    trainer = cli.main(_args(tpath, data_dir, tmp_path / "t.jsonl",
                             *_weights(hf_dir), "--output-dir", str(out),
                             "--device", "cpu"))
    trainer.close()
    _assert_records(_records(tmp_path / "t.jsonl"), jr)
    assert trainer.ckpt.latest_step() == 2
    # The weights-only export loads back as the trained model.
    _, model, cfg2 = builder.load_pretrained_model(
        str(out), tokenizer=FakeTok(), device="cpu")
    assert cfg2.llm == tcfg.OryxConfig.from_dict(cfg.to_dict()).llm
    trained = dict(trainer.state.params.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, trained[n].float()), n


_PROCESS = """
import sys
sys.path[:0] = {paths!r}
from torch_tp_common import CharTokenizer
from oryx_tpu_torch.data import native_loader
from oryx_tpu_torch.serve import builder
from oryx_tpu_torch.train import cli
builder.load_tokenizer = lambda path: CharTokenizer()
native_loader.is_available = lambda: False
trainer = cli.main(sys.argv[1:])
if trainer is not None:
    trainer.close()
"""


def test_two_processes_match_the_in_process_fit_and_jax(
        tmp_path, tmp_path_factory, data_dir, hf_dir):
    """`--coordinator / --num-processes 2 / --process-id {0,1}`, two
    commands started on their own (fsdp=2, the CPU): process 0 trains,
    process 1 serves its dispatches. The losses are the bits of the same
    fit by two ranks one process starts (tests/torch_tp_common.RankZero),
    and JAX's CLI's within tolerance; the output dir holds the whole
    trained model."""
    import socket
    import subprocess
    import sys

    from torch_tp_common import RankZero

    _, jr = _jax_records(tmp_path_factory, data_dir, hf_dir)
    _, path = _cfg_file(tmp_path, "two", mesh=jcfg.MeshConfig(fsdp=2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tests = os.path.dirname(os.path.abspath(__file__))
    code = _PROCESS.format(paths=[os.path.dirname(tests), tests])
    argv = _args(path, data_dir, tmp_path / "two.jsonl", *_weights(hf_dir),
                 "--device", "cpu", "--output-dir", str(tmp_path / "out"),
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2")
    env = dict(os.environ, JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv,
                               "--process-id", str(i)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in (1, 0)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    two = _records(tmp_path / "two.jsonl")
    _assert_records(two, jr)

    _, path1 = _cfg_file(tmp_path, "inproc", mesh=jcfg.MeshConfig(fsdp=2))
    d = RankZero(shape=(1, 2, 1, 1))
    try:
        d.run("job_cli", _args(path1, data_dir, tmp_path / "in.jsonl",
                               *_weights(hf_dir), "--device", "cpu"))
    finally:
        d.close()
    inproc = _records(tmp_path / "in.jsonl")
    for a, b in zip(two, inproc):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])
    _, model, _ = builder.load_pretrained_model(
        str(tmp_path / "out"), tokenizer=FakeTok(), device="cpu")
    assert model.llm.embed.weight.shape == (512, 64)


class FakeWriter:
    """torch.utils.tensorboard's SummaryWriter, recording its scalars (the
    real one loads TensorFlow, which must not share a process with JAX:
    tests/test_torch_train_telemetry.py runs it in a fresh interpreter)."""
    scalars: list = []

    def __init__(self, log_dir):
        self.log_dir = log_dir

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step))

    def close(self):
        pass


def test_cli_init_from_telemetry_and_faults(tmp_path, data_dir, monkeypatch,
                                           capsys):
    """--init-from a save_pretrained dir, with the metrics port, events,
    numerics probes and TensorBoard on, and $ORYX_FAULTS arming one loader
    fault the trainer skips."""
    import sys
    import types

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=FakeWriter))
    FakeWriter.scalars = []
    cfg, path = _cfg_file(tmp_path, "c", mesh=jcfg.MeshConfig(),
                          checkpoint_every=1)
    ct = tcfg.OryxConfig.from_dict(cfg.to_dict())
    init = tmp_path / "init"
    builder.save_pretrained(str(init), ct, from_jax_params(make_tree(), ct))
    monkeypatch.setenv("ORYX_FAULTS", "data_loader_next:after=0")
    trainer = cli.main(_args(
        path, data_dir, tmp_path / "m.jsonl", "--init-from", str(init),
        "--metrics-port", "0", "--events-path", str(tmp_path / "ev.jsonl"),
        "--numerics-every", "1", "--tensorboard-dir", str(tmp_path / "tb"),
        "--template", "plain", "--device", "cpu"))
    try:
        out = capsys.readouterr().out
        assert "fault injection armed from $ORYX_FAULTS" in out
        assert "telemetry: http://127.0.0.1:" in out
        assert trainer.data_faults == 1
        reg = trainer.telemetry.registry
        text = reg.render()
        assert 'oryx_faults_injected_total{site="data_loader_next"} 1' in text
        assert reg.get("steps_total") == 2
        assert reg.get("oryx_numerics_samples_total", raw_name=True) == 2
        assert text.count("oryx_numerics_grad_layer_absmax{") == \
            ct.llm.num_layers
        # The first step's fetch failed once: two data spans.
        spans = [[s.name for s in t.spans] for t in trainer.tracer.traces()]
        assert spans == [["data"] + SPANS, SPANS]
        assert len(_records(tmp_path / "m.jsonl")) == 2
        assert ("train/loss", 1) in FakeWriter.scalars
        assert ("train/loss", 2) in FakeWriter.scalars
    finally:
        trainer.close()


# ---- load_record_media ---------------------------------------------------------


@pytest.mark.parametrize("rec,root", [
    ({"image": "img1.png"}, True), ({"image": ["img0.png", "img3.png"]}, True),
    ({"video": "vid1"}, True), ({"question": "text only"}, True),
    ({"image": "img2.png"}, False),
])
def test_load_record_media_matches_jax(data_dir, rec, root):
    if not root:  # paths as given, no media root
        rec = {"image": str(data_dir / rec["image"])}
    kw = dict(media_root=str(data_dir) if root else "", num_frames=3)
    got, got_video = tmedia.load_record_media(rec, **kw)
    want, want_video = jmedia.load_record_media(rec, **kw)
    assert got_video == want_video
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_load_record_media_refuses_a_video_file(tmp_path):
    (tmp_path / "clip.mp4").write_bytes(b"\x00" * 16)
    with pytest.raises(ValueError, match="directory of frames"):
        tmedia.load_record_media({"video": "clip.mp4"},
                                 media_root=str(tmp_path))
