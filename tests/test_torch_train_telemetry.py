"""The trainer's observability in the port (train/telemetry.py,
train/step.py `numerics=`, the Trainer's options, MetricLogger's JSONL and
TensorBoard) against the JAX package on the CPU, tiny fp32 config, the same
weights and batches (tests/torch_train_common.py):

  * a 3-step run exposes the oryx_train_* series over live HTTP, scraped
    while the step loop runs, with /healthz and /readyz as a load balancer
    expects; its /metrics families (names, kinds, label sets) are exactly
    those of JAX's Trainer on the same run, loss and grad norm within
    tolerance, and the numerics probes equal;
  * the goodput / MFU accounting and `batch_flops` (JAX's test cases);
  * `train_step(numerics=True)`: the probes within tolerance of JAX's, the
    update bit-identical to numerics=False;
  * `record_numerics`' gauges and the absmax halt (JAX's case);
  * the Trainer's flight recorder spans, watchdog, halt policy,
    sharding_mode and numerics_every validation.

Tolerance: atol 2e-4, rtol 2e-3 (tests/test_qwen2.py).
"""

import dataclasses
import json
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.train import optimizer as jopt  # noqa: E402
from oryx_tpu.train import step as jstep  # noqa: E402
from oryx_tpu.train import telemetry as jtelemetry  # noqa: E402
from oryx_tpu.train.trainer import Trainer as JTrainer  # noqa: E402
from oryx_tpu.utils import metrics as jmetrics  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.train import step as tstep  # noqa: E402
from oryx_tpu_torch.train import telemetry  # noqa: E402
from oryx_tpu_torch.train.optimizer import make_optimizer  # noqa: E402
from oryx_tpu_torch.train.telemetry import TrainTelemetry  # noqa: E402
from oryx_tpu_torch.train.trainer import Trainer  # noqa: E402
from oryx_tpu_torch.utils import flops as flops_lib  # noqa: E402
from oryx_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from oryx_tpu_torch.utils.anomaly import (  # noqa: E402
    AnomalyHalt,
    AnomalyThresholds,
)
from torch_train_common import (  # noqa: E402
    TOL,
    cfgs,
    make_batches,
    make_tree,
    port_model,
    tbatch,
)

REQUIRED_SERIES = (
    "oryx_train_loss",
    "oryx_train_tokens_per_sec",
    "oryx_train_mfu",
    "oryx_train_goodput_ratio",
    "oryx_train_hbm_live_bytes",
)
SPANS = ["data", "h2d", "step_dispatch", "device_sync", "checkpoint_save"]
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$")


@pytest.fixture(autouse=True)
def full_precision(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def tree():
    return make_tree()


@pytest.fixture(scope="module")
def batches():
    return make_batches()


def samples(text: str) -> dict[str, float]:
    """Prometheus text -> {name{labels}: value}, well-formedness asserted."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, line
        out[m.group(1) + (m.group(2) or "")] = float(m.group(3))
    return out


def families(text: str) -> dict[str, tuple]:
    """{family: (kind, sorted label-name sets of its samples)}."""
    kinds = dict(re.findall(r"^# TYPE (\S+) (\S+)$", text, re.M))
    labels = {name: set() for name in kinds}
    for key in samples(text):
        name, _, rest = key.partition("{")
        fam = next(f for f in (name, re.sub(r"_(bucket|sum|count)$", "",
                                            name)) if f in kinds)
        labels[fam].add(tuple(sorted(re.findall(r"(\w+)=", rest))))
    return {n: (kinds[n], sorted(labels[n])) for n in kinds}


def _get(port: int, path: str):
    """(status, body); 503 is a result."""
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30
        ) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


def _configs(tmp_path, **train):
    cj, _ = cfgs(tune="projector_only")
    cj = dataclasses.replace(
        cj, mesh=jcfg.MeshConfig(dp=jax.device_count()),
        train=dataclasses.replace(cj.train, **{
            "log_every": 1, "checkpoint_every": 1,
            "checkpoint_dir": str(tmp_path / "j"), **train}),
    )
    # The port trains on one device: its mesh says so (a JAX-sized mesh
    # over one device raises, as JAX's build_mesh does).
    ct = tcfg.OryxConfig.from_dict(dataclasses.replace(
        cj, mesh=jcfg.MeshConfig(), train=dataclasses.replace(
            cj.train, checkpoint_dir=str(tmp_path / "t"))).to_dict())
    return cj, ct


# ---- the exporter over a live run, against JAX's -----------------------------


def test_three_step_run_scrapes_live_and_matches_jax(tree, batches, tmp_path):
    """Acceptance: a 3-step CPU run exposes
    oryx_train_{loss,tokens_per_sec,mfu,goodput_ratio,hbm_live_bytes} over
    HTTP, scraped while the step loop runs, monotone between scrapes; the
    final exposition has JAX's families, label sets and values."""
    cj, ct = _configs(tmp_path)
    data = [{k: v[0] for k, v in batches[1].items()}] * 3
    jt = JTrainer(cj, params=jax.tree_util.tree_map(jnp.asarray, tree),
                  sharding_mode="ddp", metrics_port=0, numerics_every=2,
                  events_path=str(tmp_path / "j_events.jsonl"))
    try:
        jt.fit(iter(data), num_steps=3, resume=False, prefetch=0)
        jtext = jt.telemetry.registry.render()
    finally:
        jt.close()

    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                metrics_port=0, numerics_every=2,
                events_path=str(tmp_path / "t_events.jsonl"))
    assert t.telemetry is not None
    port = t.telemetry.port
    code, body = _get(port, "/readyz")
    assert code == 503 and json.loads(body)["ready"] is False
    assert _get(port, "/healthz") == (200, '{"status": "ok"}\n')
    scrapes = []

    def feeding():
        for i in range(3):
            if i:
                scrapes.append(samples(_get(port, "/metrics")[1]))
                code, body = _get(port, "/readyz")
                assert code == 200 and json.loads(body)["ready"] is True
            yield data[i]

    try:
        t.fit(feeding(), num_steps=3, resume=False, prefetch=0)
        code, body = _get(port, "/readyz")
        assert code == 503 and "exited" in json.loads(body)["reason"]
        status, ttext = _get(port, "/metrics")
        assert status == 200
    finally:
        t.close()
    final = samples(ttext)
    scrapes.append(final)
    for name in REQUIRED_SERIES:
        assert name in final, f"missing {name}"
    assert np.isfinite(final["oryx_train_loss"])
    assert final["oryx_train_tokens_per_sec"] > 0
    assert final["oryx_train_mfu"] == 0.0  # the CPU: peak unknown, pinned 0
    assert final["oryx_train_model_flops_per_sec"] > 0
    assert 0 < final["oryx_train_goodput_ratio"] <= 1.0
    assert final["oryx_train_hbm_live_bytes"] == 0  # no card: reads 0
    assert final["oryx_train_steps_total"] == 3
    assert final["oryx_train_last_step"] == 3
    assert final["oryx_train_step_time_seconds_count"] == 3
    assert final["oryx_train_checkpoints_total"] == 3
    assert final["oryx_train_productive_seconds_total"] > 0
    assert final["oryx_numerics_samples_total"] == 2
    steps_seen = [s["oryx_train_steps_total"] for s in scrapes]
    assert steps_seen == sorted(steps_seen) and steps_seen[0] >= 1
    tokens_seen = [s["oryx_train_tokens_total"] for s in scrapes]
    assert tokens_seen == sorted(tokens_seen)
    for name in final:
        assert name.split("{")[0].startswith(
            ("oryx_train_", "oryx_anomaly_", "oryx_numerics_")), name

    # JAX's exporter on the same run: the same families and label sets.
    assert families(ttext) == families(jtext)
    want = samples(jtext)
    for key in ("oryx_train_loss", "oryx_train_grad_norm", "oryx_train_lr",
                "oryx_train_last_step", "oryx_train_tokens_total",
                "oryx_numerics_grad_absmax", "oryx_numerics_act_absmax",
                "oryx_numerics_param_absmax",
                'oryx_numerics_grad_layer_absmax{layer="0"}',
                'oryx_numerics_grad_layer_absmax{layer="1"}'):
        np.testing.assert_allclose(final[key], want[key], **TOL,
                                   err_msg=key)
    # The flight recorder: one train_step trace a step with the five spans,
    # and the record's phase seconds are those spans'.
    traces = t.tracer.traces()
    assert [tr.kind for tr in traces] == ["train_step"] * 3
    for tr, h in zip(traces, t.history):
        assert [s.name for s in tr.spans] == SPANS
        secs = tr.span_seconds()
        assert h["data_s"] == secs["data"]
        assert h["dispatch_s"] == secs["step_dispatch"]
        assert h["sync_s"] == secs["device_sync"]


def test_goodput_attribution_unit():
    tel = TrainTelemetry(port=None)
    tel.record_restore(2.0)
    tel.record_step(
        1, {"loss": 1.0, "num_tokens": 100}, step_seconds=1.0,
        data_s=0.2, dispatch_s=0.1, sync_s=0.6, checkpoint_s=0.25,
    )
    r = tel.registry
    assert r.get("productive_seconds_total") == pytest.approx(0.75)
    assert r.get("checkpoint_seconds_total") == pytest.approx(0.25)
    assert r.get("restore_seconds_total") == pytest.approx(2.0)
    assert r.get("data_wait_seconds_total") == pytest.approx(0.2)
    assert r.get("checkpoints_total") == 1
    assert 0 < r.get("goodput_ratio") <= 1.0
    # A skipped step is wall time but not goodput.
    tel.record_step(
        2, {"loss": float("nan"), "num_tokens": 100, "skipped": 1},
        step_seconds=1.0,
    )
    assert r.get("productive_seconds_total") == pytest.approx(0.75)
    assert r.get("skipped_steps_total") == 1
    tel.close()


def test_mfu_math_with_known_peak(monkeypatch):
    """With a known peak the MFU gauge is flops / (dt * peak): the port
    trains on one device."""
    seen = []

    def peak(kind):
        seen.append(kind)
        return 100e12

    monkeypatch.setattr(flops_lib, "chip_peak_flops", peak)
    tel = TrainTelemetry(port=None)
    tel.record_step(
        1, {"loss": 1.0, "num_tokens": 100}, step_seconds=2.0,
        flops=40e12,
    )
    assert seen == ["cpu"]
    assert tel.registry.get("mfu") == pytest.approx((40e12 / 2.0) / 100e12)
    assert tel.registry.get("model_flops_per_sec") == pytest.approx(20e12)
    assert tel.registry.get("tokens_per_sec_per_chip") == pytest.approx(50)
    tel.close()


def test_batch_flops_matches_jax(batches):
    cj, ct = cfgs()
    host = {k: v[0] for k, v in batches[1].items()}
    assert telemetry.batch_flops(ct, host) == jtelemetry.batch_flops(cj, host)
    stacked = {k: np.asarray(v)[None] for k, v in host.items()}
    assert telemetry.batch_flops(ct, stacked) == pytest.approx(
        telemetry.batch_flops(ct, host))
    two = {k: np.stack([v, v]) for k, v in host.items()}
    assert telemetry.batch_flops(ct, two) == pytest.approx(
        2 * telemetry.batch_flops(ct, host))
    assert telemetry.batch_flops(ct, batches[2]) == \
        jtelemetry.batch_flops(cj, batches[2])


def test_trainer_without_telemetry_has_none(tree, tmp_path):
    _, ct = _configs(tmp_path)
    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu")
    assert t.telemetry is None and t.watchdog is None
    t.close()
    # Asking for the halt policy builds the monitor even with no port.
    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                on_anomaly="halt")
    assert t.telemetry is not None
    assert t.telemetry.server is None and t.telemetry.port is None
    assert t.telemetry.on_anomaly == "halt"
    t.close()
    assert t.telemetry is None


# ---- numerics probes -----------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_numerics_probes_and_bit_identity(tree, batches, accum):
    """The probes match JAX's; numerics=True changes no bit of the update,
    the loss or the grad norm (accum 2: act_absmax is the max over the
    microbatches)."""
    cj, ct = cfgs(accum=accum, tune="full")
    batch = batches[accum]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tx = jopt.make_optimizer(cj.train, jp)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                              opt_state=tx.init(jp))
    _, jm = jstep.train_step(jstate, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                             cj, tx, numerics=True)
    jm = jax.device_get(jm)

    def one_step(numerics):
        model = port_model(tree, ct)
        txt = make_optimizer(ct.train, model)
        state = tstep.init_state(model, txt)
        state, m = tstep.train_step(state, tbatch(batch), ct, txt,
                                    numerics=numerics)
        return state, m

    s0, m0 = one_step(False)
    s1, m1 = one_step(True)
    assert "act_absmax" not in m0 and "grad_layer_absmax" not in m0
    assert set(m1) == set(jm)
    for k in ("act_absmax", "grad_absmax", "param_absmax"):
        assert float(m1[k]) > 0
        np.testing.assert_allclose(float(m1[k]), float(jm[k]), **TOL,
                                   err_msg=k)
    assert m1["grad_layer_absmax"].shape == (ct.llm.num_layers,)
    np.testing.assert_allclose(m1["grad_layer_absmax"].numpy(),
                               np.asarray(jm["grad_layer_absmax"]), **TOL)
    for k in ("loss", "grad_norm", "num_tokens"):
        assert torch.equal(m0[k], m1[k]), k
    for (n, a), (_, b) in zip(s0.params.named_parameters(),
                              s1.params.named_parameters()):
        assert torch.equal(a, b), n
    for kind in ("mu", "nu"):
        for n, x in s0.opt_state[kind].items():
            assert torch.equal(s1.opt_state[kind][n], x), n


def test_telemetry_record_numerics_gauges_and_halt():
    from oryx_tpu.utils import anomaly as janomaly

    def run(cls, thresholds_cls, halt_exc):
        tel = cls(port=None, on_anomaly="halt",
                  thresholds=thresholds_cls(min_window=4, absmax_factor=5.0))
        try:
            for step in range(6):
                tel.record_numerics(
                    step, {"grad_absmax": 1.0, "act_absmax": 2.0,
                           "param_absmax": 3.0},
                    layer_absmax=np.asarray([0.5, 1.0]),
                )
            text = tel.registry.render()
            with pytest.raises(halt_exc):
                tel.record_numerics(99, {"grad_absmax": 100.0})
            assert tel.anomaly.counts.get("absmax_explosion") == 1
            assert tel._ready_reason == "halted: absmax_explosion"
            return [x for x in text.splitlines() if "oryx_numerics" in x]
        finally:
            tel.close()

    lines = run(TrainTelemetry, AnomalyThresholds, AnomalyHalt)
    assert "oryx_numerics_grad_absmax 1" in lines
    assert "oryx_numerics_act_absmax 2" in lines
    assert 'oryx_numerics_grad_layer_absmax{layer="1"} 1' in lines
    assert lines == run(jtelemetry.TrainTelemetry,
                        janomaly.AnomalyThresholds, janomaly.AnomalyHalt)


# ---- the Trainer's options -----------------------------------------------------


@pytest.mark.parametrize("bad", [-1, 1.5, "2"])
def test_numerics_every_validated_as_jax(tree, tmp_path, bad):
    cj, ct = _configs(tmp_path)
    with pytest.raises(ValueError) as je:
        JTrainer(cj, numerics_every=bad)
    with pytest.raises(ValueError) as te:
        Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                numerics_every=bad)
    assert str(te.value) == str(je.value)


def test_sharding_modes_compute_the_same_step(tree, batches, tmp_path):
    """fsdp, zero2 and ddp on the port's one device: the same losses and
    params; any other mode raises, as JAX's Trainer does."""
    _, ct = _configs(tmp_path, checkpoint_every=100)
    data = [{k: v[0] for k, v in batches[1].items()}] * 2
    runs = {}
    for mode in ("fsdp", "zero2", "ddp"):
        t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                    sharding_mode=mode)
        t.fit(iter(data), num_steps=2, resume=False, prefetch=0)
        runs[mode] = ([h["loss"] for h in t.history],
                      [p.detach().clone() for p in
                       t.state.params.parameters()])
        t.close()
    for mode in ("zero2", "ddp"):
        assert runs[mode][0] == runs["fsdp"][0]
        assert all(torch.equal(a, b)
                   for a, b in zip(runs[mode][1], runs["fsdp"][1]))
    with pytest.raises(ValueError, match="sharding_mode"):
        Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                sharding_mode="tp")


def test_watchdog_and_halt_policy(tree, batches, tmp_path, monkeypatch):
    """stall_timeout arms a watchdog that fit activates and beats and close
    stops; under on_anomaly="halt" a NaN batch raises AnomalyHalt out of
    fit with /readyz saying why; numerics on changes no loss."""
    from oryx_tpu_torch.utils import trace as trace_lib

    _, ct = _configs(tmp_path, checkpoint_every=100,
                     skip_nonfinite_steps=True)
    host = {k: v[0] for k, v in batches[1].items()}
    states = []
    orig = trace_lib.StallWatchdog.set_active
    monkeypatch.setattr(trace_lib.StallWatchdog, "set_active",
                        lambda self, a: (states.append(a), orig(self, a)))
    t = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                stall_timeout=60.0, flight_recorder_size=2,
                numerics_every=1)
    t.fit(iter([host] * 3), num_steps=3, resume=False, prefetch=0)
    assert states == [True, False] and t.watchdog.dumps == 0
    assert len(t.tracer.traces()) == 2  # the recorder keeps the newest 2
    thread = t.watchdog._thread
    t.close()
    assert t.watchdog is None and not thread.is_alive()
    plain = Trainer(ct, params=from_jax_params(tree, ct), device="cpu")
    plain.fit(iter([host] * 3), num_steps=3, resume=False, prefetch=0)
    assert [h["loss"] for h in plain.history] == \
        [h["loss"] for h in t.history]
    plain.close()

    bad = dict(host, patches=np.full_like(host["patches"], np.nan))
    h = Trainer(ct, params=from_jax_params(tree, ct), device="cpu",
                on_anomaly="halt",
                events_path=str(tmp_path / "events.jsonl"))
    with pytest.raises(AnomalyHalt):
        h.fit(iter([host, bad, host]), num_steps=3, resume=False,
              prefetch=0)
    assert len(h.history) == 2 and h.history[1]["skipped"] == 1
    assert h.telemetry._ready_reason == "halted: nan_loss"
    events = [json.loads(x) for x in
              open(tmp_path / "events.jsonl").read().splitlines()]
    assert [e["kind"] for e in events] == ["nan_loss"]
    h.close()


# ---- MetricLogger ----------------------------------------------------------------


def test_metric_logger_writes_jsonl_as_jax(tmp_path):
    recs = {}
    for name, lib in (("t", tmetrics), ("j", jmetrics)):
        path = str(tmp_path / f"{name}.jsonl")
        lg = lib.MetricLogger(path, log_every=2)
        lg.log_step(1, {"loss": 1.0, "num_tokens": 10})
        lg.log_step(2, {"loss": float("nan"), "num_tokens": 10,
                        "skipped": 1})
        lg.close()
        recs[name] = [json.loads(x) for x in open(path)]
    assert len(recs["t"]) == 1 and recs["t"][0]["step"] == 2
    assert set(recs["t"][0]) == set(recs["j"][0])
    assert recs["t"][0]["loss"] is None and recs["t"][0]["skipped"] == 1


def test_metric_logger_tensorboard(tmp_path):
    """TensorBoard scalars `train/{key}` through torch's SummaryWriter, in a
    fresh interpreter: the writer loads TensorFlow where it is installed,
    whose runtime must not share a process with JAX's CPU client."""
    import subprocess
    import sys

    tb_dir = tmp_path / "tb"
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.dirname(os.path.dirname(__file__))!r})\n"
        "from oryx_tpu_torch.utils.metrics import MetricLogger\n"
        f"lg = MetricLogger(None, log_every=1, tensorboard_dir={str(tb_dir)!r})\n"
        "if lg._tb is None:\n"
        "    sys.exit(3)\n"
        "lg.log_step(1, {'loss': 1.0, 'num_tokens': 10})\n"
        "lg.close()\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    if res.returncode == 3:
        pytest.skip("tensorboard writer unavailable")
    assert res.returncode == 0, res.stderr[-2000:]
    assert any(f.startswith("events.out.tfevents")
               for f in os.listdir(tb_dir))


def test_metric_logger_without_tensorboard(tmp_path, monkeypatch, capsys):
    """Without TensorBoard a line says so and logging goes on."""
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    path = str(tmp_path / "m.jsonl")
    lg = tmetrics.MetricLogger(path, log_every=1,
                               tensorboard_dir=str(tmp_path / "tb"))
    assert lg._tb is None
    assert "tensorboard disabled" in capsys.readouterr().out
    lg.log_step(1, {"loss": 1.0, "num_tokens": 10})
    lg.close()
    assert json.loads(open(path).read())["loss"] == 1.0
