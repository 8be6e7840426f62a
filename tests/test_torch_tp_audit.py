"""The output auditor (serve/audit.py) on sharded pipes: at tp = 2 (each
rank replays on its own KV heads, in a private pool of its own) and at
fsdp = 2 (each rank gathers a layer's weights as it runs), every replay
step a dispatch all ranks run. Against the JAX package's auditor on its
tp = 2 and fsdp = 2 meshes, on the same weights and requests, fp32 on the
CPU over gloo: the verdicts, the record ring (first divergences, sampled
positions, tails, logit drift within tolerance) and the replies; and the
never-perturb contract (armed replies and dispatch counts equal unarmed
ones, both ranks' digests equal, the lock-order sanitizer silent).
Mirrors tests/test_torch_audit.py;
record times are not compared. The port's ranks live in one rank-0
process per mesh (tests/torch_tp_common.py); this process holds jax."""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.config import MeshConfig as JMeshConfig  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.parallel.mesh import build_mesh as jbuild_mesh  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JSched  # noqa: E402

from test_torch_audit import _assert_records_equal, _serve  # noqa: E402
from test_torch_tp_serving import _scaled  # noqa: E402
from torch_tp_common import CharTokenizer, RankZero, as_numpy_tree  # noqa

REQS = [("hello there", 6), ("tell me more", 5), ("another one", 8)]
GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
CASES = {
    "tp-split": ("tp", {}),
    "tp-ragged-int8": ("tp", dict(ragged=True, prefill_chunk=32,
                                  kv_dtype="int8", audit_tol_maxdiff=0.5,
                                  audit_tol_kl=0.01)),
    "fsdp-split": ("fsdp", {}),
    "fsdp-ragged": ("fsdp", dict(ragged=True, prefill_chunk=32)),
}


@pytest.fixture(scope="module")
def model():
    cfg = jcfg.oryx_tiny()
    tree = as_numpy_tree(_scaled(joryx.init_params(cfg, jax.random.key(0))))
    return cfg, tree


@pytest.fixture(scope="module")
def jpipes(model):
    cfg, tree = model
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    yield {
        "tp": OryxInference(CharTokenizer(), params, cfg,
                            mesh=jbuild_mesh(JMeshConfig(tp=2),
                                             devices=jax.devices()[:2]),
                            sharding_mode="tp"),
        "fsdp": OryxInference(CharTokenizer(), params, cfg,
                              mesh=jbuild_mesh(JMeshConfig(fsdp=2),
                                               devices=jax.devices()[:2]),
                              sharding_mode="fsdp"),
    }
    jax.config.update("jax_default_matmul_precision", old)


@pytest.fixture(scope="module")
def ranks(model):
    cfg, tree = model
    out = {}
    try:
        for mode, shape in (("tp", (1, 1, 2, 1)), ("fsdp", (1, 2, 1, 1))):
            out[mode] = RankZero(shape=shape)
            out[mode].run("job_pipeline", mode, tree, cfg.to_dict(), "mesh",
                          mode)
        yield out
    finally:
        for d in out.values():
            d.close()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_audits_equal_jax(ranks, jpipes, case):
    """Every finished request audited on the sharded pipe: replies,
    verdicts and the record ring equal the JAX auditor's under its mesh;
    the followers sampled rank 0's tokens."""
    mode, kw = CASES[case]
    kw = dict(audit_sample_every=1, **kw)
    _, jres, jd = _serve(JSched, jpipes[mode], REQS, **kw)
    got = ranks[mode].run("job_audit", mode, REQS, dict(GEOM, **kw))
    assert got["replies"] == jres
    d = got["audits"]
    assert d["verdicts"] == jd["verdicts"]
    assert (d["total"], d["sampled"], d["dropped"], d["pending"]) == \
        (jd["total"], jd["sampled"], jd["dropped"], jd["pending"]) == \
        (3, 3, 0, 0)
    _assert_records_equal(d["records"], jd["records"])
    assert all(r["first_divergence"] == -1 for r in d["records"])
    assert len(set(got["digests"])) == 1


@pytest.mark.parametrize("mode", ["tp", "fsdp"])
def test_armed_sharded_engine_never_perturbs(ranks, mode):
    """Replies and dispatch counts with every request audited are those
    of the unarmed engine on the same sharded pipe; with the lock-order
    sanitizer and the race detector armed, the replay's dispatches from
    the engine thread break no lock order and race no guarded field."""
    kw = dict(GEOM, ragged=True, prefill_chunk=32)
    base = ranks[mode].run("job_audit", mode, REQS, kw)
    armed = ranks[mode].run("job_audit", mode, REQS,
                            dict(kw, audit_sample_every=1, sanitize=True))
    assert armed["violations"] == []
    assert armed["replies"] == base["replies"]
    assert armed["dispatches"] == base["dispatches"]
    assert base["audits"]["total"] == 0
    assert armed["audits"]["verdicts"] == {"pass": 3, "drift": 0, "fail": 0}
