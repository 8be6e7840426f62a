"""The fused decode megastep (`fuse_steps=`) and the neural drafter in the
port against the JAX package, on the CPU.

The cases mirror tests/test_fused_decode.py:
  * `NeuralDrafter`: deterministic proposals bounded by its window; an npz
    round trip; an npz written by the JAX class proposes JAX's tokens in
    the port; `from_spec`; validation; `fit_neural_drafter` learns and is
    reproducible, and started from JAX's init (loaded through npz) gives
    JAX's per-epoch losses; the host `propose` equals the device chain
    (`neural_draft_propose`, the fused loop's drafter);
  * engine level: `ContinuousScheduler(fuse_steps=K)` replies (and
    admit/finish chunks) equal the JAX fused engine's and the port's K = 1
    engine's on the same tiny fp32 weights (JAX matmuls at "highest"), for
    greedy mixed lengths (K = 4 and "auto"), a stop string completing
    mid-megastep, eviction replay, an int8 pool, and speculation inside
    the fused loop with a JAX-written neural drafter (rollback); seeded
    sampling equals the K = 1 engine's and replays; a small budget never
    engages a megastep; `_select_fuse_k` picks the rungs JAX picks.
Tolerances: tokens byte-equal; drafter losses atol 2e-4, rtol 2e-3 (fp32
on both sides, sums in another order).

Not mirrored here, each waiting for its module: the journal and its
replay (K entries a megastep, byte-exact fused replay, the journaled fuse
plan, the named K = 1 divergence, the replay geometry), the metrics
registry (the fused_k gauge), the cost ledger (per-step billing keys), the
CLI and build_server flags, the tp=2 mesh, and the recompile watchdog.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import generate as jgen  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.data import native_loader as tnative  # noqa: E402
from oryx_tpu_torch.models import generate as tgen  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve import scheduler as tsched  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402

V = jcfg.oryx_tiny().llm.vocab_size


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


# ---------------------------------------------------------------------------
# NeuralDrafter
# ---------------------------------------------------------------------------


def test_neural_drafter_deterministic():
    d = tgen.NeuralDrafter.init(V, dim=8, window=8, seed=0)
    ctx = [5, 8, 9, 7, 1, 2, 3, 8, 9, 7, 11, 4]
    a = d.propose(ctx, 4)
    assert len(a) == 4 and all(isinstance(t, int) for t in a)
    assert a == d.propose(list(ctx), 4) == d.propose(np.asarray(ctx), 4)
    # Contexts equal on the window's tail propose alike.
    assert d.propose([99] * 6 + ctx[-8:], 4) == a
    assert d.propose(ctx, 0) == [] and d.propose([], 3) == []


def test_neural_drafter_npz_round_trip(tmp_path):
    d = tgen.NeuralDrafter.init(V, dim=8, window=8, seed=1)
    path = str(tmp_path / "draft.npz")
    d.save(path)
    d2 = tgen.NeuralDrafter.load(path)
    assert d2.window == d.window and d2.source == path
    ctx = list(range(40, 60))
    assert d2.propose(ctx, 5) == d.propose(ctx, 5)
    np.testing.assert_array_equal(d.params["embed"], d2.params["embed"])
    # The JAX class reads the port's npz.
    assert jgen.NeuralDrafter.load(path).window == d.window


@pytest.mark.parametrize("seed,ctx", [
    (0, [5, 8, 9, 7, 1, 2, 3, 8, 9, 7, 11, 4]),
    (2, [7, 3, 9, 12, 5, 5, 2, 31]),
    (3, list(range(40, 60))),
    (4, [151645, 3, 3]),  # an id past the vocabulary clamps, as in XLA
])
def test_jax_written_npz_proposes_jax_tokens(tmp_path, seed, ctx):
    jd = jgen.NeuralDrafter.init(V, dim=8, window=8, seed=seed)
    path = str(tmp_path / "jax.npz")
    jd.save(path)
    td = tgen.NeuralDrafter.load(path)
    assert td.propose(ctx, 4) == jd.propose(ctx, 4)


def test_neural_drafter_from_spec(tmp_path):
    d = tgen.NeuralDrafter.from_spec(f"init:{V}:8:8:7")
    assert d.source == f"init:{V}:8:8:7"
    same = tgen.NeuralDrafter.init(V, dim=8, window=8, seed=7)
    ctx = [3, 1, 4, 1, 5, 9, 2, 6]
    assert d.propose(ctx, 4) == same.propose(ctx, 4)
    np.testing.assert_array_equal(d.params["proj"], same.params["proj"])
    path = str(tmp_path / "d.npz")
    d.save(path)
    assert tgen.NeuralDrafter.from_spec(path).propose(ctx, 4) == \
        d.propose(ctx, 4)
    with pytest.raises(ValueError, match="init:"):
        tgen.NeuralDrafter.from_spec("init:100:8")


@pytest.mark.parametrize("embed,proj,window", [
    ((10, 4), (4, 10), 0), ((10, 4), (5, 10), 4), ((10, 4), (4, 9), 4),
], ids=["window", "inner", "vocab"])
def test_neural_drafter_validation(embed, proj, window):
    ok = dict(embed=np.zeros((10, 4), np.float32),
              proj=np.zeros((4, 10), np.float32))
    tgen.NeuralDrafter(ok, window=4)
    bad = dict(embed=np.zeros(embed, np.float32),
               proj=np.zeros(proj, np.float32))
    for cls in (jgen.NeuralDrafter, tgen.NeuralDrafter):
        with pytest.raises(ValueError):
            cls(bad, window=window)


def test_fit_neural_drafter_learns_and_validates():
    streams = [[1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3]] * 4
    d, losses = tgen.fit_neural_drafter(
        streams, vocab_size=8, dim=8, window=4, epochs=30, seed=0)
    assert losses[-1] < losses[0]
    assert d.source.startswith("fit:")
    d2, losses2 = tgen.fit_neural_drafter(
        streams, vocab_size=8, dim=8, window=4, epochs=30, seed=0)
    assert losses == losses2
    assert d.propose([1, 2, 3, 1], 3) == d2.propose([1, 2, 3, 1], 3)
    with pytest.raises(ValueError):
        tgen.fit_neural_drafter([[5]], vocab_size=8)


def test_fit_from_jax_init_gives_jax_losses(tmp_path):
    """The same full-batch descent: started from JAX's init (through npz),
    the port's per-epoch losses are JAX's, and the fitted weights
    propose alike."""
    streams = [[1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [5, 6, 5, 6, 5, 6, 7, 1]]
    kw = dict(vocab_size=16, dim=8, window=4, epochs=12, lr=0.5, seed=3)
    jd, jlosses = jgen.fit_neural_drafter(streams, **kw)
    path = str(tmp_path / "init.npz")
    jgen.NeuralDrafter.init(16, 8, window=4, seed=3).save(path)
    td, losses = tgen.fit_neural_drafter(
        streams, **kw, init=tgen.NeuralDrafter.load(path))
    np.testing.assert_allclose(losses, jlosses, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(td.params["proj"], jd.params["proj"],
                               atol=2e-4, rtol=2e-3)
    assert td.propose([1, 2, 3], 3) == jd.propose([1, 2, 3], 3)


def test_neural_drafter_host_propose_equals_device_chain():
    d = tgen.NeuralDrafter.init(V, dim=8, window=8, seed=2)
    ctx_list = [7, 3, 9, 12, 5, 5, 2]
    fed = 31
    host = d.propose(ctx_list + [fed], 4)
    CW = d.window
    ctx = np.zeros((1, CW), np.int32)
    ctx[0, CW - len(ctx_list):] = ctx_list
    drafts, dlen = tgen.neural_draft_propose(
        d.device_params(), torch.from_numpy(ctx),
        torch.tensor([len(ctx_list)], dtype=torch.int32),
        torch.tensor([fed], dtype=torch.int32), 4)
    assert dlen.tolist() == [4]
    assert drafts[0].tolist() == host


# ---------------------------------------------------------------------------
# Engine level
# ---------------------------------------------------------------------------


def _scaled(tree):
    """x20 on kernels/tables so greedy replies depend on the inputs."""
    def f(leaf):
        a = np.asarray(leaf, np.float32)
        return a if a.ndim < 2 else a * 20
    return jax.tree_util.tree_map(f, tree)


@pytest.fixture(scope="module")
def pipes():
    cfg = jcfg.oryx_tiny()
    tree = _scaled(joryx.init_params(cfg, jax.random.key(0)))
    jp = OryxInference(
        CharTokenizer(), jax.tree_util.tree_map(jnp.asarray, tree), cfg
    )
    tc = tcfg.OryxConfig.from_dict(cfg.to_dict())
    tp = Pipeline(CharTokenizer(), from_jax_params(tree, tc), tc,
                  device="cpu")
    return jp, tp


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    """Both packages on the numpy preprocessing path (pixels byte-equal)."""
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(tnative, "is_available", lambda: False)


GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
            prefill_chunk=8, ragged=True)


def _serve(pipe, reqs, sampling=None, spy=None, **kw):
    """One engine (the port's, or JAX's for an OryxInference pipe) over
    [(question, cap)], every request submitted before the start; `spy`
    collects the K of each megastep. Returns (results, scheduler,
    handles); the pool invariant held."""
    jax_side = isinstance(pipe, OryxInference)
    S = JaxScheduler if jax_side else ContinuousScheduler
    with jax.default_matmul_precision("highest"):
        sched = S(pipe, autostart=False, **dict(GEOM, **kw))
        if spy is not None:
            mega = sched._fused_megastep

            def record(k_steps):
                spy.append(k_steps)
                return mega(k_steps)

            sched._fused_megastep = record
        handles = [sched.submit({"question": q}, cap, sampling)
                   for q, cap in reqs]
        sched.start()
        results = [h.result(timeout=600) for h in handles]
    if jax_side:
        sched._check_pool_invariant()
    else:
        sched.check_pool_invariant()
    sched.close()
    return results, sched, handles


def _chunks(handles):
    return [(h.debug.get("admit_chunk"), h.debug.get("finish_chunk"))
            for h in handles]


def _ids(pipe, q):
    return len(pipe._prepare_request({"question": q})[0])


def _fused_cases(tp):
    """(requests, engine kwargs, sampling) of the parity cases."""
    q1, q2 = "hello there", "tell me more"
    ps, chunk = 16, 4
    admit1 = math.ceil((_ids(tp, q1) + chunk) / ps)
    admit2 = math.ceil((_ids(tp, q2) + chunk) / ps)
    cap = (admit1 * ps - _ids(tp, q1)) + ps
    mixed = [("hi", 24),
             ("what is going on with all of this, tell me now please", 32)]
    return {
        "greedy_k4": (mixed, dict(fuse_steps=4), None),
        "greedy_auto": ([("warm up the big solo rung", 90),
                         ("short neighbor", 20)],
                        dict(fuse_steps="auto", prefix_cache=False), None),
        "eviction_replay": ([(q1, cap), (q2, cap)],
                            dict(fuse_steps=4,
                                 num_pages=admit1 + admit2 + 1,
                                 prefix_cache=False), None),
        "int8_kv": ([("hello there", 20), ("what now?", 24)],
                    dict(fuse_steps=4, kv_dtype="int8"), None),
    }


@pytest.mark.parametrize("case", ["greedy_k4", "greedy_auto",
                                  "eviction_replay", "int8_kv"])
def test_fused_engine_matches_jax_and_the_k1_engine(pipes, case):
    """The port's fused engine gives the JAX fused engine's replies,
    usage and admit/finish chunks (the same K choices on both sides) and
    the port's K = 1 engine's replies, with fewer harvests."""
    jp, tp = pipes
    reqs, kw, sampling = _fused_cases(tp)[case]
    jk, tk = [], []
    want, _, jh = _serve(jp, reqs, sampling, spy=jk, **kw)
    got, sched, th = _serve(tp, reqs, sampling, spy=tk, **kw)
    assert got == want
    assert _chunks(th) == _chunks(jh)
    assert tk == jk and any(k > 1 for k in tk)
    base, bsched, _ = _serve(tp, reqs, sampling, **dict(kw, fuse_steps=1))
    assert got == base
    m = sched.metrics
    assert m.by_label("dispatches_total")["fused"] > 0
    assert m.get("harvest_total") < bsched.metrics.get("harvest_total")
    for series in ("decode_steps_total", "decode_steps_useful",
                   "decode_steps_wasted"):
        assert m.get(series) == bsched.metrics.get(series), series
    if case == "eviction_replay":
        assert m.get("evicted") >= 1


def test_fused_seeded_sampling_equals_k1_and_replays(pipes):
    """temperature > 0: the megastep draws each row's numbers in the order
    K sequential steps would, so the replies equal the K = 1 engine's,
    run to run."""
    _, tp = pipes
    reqs = [("hello there", 20), ("tell me more", 24)]
    sampling = {"temperature": 0.8, "top_p": 0.9, "seed": 12}
    base, _, _ = _serve(tp, reqs, sampling)
    fused, sched, _ = _serve(tp, reqs, sampling, fuse_steps=4)
    assert sched.metrics.by_label("dispatches_total")["fused"] > 0
    again, _, _ = _serve(tp, reqs, sampling, fuse_steps=4)
    assert base == fused == again


def test_fused_mid_megastep_stop_string(pipes):
    """A stop string completing inside a megastep: the host cuts at the
    logical step that matched and bills through it only; equal to JAX's
    fused engine and the port's K = 1 engine."""
    jp, tp = pipes
    q, cap = "tell me a long story please", 24
    ref, _, _ = _serve(tp, [(q, cap)])
    stop = ref[0][0][2:5]
    sampling = {"stop": [stop]}
    want, _, _ = _serve(jp, [(q, cap)], sampling, fuse_steps=4)
    got, sched, _ = _serve(tp, [(q, cap)], sampling, fuse_steps=4)
    base, bsched, _ = _serve(tp, [(q, cap)], sampling)
    assert got == want == base
    assert sched.metrics.by_label("dispatches_total")["fused"] > 0
    reply, reason, usage = got[0]
    assert reason == "stop" and stop not in reply and usage[1] < cap
    assert sched.metrics.get("decode_steps_useful") == \
        bsched.metrics.get("decode_steps_useful")


def test_fused_spec_with_a_jax_written_drafter(pipes, tmp_path):
    """Speculation inside the fused loop (the device chain drafts, the
    verify forward judges, rejects roll back) with a random neural
    drafter written by the JAX class: replies equal the JAX fused
    speculative engine's, the port's K = 1 speculative engine's and its
    plain engine's."""
    jp, tp = pipes
    path = str(tmp_path / "draft.npz")
    jd = jgen.NeuralDrafter.init(V, dim=8, window=8, seed=0)
    jd.save(path)
    reqs = [("hello there", 20), ("tell me more about that", 24)]
    kw = dict(speculate=3, fuse_steps=4)
    jk, tk = [], []
    want, _, jh = _serve(jp, reqs, drafter=jd, spy=jk, **kw)
    got, sched, th = _serve(tp, reqs, drafter=tgen.NeuralDrafter.load(path),
                            spy=tk, **kw)
    assert got == want
    assert _chunks(th) == _chunks(jh)
    assert tk == jk and tk
    k1, _, _ = _serve(tp, reqs, drafter=tgen.NeuralDrafter.load(path),
                      speculate=3)
    plain, _, _ = _serve(tp, reqs)
    assert got == k1 == plain
    m = sched.metrics
    assert m.by_label("dispatches_total")["fused_spec"] > 0
    assert m.get("draft_proposed_total") > m.get("draft_accepted_total")


def test_fused_small_budget_never_engages(pipes):
    _, tp = pipes
    reqs = [("hi", 5), ("tell me more", 6)]
    base, _, _ = _serve(tp, reqs)
    ks = []
    fused, sched, _ = _serve(tp, reqs, spy=ks, fuse_steps=16)
    assert base == fused
    assert ks == [] and "fused" not in sched.metrics.by_label(
        "dispatches_total")
    assert sched.metrics.by_label("dispatches_total")["ragged"] > 0


def test_select_fuse_k_rungs(pipes):
    """`_select_fuse_k`: the large rung for a solo resident, the small one
    for a shared step, each clamped by every live row's remaining budget
    in windows; 1 with a queue, an admission or nothing live; the same
    choice as JAX's on the same state."""
    jp, tp = pipes
    kw = dict(autostart=False, fuse_steps="auto", **GEOM)
    engines = [JaxScheduler(jp, **kw), ContinuousScheduler(tp, **kw)]

    def req(max_new, emitted=0, replay=0):
        r = tsched._Request(request={}, max_new=max_new, sampling={},
                            handle=None, submit_time=0.0, stops=[])
        r.emitted, r.replay = [0] * emitted, replay
        return r

    cases = [
        ([req(90)], None, 16),
        ([req(90), req(90)], None, 4),
        ([req(90), req(9)], None, 1),  # 3 windows left: under the rung
        ([req(64)], None, 16),
        ([req(60)], None, 4),  # 15 windows left: under the large rung
        ([req(40, emitted=30, replay=8)], None, 4),  # 18 tokens: 5 windows
        ([req(90)], "admitting", 1),
        ([], None, 1),
    ]
    for slots, pf, want in cases:
        got = []
        for e in engines:
            e.slots = slots + [None] * (2 - len(slots))
            got.append(e._select_fuse_k(list(range(len(slots))), pf))
        assert got == [want, want], (slots, pf)
    for e in engines:
        e.slots = [req(90), None]
        e._queue.append(req(5))
        assert e._select_fuse_k([0], None) == 1
        e._queue.clear()
        e.close()


@pytest.mark.parametrize("kw,match", [
    (dict(fuse_steps=0, ragged=True), "fuse_steps"),
    (dict(fuse_steps=-2, ragged=True), "fuse_steps"),
    (dict(fuse_steps="bogus", ragged=True), "fuse_steps"),
    (dict(fuse_steps=2.5, ragged=True), "fuse_steps"),
    (dict(fuse_steps=True, ragged=True), "fuse_steps"),
    (dict(fuse_steps=4), "ragged"),
    (dict(fuse_steps=4, ragged=True, speculate=2), "NeuralDrafter"),
], ids=["zero", "negative", "string", "float", "bool", "split",
        "host_drafter"])
def test_fuse_steps_validation(pipes, kw, match):
    jp, tp = pipes
    for pipe, S in ((jp, JaxScheduler), (tp, ContinuousScheduler)):
        with pytest.raises(ValueError, match=match):
            S(pipe, autostart=False, prefill_chunk=8, **kw)


class _StandInGraph:
    """A CPU stand-in for `CountedGraph`: capture runs nothing more, each
    replay runs the captured step eagerly (the owning graph's `body`)."""

    def __init__(self):
        self.owner = None

    def capture(self, stream, generators=(), label="graph"):
        import contextlib

        return contextlib.nullcontext()

    def replay(self):
        self.owner.body()

    def release(self):
        pass


@pytest.mark.parametrize("kw,sampling", [
    (dict(), None),
    (dict(fuse_steps=4), {"temperature": 0.8, "top_p": 0.9, "seed": 12}),
    (dict(speculate=3), {"temperature": 0.8, "seed": 3}),
    (dict(speculate=3, fuse_steps="auto", kv_dtype="int8",
          drafter="neural"), None),
], ids=["k1", "fused4_sampled", "spec_ngram_sampled", "fused_spec_int8"])
def test_graph_route_host_logic_on_cpu(pipes, monkeypatch, kw, sampling):
    """The graph route's host side, rehearsed on the CPU with a stand-in
    graph whose replays run the captured step eagerly: the state copied
    in, the carry each replay leaves for the next, the per-replay output
    blocks of a megastep, the sampling generators copied in and back out
    and the harvest give the eager route's replies."""
    from oryx_tpu_torch.models import generate as gen_lib
    from oryx_tpu_torch.ops.cuda import graphs

    class Stream:
        def wait_stream(self, other):
            pass

    import contextlib
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "CountedGraph", _StandInGraph)
    init = gen_lib._EngineStepGraph.__init__

    def owned(self, *a, **k):
        init(self, *a, **k)
        self.graph.owner = self

    monkeypatch.setattr(gen_lib._EngineStepGraph, "__init__", owned)
    _, tp = pipes
    reqs = [("hi", 24), ("what is going on with all of this", 32),
            ("tell me more", 14), ("hello there", 40)]
    out = []
    for graph_route in (False, True):
        k = dict(kw)
        if k.get("drafter") == "neural":
            k["drafter"] = tgen.NeuralDrafter.init(V, 8, window=8)
        sched = ContinuousScheduler(tp, autostart=False, **dict(GEOM, **k))
        sched._graph_route = lambda: graph_route
        hs = [sched.submit({"question": q}, n, sampling) for q, n in reqs]
        sched.start()
        out.append(([h.result(timeout=600) for h in hs], dict(
            sched.engine_stats,
            dispatches_total=sched.metrics.by_label("dispatches_total"),
        )))
        sched.close()
        sched.check_pool_invariant()
    (eager, me), (graph, mg) = out
    assert graph == eager
    assert me["graph_captures_total"] == 0 < mg["graph_captures_total"]
    assert mg["dispatches_total"] == me["dispatches_total"]
    assert mg["megasteps_total"] == me["megasteps_total"]
    if kw.get("fuse_steps"):
        assert sum(mg["megasteps_total"].values()) > 0
