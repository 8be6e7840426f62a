"""Speculative decoding in the port (`speculate=`, `drafter=`) against the
JAX package, on the CPU.

The cases mirror tests/test_speculative.py:
  * drafters: `NgramDrafter` proposes what the JAX drafter proposes;
  * op level: `spec_lane_metadata` routes verify lanes as JAX does, and
    1 + k lanes write the pool bytes of 1 + k sequential writes;
  * verification: `spec_verify_rows` accepts the greedy longest prefix and
    truncates at EOS bit for bit as JAX does; a sampled row's emitted
    token follows the truncated target by distribution (total variation
    against the analytic law, the `_emitted_marginal` pattern), and draws
    a fixed count from its generator whatever it accepts;
  * engine level: the port's `ContinuousScheduler(speculate=k)` replies
    (and admit/finish chunks) equal the JAX speculative engine's and the
    port's non-speculative engine's on the same tiny fp32 weights (JAX
    matmuls at "highest"), for mixed lengths, a page-boundary prompt, a
    prefix-cache partial-page copy-on-write, eviction replay, rejected
    drafts across page boundaries (the pool invariant holds) and a stop
    string completing inside an accepted span; sampled speculative runs
    replay byte-exact, with or without an eviction.
Tolerances: tokens and routing byte-equal; a sampled marginal within total
variation 0.04 of its law over 4,000 draws.

Not mirrored here, each waiting for its module: the tp=2 mesh case (tp
meshes), the recompile watchdog (the runtime sanitizers) and the cost
ledger's steps-vs-tokens split (the cost ledger).
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
from oryx_tpu.ops import paged_kv as jpk  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models import generate as tgen  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.ops import paged_kv as tpk  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import ContinuousScheduler  # noqa: E402


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


# ---------------------------------------------------------------------------
# Drafters
# ---------------------------------------------------------------------------

_RANDOM_CTX = np.random.default_rng(0).integers(0, 5, size=200)


@pytest.mark.parametrize("kw,ctx,k,want", [
    (dict(max_ngram=3, min_ngram=1), [5, 8, 9, 7, 1, 2, 3, 8, 9, 7], 4,
     [1, 2, 3, 8]),
    (dict(max_ngram=3, min_ngram=1), [5, 8, 9, 7, 1, 2, 3, 8, 9, 7], 2,
     [1, 2]),
    (dict(max_ngram=2, min_ngram=1), [1, 2, 4, 0, 1, 2, 9, 3, 1, 2], 1, [9]),
    (dict(), [1, 2, 3, 4], 4, []),
    (dict(), [1], 4, []),
    (dict(), [1, 1, 1], 0, []),
    (dict(max_ngram=2, min_ngram=2, window=6),
     [1, 2, 9, 0, 0, 0, 0, 1, 2], 3, []),
    (dict(max_ngram=2, min_ngram=2, window=None),
     [1, 2, 9, 0, 0, 0, 0, 1, 2], 1, [9]),
    (dict(), _RANDOM_CTX, 8, None),
], ids=["lookup4", "lookup2", "most_recent", "no_match", "too_short", "k0",
        "window_hides", "unbounded", "random"])
def test_ngram_drafter_matches_jax(kw, ctx, k, want):
    """Prompt lookup, the most recent occurrence, no match, the window
    bound: the port proposes JAX's tokens, deterministically (a list and
    an array of the same context agree)."""
    got = tgen.NgramDrafter(**kw).propose(ctx, k)
    assert got == jgen.NgramDrafter(**kw).propose(ctx, k)
    assert got == tgen.NgramDrafter(**kw).propose(list(ctx), k)
    if want is not None:
        assert got == want


@pytest.mark.parametrize("kw", [dict(max_ngram=1, min_ngram=2),
                                dict(max_ngram=3, window=3)])
def test_ngram_drafter_validation(kw):
    with pytest.raises(ValueError) as want:
        jgen.NgramDrafter(**kw)
    with pytest.raises(ValueError) as got:
        tgen.NgramDrafter(**kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Op level
# ---------------------------------------------------------------------------


def test_spec_lane_metadata_routing():
    seg, pos = tpk.spec_lane_metadata(torch.tensor([5, 17, 0]), 2)
    jseg, jpos = jpk.spec_lane_metadata(jnp.asarray([5, 17, 0], jnp.int32), 2)
    assert seg.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2] == np.asarray(
        jseg).tolist()
    assert pos.tolist() == [5, 6, 7, 17, 18, 19, 0, 1, 2] == np.asarray(
        jpos).tolist()
    assert seg.dtype == pos.dtype == torch.int32


def test_spec_lanes_write_like_sequential_steps():
    """1 + k verify lanes of one slot land K/V where 1 + k sequential
    single-token writes would (one lane crossing a page boundary), and
    the pool bytes equal the JAX packed writer's."""
    rng = np.random.default_rng(0)
    Hk, D, ps, P = 2, 16, 8, 8
    alloc = tpk.PageAllocator(P, ps)
    bt = np.full((2, 3), alloc.sentinel, np.int32)
    bt[1, :2] = alloc.alloc(2)
    init = rng.standard_normal((P, ps, Hk, D)).astype(np.float32)
    new = rng.standard_normal((3, Hk, D)).astype(np.float32)
    start = 6  # lane 1 crosses the page boundary at 8
    seg, pos = tpk.spec_lane_metadata(torch.tensor([0, start]), 2)

    def pool():
        p = tpk.init_paged_pool(1, P, ps, Hk, D, dtype=torch.float32,
                                device="cpu")
        p[0] = torch.from_numpy(init)
        return p[0]

    packed = tpk.write_pages_packed(
        pool(), torch.from_numpy(new), torch.from_numpy(bt), seg[3:],
        pos[3:])
    seq = pool()
    for j in range(3):
        tpk.write_pages(seq, torch.from_numpy(new[j][None, None]),
                        torch.from_numpy(bt[1:2]),
                        torch.tensor([start + j]))
    assert torch.equal(packed, seq)
    jseg, jpos = jpk.spec_lane_metadata(jnp.asarray([0, start], jnp.int32), 2)
    want = jpk.write_pages_packed(
        jnp.asarray(init), jnp.asarray(new), jnp.asarray(bt), jseg[3:],
        jpos[3:])
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Verification math
# ---------------------------------------------------------------------------


def _lanes(targets, V=7):
    lg = np.full((1, len(targets), V), -5.0, np.float32)
    for j, t in enumerate(targets):
        lg[0, j, t] = 5.0
    return lg


def _verify_both(lg, tok, drafts, dlen, eos):
    S = lg.shape[0]
    kw = dict(eos=eos)
    jacc, jcand, _ = jgen.spec_verify_rows(
        jnp.asarray(lg), jnp.asarray(tok, jnp.int32),
        jnp.asarray(drafts, jnp.int32), jnp.asarray(dlen, jnp.int32),
        jax.random.split(jax.random.key(0), S),
        temperature=jnp.zeros((S,), jnp.float32),
        top_p=jnp.ones((S,), jnp.float32),
        top_k=jnp.zeros((S,), jnp.int32), **kw,
    )
    acc, cand = tgen.spec_verify_rows(
        torch.from_numpy(lg), torch.tensor(tok, dtype=torch.int32),
        torch.tensor(drafts, dtype=torch.int32),
        torch.tensor(dlen, dtype=torch.int32), [None] * S,
        temperature=torch.zeros(S), top_p=torch.ones(S),
        top_k=torch.zeros(S, dtype=torch.int32), **kw,
    )
    assert acc.tolist() == np.asarray(jacc).tolist()
    assert cand.tolist() == np.asarray(jcand).tolist()
    return int(acc[0]), int(cand[0])


@pytest.mark.parametrize("drafts,dlen,want", [
    ([2, 4, 1], 3, (3, 5)),  # every draft accepted; bonus at lane 3
    ([2, 9, 1], 3, (1, 4)),  # mismatch at lane 1
    ([2, 4, 1], 1, (1, 4)),  # draft_len masks lanes that would match
    ([0, 0, 0], 0, (0, 2)),  # no proposals: the plain decode step
], ids=["full", "mismatch", "draft_len", "none"])
def test_spec_verify_greedy_longest_prefix(drafts, dlen, want):
    assert _verify_both(_lanes([2, 4, 1, 5]), [9], [drafts], [dlen],
                        eos=0) == want


@pytest.mark.parametrize("tok,want", [(9, 2), (6, 0)], ids=["eos_draft",
                                                              "fed_eos"])
def test_spec_verify_eos_truncation(tok, want):
    """An accepted EOS ends the span (inclusive); a fed EOS accepts
    nothing."""
    acc, _ = _verify_both(_lanes([2, 6, 1, 5]), [tok], [[2, 6, 1]], [3],
                          eos=6)
    assert acc == want


def _emitted_marginal(lg_row, draft, n, temp, top_k=0, seed=0):
    """Empirical law of the token emitted at the draft's position (the
    draft if accepted, else the bonus) over n rows, each with its own
    generator."""
    V = lg_row.shape[-1]
    lg = torch.from_numpy(np.broadcast_to(lg_row, (n, 2, V)).copy())
    gens = [torch.Generator().manual_seed(seed * n + i) for i in range(n)]
    acc, cand = tgen.spec_verify_rows(
        lg, torch.zeros(n, dtype=torch.int32),
        torch.full((n, 1), draft, dtype=torch.int32),
        torch.ones(n, dtype=torch.int32), gens,
        temperature=torch.full((n,), temp), top_p=torch.ones(n),
        top_k=torch.full((n,), top_k, dtype=torch.int32), eos=-1,
    )
    emitted = torch.where(acc == 1, draft, cand).numpy()
    return np.bincount(emitted, minlength=V) / n


@pytest.mark.parametrize("temp,top_k,pick,seed", [
    (1.0, 0, np.argmax, 0), (1.0, 0, np.argmin, 1), (0.7, 5, np.argmax, 2),
], ids=["likely_draft", "unlikely_draft", "truncated_target"])
def test_spec_verify_rejection_sampling_distribution(temp, top_k, pick, seed):
    """With a point-mass proposal, accept-with-p'(d) and the residual draw
    leave the emitted token distributed as the truncated target p' (the
    JAX package's law: its truncation on the same logits)."""
    rng = np.random.default_rng(3)
    V, n = 8, 4000
    logits = rng.standard_normal((1, 2, V)).astype(np.float32) * 1.5
    draft = int(pick(logits[0, 0]))
    l_t, _ = jgen.truncate_logits_rows(
        jnp.asarray(logits[:, 0]),
        temperature=jnp.full((1,), temp, jnp.float32),
        top_p=jnp.ones((1,), jnp.float32),
        top_k=jnp.full((1,), top_k, jnp.int32),
    )
    target = np.asarray(jax.nn.softmax(l_t, axis=-1))[0]
    emp = _emitted_marginal(logits[0], draft, n, temp, top_k=top_k,
                            seed=seed)
    tv = 0.5 * np.abs(emp - target).sum()
    assert tv < 0.04, (temp, top_k, draft, tv, emp, target)


def test_spec_verify_draws_a_fixed_count():
    """A sampling row draws k uniforms and one V-wide row a step whatever
    it accepts (so an eager step, the fused loop and a graph replay draw
    the same numbers); a greedy row draws nothing."""
    V, k = 11, 3
    lg = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, k + 1, V)).astype(
            np.float32))
    states = []
    for drafts in ([[0, 0, 0]] * 2, [lg[0].argmax(-1)[:k].tolist()] * 2):
        gens = [torch.Generator().manual_seed(7), None]
        tgen.spec_verify_rows(
            lg, torch.tensor([1, 1]), torch.tensor(drafts),
            torch.tensor([k, k]), gens,
            temperature=torch.tensor([0.8, 0.0]), top_p=torch.ones(2),
            top_k=torch.zeros(2, dtype=torch.int32), eos=-1)
        states.append(gens[0].get_state())
    ref = torch.Generator().manual_seed(7)
    torch.rand(k, generator=ref)
    torch.rand(V, generator=ref)
    assert torch.equal(states[0], states[1])
    assert torch.equal(states[0], ref.get_state())


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
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)


GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
            prefill_chunk=8, ragged=True)


def _serve(pipe, reqs, sampling=None, **kw):
    """One engine (the port's, or JAX's for an OryxInference pipe) over
    [(question, cap)]: every request submitted before the start. Returns
    (results, scheduler, handles); the pool invariant held."""
    jax_side = isinstance(pipe, OryxInference)
    geom = dict(GEOM, **kw)
    if jax_side:
        with jax.default_matmul_precision("highest"):
            sched = JaxScheduler(pipe, autostart=False, **geom)
            handles = [sched.submit({"question": q}, cap, sampling)
                       for q, cap in reqs]
            sched.start()
            results = [h.result(timeout=600) for h in handles]
        sched._check_pool_invariant()
    else:
        sched = ContinuousScheduler(pipe, autostart=False, **geom)
        handles = [sched.submit({"question": q}, cap, sampling)
                   for q, cap in reqs]
        sched.start()
        results = [h.result(timeout=600) for h in handles]
        sched.check_pool_invariant()
    sched.close()
    return results, sched, handles


def _chunks(handles):
    return [(h.debug.get("admit_chunk"), h.debug.get("finish_chunk"))
            for h in handles]


def _ids(pipe, q):
    return len(pipe._prepare_request({"question": q})[0])


def _spec_cases(tp):
    """(requests, engine kwargs) of the parity cases."""
    ps, k = 16, 3
    q = "hello"
    q = q + " " + "a" * ((-_ids(tp, q) - 1) % ps)  # ids a page multiple
    assert _ids(tp, q) % ps == 0
    q1, q2 = "hello there", "tell me more"
    admit1 = math.ceil((_ids(tp, q1) + 1 + k) / ps)
    admit2 = math.ceil((_ids(tp, q2) + 1 + k) / ps)
    cap = (admit1 * ps - _ids(tp, q1)) + ps  # one more page a row
    return {
        "mixed_lengths": ([("hi", 5), ("what is going on with all of this, "
                                       "tell me now please", 8),
                           ("tell me more", 6)], dict(speculate=3)),
        "page_boundary_prompt": ([(q, 6)], dict(speculate=4)),
        "prefix_cache_cow": ([("hello there", 5), ("hello there friend", 5),
                              ("hello there again, why?", 4)],
                             dict(speculate=3, prefix_cache=True)),
        "eviction_replay": ([(q1, cap), (q2, cap)],
                            dict(speculate=k, num_pages=admit1 + admit2 + 1,
                                 prefix_cache=False)),
    }


@pytest.mark.parametrize("case", ["mixed_lengths", "page_boundary_prompt",
                                  "prefix_cache_cow", "eviction_replay"])
def test_spec_engine_matches_jax_and_the_plain_engine(pipes, case):
    """The port's speculative engine gives the JAX speculative engine's
    replies, usage and admit/finish chunks, and the port's plain ragged
    engine's replies; only spec dispatches run, and drafts were
    proposed."""
    jp, tp = pipes
    reqs, kw = _spec_cases(tp)[case]
    want, _, jh = _serve(jp, reqs, **kw)
    got, sched, th = _serve(tp, reqs, **kw)
    assert got == want
    assert _chunks(th) == _chunks(jh)
    plain, _, _ = _serve(tp, reqs, **dict(kw, speculate=0))
    assert [r[0] for r in got] == [r[0] for r in plain]
    m = sched.metrics
    assert set(m.by_label("dispatches_total")) == {"spec"}
    assert m.histogram_totals("accepted_tokens_per_step")[0] > 0
    if case == "eviction_replay":
        assert m.get("evicted") >= 1
    if case == "prefix_cache_cow":
        assert m.get("prefix_cache_hit_tokens_total") > 0


class FixedDrafter(tgen.Drafter):
    """Always proposes the same token: on a greedy stream (almost) every
    draft is rejected, the rollback worst case."""

    def __init__(self, token: int, k: int):
        self.token, self.k = token, k

    def propose(self, context, k):
        return [self.token] * min(k, self.k)


class OracleDrafter(tgen.Drafter):
    """Proposes a recorded reply stream, keyed by how many reply tokens
    the context already holds."""

    def __init__(self, prompt_len: int, stream: list[int]):
        self.prompt_len, self.stream = prompt_len, stream

    def propose(self, context, k):
        done = len(context) - self.prompt_len  # confirmed + fed token
        return self.stream[done: done + k]


class TapDrafter(tgen.Drafter):
    """Proposes nothing and records the longest context it was shown."""

    def __init__(self):
        self.longest: list[int] = []

    def propose(self, context, k):
        ctx = [int(x) for x in context]
        if len(ctx) > len(self.longest):
            self.longest = ctx
        return []


def test_spec_rejected_drafts_at_page_boundary_leak_nothing(pipes):
    """All-reject drafts whose windows straddle page boundaries: replies
    equal JAX's with the same drafter and the port's plain engine, the
    pool invariant holds and every page is back after the finish."""
    jp, tp = pipes
    q, ps = "hello there friend", 8
    kw = dict(page_size=ps, speculate=5, prefix_cache=False)
    reqs = [(q, 3 * ps)]
    want, _, _ = _serve(jp, reqs, drafter=FixedDrafter(7, 5), **kw)
    got, sched, _ = _serve(tp, reqs, drafter=FixedDrafter(7, 5), **kw)
    assert got == want
    held = sum(1 for p in range(sched.allocator.num_pages)
               if sched.allocator.refcount(p) > 0)
    assert held == 0
    plain, _, _ = _serve(tp, reqs, **dict(kw, speculate=0))
    assert got == plain
    m = sched.metrics
    assert m.get("draft_proposed_total") > m.get("draft_accepted_total")
    assert m.get("decode_steps_wasted") > 0


def test_spec_stop_string_across_accept_boundary(pipes):
    """A stop string completing inside an accepted span (an oracle
    drafter, k = 4) truncates at the match and bills through it: the
    port equals the JAX engine with the same drafter and its own plain
    engine."""
    jp, tp = pipes
    q, cap = "tell me a long story please", 24
    ref, _, _ = _serve(tp, [(q, cap)])
    reply = ref[0][0]
    assert len(reply) >= 6, reply
    tap = TapDrafter()
    _serve(tp, [(q, cap)], speculate=1, drafter=tap)
    ids = _ids(tp, q)
    stream = tap.longest[ids:]
    assert len(stream) >= 6
    sampling = {"stop": [reply[2:5]]}
    plain, _, _ = _serve(tp, [(q, cap)], sampling)
    want, _, _ = _serve(jp, [(q, cap)], sampling, speculate=4,
                        drafter=OracleDrafter(ids, stream))
    got, sched, _ = _serve(tp, [(q, cap)], sampling, speculate=4,
                           drafter=OracleDrafter(ids, stream))
    assert got == want == plain
    text, reason, usage = got[0]
    assert reason == "stop" and reply[2:5] not in text
    assert usage[1] <= len(reply)
    assert sched.metrics.get("draft_accepted_total") > 0


def test_spec_sampled_self_replay(pipes):
    """Sampling under speculation: the same seed gives the same bytes run
    to run, and a run with an eviction replay gives the replies of a run
    without one (the drafter proposes from the device-confirmed
    stream)."""
    _, tp = pipes
    q1, q2 = "hello there", "tell me more"
    ps, k = 16, 3
    sampling = {"temperature": 0.8, "top_p": 0.9, "seed": 12}
    admit1 = math.ceil((_ids(tp, q1) + 1 + k) / ps)
    admit2 = math.ceil((_ids(tp, q2) + 1 + k) / ps)
    cap = (admit1 * ps - _ids(tp, q1)) + ps
    kw = dict(speculate=k, page_size=ps, prefix_cache=False)
    reqs = [(q1, cap), (q2, cap)]
    tight, ts, _ = _serve(tp, reqs, sampling,
                          num_pages=admit1 + admit2 + 1, **kw)
    assert ts.metrics.get("evicted") >= 1
    roomy, rs, _ = _serve(tp, reqs, sampling, **kw)
    assert rs.metrics.get("evicted") == 0
    again, _, _ = _serve(tp, reqs, sampling, **kw)
    assert tight == roomy == again


@pytest.mark.parametrize("kw,match", [
    (dict(speculate=2), "ragged"),
    (dict(speculate=-1, ragged=True), "non-negative"),
    (dict(speculate=1.5, ragged=True), "non-negative"),
], ids=["split", "negative", "float"])
def test_speculate_validation(pipes, kw, match):
    _, tp = pipes
    with pytest.raises(ValueError, match=match):
        ContinuousScheduler(tp, autostart=False, prefill_chunk=8, **kw)
