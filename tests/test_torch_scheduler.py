"""The port's `ContinuousScheduler` against the JAX package's, on the CPU.

Both engines serve the same request lists on the same tiny weights (the
JAX init made input-sensitive, converted with `from_jax_params`; fp32, JAX
matmuls at "highest" precision), with the prefix cache named on both sides:
off in the cases below, on in `test_engines_equal_with_prefix_cache` (and
in tests/test_torch_prefix_cache.py). Replies, finish reasons and usage
must be equal. The cases mirror
tests/test_scheduler.py (a short row frees its slot, FIFO admission, mixed
sampling, eviction replay, a too-large request) and add image requests and
the ragged engine. Seeded sampling draws other numbers in the two
frameworks, so a sampled reply is held against the port's own replay.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from oryx_tpu import config as jcfg  # noqa: E402
from oryx_tpu.data import native_loader  # noqa: E402
from oryx_tpu.models import oryx as joryx  # noqa: E402
from oryx_tpu.serve.pipeline import OryxInference  # noqa: E402
from oryx_tpu.serve.scheduler import ContinuousScheduler as JaxScheduler  # noqa: E402
from oryx_tpu_torch import config as tcfg  # noqa: E402
from oryx_tpu_torch.models.convert import from_jax_params  # noqa: E402
from oryx_tpu_torch.serve.pipeline import Pipeline  # noqa: E402
from oryx_tpu_torch.serve.scheduler import (  # noqa: E402
    AdmissionRejected,
    ContinuousScheduler,
)


class CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [min(ord(c), 500) for c in text]

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if 0 < i < 500)


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
    tp = Pipeline(
        CharTokenizer(),
        from_jax_params(tree, tcfg.OryxConfig.from_dict(cfg.to_dict())),
        tcfg.OryxConfig.from_dict(cfg.to_dict()), device="cpu",
    )
    return jp, tp


@pytest.fixture(autouse=True)
def _no_native_loader(monkeypatch):
    monkeypatch.setattr(native_loader, "is_available", lambda: False)
    monkeypatch.setattr(
        "oryx_tpu_torch.data.native_loader.is_available", lambda: False)


def _serve(sched, reqs):
    """Submit everything before starting (deterministic admission order),
    then collect every result: (reply, reason, usage) or the error."""
    handles = [sched.submit(r, cap, s) for r, cap, s in reqs]
    sched.start()
    out = []
    for h in handles:
        try:
            out.append(h.result(timeout=600))
        except RuntimeError as e:
            out.append(("error", str(e).split(":")[0], None))
    sched.close()
    return handles, out


def _chunks(handles):
    return [
        (h.debug.get("admit_chunk"), h.debug.get("finish_chunk"))
        for h in handles
    ]


def _both(pipes, reqs, prefix_cache=False, **kw):
    """(port scheduler, port handles, port results, JAX results) on one
    request list, both engines with the prefix cache on or off. The two
    engines also admit and finish every request at the same chunk."""
    jp, tp = pipes
    with jax.default_matmul_precision("highest"):
        jhandles, want = _serve(
            JaxScheduler(jp, autostart=False, prefix_cache=prefix_cache,
                         **kw),
            reqs,
        )
    sched = ContinuousScheduler(tp, autostart=False,
                                prefix_cache=prefix_cache, **kw)
    handles, got = _serve(sched, reqs)
    sched.check_pool_invariant()
    assert _chunks(handles) == _chunks(jhandles)
    return sched, handles, got, want


def _q(text, cap, sampling=None):
    return ({"question": text}, cap, sampling)


def _images():
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    return [
        ({"question": "what is this?", "images": [img(40, 56)]}, 6, None),
        _q("hello there", 9),
        ({"question": "compare them", "images": [img(60, 30), img(28, 28)]},
         5, None),
        ({"question": "what happens?", "images": [img(42, 42)] * 4,
          "is_video": True}, 7, None),
    ]


GEOM = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_short_row_frees_slot_and_admits_within_chunk(pipes, ragged):
    kw = dict(GEOM, ragged=ragged, prefill_chunk=16 if ragged else None)
    reqs = [_q("hello there", 3), _q("what now?", 12), _q("tell me more", 5)]
    sched, handles, got, want = _both(pipes, reqs, **kw)
    assert got == want
    assert [u[1] for _, _, u in got] == [3, 12, 5]
    assert len({r for r, _, _ in got}) == 3  # the rows really differ
    if not ragged:
        # Request 3 waited for a slot and entered at the chunk boundary
        # where request 1 finished. (The ragged engine prefills one prompt
        # at a time, so there it waits for request 2's prefill as well.)
        admit_3 = handles[2].debug["admit_chunk"]
        assert admit_3 <= handles[0].debug["finish_chunk"]
    m = sched.metrics
    assert m.get("admitted") == m.get("completed") == 3
    assert m.get("decode_steps_wasted") < m.get("decode_steps_total")
    kinds = set(m.by_label("dispatches_total"))
    assert kinds == ({"ragged"} if ragged else {"prefill", "decode"})


def test_no_starvation_fifo(pipes):
    reqs = [_q(f"question number {i}", 4 + (i % 3)) for i in range(6)]
    _, handles, got, want = _both(pipes, reqs, **GEOM)
    assert got == want
    admit = [h.debug["admit_chunk"] for h in handles]
    assert admit == sorted(admit)


def test_mixed_sampling_greedy_equal_and_seeded_replay(pipes):
    """Greedy rows equal the JAX engine's while a sampled row decodes
    beside them; the seeded row is the same in a second port run."""
    _, tp = pipes
    sampled = {"temperature": 0.9, "top_p": 0.9, "seed": 3}
    reqs = [_q("hello there", 5), _q("what now?", 5, sampled),
            _q("tell me more", 5)]
    _, _, got, want = _both(pipes, reqs, **GEOM)
    assert [got[0], got[2]] == [want[0], want[2]]
    sched = ContinuousScheduler(tp, autostart=False, **GEOM)
    _, again = _serve(sched, reqs)
    assert again == got
    assert got[1][2] == (want[1][2][0], 5)


def test_sampled_replay_independent_of_neighbours(pipes):
    """A seeded row's reply does not depend on which rows decode beside it
    (per-request generators)."""
    _, tp = pipes
    sampled = {"temperature": 1.0, "seed": 7, "top_k": 50}
    alone = _serve(
        ContinuousScheduler(tp, autostart=False, **GEOM),
        [_q("what now?", 6, sampled)],
    )[1][0]
    crowd = _serve(
        ContinuousScheduler(tp, autostart=False, **GEOM),
        [_q("hi", 9), _q("what now?", 6, sampled), _q("more", 2)],
    )[1][1]
    assert alone == crowd


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_eviction_requeues_and_replays(pipes, ragged):
    """A pool too small for both rows' growth evicts the younger slot,
    which replays deterministically after the older finishes."""
    jp, _ = pipes
    q1, q2 = "hello there", "tell me more"
    chunk, ps = 4, 16
    ids1 = len(jp._prepare_request({"question": q1})[0])
    ids2 = len(jp._prepare_request({"question": q2})[0])
    admit1 = math.ceil((ids1 + chunk) / ps)
    admit2 = math.ceil((ids2 + chunk) / ps)
    cap = (admit1 * ps - ids1) + ps  # forces one extra page per row
    kw = dict(GEOM, num_pages=admit1 + admit2 + 1, ragged=ragged,
              prefill_chunk=16 if ragged else None)
    sampled = {"temperature": 0.8, "seed": 5}
    reqs = [_q(q1, cap), _q(q2, cap, sampled)]
    sched, _, got, want = _both(pipes, reqs, **kw)
    assert sched.metrics.get("evicted") >= 1
    assert got[0] == want[0]
    assert got[1][2] == want[1][2] == (ids2, cap)
    # The evicted sampled row replays its own stream: a run with room for
    # both rows (no eviction) gives the same reply.
    roomy = ContinuousScheduler(
        pipes[1], autostart=False, **dict(kw, num_pages=None)
    )
    _, calm = _serve(roomy, reqs)
    assert roomy.metrics.get("evicted") == 0
    assert calm == got


def test_request_filling_max_ctx_leaves_neighbours_intact(pipes, monkeypatch):
    """A request whose prompt + max_tokens fills max_ctx exactly runs its
    last chunk past the block table; those writes are dropped, so the
    neighbour admitted first (holding page 0) replies as it does alone.
    (The JAX per-row writer lands them in page 0.)"""
    from oryx_tpu_torch.ops import paged_kv

    _, tp = pipes
    long_q = "please describe the following scene in great detail"
    n_long = len(tp._prepare_request({"question": long_q})[0])
    n_short = len(tp._prepare_request({"question": "hi"})[0])
    ps, chunk = 16, 4
    max_ctx = -(-(n_long + 6) // ps) * ps
    first = _q("hi", max_ctx - n_short - chunk)
    filler = _q(long_q, max_ctx - n_long)
    past = []
    index = paged_kv.write_index

    def spy(P, page_size, bt, start, T, *, write_mask=None):
        live = start.long() + T > bt.shape[1] * page_size
        if write_mask is not None:
            live = live & write_mask
        past.append(bool(live.any()))
        return index(P, page_size, bt, start, T, write_mask=write_mask)

    monkeypatch.setattr(paged_kv, "write_index", spy)
    kw = dict(num_slots=2, page_size=ps, chunk=chunk, max_ctx=max_ctx)
    together = _serve(
        ContinuousScheduler(tp, autostart=False, **kw), [first, filler]
    )[1]
    assert any(past)  # the filler's last chunk did write past its table
    alone = _serve(ContinuousScheduler(tp, autostart=False, **kw), [first])[1]
    assert together[0] == alone[0]
    assert together[1][2] == (n_long, max_ctx - n_long)


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
@pytest.mark.parametrize("case", ["short", "fifo", "images"])
def test_engines_equal_with_prefix_cache(pipes, case, ragged):
    """The cases above with the prefix cache on in both engines: every text
    prompt shares the template's system prompt, so later admissions splice
    its pages; replies, usage, admit/finish chunks and the cached tokens
    of each request are equal."""
    reqs = {
        "short": [_q("hello there", 3), _q("what now?", 12),
                  _q("tell me more", 5)],
        "fifo": [_q(f"question number {i}", 4 + (i % 3)) for i in range(6)],
        "images": _images() + [_q("hello there again", 4)],
    }[case]
    kw = dict(GEOM, ragged=ragged, prefill_chunk=32 if ragged else None)
    jp, _ = pipes
    with jax.default_matmul_precision("highest"):
        jsched = JaxScheduler(jp, autostart=False, **kw)
        jhandles, want = _serve(jsched, reqs)
    sched = ContinuousScheduler(pipes[1], autostart=False, **kw)
    handles, got = _serve(sched, reqs)
    sched.check_pool_invariant()
    assert got == want
    assert _chunks(handles) == _chunks(jhandles)
    cached = [h.debug["cached_tokens"] for h in handles]
    assert cached == [h.debug["cost"]["cached_tokens"] for h in jhandles]
    assert sum(cached) > 0
    assert sched.metrics.get("prefix_cache_hit_tokens_total") == sum(cached)


def test_request_too_large_errors_cleanly(pipes):
    reqs = [_q("hi", 2048), _q("hello there", 4)]
    _, _, got, want = _both(pipes, reqs, **GEOM)
    assert got == want
    assert got[0][:2] == ("error", "ValueError")
    assert got[1][2][1] == 4


@pytest.mark.parametrize("ragged", [False, True], ids=["split", "ragged"])
def test_image_requests_equal(pipes, ragged):
    """Image, multi-image and video prompts beside a text one, 2 slots."""
    kw = dict(GEOM, ragged=ragged, prefill_chunk=32 if ragged else None)
    _, _, got, want = _both(pipes, _images(), **kw)
    assert got == want
    assert len({r for r, _, _ in got}) == 4


def test_chunked_prefill_split_equal(pipes):
    """The split engine with bounded prefill chunks (several per prompt)."""
    kw = dict(GEOM, prefill_chunk=16)
    _, _, got, want = _both(pipes, _images()[:3], **kw)
    assert got == want


def test_pallas_impl_routes_to_the_paged_kernels_plain_twins(pipes):
    """attn_impl="pallas": on CPU tensors the paged kernels' wrappers run
    their plain twins, so replies equal the "xla" engine's."""
    _, tp = pipes
    reqs = [_q("hello there", 6), _q("what now?", 7), _q("tell me", 3)]
    replies = []
    for impl in ("xla", "pallas"):
        cfg = dataclasses.replace(tp.cfg, attn_impl=impl)
        pipe = Pipeline(tp.tokenizer, tp.params, cfg, device="cpu")
        for ragged in (False, True):
            sched = ContinuousScheduler(
                pipe, autostart=False, ragged=ragged,
                **dict(GEOM, prefill_chunk=16 if ragged else None),
            )
            replies.append(_serve(sched, reqs)[1])
    assert all(r == replies[0] for r in replies)


def test_streaming_cancel_and_backpressure(pipes):
    """Streaming deltas assemble the reply; a cancelled request frees its
    slot; a full queue rejects without queueing."""
    _, tp = pipes
    sched = ContinuousScheduler(tp, autostart=False, max_queue=2, **GEOM)
    h = sched.submit({"question": "hello there"}, 6, streaming=True)
    gone = sched.submit({"question": "never mind"}, 6)
    with pytest.raises(AdmissionRejected) as e:
        sched.submit({"question": "one too many"}, 6)
    assert e.value.reason == "backpressure"
    sched.cancel(gone)
    sched.start()
    reply, reason, usage = h.result(timeout=600)
    sched.close()
    deltas = []
    while not h.events.empty():
        deltas.append(h.events.get())
    assert deltas[-1] == ("end", reason, usage)
    assert "".join(d[1] for d in deltas[:-1]) == reply
    assert sched.metrics.get("cancelled") == 1
    assert sched.queue_len() == 0 and not sched.alive()
    sched.check_pool_invariant()
    with pytest.raises(AdmissionRejected):
        sched.submit({"question": "late"}, 2)


def test_rejects_bad_geometry(pipes):
    _, tp = pipes
    with pytest.raises(ValueError, match="multiple"):
        ContinuousScheduler(tp, autostart=False, page_size=16, max_ctx=100)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousScheduler(tp, autostart=False, ragged=True)
    with pytest.raises(ValueError, match="chunk"):
        ContinuousScheduler(tp, autostart=False, chunk=0)
