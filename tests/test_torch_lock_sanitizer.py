"""The port's lock-order sanitizer and race detector
(oryx_tpu_torch/analysis/sanitizers.py) against the JAX package's: the
27 cases of tests/test_lock_sanitizer.py with the JAX tests' verdicts
(seeded ordering violations and seeded guarded-field races fire;
handoff and thread death do not; disarm restores the classes; the
oryx_lock_{wait,hold}_seconds histograms render), then the port's
manifest against the JAX tuple, its annotation reader against JAX's
analysis.core on the race-surface classes, the same verdicts on a battery
of scenarios run through both sanitizers, and a port server armed by
ORYX_LOCK_SANITIZER=1 serving tests/test_torch_api_server.py's mix with
zero violations, the unarmed replies and the armed JAX server's lock
families.

Lock pairs for deliberately inverted acquisitions are built through
`san.make(...)` rather than the `named_lock(...)` literal, so the static
lock-order rule never mistakes these seeded runtime scenarios for
production nesting.
"""

import re
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")

from oryx_tpu_torch.analysis import sanitizers as S  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# Manifest coherence
# ---------------------------------------------------------------------------


def test_manifest_comment_matches_lock_order_tuple():
    """The `# lock-order:` comment (what the static rule enforces) and
    the LOCK_ORDER tuple (what the runtime enforces) must be the same
    declaration — drift would split the two enforcement halves."""
    from oryx_tpu.concurrency import LOCK_ORDER as JAX_ORDER
    from oryx_tpu_torch.concurrency import LOCK_ORDER

    src = (ROOT / "oryx_tpu_torch" / "concurrency.py").read_text()
    m = re.search(r"^# lock-order: (.+)$", src, re.M)
    assert m, "concurrency.py lost its # lock-order: manifest comment"
    chain = tuple(p.strip() for p in m.group(1).split("<"))
    assert chain == LOCK_ORDER == JAX_ORDER
    assert S.LockOrderSanitizer().order == LOCK_ORDER


def test_named_lock_disarmed_returns_plain_primitives():
    assert not S.lock_sanitizer_armed()
    assert isinstance(S.named_lock("x"), type(threading.Lock()))
    assert isinstance(
        S.named_lock("x", kind="condition"), threading.Condition
    )
    # RLock's concrete type varies; the contract is "not instrumented".
    assert not isinstance(
        S.named_lock("x", kind="rlock"), S._InstrumentedLock
    )


def test_named_lock_armed_returns_instrumented():
    with S.lock_sanitizer(race_modules=[]):
        lk = S.named_lock("scheduler._cond", kind="condition")
        assert isinstance(lk, S._InstrumentedLock)
        with lk:
            assert lk.held_by_current()
        assert not lk.held_by_current()


# ---------------------------------------------------------------------------
# Ordering violations (the seeded-deadlock fixtures)
# ---------------------------------------------------------------------------


def test_declared_order_inversion_raises_at_acquire():
    with S.lock_sanitizer(order=("a", "b"), race_modules=[]) as san:
        a, b = san.make("a"), san.make("b")
        with a:
            with b:
                pass  # declared order: fine
        with pytest.raises(S.LockOrderViolation, match="inverts"):
            with b:
                with a:
                    pass
        assert len(san.stats.violations) == 1


def test_unranked_cycle_detected_dynamically():
    with S.lock_sanitizer(order=(), race_modules=[]) as san:
        x, y = san.make("x"), san.make("y")
        with x:
            with y:
                pass
        with pytest.raises(S.LockOrderViolation, match="cycle"):
            with y:
                with x:
                    pass
        assert any("cycle" in v for v in san.stats.violations)


def test_record_mode_collects_without_raising():
    with S.lock_sanitizer(
        order=("a", "b"), action="record", race_modules=[]
    ) as san:
        a, b = san.make("a"), san.make("b")
        with b:
            with a:
                pass  # inverted, but recorded only
        assert len(san.stats.violations) == 1


def test_same_name_different_instance_nesting_flagged():
    with S.lock_sanitizer(race_modules=[]) as san:
        t1, t2 = san.make("trace._lock"), san.make("trace._lock")
        with pytest.raises(S.LockOrderViolation, match="same name"):
            with t1:
                with t2:
                    pass
        assert san.stats.violations


def test_plain_lock_reentry_is_self_deadlock():
    with S.lock_sanitizer(race_modules=[]):
        lk = S.named_lock("solo")
        with pytest.raises(S.LockOrderViolation, match="re-entrant"):
            with lk:
                with lk:
                    pass


def test_condition_reentrancy_counted_not_flagged():
    with S.lock_sanitizer(race_modules=[]) as san:
        c = san.make("scheduler._cond", "condition")
        with c:
            with c:
                pass
        assert san.stats.reentrant == {"scheduler._cond": 1}
        assert not san.stats.violations


def test_condition_wait_keeps_held_stack_honest():
    with S.lock_sanitizer(race_modules=[]) as san:
        c = san.make("scheduler._cond", "condition")
        seen: list[list[str]] = []

        def waiter():
            with c:
                c.wait(timeout=0.05)
                seen.append(san.held_names())

        t = threading.Thread(target=waiter)
        t.start()
        t.join(10)
        assert seen == [["scheduler._cond"]]  # re-held after wait
        assert san.held_names() == []  # this thread never held it


def test_cross_thread_isolation():
    """Held stacks are per-thread: thread B acquiring in 'reverse'
    order relative to thread A's CONCURRENT holdings is not a
    violation (only same-thread nesting orders)."""
    with S.lock_sanitizer(order=("a", "b"), race_modules=[]) as san:
        a, b = san.make("a"), san.make("b")
        with a:
            done = threading.Event()
            err: list[BaseException] = []

            def other():
                try:
                    with b:
                        pass
                except BaseException as e:  # pragma: no cover
                    err.append(e)
                finally:
                    done.set()

            threading.Thread(target=other).start()
            assert done.wait(10)
            assert not err
        assert not san.stats.violations


def test_hot_dispatch_flags_held_locks_only():
    with S.lock_sanitizer(race_modules=[]) as san:
        S.hot_dispatch("decode")  # nothing held: quiet
        lk = san.make("scheduler._cond", "condition")
        with pytest.raises(S.LockOrderViolation, match="hot-path"):
            with lk:
                S.hot_dispatch("decode")
        assert any("hot-path" in v for v in san.stats.violations)
    S.hot_dispatch("decode")  # disarmed: free no-op


def test_lock_histograms_render_through_registry():
    from oryx_tpu_torch.utils.metrics import Registry

    with S.lock_sanitizer(race_modules=[]) as san:
        reg = Registry("oryx_serving")
        assert S.bind_lock_metrics(reg)
        lk = san.make("scheduler._cond", "condition")
        with lk:
            pass
        text = reg.render()
        for fam in ("oryx_lock_wait_seconds", "oryx_lock_hold_seconds"):
            assert (
                f'{fam}_bucket{{lock="scheduler._cond",le=' in text
            ), text
            assert f'{fam}_count{{lock="scheduler._cond"}} 1' in text
    assert not S.bind_lock_metrics(Registry())  # disarmed: no-op


def test_record_mode_inverted_edge_not_recorded_as_legal_cycle():
    """Regression: in record mode an order-inverting acquire used to
    insert its inverted edge into the observed graph, so every LATER
    legal nesting of the same pair reported a spurious 'cycle' at the
    correct call site."""
    with S.lock_sanitizer(
        order=("a", "b"), action="record", race_modules=[]
    ) as san:
        a, b = san.make("a"), san.make("b")
        with b:
            with a:
                pass  # the inversion: one violation, edge NOT kept
        with a:
            with b:
                pass  # legal nesting must stay silent
        assert len(san.stats.violations) == 1, san.stats.violations
        assert "inverts" in san.stats.violations[0]


def test_same_name_nesting_records_exactly_one_violation():
    """Regression: record mode used to append a second, nonsensical
    'cycle' entry (self-reachability is trivially true) and seed an
    x->x self-edge on top of the same-name violation."""
    with S.lock_sanitizer(action="record", race_modules=[]) as san:
        t1, t2 = san.make("trace._lock"), san.make("trace._lock")
        with t1:
            with t2:
                pass
        assert len(san.stats.violations) == 1
        assert "same name" in san.stats.violations[0]
        assert "trace._lock" not in san._edges.get("trace._lock", ())


def test_wait_for_predicate_sees_lock_held(toy):
    """Regression: Condition.wait_for evaluates its predicate with the
    lock genuinely HELD, but the wrapper used to pop the held stack
    around the whole call — a guarded-field read inside the predicate
    (the classic engine-loop `wait_for(lambda: self._queue or ...)`)
    raised a false RaceViolation."""
    import importlib.util

    p = toy.__file__.replace("race_toy", "race_cond")
    with open(p, "w") as f:
        f.write(
            "from oryx_tpu_torch.analysis.sanitizers import named_lock\n"
            "class Box:\n"
            "    def __init__(self):\n"
            "        self._cond = named_lock('scheduler._cond',"
            " kind='condition')\n"
            "        self.queue = []  # guarded-by: _cond\n"
        )
    spec = importlib.util.spec_from_file_location("race_cond", p)
    mod = importlib.util.module_from_spec(spec)
    with S.lock_sanitizer(race_modules=[]):
        spec.loader.exec_module(mod)
        det = S._RACE
        det.install_module(mod)
        box = mod.Box()
        err: list[BaseException] = []
        started = threading.Event()

        def consumer():
            try:
                with box._cond:
                    started.set()
                    box._cond.wait_for(lambda: bool(box.queue), 5)
            except BaseException as e:  # pragma: no cover
                err.append(e)

        t = threading.Thread(target=consumer)
        t.start()
        assert started.wait(10)
        with box._cond:
            box.queue.append(1)
            box._cond.notify()
        t.join(10)
        assert not err, err
        assert not S.race_violations()


def test_rebinding_registry_moves_the_sample_stream():
    """Regression: re-binding (chaos boots one server per scenario)
    left the OLD registry's collector live, draining the shared buffer
    into whichever registry scraped first. The newest binding owns the
    stream; a superseded registry's scrape no-ops."""
    from oryx_tpu_torch.utils.metrics import Registry

    with S.lock_sanitizer(race_modules=[]) as san:
        old, new = Registry(), Registry()
        san.bind_registry(old)
        san.bind_registry(new)
        lk = san.make("scheduler._cond", "condition")
        with lk:
            pass
        old_text = old.render()  # stale collector must NOT drain
        assert 'oryx_lock_hold_seconds_count{lock="scheduler._cond"}' \
            not in old_text
        new_text = new.render()
        assert 'oryx_lock_hold_seconds_count{lock="scheduler._cond"} 1' \
            in new_text


def test_dropped_samples_surface_as_counter():
    """Regression: samples past the buffer cap were dropped with no
    indication anywhere; the drop count is now a raw-named counter."""
    from oryx_tpu_torch.utils.metrics import Registry

    with S.lock_sanitizer(race_modules=[]) as san:
        san._SAMPLE_CAP = 0  # every sample drops
        reg = Registry()
        san.bind_registry(reg)
        lk = san.make("scheduler._cond", "condition")
        with lk:
            pass
        text = reg.render()
        # At least the condition's wait+hold pair dropped (the armed
        # registry's own instrumented locks drop samples here too).
        m = re.search(r"^oryx_lock_samples_dropped_total (\d+)$",
                      text, re.M)
        assert m and int(m.group(1)) >= 2, text
        assert 'oryx_lock_hold_seconds_count{lock="scheduler._cond"}' \
            not in text


# ---------------------------------------------------------------------------
# Race detector
# ---------------------------------------------------------------------------


@pytest.fixture()
def toy(tmp_path):
    """A module with one guarded and one thread-owned field, written
    to disk so install_module parses REAL source annotations."""
    import importlib.util

    p = tmp_path / "race_toy.py"
    p.write_text(
        "import threading\n"
        "class Box:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.items = []  # guarded-by: _lock\n"
        "        self.owned = 0  # thread-owned: engine\n"
    )
    spec = importlib.util.spec_from_file_location("race_toy", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interleave(box, attr, main_access):
    """Touch box.<attr> from a second thread that STAYS ALIVE while
    the main thread interleaves back — the A B A shape."""
    touched, release = threading.Event(), threading.Event()

    def other():
        getattr(box, attr)
        touched.set()
        release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    assert touched.wait(10)
    try:
        return main_access()
    finally:
        release.set()
        t.join(10)


def test_seeded_guarded_race_fires(toy):
    """The acceptance-criteria seeded race: two live threads
    interleave on a guarded field without the lock — must fire."""
    with S.lock_sanitizer(race_modules=[toy]) as san:
        box = toy.Box()
        box.items.append(1)  # creator: exclusive
        with pytest.raises(S.RaceViolation, match="guarded field"):
            _interleave(box, "items", lambda: box.items)
        assert S.race_violations()
        # Race findings mirror into the sanitizer's stats: one
        # `lock_stats().violations` assertion covers both halves, as
        # the lock_stats docstring promises.
        assert any(
            "guarded field" in v for v in san.stats.violations
        )


def test_guarded_access_under_lock_is_clean(toy):
    with S.lock_sanitizer(race_modules=[toy]):
        box = toy.Box()

        def locked_read():
            with box._lock:
                return box.items

        locked_read()
        _interleave(box, "items", locked_read)
        # The interloper's bare read was the handoff access (legal);
        # everything after holds the lock -> no violation recorded.
        assert not S.race_violations()


def test_seeded_thread_owned_race_fires(toy):
    with S.lock_sanitizer(race_modules=[toy]):
        box = toy.Box()
        box.owned = 1
        with pytest.raises(S.RaceViolation, match="thread-owned"):
            _interleave(box, "owned", lambda: box.owned)


def test_ownership_handoff_is_legal(toy):
    """A A B B — the submit-thread-builds, engine-thread-owns shape.
    The creator never comes back, so no violation."""
    with S.lock_sanitizer(race_modules=[toy]):
        box = toy.Box()
        box.owned = 2
        done = threading.Event()
        err: list[BaseException] = []

        def engine():
            try:
                box.owned += 1
                assert box.owned == 3
            except BaseException as e:  # pragma: no cover
                err.append(e)
            finally:
                done.set()

        threading.Thread(target=engine, name="oryx-engine").start()
        assert done.wait(10)
        assert not err
        assert not S.race_violations()


def test_dead_owner_handoff_is_legal(toy):
    """Thread death is a happens-before edge: the supervisor touching
    a DEAD engine's state (restart, drain-of-dead-engine) is legal and
    starts a fresh ownership epoch."""
    with S.lock_sanitizer(race_modules=[toy]):
        box = toy.Box()
        box.owned = 1

        t = threading.Thread(
            target=lambda: setattr(box, "owned", 2), name="oryx-engine"
        )
        t.start()
        t.join(10)
        # Owner thread is dead -> the main thread may take over, and
        # so may a THIRD thread after it, repeatedly.
        assert box.owned == 2
        box.owned = 3
        assert not S.race_violations()


def test_race_exempt_suppresses_checks(toy):
    with S.lock_sanitizer(race_modules=[toy]):
        box = toy.Box()
        box.items.append(1)

        def exempt_read():
            with S.race_exempt("quiesced"):
                return box.items

        _interleave(box, "items", exempt_read)
        # Exempted access neither raises nor records.
        assert not S.race_violations()


def test_race_exempt_covers_stale_descriptor_epochs(toy):
    """Regression (found wiring the speculative engine's pool-invariant
    check through the armed CI pass): a descriptor installed by an
    EARLIER arming epoch can outlive its detector (process-wide arming
    via build_server's maybe_arm_from_env has no disarm point, and a
    re-arming skips already-instrumented fields) — race_exempt taken
    under the CURRENT epoch must still suppress the stale descriptor's
    check, or an exempted quiesced read raises RaceViolation."""
    stale = S.RaceDetector(action="raise")
    try:
        stale.install_module(toy)
        box = toy.Box()
        box.items.append(1)  # main thread seeds ownership

        def exempt_read():
            with S.race_exempt("quiesced"):
                return box.items

        # A second live thread interleaves, then the main thread reads
        # back under race_exempt — with the exemption keyed to the
        # stale detector this raised; keyed to the thread it must not.
        assert _interleave(box, "items", exempt_read) == [1]
        assert not stale.violations
    finally:
        stale.uninstall()


def test_disarm_restores_classes(toy):
    with S.lock_sanitizer(race_modules=[toy]):
        assert any(
            isinstance(v, S._RaceField)
            for v in toy.Box.__dict__.values()
        )
    assert not any(
        isinstance(v, S._RaceField) for v in toy.Box.__dict__.values()
    )
    box = toy.Box()
    box.items.append(1)
    assert box.items == [1]


def test_real_serving_surface_instruments():
    """The production annotations parse and install: the scheduler's
    guarded control state, the prefix cache's thread-owned plane, the
    trace/tracer/watchdog guarded fields."""
    import oryx_tpu_torch.serve.prefix_cache as pc
    import oryx_tpu_torch.utils.trace as tr

    det = S.RaceDetector(action="record")
    try:
        assert det.install_module(pc) >= 2  # trie + _pages
        assert det.install_module(tr) >= 5  # spans/_stack/_traces/...
    finally:
        det.uninstall()


def test_instrumented_prefix_cache_still_works():
    """Descriptor-wrapped fields behave identically for the owner
    thread (values, defaults, mutation) — instrumentation must never
    change semantics."""
    import oryx_tpu_torch.serve.prefix_cache as pc

    class _Alloc:
        page_size = 4

        def __init__(self):
            self.shared = []

        def share(self, pages, owner=None):
            self.shared.extend(pages)

        def release(self, pages, owner=None):
            pass

        def refcount(self, page):
            return 2  # everything pinned

    with S.lock_sanitizer(race_modules=[pc]):
        cache = pc.PagedPrefixCache(_Alloc())
        n = cache.insert(list(range(8)), [7, 9])
        assert n == 2 and cache.pages == 2
        matched, pages = cache.lookup(list(range(8)))
        assert matched == 8 and pages == [7, 9]
        assert not S.race_violations()


# ---------------------------------------------------------------------------
# The port against the JAX package
# ---------------------------------------------------------------------------

_SURFACE = ("serve.scheduler", "serve.prefix_cache", "serve.api_server",
            "utils.trace", "utils.metrics")


@pytest.mark.parametrize("module", _SURFACE)
def test_annotations_equal_jax_on_the_race_surface(module):
    """The port's reader over the port's sources gives the JAX package's
    analysis.core maps on every class both have, for every field the JAX
    map annotates that the port's class declares; and the detector
    instruments what the reader finds."""
    import ast
    import importlib

    from oryx_tpu.analysis.core import ParsedModule, field_annotations

    jmod = importlib.import_module(f"oryx_tpu.{module}")
    tmod = importlib.import_module(f"oryx_tpu_torch.{module}")
    jsrc = Path(jmod.__file__).read_text()
    parsed = ParsedModule(jmod.__file__, jsrc)
    want = {node.name: field_annotations(parsed, node)
            for node in ast.walk(parsed.tree)
            if isinstance(node, ast.ClassDef)}
    tsrc = Path(tmod.__file__).read_text()
    got = dict(S.field_annotations(tsrc))
    assert sorted(S.field_annotations(jsrc)) == sorted(want.items())
    compared = 0
    for cls, fields in want.items():
        if cls not in got:
            continue
        declared = set(re.findall(
            r"^\s*(?:self\.)?([A-Za-z_]\w*)\s*(?::[^=#\n]+)?=", tsrc, re.M))
        for field, ann in fields.items():
            if field in declared:
                assert got[cls].get(field) == ann, (cls, field)
                compared += 1
    assert compared >= {"serve.scheduler": 20, "serve.prefix_cache": 5,
                        "serve.api_server": 1, "utils.trace": 7,
                        "utils.metrics": 3}[module]
    det = S.RaceDetector(action="record")
    try:
        assert det.install_module(tmod) == sum(
            len(f) for name, f in S.field_annotations(tsrc)
            if isinstance(getattr(tmod, name, None), type))
    finally:
        det.uninstall()


def _battery(mod):
    """Ordering, cycle, same-name, re-entrant and hot-dispatch scenarios
    in record mode: the violations each records (the package path cut)
    and the acquire counts."""
    out = []
    scenarios = [
        (("a", "b"), [("a", "b"), ("b", "a"), ("a", "b")]),
        ((), [("x", "y"), ("y", "x")]),
        (None, [("trace._lock", "trace._lock")]),
        (None, [("registry._lock", "scheduler._cond")]),
        (None, [("scheduler._cond", "metrics.family")]),
    ]
    for order, nests in scenarios:
        with mod.lock_sanitizer(order=order, action="record",
                                race_modules=[]) as san:
            for outer, inner in nests:
                a, b = san.make(outer), san.make(inner)
                with a:
                    with b:
                        mod.hot_dispatch("decode")
            again = san.make("again", "rlock")
            with again:
                with again:
                    pass
            out.append([re.sub(r"oryx_tpu(_torch)?/", "", v)
                        for v in san.stats.violations])
            out.append((dict(san.stats.acquires),
                        dict(san.stats.reentrant)))
    return out


def test_sanitizer_verdicts_equal_jax():
    from oryx_tpu.analysis import sanitizers as JS

    got, want = _battery(S), _battery(JS)
    assert got == want
    assert any("inverts" in v for v in got[6])
    assert any("cycle" in v for v in got[2])


@pytest.mark.parametrize("engine", ["split", "ragged"])
def test_armed_server_serves_the_mix_clean(engine, monkeypatch):
    """ORYX_LOCK_SANITIZER=1: the port's server arms at build, serves the
    api_server mix with zero lock, race and hot-dispatch violations and
    the unarmed replies, counters and ledgers, and shows the armed JAX
    server's /metrics families (the oryx_lock_* ones included)."""
    import jax

    import test_torch_api_server as A
    from oryx_tpu.analysis import sanitizers as JS
    from oryx_tpu_torch.serve import api_server as tapi

    from torch_serve_common import make_pipes

    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        jp, tp = make_pipes()
        kw = A.ENGINES[engine]
        probe = A.Server(tapi.build_server(tp, port=0, **kw))
        stop = probe.post({"messages": A._user("hello there"),
                           "max_tokens": 6})[2]
        probe.close()
        reqs = A._requests(stop["choices"][0]["message"]["content"][2])
        plain = A._serve_all(tapi, tp, kw, reqs)
        monkeypatch.setenv("ORYX_LOCK_SANITIZER", "1")
        try:
            armed = A._serve_all(tapi, tp, kw, reqs)
            assert S.lock_sanitizer_armed()
            stats = S.lock_stats()
            assert stats.violations == [] and S.race_violations() == []
            assert stats.acquires["scheduler._cond"] > 0
            jarmed = A._serve_all(A.japi, jp, kw, reqs)
            assert JS.lock_stats().violations == []
        finally:
            S.disarm_lock_sanitizer()
            JS.disarm_lock_sanitizer()
    finally:
        jax.config.update("jax_default_matmul_precision", old)
    assert armed[0] == plain[0]
    assert A._families(armed[1]) == A._families(jarmed[1])
    locks = {f for f in A._families(armed[1]) if f.startswith("oryx_lock_")}
    assert {"oryx_lock_wait_seconds", "oryx_lock_hold_seconds"} <= locks
    assert 'oryx_lock_hold_seconds_count{lock="scheduler._cond"}' in armed[1]
    for name in ("admitted", "completed", "decode_steps_total"):
        pat = rf"^oryx_serving_{name} (\S+)$"
        assert re.search(pat, armed[1], re.M).group(1) == \
            re.search(pat, plain[1], re.M).group(1), name


def test_armed_supervised_restart_hands_ownership_over(monkeypatch):
    """The engine thread dies mid-request under the armed detector (and
    the thread-owned `_Request` / scheduler fields it held); the
    supervisor's restart takes them over through thread death, the
    replayed reply equals the unbroken one, and nothing is flagged."""
    import json
    import threading
    import time
    import urllib.request

    from oryx_tpu_torch.serve import api_server as tapi
    from oryx_tpu_torch.utils import faults

    from torch_serve_common import make_pipes

    _, tp = make_pipes()
    body = {"messages": [{"role": "user", "content": "hello there chaos"}],
            "max_tokens": 10}
    kw = dict(port=0, engine="continuous", num_slots=2, page_size=16,
              decode_chunk=4, max_ctx=512)

    def serve(faults_spec=None):
        srv = tapi.build_server(tp, faults_spec=faults_spec, **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                reply = json.load(r)["choices"][0]["message"]["content"]
            deadline = time.monotonic() + 30
            while faults_spec and srv.scheduler.restarts < 1:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            srv.scheduler.check_pool_invariant()
            return reply, srv.scheduler.restarts
        finally:
            faults.reset()
            srv.supervisor.stop()
            srv.scheduler.close()
            srv.shutdown()
            srv.server_close()

    want, _ = serve()
    monkeypatch.setenv("ORYX_LOCK_SANITIZER", "1")
    try:
        got, restarts = serve("engine_crash:after=2")
        assert S.lock_stats().violations == []
        assert S.race_violations() == []
    finally:
        S.disarm_lock_sanitizer()
        faults.reset()
    assert restarts >= 1 and got == want
