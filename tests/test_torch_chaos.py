"""The chaos scenarios of the JAX package's scripts/chaos_suite.py against
the port's tiny server (that script imports the JAX package, so it cannot
run against the port unchanged): injected pool exhaustion, engine-thread
death with supervised replay, a journaled crash that replays offline,
a hung dispatch turned into a 504, a client that vanishes mid-stream, a
drafter whose accept rate collapses, a failed host-tier re-upload and
failed checkpoint saves. After each server scenario the invariant triad
holds: the pool invariant with zero leaked pages, /readyz 200 and a real
completion, and oryx_faults_injected_total equal to the injector's own
count."""

import json
import os
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oryx_tpu_torch.serve import api_server  # noqa: E402
from oryx_tpu_torch.serve import journal as journal_lib  # noqa: E402
from oryx_tpu_torch.serve import replay as rj  # noqa: E402
from oryx_tpu_torch.utils import faults  # noqa: E402
from oryx_tpu_torch.utils.retry import urlopen_json  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serve_common import make_pipes  # noqa: E402


@pytest.fixture(scope="module")
def pipe():
    return make_pipes()[1]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.reset()
    yield
    faults.reset()


def wait_for(predicate, timeout=120.0, what="condition") -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if predicate():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class Harness:
    """One tiny in-process server per scenario (the chaos suite's
    geometry: 2 slots, 16-token pages, 4-step chunks, max_ctx 512)."""

    def __init__(self, pipe, faults_spec: str, **server_kw):
        self.pipe = pipe
        self.srv = api_server.build_server(
            pipe, port=0, engine="continuous", num_slots=2, page_size=16,
            decode_chunk=4, max_ctx=512, faults_spec=faults_spec,
            **server_kw,
        )
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"

    def close(self) -> None:
        faults.reset()
        if self.srv.supervisor is not None:
            self.srv.supervisor.stop()
        if self.srv.scheduler is not None:
            self.srv.scheduler.close()
        if self.srv.journal is not None:
            self.srv.journal.close()
        self.srv.shutdown()
        self.srv.server_close()

    def get(self, path, **kw):
        return urlopen_json(self.base + path, **kw)

    def chat(self, content: str, max_tokens: int, timeout: float = 600.0):
        return urlopen_json(
            self.base + "/v1/chat/completions",
            data=json.dumps({
                "messages": [{"role": "user", "content": content}],
                "max_tokens": max_tokens,
            }).encode(),
            headers={"Content-Type": "application/json"}, timeout=timeout,
        )

    def triad(self, sites: list[str]) -> int:
        """The invariant triad after a scenario; returns the faults
        injected."""
        sched = self.srv.scheduler
        wait_for(lambda: all(r is None for r in sched.slots)
                 and sched.queue_len() == 0, what="slots and queue empty")
        sched.check_pool_invariant()
        cache_pages = (len(sched.prefix_cache.held_pages())
                       if sched.prefix_cache is not None else 0)
        assert sched.allocator.num_free + cache_pages == sched.num_pages
        status, body, _ = self.get("/readyz", timeout=30)
        assert status == 200 and body["ready"] is True, body
        status, body, _ = self.chat("post-chaos probe", 3)
        assert status == 200, body
        with urllib.request.urlopen(self.base + "/metrics", timeout=30) as r:
            text = r.read().decode()
        total = 0
        for site in sites:
            m = re.search(rf'^oryx_faults_injected_total\{{site="{site}"\}} '
                          r"([0-9.e+-]+)$", text, re.M)
            assert (float(m.group(1)) if m else 0.0) == \
                faults.injected_count(site), site
            total += faults.injected_count(site)
        return total


def _reply(body) -> str:
    return body["choices"][0]["message"]["content"]


def test_page_alloc_oom(pipe):
    """Pool exhaustion on a schedule under a shared-prefix burst: every
    request answers, one trigger=oom forensic an injected raise, the page
    map reconciled afterwards."""
    h = Harness(pipe, "page_alloc_oom:every=3,times=6")
    try:
        results = []

        def one(i):
            results.append(h.chat(
                "shared prefix for the chaos burst to splice! " + f"q{i}",
                3 + i % 2)[0])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert results == [200] * 4
        h.triad(["page_alloc_oom"])
        injected = faults.injected_count("page_alloc_oom")
        assert injected >= 1
        assert h.srv.metrics.by_label("oom_forensics_total").get("oom") \
            == injected
        status, recs, _ = h.get("/debug/oom?n=64", timeout=30)
        assert status == 200 and recs["total"] >= injected
        for rec in recs["records"]:
            assert rec["top_requests"] and rec["pool"]["reconciled"]
        status, pages, _ = h.get("/debug/pages?format=summary", timeout=30)
        assert pages["summary"]["reconciled"] and \
            pages["summary"]["slot"] == 0
    finally:
        h.close()


def test_engine_crash(pipe):
    """The engine thread dies mid-flight; the supervisor restarts it and
    the replayed reply equals the in-process engine's."""
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    q, m = "hello there chaos", 10
    sched = ContinuousScheduler(pipe, num_slots=2, page_size=16, chunk=4,
                                max_ctx=512)
    ref = sched.submit({"question": q, "images": [], "is_video": False,
                        "history": []}, m).result(timeout=600)[0]
    sched.close()
    h = Harness(pipe, "engine_crash:after=2")
    try:
        status, body, _ = h.chat(q, m)
        assert status == 200, body
        assert _reply(body) == ref
        wait_for(lambda: h.srv.scheduler.restarts >= 1, timeout=30,
                 what="supervisor restart")
        assert h.srv.metrics.get("engine_restarts_total") >= 1
        assert h.triad(["engine_crash"]) == 1
    finally:
        h.close()


def test_journaled_crash(pipe, tmp_path):
    """A crash mid-burst is journaled (fault and restart entries) and the
    file replays offline decision for decision."""
    jpath = str(tmp_path / "journal.jsonl")
    h = Harness(pipe, "engine_crash:after=3", journal_path=jpath)
    try:
        for i in range(3):
            status, body, _ = h.chat(f"journal me through the crash q{i}",
                                     4 + i % 3)
            assert status == 200, body
        wait_for(lambda: h.srv.scheduler.restarts >= 1, timeout=30,
                 what="supervisor restart")
        h.triad(["engine_crash"])
        h.srv.supervisor.stop()
        h.srv.scheduler.close()
        h.srv.journal.close()
        header, entries = journal_lib.read_journal(jpath)
        kinds = {e["kind"] for e in entries}
        assert {"fault", "restart"} <= kinds
        assert header["config"]["faults_spec"] == "engine_crash:after=3"
        res = rj.run_replay(header, entries, pipe=pipe)
        assert not (res["feed_errors"] or res["timed_out"]
                    or res["gave_up"])
        assert rj.first_divergence(entries, res["entries"]) is None
        matched, total, bad = rj.reply_match(entries, res["entries"])
        assert matched == total >= 4, bad
    finally:
        h.close()


def test_hung_dispatch(pipe):
    """The first decode dispatch stalls past the deadline: the next step
    boundary answers 504 and frees the slot."""
    h = Harness(pipe, "decode_dispatch:delay=2.0,after=0",
                request_timeout=0.75)
    try:
        status, body, _ = h.chat("about to hang", 64)
        assert status == 504, body
        assert body["error"]["type"] == "timeout_error"
        assert h.srv.metrics.get("deadline_exceeded_total") >= 1
        h.srv.scheduler.request_timeout = None
        h.triad(["decode_dispatch"])
    finally:
        h.close()


def test_client_disconnect(pipe):
    """The SSE write raises BrokenPipeError: the request is cancelled and
    its pages and cache shares come back."""
    h = Harness(pipe, "client_disconnect:after=0")
    try:
        req = urllib.request.Request(
            h.base + "/v1/chat/completions",
            data=json.dumps({
                "messages": [{"role": "user", "content": "stream then vanish"}],
                "max_tokens": 200, "stream": True,
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                r.read()
        except (OSError, urllib.error.URLError):
            pass
        wait_for(lambda: h.srv.metrics.get("cancelled") >= 1,
                 what="cancellation")
        assert h.triad(["client_disconnect"]) == 1
    finally:
        h.close()


def test_spec_drift(pipe):
    """An oracle drafter that degrades mid-run into garbage: exactly one
    spec_accept_collapse event for the degraded phase, every reply the
    plain engine's, no page held afterwards."""
    from oryx_tpu_torch.models import generate as gen_lib
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils.anomaly import AnomalyMonitor

    q, cap = "tell me a long story please", 40
    ids = len(pipe._prepare_request({"question": q})[0])

    class Tap(gen_lib.Drafter):
        def __init__(self):
            self.longest: list[int] = []

        def propose(self, context, k):
            ctx = [int(x) for x in context]
            if len(ctx) > len(self.longest):
                self.longest = ctx
            return []

    tap = Tap()
    sched = ContinuousScheduler(
        pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
        prefill_chunk=8, ragged=True, speculate=1, drafter=tap,
        autostart=False, prefix_cache=False,
    )
    hd = sched.submit({"question": q}, cap)
    sched.start()
    ref = hd.result(timeout=600)[0]
    sched.close()
    stream = tap.longest[ids:]

    class DegradableOracle(gen_lib.Drafter):
        def __init__(self):
            self.degraded = False

        def propose(self, context, k):
            if self.degraded:
                return [7] * k
            done = len(context) - ids
            return stream[done: done + k]

    oracle = DegradableOracle()
    monitor = AnomalyMonitor(source="serve")
    sched = ContinuousScheduler(
        pipe, num_slots=2, page_size=16, chunk=4, max_ctx=512,
        prefill_chunk=8, ragged=True, speculate=3, drafter=oracle,
        anomaly=monitor, autostart=False, prefix_cache=False,
    )
    sched.start()
    try:
        for _ in range(2):
            assert sched.submit({"question": q}, cap).result(
                timeout=600)[0] == ref
        assert not monitor.counts.get("spec_accept_collapse", 0)
        oracle.degraded = True
        for _ in range(2):
            assert sched.submit({"question": q}, cap).result(
                timeout=600)[0] == ref
        assert monitor.counts.get("spec_accept_collapse", 0) == 1
        sched.check_pool_invariant()
        assert not any(sched.allocator.refcount(p) > 0
                       for p in range(sched.allocator.num_pages))
    finally:
        sched.close()
        monitor.close()


def test_host_spill_upload(pipe):
    """A failed host-tier re-upload on an int8 pool degrades the reload to
    a cold recompute: the same reply, then a normal cached hit."""
    h = Harness(pipe, "host_spill_upload:times=1", kv_dtype="int8",
                host_cache_bytes=1 << 24, prefill_chunk=32)
    try:
        prompt = "host tier chaos shared prefix " * 4
        status, cold, _ = h.chat(prompt, 6)
        assert status == 200, cold
        sched = h.srv.scheduler
        wait_for(lambda: all(r is None for r in sched.slots)
                 and sched.queue_len() == 0, what="quiesce")
        cache = sched.prefix_cache
        cache.evict(cache.evictable_pages())
        assert cache.spilled_pages
        status, warm, _ = h.chat(prompt, 6)
        assert status == 200 and _reply(warm) == _reply(cold)
        assert faults.injected_count("host_spill_upload") == 1
        status, third, _ = h.chat(prompt, 6)
        assert status == 200 and _reply(third) == _reply(cold)
        h.triad(["host_spill_upload"])
    finally:
        h.close()


def test_checkpoint_save(tmp_path):
    """Two injected save failures: the retries land the checkpoint on the
    third attempt on the pinned schedule, and the bound registry counts
    both."""
    import types

    from oryx_tpu_torch.utils.checkpoint import CheckpointManager
    from oryx_tpu_torch.utils.metrics import Registry
    from oryx_tpu_torch.utils.retry import BackoffPolicy

    faults.configure("checkpoint_save:times=2")
    reg = Registry()
    faults.bind_registry(reg)
    slept: list[float] = []
    mgr = CheckpointManager(
        os.path.join(tmp_path, "ck"),
        save_retry=BackoffPolicy(retries=3, base_s=0.5, factor=2.0,
                                 jitter=0.0),
        sleep=slept.append,
    )
    model = torch.nn.Linear(4, 4)
    state = types.SimpleNamespace(params=model, step=1,
                                  opt_state={"x": torch.arange(16.0)})
    assert mgr.save(1, state, ["weight", "bias"]) is True
    assert mgr.latest_step() == 1
    want = model.weight.detach().clone()
    with torch.no_grad():
        model.weight.zero_()
    mgr.restore(state)
    assert torch.equal(model.weight, want)
    assert np.array_equal(state.opt_state["x"].numpy(), np.arange(16.0))
    assert slept == [0.5, 1.0]
    m = re.search(r'^oryx_faults_injected_total\{site="checkpoint_save"\} '
                  r"([0-9.e+-]+)$", reg.render(), re.M)
    assert float(m.group(1)) == faults.injected_count("checkpoint_save") == 2
