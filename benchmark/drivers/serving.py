"""What both serving drivers share: the engine built over seeded weights,
requests tracked from the client's side, the served-token check and the
traced window's records.

The engine is the program's own: `Pipeline` over the benchmark's weights
and `ContinuousScheduler` with the cell's settings, driven in process
through `submit`. Each request streams; its events queue is swapped for a
recorder that stamps every delta with the host clock as the engine thread
emits it, which is when a streaming client could read it."""

from __future__ import annotations

import queue
import sys
import time

import numpy as np
import torch

from benchmark import count
from benchmark.harness import trace as trace_lib
from benchmark.harness.tokenizer import CodepointTokenizer, ids_of
from benchmark.harness.weights import make_weights


class Recorder:
    """A handle's events queue that keeps [(perf_counter, event)]."""

    def __init__(self, old: queue.Queue) -> None:
        self.events: list[tuple[float, tuple]] = []
        now = time.perf_counter()
        while True:
            try:
                self.events.append((now, old.get_nowait()))
            except queue.Empty:
                break

    def put(self, item, block=True, timeout=None) -> None:
        self.events.append((time.perf_counter(), item))


class Tracked:
    """One request: its traffic item, due time, handle and the times its
    tokens appeared."""

    def __init__(self, item: dict, due: float) -> None:
        self.item, self.due = item, due
        self.handle = None
        self.rec: Recorder | None = None
        self.submitted = None

    def token_times(self) -> list[float]:
        """One host time a token: each delta's time for each of its
        characters (one character a token)."""
        out = []
        for t, ev in (self.rec.events if self.rec else []):
            if ev[0] == "delta":
                out += [t] * len(ev[1])
        return out

    @property
    def ok(self) -> bool:
        h = self.handle
        return h is not None and h.done.is_set() and h.error is None

    def served(self) -> list[int]:
        return ids_of(self.handle.reply)


def build_engine(cfg_file: dict, engine: dict, seed: int, timeline_cap: int,
                 device: str = "cuda"):
    """(scheduler, weights, OryxConfig) over seeded bf16 weights."""
    from oryx_tpu_torch.config import OryxConfig
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler
    from oryx_tpu_torch.utils.timeline import StepTimeline

    cfg = OryxConfig.from_dict(cfg_file["oryx"])
    model = oryx.empty_model(cfg, dtype=torch.bfloat16)
    layout = [(n, tuple(p.shape)) for n, p in model.state_dict().items()]
    weights = make_weights(layout, seed, torch.bfloat16, device)
    model.load_state_dict(weights, assign=True)
    model.requires_grad_(False)
    tok = CodepointTokenizer(cfg.generation.eos_token_id)
    pipe = Pipeline(tok, model, cfg, device=device)
    sched = ContinuousScheduler(
        pipe, seed=seed % (1 << 31),
        timeline=StepTimeline(capacity=timeline_cap), **engine)
    return sched, weights, cfg


def submit(sched, tr: Tracked) -> None:
    it = tr.item
    tr.submitted = time.perf_counter()
    h = sched.submit(it["request"], it["max_new"], {}, streaming=True)
    tr.rec = Recorder(h.events)
    h.events = tr.rec
    tr.handle = h


def wait_all(tracked: list[Tracked], deadline: float) -> None:
    for tr in tracked:
        if tr.handle is not None:
            tr.handle.done.wait(max(0.0, deadline - time.perf_counter()))


def warm(sched, items: list[dict], timeout: float = 600.0) -> None:
    """Serve `items` at once and wait: every shape the window will use
    (the tower's and compressor's buckets, prefill-lane and pure-decode
    dispatches, the engine-step graph's capture) runs before it opens."""
    tracked = [Tracked(it, 0.0) for it in items]
    for tr in tracked:
        submit(sched, tr)
    wait_all(tracked, time.perf_counter() + timeout)
    bad = [tr for tr in tracked if not tr.ok]
    if bad:
        raise RuntimeError(f"{len(bad)} warm-up request(s) failed: "
                           f"{bad[0].handle.error if bad[0].handle else ''}")


# ---- the served-token check -------------------------------------------------

def sample_cases(done: list[Tracked], n: int, seed: int) -> list[dict]:
    """n finished requests drawn from the seed, with the request served
    most tokens and the one with the longest prompt among them."""
    if not done:
        return []
    by_served = max(done, key=lambda t: len(t.served()))
    by_prompt = max(done, key=lambda t: t.handle.usage[0])
    pick = [by_served] + ([by_prompt] if by_prompt is not by_served else [])
    rest = [t for t in done if t not in pick]
    r = np.random.default_rng([seed % (1 << 63), 5])
    for i in r.permutation(len(rest))[:max(0, n - len(pick))]:
        pick.append(rest[int(i)])
    return [{"request": t.item["request"], "kind": t.item["kind"],
             "served": t.served()} for t in pick if t.served()]


def check(weights, cfg_file, cases, limit: float,
          control: bool = False) -> dict:
    """The compared numbers; with `control` (benchmark/tools/control.py)
    the fp8 control's reading (and the int8 one's) beside them."""
    from benchmark.reference import serve_check

    t0 = time.perf_counter()
    res = serve_check.served_gap(weights, cfg_file["oryx"], cases)
    sys.stderr.write(f"reference: {len(cases)} requests, {res['tokens']} "
                     f"served tokens in {time.perf_counter() - t0:.1f} s\n")
    out = {"max_gap": {"value": res["max_gap"], "limit": limit},
           "checked_tokens": {"value": res["tokens"], "limit": None}}
    if control:
        ctl = serve_check.control_gap(weights, cfg_file["oryx"], cases)
        for key in ("control_max_gap", "int8_max_gap"):
            out[key] = {"value": ctl[key], "limit": None}
    return out


# ---- traced window ---------------------------------------------------------

class CallLog:
    """In the traced run only: the K1 calls of the vision tower and the
    compressor (their segment ids kept on the card until the window
    closes), and the engine steps that carried prefill lanes (by their
    timeline ordinal)."""

    def __init__(self, sched) -> None:
        from oryx_tpu_torch.models import compressor, generate, oryx_vit

        self.active = False
        self.k1: list[tuple] = []
        self.prefill_steps: set[int] = set()
        self._restore = []
        log = self

        def wrap_seg(mod):
            orig = mod.segment_attention

            def seg(q, k, v, q_seg, kv_seg, *a, **kw):
                if log.active:
                    log.k1.append((tuple(q.shape), tuple(k.shape),
                                   q_seg.detach().clone(),
                                   kv_seg.detach().clone()))
                return orig(q, k, v, q_seg, kv_seg, *a, **kw)
            mod.segment_attention = seg
            self._restore.append((mod, "segment_attention", orig))

        wrap_seg(oryx_vit)
        wrap_seg(compressor)
        orig_step = generate.paged_ragged_step

        def step(*a, **kw):
            if kw.get("pf_width"):
                log.prefill_steps.add(sched.timeline.total_steps + 1)
            return orig_step(*a, **kw)
        generate.paged_ragged_step = step
        self._restore.append((generate, "paged_ragged_step", orig_step))

    def begin(self) -> None:
        self.k1_launch0 = k1_launches()
        self.active = True

    def end(self) -> None:
        self.active = False

    def close(self) -> None:
        for mod, name, orig in self._restore:
            setattr(mod, name, orig)

    def k1_summary(self, win) -> dict:
        """The K1 records found in the window against the launches the
        program counted meanwhile (printed), and the calls' least time."""
        found = sum(1 for name, *_ in win.in_window() if "flash_fwd_" in name)
        sys.stderr.write(
            f"trace: K1 records {found}, launches expected "
            f"{k1_launches() - self.k1_launch0} (program counter), calls "
            f"recorded {len(self.k1)}\n")
        return {"k1_bound_s": self.k1_bound_s()}

    def k1_bound_s(self) -> float:
        total = 0.0
        for qs, ks, qseg, kvseg in self.k1:
            qv = qseg.reshape(-1).cpu().numpy()
            kv = kvseg.reshape(-1).cpu().numpy()
            pairs = count.segment_pairs(qv.tolist(), kv.tolist())
            total += count.attention_fwd_bound(
                qs[2], ks[2], qs[3], int((qv > 0).sum()),
                int((kv > 0).sum()), pairs)
        return total


def k1_launches() -> int:
    """K1's segment-masked forward launches so far (the program's counter,
    keyed (causal, has_segments, B, Hq, Hk, Tq, Tk, D)): the tower's and
    the compressor's calls."""
    from oryx_tpu_torch.ops.cuda import flash_attention

    return sum(n for key, n in flash_attention.LAUNCHES.items() if key[1])


def timeline_in(sched, t0_ns: int, t1_ns: int) -> list[dict]:
    """Step records that completed inside [t0, t1] (host wall clock)."""
    return [r for r in reversed(sched.timeline.snapshot())
            if t0_ns / 1e9 <= r["ts_unix_s"] <= t1_ns / 1e9]


def name_gap(gap, steps, prefill_steps) -> str:
    """What the host was doing in an idle gap: inside an eager
    prefill-lane dispatch, a pure-decode (graph replay) dispatch, or
    between dispatches (admission and prompt prep, harvest)."""
    mid = (gap[0] + gap[1]) / 2e9
    for r in steps:
        if r["ts_unix_s"] - r["dur_s"] <= mid <= r["ts_unix_s"]:
            return ("prefill-lane dispatch" if r["step"] in prefill_steps
                    else "pure-decode dispatch")
    return "between dispatches"


def trace_summary(win: trace_lib.TracedWindow, steps, prefill_steps) -> dict:
    recs = win.in_window()
    gaps = trace_lib.idle_gaps(recs, win.t0_ns, win.t1_ns)[:10]
    return {
        "busy_s": trace_lib.busy_s(recs),
        "window_s": win.window_s,
        "family_s": trace_lib.family_seconds(recs),
        # K1's forward kernel alone (its decode route has kernels of its
        # own, which the tower and compressor never take).
        "k1_fwd_s": sum(e - s for n, s, e in recs if "flash_fwd_" in n) / 1e9,
        "breakdown": {
            "device_ops": trace_lib.top_ops(recs),
            "idle_gaps": [[name_gap(g, steps, prefill_steps),
                           (g[1] - g[0]) / 1e9] for g in gaps],
        },
    }
