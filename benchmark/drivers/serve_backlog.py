"""Backlog serving: a queue deeper than any window can drain is submitted
before the window, the engine runs until its slots turn over in steady
state (`steady_s`, counted in set-up), and the window counts every output
token emitted inside it.

`output_tokens_per_s` is all tokens emitted in the window over the window.
`tpot_p90_ms` is the 90th percentile over the requests that emitted tokens
in at least two dispatches inside the window of (t_last - t_first) /
(n - 1) over those tokens."""

from __future__ import annotations

import sys
import time

import torch

from benchmark.drivers import serving
from benchmark.drivers.serve_open import warm_specs, window_flops
from benchmark.harness import stats
from benchmark.harness.trace import TracedWindow
from benchmark.traffic import mix


def run(ctx) -> dict:
    w, cfgf, seed, seconds = ctx.workload, ctx.config, ctx.seed, ctx.seconds
    t = w["traffic"]
    specs = mix.specs(t, t["backlog"])
    # The backlog's order is the file's (which requests the window serves
    # sets its work); the seed gives the words and the weights.
    items = mix.materialize(specs, seed, order_seed=t["mix_seed"])
    warm_items = mix.materialize(warm_specs(specs), seed + 1)

    sched, weights, _ = serving.build_engine(
        cfgf, w["engine"], seed, timeline_cap=1 << 16, device=ctx.device)
    serving.warm(sched, warm_items)
    tracked = [serving.Tracked(it, 0.0) for it in items]
    for tr in tracked:
        serving.submit(sched, tr)
    time.sleep(float(t["steady_s"]))
    calls = serving.CallLog(sched) if ctx.trace else None
    win = TracedWindow() if ctx.trace else None
    ctx.mark_setup()

    t0 = time.perf_counter()
    epoch = time.time() - t0
    t1 = t0 + seconds
    if win is not None:
        start = t0 + max(0.0, (seconds - w["trace_seconds"]) / 2)
        time.sleep(max(0.0, start - time.perf_counter()))
        calls.begin()
        win.start()
        time.sleep(max(0.0, start + w["trace_seconds"] - time.perf_counter()))
        calls.end()
        win.stop()
    time.sleep(max(0.0, t1 - time.perf_counter()))
    device = ctx.device_record()
    in_queue = sched.queue_len()
    sched.close()

    tokens, tpot = 0, []
    for tr in tracked:
        times = [x for x in tr.token_times() if t0 <= x <= t1]
        tokens += len(times)
        if len(set(times)) >= 2:
            tpot.append((times[-1] - times[0]) / (len(times) - 1))
    failed = sum(1 for tr in tracked if tr.handle.error is not None)
    done = [tr for tr in tracked if tr.ok]
    sys.stderr.write(
        f"backlog: {len(tracked)} queued, {len(done)} finished, {failed} "
        f"failed, {in_queue} still queued at close; {tokens} tokens in "
        f"{seconds} s\n")
    if in_queue == 0:
        sys.stderr.write("backlog: the queue ran dry inside the window\n")
        failed += 1
    active = [tr for tr in tracked
              if any(t0 <= x <= t1 for x in tr.token_times())]
    out = {"attempted": len(active), "failed": failed, "device": device}
    if not ctx.trace:
        out["metrics"] = {
            "output_tokens_per_s": tokens / seconds,
            "tpot_p90_ms": (stats.percentile(tpot, 90) * 1e3
                            if tpot else None),
        }
    else:
        steps = serving.timeline_in(sched, win.t0_ns, win.t1_ns)
        summ = serving.trace_summary(win, steps, calls.prefill_steps)
        out["trace"] = dict(
            summ, steps=steps, prefill_steps=calls.prefill_steps,
            chunk=sched.chunk, **calls.k1_summary(win),
            model_flops=window_flops(
                cfgf["oryx"], tracked, win.t0_ns / 1e9 - epoch,
                win.t1_ns / 1e9 - epoch),
        )
        calls.close()
    del sched
    torch.cuda.empty_cache()
    cases = serving.sample_cases(done, w["check"]["sample"], seed)
    out["checks"] = serving.check(weights, cfgf, cases,
                                  w["check"]["max_gap"], ctx.control)
    return out
