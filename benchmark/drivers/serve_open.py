"""Open-loop serving: requests sent on a seeded Poisson schedule at the
cell's fixed rate, whether or not earlier ones have finished.

Each request is timed from when it was due: TTFT is its first token's
time less its due time, so a stall counts against every request it delays.
TPOT is (t_last - t_first) / (n - 1) over its own tokens. Both tails are
over every request due in the window; a request that fails, or has not
finished a minute after the window closed, counts in `failed`."""

from __future__ import annotations

import sys
import time

import torch

from benchmark import count
from benchmark.drivers import serving
from benchmark.harness import stats
from benchmark.harness.trace import TracedWindow
from benchmark.reference import oryx_ref
from benchmark.traffic import mix

LATE_S = 60.0


def warm_specs(specs: list[dict]) -> list[dict]:
    """The largest request of each kind (most pixels), at the smallest
    max_new that still decodes past the first dispatch."""
    best: dict[str, dict] = {}
    for s in specs:
        px = sum(h * w for h, w in s["sizes"]) + s.get("prompt_bytes", 0)
        if s["kind"] not in best or px > best[s["kind"]][0]:
            best[s["kind"]] = (px, s)
    return [dict(s, max_new=24) for _, s in best.values()]


def request_flops(cfg: dict, tr: serving.Tracked) -> tuple[float, int]:
    """(visual + prefill FLOPs, prompt length) of one request, from its
    sizes."""
    req, kind = tr.item["request"], tr.item["kind"]
    images = req.get("images") or []
    v = cfg["vision"]
    cap = v["max_patches_per_image"]
    if kind == "video":
        cap = max(1, cap // len(images))
    s = oryx_ref.SIDE_FACTOR.get(kind, 1)
    grids = [oryx_ref.patch_grid(im.shape[:2], v["patch_size"], cap)
             for im in images]
    n_media = 0 if not images else (1 if kind == "video" else len(images))
    ids = oryx_ref.prompt_ids(req["question"], n_media,
                              len(images) if kind == "video" else 0)
    text = sum(1 for t in ids if t != oryx_ref.IMAGE_TOKEN)
    vis = sum(-(-h // s) * -(-w // s) for h, w in grids)
    length = text + vis
    f = count.visual_flops(cfg, grids, [s] * len(grids)) if images else 0.0
    return f + count.prefill_flops(cfg["llm"], length), length


def window_flops(cfg: dict, tracked, t0: float, t1: float) -> float:
    """Model FLOPs of the work done in [t0, t1] (host perf clock): a
    request's visual encode and prefill at its first token, each decode
    token at its own time."""
    llm = cfg["llm"]
    f = 0.0
    for tr in tracked:
        times = tr.token_times()
        if not times:
            continue
        pf, length = request_flops(cfg, tr)
        if t0 <= times[0] <= t1:
            f += pf
        for k, t in enumerate(times[1:], start=1):
            if t0 <= t <= t1:
                f += count.decode_flops(llm, length + k)
    return f


def run(ctx) -> dict:
    w, cfgf, seed, seconds = ctx.workload, ctx.config, ctx.seed, ctx.seconds
    t = w["traffic"]
    rate = float(t["rate_per_s"])
    n = max(1, round(rate * seconds))
    specs = mix.specs(t, n)
    # One schedule for every seed: which request comes when, and the gaps
    # between them, are drawn from the file's mix_seed; the run's seed
    # gives the pixels, words and weights. Queueing makes the tails swing
    # with the order far more than between two runs of one order.
    items = mix.materialize(specs, seed, order_seed=t["mix_seed"])
    due = mix.arrivals(n, rate, seconds, mix.rng(t["mix_seed"], 3))
    warm_items = mix.materialize(warm_specs(specs), seed + 1)

    sched, weights, _ = serving.build_engine(
        cfgf, w["engine"], seed, timeline_cap=1 << 16, device=ctx.device)
    serving.warm(sched, warm_items)
    calls = serving.CallLog(sched) if ctx.trace else None
    win = TracedWindow() if ctx.trace else None
    ctx.mark_setup()

    t0 = time.perf_counter()
    epoch = time.time() - t0
    tracked = [serving.Tracked(it, t0 + float(d))
               for it, d in zip(items, due)]
    tr_start = t0 + max(0.0, (seconds - w["trace_seconds"]) / 2)
    tr_stop = tr_start + w["trace_seconds"]
    events = [(tr.due, "submit", tr) for tr in tracked]
    if win is not None:
        events += [(tr_start, "trace_on", None), (tr_stop, "trace_off", None)]
    events.sort(key=lambda e: e[0])
    for when, kind, tr in events:
        delay = when - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if kind == "submit":
            serving.submit(sched, tr)
        elif kind == "trace_on":
            calls.begin()
            win.start()
        else:
            calls.end()
            win.stop()
    serving.wait_all(tracked, t0 + seconds + LATE_S)
    device = ctx.device_record()

    done = [tr for tr in tracked if tr.ok]
    failed = len(tracked) - len(done)
    late = max(tr.submitted - tr.due for tr in tracked)
    ttft = [tr.token_times()[0] - tr.due for tr in done if tr.token_times()]
    tpot = []
    for tr in done:
        times = tr.token_times()
        if len(times) >= 2:
            tpot.append((times[-1] - times[0]) / (len(times) - 1))
    sys.stderr.write(
        f"open loop: {len(tracked)} requests at {rate}/s over {seconds} s, "
        f"{failed} failed, generator at most {late * 1e3:.1f} ms late; "
        f"queue at close {sched.queue_len()}\n")
    if len(ttft) > 1 and len(tpot) > 1:
        sys.stderr.write(
            f"  TTFT p50 {stats.percentile(ttft, 50):.4f} p90 "
            f"{stats.percentile(ttft, 90):.4f} s; TPOT p50 "
            f"{stats.percentile(tpot, 50) * 1e3:.3f} p90 "
            f"{stats.percentile(tpot, 90) * 1e3:.3f} ms; TTFT mean "
            f"{stats.mean(ttft):.4f} s, TPOT mean "
            f"{stats.mean(tpot) * 1e3:.3f} ms\n")
    for kind in sorted({tr.item["kind"] for tr in done}):
        ks = [tr.token_times()[0] - tr.due for tr in done
              if tr.item["kind"] == kind and tr.token_times()]
        sys.stderr.write(f"  {kind}: {len(ks)} requests, TTFT p50 "
                         f"{stats.percentile(ks, 50):.3f} s, max "
                         f"{max(ks):.3f} s\n")

    out = {"attempted": len(tracked), "failed": failed, "device": device}
    if not ctx.trace:
        out["metrics"] = {
            "ttft_p90_s": stats.percentile(ttft, 90) if ttft else None,
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

    sched.close()
    del sched
    torch.cuda.empty_cache()
    cases = serving.sample_cases(done, w["check"]["sample"], seed)
    out["checks"] = serving.check(weights, cfgf, cases,
                                  w["check"]["max_gap"], ctx.control)
    return out
