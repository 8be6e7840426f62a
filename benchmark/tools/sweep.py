"""The knee of an open-loop serving cell: one engine, set up once, offered
each rate in turn for --seconds; for each, the queue depth through the
window, the TTFT of each quarter of the requests and the time to drain.
The knee is the highest rate whose queue does not grow over the window.

    python3 benchmark/tools/sweep.py --workload oryx-7b.video-qa \
        --rates 2 3 4 5 --seconds 30 --seed 7
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.drivers import serving  # noqa: E402
from benchmark.drivers.serve_open import warm_specs  # noqa: E402
from benchmark.harness import spec, stats  # noqa: E402
from benchmark.traffic import mix  # noqa: E402


def offer(sched, t: dict, rate: float, seconds: float, seed: int) -> dict:
    n = max(1, round(rate * seconds))
    items = mix.materialize(mix.specs(t, n), seed)
    due = mix.arrivals(n, rate, seconds, mix.rng(seed, 3))
    t0 = time.perf_counter()
    tracked = [serving.Tracked(it, t0 + float(d)) for it, d in zip(items, due)]
    depth = []
    marks = [t0 + seconds * q for q in (0.25, 0.5, 0.75, 1.0)]
    for tr in tracked:
        while marks and marks[0] <= tr.due:
            time.sleep(max(0.0, marks[0] - time.perf_counter()))
            depth.append(sched.queue_len())
            marks.pop(0)
        time.sleep(max(0.0, tr.due - time.perf_counter()))
        serving.submit(sched, tr)
    for m in marks:
        time.sleep(max(0.0, m - time.perf_counter()))
        depth.append(sched.queue_len())
    serving.wait_all(tracked, t0 + seconds + 120)
    drain = max((tr.token_times()[-1] for tr in tracked if tr.token_times()),
                default=t0) - (t0 + seconds)
    ttft = [tr.token_times()[0] - tr.due if tr.token_times() else None
            for tr in tracked]
    q = len(tracked) // 4 or 1
    quarters = [[x for x in ttft[i * q:(i + 1) * q] if x is not None]
                for i in range(4)]
    return {
        "rate": rate, "requests": n,
        "failed": sum(1 for tr in tracked if not tr.ok),
        "queue_at_quarters": depth,
        "ttft_p50_by_quarter": [stats.percentile(x, 50) if x else None
                                for x in quarters],
        "ttft_p90": stats.percentile([x for x in ttft if x is not None], 90),
        "drain_s": drain,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="oryx-7b.video-qa")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    w = spec.workload(args.workload)
    cfgf = spec.config(w["config"])
    t = w["traffic"]
    sched, _, _ = serving.build_engine(cfgf, w["engine"], args.seed,
                                       timeline_cap=1 << 16)
    specs = mix.specs(t, 45)
    serving.warm(sched, mix.materialize(warm_specs(specs), args.seed + 1))
    for i, rate in enumerate(args.rates):
        res = offer(sched, t, rate, args.seconds, args.seed + 100 + i)
        print(json.dumps(res), flush=True)
    sched.close()


if __name__ == "__main__":
    main()
