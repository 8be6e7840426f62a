"""The traced window of a `--trace 1` run: a `torch.profiler` session over
the card (CUPTI kernel records), held a grace after a synchronize before it
stops so that late-stamped records land inside it, and the arithmetic on
its records: the busy union, kernel families and the longest idle gaps.

Kernel records carry start times on the host's wall clock (ns since the
epoch), the clock of `time.time_ns()` and of the engine's step timeline."""

from __future__ import annotations

import time
from collections import defaultdict

GRACE_S = 0.2

# Kernel families by name: the port's hand-written kernels by their CUDA
# function names (csrc/*.cu), the rest by the libraries' name patterns.
FAMILIES = (
    ("K5", ("flash_bwd_",)),
    ("K1", ("flash_fwd_", "flash_decode_")),
    ("K3/K4", ("paged_split", "paged_merge", "paged_f32")),
    ("q8", ("q8_small", "q8_large", "q8_f32")),
    ("cuBLAS GEMM", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "elementwise/other"


class TracedWindow:
    """start() / stop(): the profiler session; after stop, `kernels`
    [(name, start_ns, end_ns)] and the window [t0_ns, t1_ns]."""

    def __init__(self) -> None:
        self.prof = None
        self.kernels: list[tuple[str, int, int]] = []
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        import torch
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        time.sleep(GRACE_S)
        self.prof.stop()
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = int(e.start_ns())
            out.append((e.name(), s, s + int(e.duration_ns())))
        self.kernels = sorted(out, key=lambda k: k[1])
        self.prof = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def in_window(self) -> list[tuple[str, int, int]]:
        """Records clipped to the window (records wholly outside dropped)."""
        out = []
        for name, s, e in self.kernels:
            s2, e2 = max(s, self.t0_ns), min(e, self.t1_ns)
            if e2 > s2:
                out.append((name, s2, e2))
        return out


def busy_intervals(records) -> list[tuple[int, int]]:
    """The union of [start, end) intervals, merged and sorted."""
    merged: list[list[int]] = []
    for _, s, e in sorted(records, key=lambda r: r[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(records) -> float:
    return sum(e - s for s, e in busy_intervals(records)) / 1e9


def idle_gaps(records, t0: int, t1: int) -> list[tuple[int, int]]:
    """Gaps of the window [t0, t1) that no record covers, longest first."""
    gaps, cur = [], t0
    for s, e in busy_intervals(records):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if t1 > cur:
        gaps.append((cur, t1))
    return sorted(gaps, key=lambda g: g[0] - g[1])


def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces and
    template and call arguments."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    for cut in ("<", "("):
        n = n.split(cut, 1)[0]
    return n.rsplit("::", 1)[-1][:80]


def family_seconds(records) -> dict[str, float]:
    out: dict[str, float] = defaultdict(float)
    for name, s, e in records:
        out[family(name)] += (e - s) / 1e9
    return dict(out)


def top_ops(records, n: int = 10) -> list[list]:
    """The n device operations (by name, family-tagged) that took most
    time: [[name, seconds]]."""
    by: dict[str, float] = defaultdict(float)
    for name, s, e in records:
        by[f"{family(name)}: {short_name(name)}"] += (e - s) / 1e9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
