"""Profiling: torch.profiler glue, per-dispatch device time and a step
timer (port of `oryx_tpu.utils.profiling`).

Captures run `torch.profiler` over CUPTI on the card (CUDA activity: every
kernel, copy and memset with its stream) and over the host's own tracer on
a CPU-only engine, and utils/xplane.py turns them into planes. The
serving engine's `DeviceTimeSampler` brackets every Nth dispatch in one
capture and credits the kernels' busy time inside the dispatch's window to
`oryx_device_time_seconds_total{kind=}`; `GET /debug/profile?steps=K` is
the same machinery over K dispatches, answered with a Chrome trace.

The reference's `start_server` (jax's remote profiler server) has no
counterpart: the port's on-demand capture is /debug/profile.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Iterator

import torch

from oryx_tpu_torch.ops.cuda import graphs
from oryx_tpu_torch.utils import trace as trace_lib
from oryx_tpu_torch.utils import xplane

# The device planes and their stream lines (utils/xplane.planes_from_kineto).
DEVICE_PLANE = "/device:GPU"
DEVICE_LINE = "Stream"


def _activities(device) -> list:
    """CUDA activity on the card (CUPTI: device events and the runtime
    calls that launched them), CPU activity on a CPU-only engine."""
    from torch.profiler import ProfilerActivity

    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def _start_trace(device):
    """A started torch.profiler session for `device`; the one helper every
    capture path (op_profile, the DeviceTimeSampler) shares. A session
    starts and stops while no CUDA graph is being captured: both act on
    the whole device, and another engine's capture may be open
    (ops/cuda/graphs.no_capture)."""
    prof = torch.profiler.profile(activities=_activities(device))
    with graphs.no_capture():
        prof.start()
    return prof


def _stop(prof) -> None:
    """Stop a session that `_start_trace` started."""
    with graphs.no_capture():
        prof.stop()


def _stop_trace(prof) -> list[xplane.Plane]:
    """Stop a session and return its planes."""
    _stop(prof)
    return xplane.planes_from_kineto(prof.profiler.kineto_results.events())


@contextlib.contextmanager
def trace(logdir: str, *, device="cuda") -> Iterator[None]:
    """Capture a trace viewable in Perfetto/chrome://tracing: the host and,
    on the card, the device, written to `logdir`/trace.json."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Context manager naming a region in the profiler timeline (a
    record_function range). Wrap the host dispatch of model phases (vit /
    compressor / decoder / data)."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class OpProfile:
    """Result of op_profile: ranked (name, total_ms) plus provenance —
    `source` tells device kernel time ("gpu_kernels") from the host-event
    fallback ("host_fallback"), which measures python/dispatch and must
    never be mistaken for device time when optimizing."""

    top: list[tuple[str, float]]
    source: str
    trace_path: str
    plane_names: list[str]
    # Wall-clock ns bracketing the profiler session (the join of host
    # spans to device events reads them).
    trace_start_ns: int = 0
    trace_end_ns: int = 0


def op_profile(fn, *args, trace_dir: str, steps: int = 3, top_n: int = 25,
               sync=None, device="cuda") -> OpProfile:
    """Run `fn(*args)` `steps` times under a capture and return the top ops
    by total device time (each kernel name summed over the card's stream
    lines); on a CPU-only engine the host events (annotations excluded),
    flagged by `.source`. The capture is written to `trace_dir`/trace.json.

    fn should be warm (graphs captured, kernels built) before the call.
    `sync` receives the last result and must wait for it (default:
    torch.cuda.synchronize on the card)."""
    if sync is None:
        def sync(_out):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
    os.makedirs(trace_dir, exist_ok=True)
    prof = _start_trace(device)
    t_start = trace_lib.now_ns()
    out = None
    for _ in range(steps):
        out = fn(*args)
    sync(out)
    t_end = trace_lib.now_ns()
    planes = _stop_trace(prof)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    names = [p.name for p in planes]
    device_top = xplane.top_ops(
        planes, n=top_n, plane_filter=DEVICE_PLANE, line_filter=DEVICE_LINE
    )
    if device_top:
        return OpProfile(device_top, "gpu_kernels", path, names, t_start,
                         t_end)
    host = [
        xplane.Plane(p.name, [ln for ln in p.lines
                              if "Modules" not in ln.name])
        for p in planes
    ]
    return OpProfile(xplane.top_ops(host, n=top_n), "host_fallback", path,
                     names, t_start, t_end)


# ---------------------------------------------------------------------------
# Continuous device-time attribution
# ---------------------------------------------------------------------------

# The dispatch kinds the serving engine emits (utils/timeline.py) plus the
# "other" bucket for capture time outside every window.
DISPATCH_KINDS = ("ragged", "spec", "prefill", "decode", "other")

# Seconds an on-demand capture on the card stays open after its last
# dispatch's kernels are done. CUPTI stamps some kernel records of CUDA
# graph replays after the host has seen those kernels finish (by up to
# milliseconds), and the profiler drops every record stamped past the
# session's stop. On an H100 a capture stopped at once lost 1-56 of its
# 896 K4 records in 7 of 26 runs; held open 0.2 s it lost none in 8, and
# 1 s none in 16 (scripts/torch_capture_check.py; PERF.md §6). The wait
# runs on the engine thread: every on-demand capture on the card holds
# serving this long after its last dispatch. A periodic sample stops at
# once, so it may miss such late records of a graph-replay dispatch and
# undercount that dispatch's device time (PERF.md §6 counts them).
CAPTURE_GRACE_S = 0.2


def attribute_capture(planes, windows: list[tuple[str, int, int]],
                      session_end_ns: int = 0) -> dict:
    """Attribution of one capture onto labeled host windows: per-label busy
    microseconds (interval union on the busiest stream, clipped per window,
    so in-window time never exceeds the window), plus "other" (busy time
    outside every window) and the provenance source. Device planes are
    preferred ("gpu_kernels"); without them the host-event fallback
    measures python/dispatch time with the annotation ('Modules') lines
    excluded ("host_fallback")."""
    spans = xplane.busiest_line_spans(
        planes, plane_filter=DEVICE_PLANE, line_filter=DEVICE_LINE,
        session_end_ns=session_end_ns,
    )
    source = "gpu_kernels"
    if not spans:
        spans = xplane.busiest_line_spans(
            planes, line_exclude="Modules", session_end_ns=session_end_ns,
        )
        source = "host_fallback"
    out: dict = {"by_kind_us": {}, "other_us": 0, "source": source}
    windowed = 0
    for label, t0, t1 in windows:
        busy = xplane.clipped_us(spans, t0, t1)
        out["by_kind_us"][label] = out["by_kind_us"].get(label, 0) + busy
        windowed += busy
    total_busy = sum(e - s for s, e in spans) // 1000
    out["other_us"] = max(0, total_busy - windowed)
    return out


class DeviceTimeSampler:
    """Always-on sampled device-time attributor for the serving engine.

    Every N engine steps (``every``; 0 = off) the scheduler brackets ONE
    dispatch in a torch.profiler capture, and the capture's busy time
    inside the dispatch window lands on
    ``oryx_device_time_seconds_total{kind=}`` (busy time outside it on
    kind="other") with the sampled window on
    ``oryx_profile_sampled_wall_seconds_total{kind=}``, so device/wall per
    kind is a ratio of two counters scraped together. The same begin/finish
    machinery serves the on-demand ``GET /debug/profile?steps=K`` capture.

    Failure contract: a capture that cannot start, stop, parse or
    attribute increments ``oryx_profile_capture_errors_total{stage=}`` and
    the engine step proceeds unprofiled; sampling may lose a sample, never
    a token. A capture observes the dispatch and never changes its
    tokens; an on-demand capture on the card delays the next dispatch by
    CAPTURE_GRACE_S (the engine thread waits before the stop), and a
    periodic sample of a graph replay may undercount its device time
    (see CAPTURE_GRACE_S).

    Engine-thread-owned; the profiler is process-global, so a concurrent
    capture elsewhere in the process surfaces as a counted stage="start"
    error, not a crash. `device`: the engine's device (CUDA activity on
    the card, the host tracer otherwise)."""

    def __init__(self, registry=None, *, every: int = 0, device="cpu"):
        self.every = max(0, int(every))
        self.device = torch.device(device)
        self._step = 0  # thread-owned: engine
        self._prof = None  # thread-owned: engine
        self._dev = self._wall = self._errs = self._caps = None
        if registry is not None:
            self._dev = registry.counter(
                "oryx_device_time_seconds_total", ("kind",), raw_name=True,
            )
            self._wall = registry.counter(
                "oryx_profile_sampled_wall_seconds_total", ("kind",),
                raw_name=True,
            )
            self._errs = registry.counter(
                "oryx_profile_capture_errors_total", ("stage",),
                raw_name=True,
            )
            self._caps = registry.counter(
                "oryx_profile_captures_total", raw_name=True
            )

    def _err(self, stage: str) -> None:
        if self._errs is not None:
            self._errs.labels(stage=stage).inc()

    def tick(self) -> bool:
        """Advance the engine-step counter; True when THIS step is due a
        sample (every Nth step; never with every=0)."""
        self._step += 1
        return self.every > 0 and self._step % self.every == 0

    def begin(self) -> bool:
        """Start one capture. False (with the labeled error counted) when
        the profiler cannot start: callers then run the step
        unprofiled."""
        try:
            self._prof = _start_trace(self.device)
        except Exception:
            self._err("start")
            self._prof = None
            return False
        return True

    def abort(self) -> None:
        """Discard an in-flight capture (the dispatch-failure path): stop
        the process-global profiler if this sampler started it, reporting
        nothing, so later captures can start."""
        prof, self._prof = self._prof, None
        if prof is None:
            return
        try:
            _stop(prof)
        except Exception:
            self._err("stop")

    def _stop_and_parse(self, grace_s: float = 0.0):
        """Stop the in-flight capture `grace_s` after now (the engine idle
        meanwhile) and build its planes; returns (planes, session_end_ns)
        or None with the stage counted."""
        prof, self._prof = self._prof, None
        try:
            time.sleep(grace_s)
            _stop(prof)
            end_ns = trace_lib.now_ns()
        except Exception:
            self._err("stop")
            return None
        try:
            planes = xplane.planes_from_kineto(
                prof.profiler.kineto_results.events())
        except Exception:
            self._err("parse")
            return None
        return planes, end_ns

    def _credit(self, att: dict, windows) -> None:
        if self._dev is None:
            return
        for kind, us in att["by_kind_us"].items():
            if us:
                self._dev.labels(kind=kind).inc(us / 1e6)
        if att["other_us"]:
            self._dev.labels(kind="other").inc(att["other_us"] / 1e6)
        for kind, t0, t1 in windows:
            self._wall.labels(kind=kind).inc(max(0, t1 - t0) / 1e9)
        if self._caps is not None:
            self._caps.inc()

    def end(self, kind: str, t0_ns: int, t1_ns: int) -> int | None:
        """Close a per-step sample around one dispatch window: counters
        fed; returns the window's device microseconds (the timeline
        record's device_us) or None on a counted failure."""
        parsed = self._stop_and_parse()
        if parsed is None:
            return None
        planes, end_ns = parsed
        try:
            att = attribute_capture(
                planes, [(kind, t0_ns, t1_ns)], session_end_ns=end_ns
            )
        except Exception:
            self._err("attribute")
            return None
        self._credit(att, [(kind, t0_ns, t1_ns)])
        return att["by_kind_us"].get(kind, 0)

    def finish_capture(self, windows: list[tuple[str, int, int]]) -> dict:
        """Close an on-demand multi-step capture: the /debug/profile body, a
        Chrome trace plus per-kind attribution over the captured dispatch
        windows. Errors come back as {"error": ...} (and the stage
        counter), never raised into the engine loop. On the card the
        capture stays open CAPTURE_GRACE_S past the last window, so that
        it keeps every kernel record of the captured dispatches."""
        parsed = self._stop_and_parse(
            CAPTURE_GRACE_S if self.device.type == "cuda" else 0.0)
        if parsed is None:
            return {"error": "profile capture failed (see "
                    "oryx_profile_capture_errors_total)"}
        planes, end_ns = parsed
        try:
            att = attribute_capture(planes, windows, session_end_ns=end_ns)
            body = xplane.chrome_trace(planes)
        except Exception as e:
            self._err("attribute")
            return {"error": f"profile attribution failed: "
                    f"{type(e).__name__}: {e}"}
        self._credit(att, windows)
        body["steps"] = len(windows)
        body["device_time_us"] = att["by_kind_us"]
        body["other_us"] = att["other_us"]
        body["source"] = att["source"]
        return body


class StepTimer:
    """Rolling wall-clock step stats: step time and tokens/sec/chip.

    Call `tick(num_tokens)` once per optimizer step AFTER the host has
    synchronized on the step's results (an unsynced tick measures only the
    launches).
    """

    def __init__(self, window: int = 20, n_chips: int | None = None) -> None:
        self.window = window
        self.n_chips = n_chips or max(1, torch.cuda.device_count())
        self._times: list[float] = []
        self._tokens: list[int] = []
        self._last: float | None = None

    def tick(self, num_tokens: int) -> dict[str, float] | None:
        """Record a step boundary; returns rolling stats (None on the first
        tick, which only arms the timer)."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._times.append(dt)
        self._tokens.append(num_tokens)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._tokens.pop(0)
        total_t = sum(self._times)
        total_tok = sum(self._tokens)
        return {
            "step_time_s": dt,
            "step_time_avg_s": total_t / len(self._times),
            "tokens_per_sec": total_tok / total_t,
            "tokens_per_sec_per_chip": total_tok / total_t / self.n_chips,
        }
