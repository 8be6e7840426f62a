"""Device-time attribution over profiler planes (port of the
trace-format-independent half of `oryx_tpu.utils.xplane`).

A capture is a list of planes -> lines -> events: on the card one plane a
device ("/device:GPU:<i>") whose lines are its CUDA streams ("Stream <id>"),
each event a kernel, copy or memset from CUPTI; on the host one plane
("/host:CPU") whose lines are threads ("Thread <tid>"), with the
`record_function` ranges of each thread on a line of their own
("Thread <tid> Modules": the enclosing spans, as XLA's module lines are).
`planes_from_kineto` builds them from a `torch.profiler` capture; the
helpers below (op totals, interval unions, window clips, the Chrome trace,
midpoint attribution) are the reference's, unchanged.

Timestamps: an event's absolute start is line.timestamp_ns +
event.offset_ps/1000. torch.profiler stamps events in unix-epoch
nanoseconds, the clock utils/trace.py anchors host spans to, which is what
lets attribute_device_time() join device time back onto host-side
dispatch/step spans.

The reference also decodes XLA's own `*.xplane.pb` files (a protobuf
reader); the port has no such file and does not carry that reader.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Event:
    name: str
    duration_ps: int
    offset_ps: int = 0  # start offset within the owning line


@dataclass
class Line:
    name: str
    events: list[Event] = field(default_factory=list)
    timestamp_ns: int = 0  # line start (unix epoch)


@dataclass
class Plane:
    name: str
    lines: list[Line] = field(default_factory=list)
    # Integer-valued plane stats (e.g. a profile_start_time in epoch ns,
    # the clock anchor a relative-timeline plane needs).
    stats: dict[str, int] = field(default_factory=dict)



def planes_from_kineto(events) -> list[Plane]:
    """Planes from a torch.profiler capture's kineto events
    (`prof.profiler.kineto_results.events()`): device events (kernels,
    copies, memsets) on "/device:GPU:<index>" with a line a stream, host
    events on "/host:CPU" with a line a thread and the user annotations of
    each thread on "Thread <tid> Modules". Each line's timestamp is its
    earliest event start (epoch ns); zero-length events are dropped."""
    from torch.autograd import DeviceType

    lines: dict[tuple[str, str], list] = {}
    for e in events:
        dur = int(e.duration_ns())
        if dur <= 0:
            continue
        if e.device_type() == DeviceType.CUDA:
            key = (f"/device:GPU:{e.device_index()}",
                   f"Stream {e.device_resource_id()}")
        else:
            tid = e.start_thread_id()
            key = ("/host:CPU", f"Thread {tid} Modules"
                   if e.is_user_annotation() else f"Thread {tid}")
        lines.setdefault(key, []).append(
            (int(e.start_ns()), dur, e.name()))
    planes: dict[str, Plane] = {}
    for (pname, lname), evs in sorted(lines.items()):
        t0 = min(s for s, _, _ in evs)
        line = Line(lname, [
            Event(name, dur * 1000, (s - t0) * 1000)
            for s, dur, name in sorted(evs)
        ], timestamp_ns=t0)
        planes.setdefault(pname, Plane(pname)).lines.append(line)
    return list(planes.values())


def op_totals(
    planes: list[Plane],
    plane_filter: str = "",
    line_filter: str = "",
) -> dict[str, int]:
    """Total duration_ps per event name over matching planes/lines.

    Device planes are named like '/device:GPU:0' with a line a stream;
    pass plane_filter='/device:GPU', line_filter='Stream' for a per-kernel
    device-time profile."""
    totals: dict[str, int] = {}
    for plane in planes:
        if plane_filter and plane_filter not in plane.name:
            continue
        for line in plane.lines:
            if line_filter and line_filter not in line.name:
                continue
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0) + ev.duration_ps
    return totals


def top_ops(
    planes: list[Plane], n: int = 25, **kw
) -> list[tuple[str, float]]:
    """Top-n (name, total_ms) by duration."""
    totals = op_totals(planes, **kw)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [(name, ps / 1e9) for name, ps in ranked]


# Line timestamps below this are clearly not unix-epoch ns (10**15 ns
# past 1970 is mid-2001; any real wall clock is ~1.7e18): such a
# timeline is relative to some process-local clock and needs aligning.
_EPOCH_THRESHOLD_NS = 10**15


def profile_start_time_ns(planes: list[Plane]) -> int:
    """Epoch-ns start of the profiler session, from a plane's
    profile_start_time stat (0 when absent). Relative line timestamps
    are offsets from this instant."""
    for plane in planes:
        if (t := plane.stats.get("profile_start_time", 0)):
            return t
    return 0


def _plane_shift_ns(plane: Plane, session_end_ns: int) -> int:
    """Fallback alignment shift for a relative-timeline plane in a
    file with no profile_start_time stat. Anchor on the trace END:
    every event a profiler session records ends at or before the stop,
    and the last one ends about AT it — so `session_end_ns - max(event
    end)` maps the plane's timeline onto the wall clock to within the
    stop's teardown latency (~ms)."""
    max_end = 0
    for line in plane.lines:
        for ev in line.events:
            end = line.timestamp_ns + (
                ev.offset_ps + ev.duration_ps
            ) // 1000
            max_end = max(max_end, end)
    return session_end_ns - max_end


def merge_intervals(
    intervals: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Sorted DISJOINT union of [start_ns, end_ns) intervals — busy
    time, not summed durations, so nested/overlapping events (host
    python stacks, fused op sub-events) can never count the same wall
    nanosecond twice."""
    if not intervals:
        return []
    intervals = sorted(intervals)
    out = [intervals[0]]
    for s, e in intervals[1:]:
        cs, ce = out[-1]
        if s > ce:
            out.append((s, e))
        elif e > ce:
            out[-1] = (cs, e)
    return out


def clipped_us(merged: list[tuple[int, int]], t0_ns: int,
               t1_ns: int) -> int:
    """Microseconds of already-merged intervals inside [t0, t1) — the
    per-window clip, O(len(merged)), run against one precomputed
    merge for any number of windows."""
    total = 0
    for s, e in merged:
        lo, hi = max(s, t0_ns), min(e, t1_ns)
        if hi > lo:
            total += hi - lo
    return total // 1000


def busiest_line_spans(
    planes: list[Plane],
    plane_filter: str = "",
    line_filter: str = "",
    line_exclude: str = "",
    session_end_ns: int = 0,
) -> list[tuple[int, int]]:
    """The merged busy intervals (epoch ns) of the BUSIEST matching
    line — precomputed ONCE per capture; per-window attribution is
    then a cheap clip (utils/profiling.attribute_capture runs up to
    hundreds of windows on the engine thread, so a per-window rescan
    of every event would stall the dispatch loop).

    One line = one execution stream (a CUDA stream, a host thread), so
    the per-line interval union is genuine busy time
    and an in-window clip can never exceed the window. Taking the
    busiest line (rather than summing lines) keeps the host-event
    fallback honest — host captures carry one line per python thread
    and summing them would charge idle threads' tracer overhead as
    device time. Clock alignment follows attribute_device_time: epoch
    timestamps pass through, relative planes anchor on the file's own
    profile_start_time stat, else on session_end_ns."""
    start_anchor = profile_start_time_ns(planes)
    best: list[tuple[int, int]] = []
    best_total = 0
    for plane in planes:
        if plane_filter and plane_filter not in plane.name:
            continue
        relative = any(
            line.timestamp_ns < _EPOCH_THRESHOLD_NS
            for line in plane.lines if line.events
        )
        shift = 0
        if relative:
            shift = start_anchor or _plane_shift_ns(
                plane, session_end_ns
            )
        for line in plane.lines:
            if line_filter and line_filter not in line.name:
                continue
            if line_exclude and line_exclude in line.name:
                continue
            base = line.timestamp_ns + shift
            merged = merge_intervals([
                (base + ev.offset_ps // 1000,
                 base + (ev.offset_ps + ev.duration_ps) // 1000)
                for ev in line.events
            ])
            total = sum(e - s for s, e in merged)
            if total > best_total:
                best, best_total = merged, total
    return best


def busy_time_us(
    planes: list[Plane],
    t0_ns: int,
    t1_ns: int,
    plane_filter: str = "",
    line_filter: str = "",
    line_exclude: str = "",
    session_end_ns: int = 0,
) -> tuple[int, int]:
    """(busy_us inside [t0_ns, t1_ns), busy_us over the whole capture)
    on the busiest matching line — the one-window convenience over
    busiest_line_spans (multi-window callers precompute the spans and
    clip per window instead)."""
    merged = busiest_line_spans(
        planes, plane_filter=plane_filter, line_filter=line_filter,
        line_exclude=line_exclude, session_end_ns=session_end_ns,
    )
    return (
        clipped_us(merged, t0_ns, t1_ns),
        sum(e - s for s, e in merged) // 1000,
    )


def chrome_trace(planes: list[Plane], limit: int = 50000) -> dict:
    """Chrome trace-event JSON from parsed planes — loads directly in
    Perfetto / chrome://tracing (the GET /debug/profile response body).
    Planes become processes, lines become threads (named via metadata
    events); timestamps are each line's own clock in microseconds.
    `limit` caps the event count so one capture can never produce an
    unbounded response; the cap is reported when it bites."""
    events: list[dict] = []
    truncated = False
    for pi, plane in enumerate(planes):
        events.append({
            "name": "process_name", "ph": "M", "pid": pi, "tid": 0,
            "args": {"name": plane.name or f"plane {pi}"},
        })
        for li, line in enumerate(plane.lines):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pi, "tid": li,
                "args": {"name": line.name or f"line {li}"},
            })
            base_us = line.timestamp_ns / 1e3
            for ev in line.events:
                if len(events) >= limit:
                    truncated = True
                    break
                events.append({
                    "name": ev.name, "ph": "X",
                    "ts": base_us + ev.offset_ps / 1e6,
                    "dur": max(ev.duration_ps / 1e6, 1e-3),
                    "pid": pi, "tid": li,
                })
            if truncated:
                break
        if truncated:
            break
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "truncated": truncated,
    }


def attribute_device_time(
    planes: list[Plane],
    windows: list[tuple[str, int, int]],
    plane_filter: str = "",
    line_filter: str = "",
    session_end_ns: int = 0,
) -> dict[str, int]:
    """Attribute device-event time onto host-side span windows.

    windows: (label, start_ns, end_ns) in unix-epoch ns — e.g. the
    decode-chunk / train-step spans a utils/trace.py flight recorder
    produced (trace.windows_from_traces). Each matching device event is
    credited, by its midpoint, to the window containing it; events
    outside every window land in "_unattributed". Returns
    label -> total duration_ps. Windows with zero matching events still
    appear (value 0), so a run whose clocks don't line up reads as
    all-unattributed instead of silently empty.

    Relative (non-epoch) line timestamps are offsets from the
    profiler-session start, which a plane may record (a
    profile_start_time stat) — that is the preferred anchor.
    session_end_ns (wall-clock ns at the profiler's stop;
    profiling.op_profile records it as OpProfile.trace_end_ns) is the
    fallback: the plane's last event end is anchored at it. Epoch-stamped
    planes (every torch.profiler plane) need no alignment.
    """
    totals: dict[str, int] = {label: 0 for label, _, _ in windows}
    totals["_unattributed"] = 0
    spans = sorted(windows, key=lambda w: w[1])
    start_anchor = profile_start_time_ns(planes)
    for plane in planes:
        if plane_filter and plane_filter not in plane.name:
            continue
        relative = any(
            line.timestamp_ns < _EPOCH_THRESHOLD_NS
            for line in plane.lines if line.events
        )
        shift = 0
        if relative:
            shift = start_anchor or _plane_shift_ns(
                plane, session_end_ns
            )
        for line in plane.lines:
            if line_filter and line_filter not in line.name:
                continue
            base = line.timestamp_ns + shift
            for ev in line.events:
                mid_ns = base + (
                    ev.offset_ps + ev.duration_ps // 2
                ) // 1000
                hits = [
                    label for label, t0, t1 in spans
                    if t0 <= mid_ns < t1
                ]
                if not hits:
                    totals["_unattributed"] += ev.duration_ps
                    continue
                # Overlapping windows split the credit: the scheduler
                # stamps one shared decode dispatch onto EVERY live
                # request, so identical windows are the normal case in
                # a live-recorder join — first-match-wins would hand
                # all device time to one request and 0 to the rest.
                share = ev.duration_ps // len(hits)
                for label in hits:
                    totals[label] += share
                totals[hits[0]] += ev.duration_ps - share * len(hits)
    return totals
