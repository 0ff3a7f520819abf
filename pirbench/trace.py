"""The benchmark's spans and the device's trace, on one clock.

Spans are the benchmark's own, around its calls into the program: each is
timed by the host clock (any thread) and also opened as a
`record_function` of the same name, so that it shows in a profiler
trace. A traced window runs under torch.profiler; the device's kernels,
copies and memsets are read from it and moved onto the host clock by the
window span, whose start and end both clocks record. All times here are
microseconds from the window's start.
"""

from __future__ import annotations

import bisect
import contextlib
import time

SPAN_PREFIX = "pirbench."
WINDOW = SPAN_PREFIX + "window"
COPY_PREFIXES = ("Memcpy", "Memset")


class Spans:
    """The window's spans: (start, end) in host seconds, name, queries in the call."""

    def __init__(self):
        self.rows: list[tuple[float, float, str, int]] = []

    @contextlib.contextmanager
    def span(self, name: str, queries: int = 1):
        from torch.profiler import record_function

        with record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.rows.append((t0, time.perf_counter(), name, queries))


@contextlib.contextmanager
def window(spans: Spans, trace: bool, cuda: bool):
    """The measured window, under torch.profiler when `trace`; yields a
    dict that holds, after the block, "start" and "end" (host seconds) and,
    traced, "device": the device's (start_us, end_us, name) from the
    window's start."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: dict = {}
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities) if trace else contextlib.nullcontext()
    with prof:
        with record_function(WINDOW):
            out["start"] = time.perf_counter()
            yield out
            if cuda:
                import torch

                torch.cuda.synchronize()
            out["end"] = time.perf_counter()
    if trace:
        out["device"] = device_events(prof, out["start"], out["end"])


def device_events(prof, host_start: float, host_end: float) -> list[tuple[float, float, str, float | None]]:
    """The device's events of a profile: (start, end, name, launch) in
    microseconds from host_start, where launch is when the host launched
    the event (its runtime call, matched by correlation id), or None.
    Mapped through the window span's start and end on both clocks. Read
    from the profiler's raw events: building its Python event tree takes
    minutes for a window of some 10^5 operations."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    anchor = [e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU]
    if not anchor:
        return []
    p0 = anchor[0].start_ns()
    p1 = p0 + anchor[0].duration_ns()
    scale = (host_end - host_start) * 1e9 / (p1 - p0) if p1 > p0 else 1.0

    def us(ns: int) -> float:
        return (ns - p0) * scale / 1e3

    launches = {e.correlation_id(): us(e.start_ns()) for e in events
                if e.device_type() == DeviceType.CPU and e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    out = []
    for e in events:
        # the spans' own ranges show on the device's timeline too, as annotations
        if e.device_type() != DeviceType.CUDA or e.name().startswith(SPAN_PREFIX):
            continue
        start = us(e.start_ns())
        out.append((start, start + e.duration_ns() * scale / 1e3, e.name(), launches.get(e.correlation_id())))
    return sorted(out, key=lambda x: x[:2])


def is_copy(name: str) -> bool:
    return name.startswith(COPY_PREFIXES)


def merged(intervals, w0: float, w1: float) -> list[list[float]]:
    """The union of (start, end) intervals, clipped to [w0, w1]."""
    out: list[list[float]] = []
    for start, end in sorted((max(a, w0), min(b, w1)) for a, b in intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _overlapping(spans: list, starts: list[float], t0: float, t1: float) -> range:
    """Indices of the sorted, non-overlapping spans that overlap (t0, t1)."""
    first = max(0, bisect.bisect_right(starts, t0) - 1)
    return range(first, bisect.bisect_left(starts, t1))


def device_ms_by_span(spans: list[tuple[float, float]], events: list[tuple]) -> list[float]:
    """Device ms of the events each span launched (spans as (start, end)
    microseconds, sorted and not overlapping; events as (start, end,
    launch)). An event belongs to the span in which the host launched it;
    one whose launch the trace does not give belongs to the span it
    overlaps most, even where it ends after the span (the trace aligns the
    device's clock to the host's only to some microseconds). An event in
    no span is in none."""
    starts = [s0 for s0, _ in spans]
    sums = [0.0] * len(spans)
    for c0, c1, launch in events:
        best = None
        if launch is not None:
            i = bisect.bisect_right(starts, launch) - 1
            best = i if i >= 0 and launch <= spans[i][1] else None
        else:
            most = 0.0
            for i in _overlapping(spans, starts, c0, c1):
                overlap = min(c1, spans[i][1]) - max(c0, spans[i][0])
                if overlap > most:
                    best, most = i, overlap
        if best is not None:
            sums[best] += c1 - c0
    return [s / 1e3 for s in sums]


def idle_gaps(spans: list[tuple[float, float, str]], busy: list[list[float]], w0: float, w1: float):
    """The device's idle intervals in [w0, w1], each as (us, label): the
    span the host spent most of that interval in, or "host between spans"
    (spans sorted and not overlapping)."""
    starts = [s0 for s0, _, _ in spans]
    edges = [w0] + [x for interval in busy for x in interval] + [w1]
    out = []
    for g0, g1 in ((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)):
        if g1 <= g0:
            continue
        parts: dict[str, float] = {}
        for i in _overlapping(spans, starts, g0, g1):
            s0, s1, name = spans[i]
            inside = min(g1, s1) - max(g0, s0)
            if inside > 0:
                parts[name] = parts.get(name, 0.0) + inside
        outside = (g1 - g0) - sum(parts.values())
        if outside > 0:
            parts["host between spans"] = outside
        out.append((g1 - g0, max(parts, key=parts.get)))
    return out
