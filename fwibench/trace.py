"""The traced window: one ``torch.profiler`` window over whole
evaluations, reduced to device busy time (the union of kernel intervals:
programmatic dependent launches and side streams make kernel spans
overlap, so sums over-read), the kernel count, the kernels that took most
time, and the idle gaps named by what the host was doing."""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

TOP = 10
NAME_CHARS = 160


@dataclasses.dataclass
class Summary:
    window_s: float  # the traced window, host clock
    busy_s: float  # union of kernel intervals inside it
    kernels: int
    device_ops: list  # [[name, seconds], ...] by summed kernel time
    idle_gaps: list  # [[host activity, seconds], ...] by summed gap time


def union(intervals) -> list:
    """Merged (start, end) of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clip(merged, lo, hi) -> list:
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def gaps(merged, lo, hi) -> list:
    """Idle (start, end) of the window [lo, hi] between merged busy spans."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(gap_list, host, limit: int = 400) -> list:
    """Seconds of idle time by the innermost host activity that spans each
    gap's middle (the ``limit`` longest gaps; the rest summed as
    "(shorter gaps)"). ``host``: (names, starts, ends) in ns."""
    names, starts, ends = host
    by = defaultdict(float)
    ordered = sorted(gap_list, key=lambda g: g[0] - g[1])
    for s, e in ordered[:limit]:
        mid = 0.5 * (s + e)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        if inside.size:
            k = inside[np.argmin(ends[inside] - starts[inside])]
            by[names[k]] += (e - s) * 1e-9
        else:
            by["(no host activity)"] += (e - s) * 1e-9
    rest = sum(e - s for s, e in ordered[limit:]) * 1e-9
    if rest:
        by["(shorter gaps)"] += rest
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(kernels, host, lo: float, hi: float) -> Summary:
    """``kernels``: [(name, start_ns, end_ns)] on the device; ``host``:
    [(name, start_ns, end_ns)] on the host; [lo, hi] the window in ns."""
    inside = [(n, s, e) for n, s, e in kernels if e > lo and s < hi]
    merged = clip(union([(s, e) for _, s, e in inside]), lo, hi)
    busy = sum(e - s for s, e in merged) * 1e-9
    per = defaultdict(float)
    for n, s, e in inside:
        per[n[:NAME_CHARS]] += (min(e, hi) - max(s, lo)) * 1e-9
    ops = [[k, v] for k, v in sorted(per.items(), key=lambda kv: -kv[1])[:TOP]]
    h = [(n, s, e) for n, s, e in host if e > lo and s < hi]
    arrays = (np.array([n[:NAME_CHARS] for n, _, _ in h], dtype=object),
              np.array([s for _, s, _ in h], dtype=np.float64),
              np.array([e for _, _, e in h], dtype=np.float64))
    return Summary(window_s=(hi - lo) * 1e-9, busy_s=busy, kernels=len(inside),
                   device_ops=ops, idle_gaps=name_gaps(gaps(merged, lo, hi), arrays))


def events(prof):
    """(device kernels, host activities, window) from a stopped profiler:
    each [(name, start_ns, end_ns)], the window the "fwibench.window"
    range spans. Copies and memsets are not kernels."""
    from torch.autograd import DeviceType

    kernels, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name, s = ev.name(), ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            # the device-side copies of the harness's ranges are not kernels
            if not name.startswith(("Memcpy", "Memset", "fwibench.")):
                kernels.append((name, s, e))
        else:
            if name == "fwibench.window":
                window = (s, e)
            host.append((name, s, e))
    return kernels, host, window


class Tracer:
    """Profiles one stretch of a run: ``start()``, the work inside
    ``window()``, ``stop()`` (after the device is idle), then ``summary``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.summary = None

    def start(self):
        self.prof.start()

    def window(self):
        from torch.profiler import record_function

        return record_function("fwibench.window")

    def stop(self):
        self.prof.stop()
        kernels, host, window = events(self.prof)
        if window is None:
            raise RuntimeError("the traced window's range is missing from the trace")
        self.summary = summarize(kernels, host, *window)
        return self.summary
