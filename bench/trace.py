"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics and
the result's ``device`` and ``breakdown`` read.

:func:`profiled` runs a slice of the cell's own work under the profiler,
the card synchronised at both ends, and returns a :class:`Trace`: every
device activity (kernels, copies, sets) as ``(name, start_s, end_s)``, the
host's operations and ranges, and the slice's length on the host clock.
"""
from __future__ import annotations

import time
from collections import defaultdict


def _ns(event, start: bool) -> float:
    if start:
        return float(event.start_ns())
    if hasattr(event, "end_ns"):
        return float(event.end_ns())
    return float(event.start_ns() + event.duration_ns())


def _annotation(event) -> bool:
    """A ``record_function`` range mirrored on the device's timeline: not
    device work."""
    if hasattr(event, "is_user_annotation") and event.is_user_annotation():
        return True
    return "annotation" in str(getattr(event, "activity_type", lambda: "")())


class Trace:
    def __init__(self, device_events, host_events, window_s: float):
        self.device = sorted(device_events, key=lambda e: e[1])
        self.host = host_events
        self.window_s = window_s

    def kernels(self, names):
        """``(start_s, end_s)`` of every device activity whose name holds
        one of ``names``."""
        return [(s, e) for n, s, e in self.device if any(k in n for k in names)]

    def busy_intervals(self):
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for n, s, e in self.device:
            by_name[n] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                      reverse=True)[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[self._host_at(a, b), g] for g, a, b in gaps]}

    def _host_at(self, start: float, end: float) -> str:
        """The innermost host operation that spans the whole gap, or else
        the one that took most of the gap's time (many short operations:
        eager dispatch, or a graph being captured)."""
        spans, inside = None, defaultdict(float)
        for n, s, e in self.host:
            if s <= start and e >= end:
                if spans is None or e - s < spans[2] - spans[1]:
                    spans = (n, s, e)
            elif e > start and s < end:
                inside[n] += min(e, end) - max(s, start)
        if spans is not None:
            return spans[0][:200]
        if inside:
            return ("within the gap: " + max(inside, key=inside.get))[:200]
        return "no host operation"


def profiled(work, device_type: str) -> Trace:
    """Run ``work()`` under ``torch.profiler`` and reduce its events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device_type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        work()
        if device_type == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        row = (ev.name(), _ns(ev, True) * 1e-9, _ns(ev, False) * 1e-9)
        if ev.device_type() == DeviceType.CPU:
            host.append(row)
        elif not _annotation(ev):
            dev.append(row)
    return Trace(dev, host, window_s)
