"""Reduction of a `torch.profiler` window to what the per-layer metrics read.

Device activity is every CUDA event of the trace: kernels, copies and
sets.  Busy time is the length of the union of their intervals (the
arithmetic of the program's `eval/trace.py:_busy_us`, here over the whole
traced window).  The idle gaps between busy stretches are labelled
by the innermost host operation that was running at the gap's middle:
what the host was doing while the device waited.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

TOP = 10


def merged(intervals):
    """The union of [start, end) intervals as sorted disjoint stretches."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """device: [(start_ns, end_ns, name)]; host: [(start_ns, end_ns, name)]."""

    def __init__(self, device, host):
        self.device, self.host = device, host
        self.busy_ns = sum(e - s for s, e in merged((s, e) for s, e, _ in device))
        by_name = defaultdict(lambda: [0, 0])
        for s, e, name in device:
            by_name[name][0] += 1
            by_name[name][1] += e - s
        self.by_name = dict(by_name)

    @classmethod
    def from_profiler(cls, prof):
        from torch.autograd import DeviceType

        device, host = [], []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns()
            item = (s, s + ev.duration_ns(), ev.name())
            (device if ev.device_type() == DeviceType.CUDA else host).append(item)
        return cls(device, host)

    def kernel_ns(self, patterns) -> int:
        """Device time of the operations whose names hold any pattern."""
        return sum(ns for name, (_, ns) in self.by_name.items()
                   if any(p in name for p in patterns))

    def top_ops(self, n: int = TOP):
        """[[name, seconds]] of the operations with the most device time."""
        ranked = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:n]
        return [[name[:64], ns / 1e9] for name, (_, ns) in ranked]

    def idle_gaps(self, n: int = TOP):
        """[[host op, seconds]] of the longest idle gaps between busy
        stretches, each named by the innermost host operation under it
        ('host' where none was running)."""
        spans = merged((s, e) for s, e, _ in self.device)
        gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2)
                       for a, b in zip(spans, spans[1:]) if b[0] > a[1]),
                      reverse=True)[:n]
        host = sorted(self.host)
        starts = [s for s, _, _ in host]
        out = []
        for length, mid in gaps:
            label, best = "host", None
            for s, e, name in host[:bisect_right(starts, mid)]:
                if e > mid and (best is None or e - s < best):
                    label, best = name, e - s
            out.append([label[:64], length / 1e9])
        return out
