"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
units of the window (the host's ops and ranges, the card's kernels and
copies), reduced to what the per-layer readers and the result line need.

Device busy time is the sum of the durations of the card's activities (one
stream: they do not overlap), as ``chip_smoke.py`` sums it; the window is
the wall time from the profiler's start to a synchronize at its end. An
idle gap is the time between the end of one device activity and the start
of the next, named by the innermost host range open at its start.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    units: int                                   # units of work traced
    kernels: dict = field(default_factory=dict)  # name -> (count, seconds)
    spans: dict = field(default_factory=dict)    # range name -> (count, host seconds)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, *needles: str):
        """(calls, seconds) of the device activities whose name holds any of
        ``needles``; (0, 0.0) where none ran."""
        n, s = 0, 0.0
        for name, (c, t) in self.kernels.items():
            if any(x in name for x in needles):
                n, s = n + c, s + t
        return n, s


class Tracer:
    """``start()`` / ``stop(units)`` around the traced units; inactive (both
    no-ops, ``summary`` None) unless ``active``."""

    def __init__(self, active: bool, device=None):
        self.active = active
        self.cuda = device is None or torch.device(device).type == "cuda"
        self.summary: TraceSummary | None = None
        self._prof = None

    def start(self):
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: int):
        if not self.active or self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.summary = reduce_events(self._prof.events(), wall, units)
        self._prof = None


def reduce_events(events, window_s: float, units: int, top: int = 10) -> TraceSummary:
    """Kernel times by name, host ranges by name, the busiest device ops and
    the longest idle gaps of one profiler pass."""
    dev_type = torch.autograd.DeviceType.CUDA
    host_names = {e.name for e in events if e.device_type != dev_type}
    kern, ranges = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == dev_type:
            # a host range's image on the device's timeline is no device work
            if not getattr(e, "is_user_annotation", False) and e.name not in host_names:
                kern.append((tr.start, tr.end, e.name))
        elif "/" in e.name or e.name.startswith("Optimizer."):
            ranges.append((tr.start, tr.end, e.name))
    kernels, spans = {}, {}
    for s, t, name in kern:
        c, d = kernels.get(name, (0, 0.0))
        kernels[name] = (c + 1, d + (t - s) / 1e6)
    for s, t, name in ranges:
        c, d = spans.get(name, (0, 0.0))
        spans[name] = (c + 1, d + (t - s) / 1e6)
    busy = sum(d for _, d in kernels.values())
    device_ops = sorted(([n, d] for n, (_, d) in kernels.items()), key=lambda x: -x[1])[:top]
    return TraceSummary(window_s=window_s, busy_s=busy, units=units, kernels=kernels,
                        spans=spans, device_ops=device_ops,
                        idle_gaps=idle_gaps(kern, ranges, top))


def idle_gaps(kern: list, ranges: list, top: int = 10) -> list:
    """The ``top`` longest gaps between device activities, in seconds, each
    named by the innermost host range (shortest) open at the gap's start, or
    "host" where none is."""
    kern = sorted(kern)
    gaps, end = [], None
    for s, t, _ in kern:
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = t if end is None else max(end, t)
    gaps.sort(reverse=True)
    out = []
    for length, at in gaps[:top]:
        open_ = [(t - s, name) for s, t, name in ranges if s <= at <= t]
        out.append([min(open_)[1] if open_ else "host", length / 1e6])
    return out
