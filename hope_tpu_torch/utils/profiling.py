"""Trace capture, throughput counting and metrics logging (counterpart of
the training half of ``hope_tpu/utils/profiling.py``: ``trace``,
``annotate``, ``StepTimer`` and ``MetricsWriter``)."""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside the block with ``torch.profiler`` (the host's
    ops and ranges, and the card's kernels and copies where CUDA is
    available), written as a Chrome trace to ``<log_dir>/trace.json``
    (chrome://tracing, Perfetto). Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range that shows in the profiler's timeline."""
    return record_function(name)


@dataclass
class StepTimer:
    """Rolling throughput counter for training / rollout loops.

    >>> timer = StepTimer(unit="env-steps")
    >>> timer.tick(n=1024)   # after each batched step
    >>> timer.report()       # {"unit_per_sec": ..., "total": ...}
    """

    unit: str = "steps"
    window: int = 50
    _times: list = field(default_factory=list)
    _counts: list = field(default_factory=list)
    total: int = 0

    def tick(self, n: int = 1):
        self._times.append(time.perf_counter())
        self._counts.append(n)
        self.total += n
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._counts.pop(0)

    def report(self) -> Optional[dict]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        n = sum(self._counts[1:])
        return {"unit": self.unit, "unit_per_sec": n / dt if dt > 0 else None,
                "total": self.total}


class MetricsWriter:
    """``metrics.jsonl`` sink, mirrored to TensorBoard where
    ``torch.utils.tensorboard`` imports (best-effort: it needs the
    ``tensorboard`` package)."""

    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(log_dir)

    def write(self, step: int, scalars: dict):
        self._f.write(json.dumps({"step": step, **scalars}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
