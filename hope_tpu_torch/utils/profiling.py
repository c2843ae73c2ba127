"""Trace capture, named ranges and counters on the profiler's clock,
throughput counting and metrics logging (counterpart of
``hope_tpu/utils/profiling.py``: ``trace``, ``annotate``, ``StepTimer`` and
``MetricsWriter``).

Ranges and counters cost one flag check when no profiler records: the
program opens them on every control step, and ``torch.profiler`` (the
benchmark's traced pass, ``train_sac --profile-chunks``, ``chip_smoke.py``)
turns them on for as long as it records. The ranges land on the profiler's
timeline beside the card's kernels, so a gap on the card is named by the
range the host was in.

The JAX package's compile cache (``hope_tpu/utils/cache.py``) has no
counterpart here: nothing is traced or compiled per call, and the CUDA
kernels' build cache is ``ops/_build.py``'s ``build/`` directory.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
# counter name -> the values counted since the last reset: host ints, and
# device tensors kept as given until ``counters`` sums them or, once _FOLD of
# them are pending, ``_fold`` adds them up on their device (two launches every
# _FOLD counts, no sync), so a long profiled run holds a bounded few
_counts: dict = {}
_FOLD = 64


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace what runs inside the block with ``torch.profiler`` (the host's
    ops and ranges, and the card's kernels and copies where CUDA is
    available), written as a Chrome trace to ``<log_dir>/trace.json``
    (chrome://tracing, Perfetto), and the block's counters to
    ``<log_dir>/counters.json``. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_counters()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counters(), f, indent=1)


def annotate(name: str):
    """A named range on the profiler's timeline while a profiler records;
    a shared null context otherwise."""
    return record_function(name) if _recording() else _OFF


def annotated(name: str):
    """Decorator: every call of the function runs inside ``annotate(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, value):
    """Add ``value`` (a host int, or a device tensor summed on its device
    later: never a sync, and a launch only every ``_FOLD`` counts) to the
    counter ``name``, while a profiler records; nothing otherwise."""
    if _recording():
        pending = _counts.setdefault(name, [])
        pending.append(value)
        if len(pending) >= _FOLD:
            _counts[name] = _fold(pending)


def _fold(values: list) -> list:
    """``values`` added up to one host int and one tensor per device, without
    reading a tensor back."""
    host = sum(int(v) for v in values if not isinstance(v, torch.Tensor))
    on = {}
    for v in values:
        if isinstance(v, torch.Tensor):
            on.setdefault(v.device, []).append(v.reshape(-1))
    return [host] + [torch.cat(vs).sum(0, dtype=torch.int64, keepdim=True) for vs in on.values()]


def counters() -> dict:
    """{name: int} of what was counted since the last reset; the counts
    stay in place."""
    out = {}
    for name, values in _counts.items():
        total = sum(int(v.sum()) if isinstance(v, torch.Tensor) else int(v) for v in values)
        _counts[name] = [total]
        out[name] = total
    return out


def reset_counters():
    _counts.clear()


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
