"""Trace capture, timing, cost probes, throughput counting and metrics
logging (counterpart of ``hope_tpu/utils/profiling.py``: ``trace``,
``annotate``, ``time_fn``, ``compiled_cost``, ``StepTimer`` and
``MetricsWriter``).

The JAX package's compile cache (``hope_tpu/utils/cache.py``) has no
counterpart here: nothing is traced or compiled per call, and the CUDA
kernels' build cache is ``ops/_build.py``'s ``build/`` directory.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

# published NVIDIA H100 SXM peaks (data sheet): float32 operations outside the
# tensor cores, HBM3 bytes/s
PEAKS = {"f32_flops": 67e12, "hbm_bytes": 3.35e12}


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


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 20, **kwargs) -> dict:
    """Steady-state wall time of ``fn(*args, **kwargs)``: ``warmup`` untimed
    calls, then ``iters`` timed ones between two device synchronizations
    (PyTorch's CUDA calls return before the device finishes; on the CPU
    there is nothing to wait for).

    Returns {"mean_ms", "calls_per_sec", "iters"}."""
    for _ in range(max(warmup, 1)):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    dt = (time.perf_counter() - t0) / iters
    return {"mean_ms": dt * 1e3, "calls_per_sec": 1.0 / dt, "iters": iters}


def compiled_cost(fn: Callable, *args, **kwargs) -> dict:
    """Operations of one call of ``fn`` and the rate it reaches, against the
    H100's float32 peak (``PEAKS``).

    ``flops`` comes from ``torch.utils.flop_counter.FlopCounterMode``, which
    counts the ops it has formulas for (matrix products, convolutions,
    attention) and nothing else. ``bytes_accessed`` is None: PyTorch's eager
    calls give no count of the bytes they move, so no memory roofline share
    is given either.

    Returns {"flops", "bytes_accessed", "mean_ms", "achieved_tflops",
    "f32_roofline_frac"} (the last two where ``flops`` is nonzero)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    out = {"flops": counter.get_total_flops(), "bytes_accessed": None}
    out["mean_ms"] = time_fn(fn, *args, **kwargs)["mean_ms"]
    if out["flops"]:
        sec = out["mean_ms"] / 1e3
        out["achieved_tflops"] = out["flops"] / sec / 1e12
        out["f32_roofline_frac"] = out["flops"] / sec / PEAKS["f32_flops"]
    return out


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
