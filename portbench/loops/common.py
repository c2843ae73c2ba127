"""What every window loop shares: seeds derived from the run's seed, the
precision the configuration states, the peak memory and the freeing of the
program's state before the reference runs."""
from __future__ import annotations

import gc
import os
import random

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one draw of the run, from the run's seed and the
    draw's tags (a cycle's index, a battery's): every run of one seed makes
    the same inputs, and any whole number is a valid run seed."""
    x = seed % (1 << 62)
    for t in tags:
        x = (x * 1_000_003 + 7_919 * (t + 1)) % (1 << 62)
    return x


def sample(seed: int, population: int, k: int, tag: int = 0) -> list:
    """``k`` distinct indices of ``range(population)`` drawn from the seed,
    sorted (all of them where ``k`` >= ``population``)."""
    rng = random.Random(sub_seed(seed, 99_991, tag))
    return sorted(rng.sample(range(population), min(k, population)))


def set_precision(ctx):
    """Float32 products and convolutions in full precision, as the CLIs set
    them on the card (the configuration's ``tf32: false``), unless the
    control switches the program's TF32 path on."""
    tf32 = ctx.control == "tf32" or bool(ctx.config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def reference_precision(ctx):
    """The reference runs in full precision (float64 where it says so,
    float32 products with TF32 off), whatever the program's side ran in."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def memory_peak(ctx) -> int:
    """The process's peak device memory so far (bytes; 0 on the CPU)."""
    if ctx.device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(ctx.device))


def release():
    """Drop what the program held on the device before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


__all__ = ["ROOT", "memory_peak", "reference_precision", "release", "sample", "set_precision",
           "sub_seed"]
