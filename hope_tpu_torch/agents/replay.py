"""Replay ring buffer on the device (counterpart of
``hope_tpu/agents/replay.py``).

A fixed-capacity dict of tensors with a cursor. Pushes write in place (the
JAX ring is rebuilt functionally and donated; here the ring's tensors are
updated where they lie, which needs no second copy of a multi-GB buffer).
``cursor`` and ``size`` are host integers: every push has a batch size known
on the host, so reading them never waits for the device. BEV images are
stored as uint8 (``(v * 255 + 0.5)``, decoded ``/ 255``), which is exact for
the rasterizer's colours.

Across W ranks (``parallel.mesh``) the ring's rows are sharded as the JAX
package shards ``replay.data``: rank r holds the contiguous block
``[lo, lo + capacity / W)`` (``lo = r * capacity / W``), while ``cursor``,
``size`` and the sampling draws are the same on every rank. A push takes the
whole step's transitions (gathered from every rank) and each rank writes the
ring positions its block owns; a sample draws global indices, each rank
fills the rows it owns, and one collective assembles the same minibatch on
every rank. A full checkpoint gathers the blocks back in rank order, the
one-process layout (``train/resume.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..parallel.mesh import Mesh, all_reduce_sum


@dataclass
class Replay:
    data: dict          # field -> (rows, ...) tensor: ring positions [lo, lo + rows)
    cursor: int
    size: int
    capacity: int
    lo: int = 0         # the first ring position this rank holds
    mesh: Mesh | None = None

    @property
    def rows(self) -> int:
        return next(iter(self.data.values())).shape[0]


def _encode(k, v):
    return (v * 255.0 + 0.5).to(torch.uint8) if k.endswith("img") else v


def _decode(k, v):
    return v.to(torch.float32) / 255.0 if k.endswith("img") else v


def create(capacity: int, example: dict, mesh: Mesh | None = None) -> Replay:
    """``example`` is one transition WITHOUT a batch dim, e.g.
    {obs/..., action, reward, done, log_prob, next_obs/...}; the ring takes
    its shapes, dtypes (uint8 for keys ending in "img") and device. Across
    the ranks of ``mesh`` (``capacity`` divisible by their number) this rank
    holds its block of the positions."""
    lo, hi = (0, capacity) if mesh is None else mesh.bounds(capacity)
    if mesh is not None and capacity % mesh.world:
        raise ValueError(f"replay capacity {capacity} is not divisible by {mesh.world} ranks")
    data = {k: torch.zeros((hi - lo,) + tuple(v.shape),
                           dtype=torch.uint8 if k.endswith("img") else v.dtype,
                           device=v.device)
            for k, v in example.items()}
    return Replay(data=data, cursor=0, size=0, capacity=capacity, lo=lo,
                  mesh=mesh if mesh is not None and mesh.sharded else None)


def push_batch(buf: Replay, batch: dict) -> Replay:
    """Write B transitions (leading dim B; on a sharded ring the whole
    step's, from every rank) at the ring cursor, in place: this rank writes
    the positions it holds. Returns ``buf``."""
    b = next(iter(batch.values())).shape[0]
    dev = next(iter(buf.data.values())).device
    idx = (buf.cursor + torch.arange(b, device=dev)) % buf.capacity
    if buf.mesh is None:
        for k, v in batch.items():
            buf.data[k].index_copy_(0, idx, _encode(k, v))
    else:
        own = (idx >= buf.lo) & (idx < buf.lo + buf.rows)
        for k, v in batch.items():
            buf.data[k].index_copy_(0, idx[own] - buf.lo, _encode(k, v[own]))
    buf.cursor = (buf.cursor + b) % buf.capacity
    buf.size = min(buf.size + b, buf.capacity)
    return buf


def sample(buf: Replay, batch_size: int, generator: torch.Generator | None = None,
           idx: torch.Tensor | None = None) -> dict:
    """A decoded batch at ``idx``, or at uniform indices over the filled part
    of the ring from ``generator``. On a sharded ring every rank fills the
    rows it holds and one sum of their bytes over the ranks gives each the
    whole batch (bitwise: every row has one owner, the others add zeros)."""
    dev = next(iter(buf.data.values())).device
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,), generator=generator,
                            device=dev)
    if buf.mesh is None:
        return {k: _decode(k, v[idx]) for k, v in buf.data.items()}
    idx = idx.to(dev)
    own = (idx >= buf.lo) & (idx < buf.lo + buf.rows)
    local = torch.where(own, idx - buf.lo, 0)
    out = {}
    for k, v in buf.data.items():
        rows = v[local]
        out[k] = torch.where(own.reshape((-1,) + (1,) * (v.ndim - 1)), rows,
                             torch.zeros_like(rows))
    all_reduce_sum(list(out.values()), buf.mesh, as_bytes=True)
    return {k: _decode(k, v) for k, v in out.items()}


def unflatten_obs(flat: dict, prefix: str) -> dict:
    """Extract '{prefix}/<modality>' entries back into an obs dict."""
    p = prefix + "/"
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def flatten_obs(obs: dict, prefix: str) -> dict:
    return {f"{prefix}/{k}": v for k, v in obs.items()}
