"""Ranks, sharding and collectives on ``torch.distributed`` (counterpart of
``hope_tpu/parallel/mesh.py``).

The JAX package runs one SPMD program over a ``('dp',)`` device mesh: env
batches and the replay ring live batch-sharded, parameters replicated, and
XLA inserts the gradient psum. Here each device is one process (a rank) that
holds the contiguous block ``[r * n / W, (r + 1) * n / W)`` of every
batch-sharded leaf, as ``shard_batch`` lays it out, and a copy of every
replicated one; the collectives the training loop needs are spelled out:

- :func:`gather_replicated`: every rank's block back into the full leading
  axis, on every rank (all_gather);
- :func:`gather_to_root`: the same onto rank 0 only (a checkpoint's replay
  ring is too large to hold twice on every rank);
- :func:`all_reduce_sum`: an in-place sum of a list of tensors over the
  ranks, flattened into one bucket (the gradient reduction);
- :func:`barrier`.

The backend is named by the caller, never guessed: ``nccl`` where each rank
has a CUDA device of its own, ``gloo`` for CPU ranks (and for several ranks
sharing one card). Gloo's CUDA support differs per collective, so with gloo
the payload of a CUDA tensor goes through a host tensor explicitly. Payloads
travel as raw bytes, so a gather or a sum of zeros with one owner's bytes is
bitwise. With one rank (``world == 1``) every helper is the identity.

Each collective's wall time and payload bytes accumulate in ``Mesh.stats``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves, tree_map

BACKENDS = ("nccl", "gloo")


@dataclass
class Mesh:
    """One rank's view of a ``('dp',)`` mesh of ``world`` ranks: its index,
    its device and the backend of the default process group."""

    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    backend: str | None = None
    stats: dict = field(default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0})

    @property
    def sharded(self) -> bool:
        return self.world > 1

    def bounds(self, n: int) -> tuple[int, int]:
        """The rows [lo, hi) of an axis of length ``n`` that this rank holds."""
        return self.rank * n // self.world, (self.rank + 1) * n // self.world

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``x``'s leading axis (a view)."""
        lo, hi = self.bounds(x.shape[0])
        return x[lo:hi]

    def reset_stats(self) -> dict:
        """Return the collective counters so far and start them from 0."""
        out, self.stats = self.stats, {"calls": 0, "bytes": 0, "seconds": 0.0}
        return out


def initialize_multihost(coordinator: str | None, num_processes: int | None,
                         process_id: int | None, backend: str | None, timeout_s: int = 600):
    """Join the default process group as rank ``process_id`` of
    ``num_processes`` (no-op for one process), rendezvousing at
    ``coordinator`` (``host:port``) over TCP, with ``backend`` (named by
    the caller: one of BACKENDS)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if coordinator is None:
        raise ValueError("a multi-process group needs a coordinator host:port")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))


def make_mesh(device) -> Mesh:
    """The mesh of the default process group (one rank where there is none),
    with ``device`` as this rank's."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=device)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    return Mesh(world=dist.get_world_size(), rank=dist.get_rank(), device=device,
                backend=backend)


def shutdown(mesh: Mesh | None):
    """Leave the default process group (after a last barrier); a no-op once
    it is left."""
    if mesh is not None and mesh.sharded and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


# ------------------------------------------------------------------ trees

def shard_batch(tree, mesh: Mesh | None):
    """This rank's contiguous block of every leaf's leading axis."""
    if mesh is None or not mesh.sharded:
        return tree
    return tree_map(mesh.rows, tree)


def replicate(tree, mesh: Mesh | None):
    """Every leaf whole, on this rank's device (each rank holds a copy)."""
    if mesh is None:
        return tree
    return tree_map(lambda x: x.to(mesh.device), tree)


# ------------------------------------------------------------ collectives

def _bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values as a flat uint8 tensor, padded to a multiple of 8
    bytes (so that each part of a packed buffer starts aligned for any
    dtype)."""
    b = t.contiguous().reshape(-1).view(torch.uint8)
    pad = -b.numel() % 8
    return torch.cat([b, b.new_zeros(pad)]) if pad else b


def _from_bytes(b: torch.Tensor, like: torch.Tensor, rows: int | None = None) -> torch.Tensor:
    """Bytes back into a tensor of ``like``'s dtype and shape (with ``rows``
    rows where given)."""
    shape = tuple(like.shape) if rows is None else (rows,) + tuple(like.shape[1:])
    n = math.prod(shape) * like.element_size()
    return b[:n].view(like.dtype).reshape(shape)


class _Timed:
    def __init__(self, mesh: Mesh, nbytes: int):
        self.mesh, self.nbytes = mesh, nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        s = self.mesh.stats
        s["calls"] += 1
        s["bytes"] += self.nbytes
        s["seconds"] += time.perf_counter() - self.t0


def _staged(mesh: Mesh, buf: torch.Tensor) -> torch.Tensor:
    """Where the payload must go through the host (gloo with a CUDA
    tensor), a host copy; else ``buf`` itself."""
    return buf.cpu() if (mesh.backend == "gloo" and buf.is_cuda) else buf


def gather_replicated(tree, mesh: Mesh | None):
    """Every rank's block of each leaf concatenated along the leading axis in
    rank order, on every rank: the one-process layout. Leaves must have the
    same shape on every rank; all of them travel in one all_gather."""
    if mesh is None or not mesh.sharded:
        return tree
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    packed = [_bytes(x) for x in leaves]
    buf = _staged(mesh, torch.cat(packed))
    parts = [torch.empty_like(buf) for _ in range(mesh.world)]
    with _Timed(mesh, buf.numel()):
        dist.all_gather(parts, buf)
    sizes = [p.numel() for p in packed]
    per_rank = [torch.split(p.to(mesh.device), sizes) for p in parts]
    it = iter(range(len(leaves)))

    def whole(x):
        i = next(it)
        return torch.cat([_from_bytes(pr[i], x) for pr in per_rank])

    return tree_map(whole, tree)


def gather_to_root(tree, mesh: Mesh | None):
    """As :func:`gather_replicated`, onto rank 0 alone (on its host where the
    payload went through it): rank 0 returns the whole tree, the other ranks
    None. One gather per leaf, so a large tree never needs a second copy of
    itself in one buffer."""
    if mesh is None or not mesh.sharded:
        return tree
    root = mesh.rank == 0

    def one(x):
        buf = _staged(mesh, _bytes(x))
        parts = [torch.empty_like(buf) for _ in range(mesh.world)] if root else None
        with _Timed(mesh, buf.numel()):
            dist.gather(buf, parts, dst=0)
        if not root:
            return None
        return torch.cat([_from_bytes(p, x) for p in parts])

    out = tree_map(one, tree)
    return out if root else None


def all_reduce_sum(tensors: list, mesh: Mesh | None, as_bytes: bool = False) -> list:
    """Sum each tensor of ``tensors`` over the ranks, in place, in one
    collective; returns the list. ``as_bytes`` sums their raw bytes instead
    (exact where at most one rank holds nonzero bytes at each place, as when
    each rank fills the rows it owns)."""
    if mesh is None or not mesh.sharded or not tensors:
        return tensors
    if as_bytes:
        flat = [_bytes(t) for t in tensors]
    else:
        dtype = tensors[0].dtype
        if any(t.dtype != dtype for t in tensors):
            raise ValueError("all_reduce_sum: tensors of one dtype only (or as_bytes)")
        flat = [t.reshape(-1) for t in tensors]
    buf = _staged(mesh, torch.cat(flat))
    with _Timed(mesh, buf.numel() * buf.element_size()):
        dist.all_reduce(buf)
    buf = buf.to(mesh.device)
    for t, part in zip(tensors, torch.split(buf, [f.numel() for f in flat])):
        with torch.no_grad():
            t.copy_(_from_bytes(part, t) if as_bytes else part.reshape(t.shape))
    return tensors


def barrier(mesh: Mesh | None):
    """Wait until every rank is here."""
    if mesh is not None and mesh.sharded:
        with _Timed(mesh, 0):
            dist.barrier()


def agree(flag: bool, mesh: Mesh | None) -> bool:
    """True on every rank where ``flag`` holds on any rank (a loop's stop that
    a host clock decides must be taken by all ranks at once)."""
    if mesh is None or not mesh.sharded:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=mesh.device if mesh.backend == "nccl" else "cpu")
    dist.all_reduce(t)
    return bool(t.item())
