"""Swept car outline vs obstacle edges: the CUDA kernel
``csrc/sweep_collide.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``hope_tpu/ops/sweep_collide.py:76``
(``swept_collide``). Bound on the H100: operations, and the order they are
done in (up to ~1.8e10 float operations at the battery's shapes; a few per
cent of that where, as there, nearly every word collides early and only the
tests up to its first hit are needed). The kernel gives each word one block
that walks the path in order in doubling stages, compacts the env's live
edges into shared memory, drops most edges for a whole warp with a broad
phase that needs no margin, and votes per warp; see the kernel source.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check, ptr

KERNEL = CudaKernel("sweep_collide", "swept_collide",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the shared-memory check of the entry point in csrc/sweep_collide.cu (16
# bytes per edge slot, 227 KB a block less the kernel's own 64 bytes), stated
# here so that the wrapper can refuse by name
MAX_EDGES = (227 * 1024 - 64) // 16


def swept_collide_plain(car_edges, car_live, scene_edges, scene_mask, chunk: int = 64,
                        per_segment: bool = False):
    """Plain PyTorch version of :func:`swept_collide` (any device): the
    divide-free segment test of every (car segment, edge) pair, ``chunk`` car
    segments at a time. With ``per_segment`` it returns (B, K, S): whether
    each car segment hits any live edge."""
    qx = scene_edges[:, None, None, :, 0]                  # (B, 1, 1, E)
    qy = scene_edges[:, None, None, :, 1]
    sx = scene_edges[:, None, None, :, 2] - qx
    sy = scene_edges[:, None, None, :, 3] - qy
    em = scene_mask[:, None, None, :]
    B, K, S, _ = car_edges.shape
    out = torch.zeros((B, K), dtype=torch.bool, device=car_edges.device)
    segs = []
    for s0 in range(0, S, chunk):
        c = car_edges[:, :, s0:s0 + chunk, None, :]        # (B, K, c, 1, 4)
        px, py = c[..., 0], c[..., 1]
        rx = c[..., 2] - px
        ry = c[..., 3] - py
        live = car_live[:, :, s0:s0 + chunk, None]
        rxs = rx * sy - ry * sx
        qpx = qx - px
        qpy = qy - py
        qpxr = qpx * ry - qpy * rx
        qpxs = qpx * sy - qpy * sx
        arxs = torch.abs(rxs)
        hit = ((qpxs * rxs >= 0.0) & (torch.abs(qpxs) <= arxs)
               & (qpxr * rxs >= 0.0) & (torch.abs(qpxr) <= arxs)
               & (rxs != 0.0) & live & em)
        if per_segment:
            segs.append(torch.any(hit, dim=-1))
        else:
            out |= torch.any(hit.flatten(2), dim=-1)
    return torch.cat(segs, dim=-1) if per_segment else out


def swept_collide(car_edges, car_live, scene_edges, scene_mask):
    """Any-intersection test of per-word swept car outlines vs scene edges.

    Args:
      car_edges: (B, K, S, 4) float32 car outline segments along each path.
      car_live: (B, K, S) bool live-segment mask.
      scene_edges: (B, E, 4) float32 obstacle segments.
      scene_mask: (B, E) bool live-edge mask.

    Returns:
      (B, K) bool, True where the swept path hits any live edge. CUDA tensors
      go through the kernel, which raises for more than ``MAX_EDGES`` edge
      slots (an env's edges must fit one block's shared memory); CPU tensors
      go through :func:`swept_collide_plain`.
    """
    dev = car_edges.device
    if dev.type == "cpu":
        return swept_collide_plain(car_edges, car_live, scene_edges, scene_mask)
    if dev.type != "cuda":
        raise ValueError(f"swept_collide: unsupported device {dev}")
    B, K, S, _ = car_edges.shape
    E = scene_edges.shape[1]
    check(car_edges, "car_edges", torch.float32, (B, K, S, 4), dev)
    check(car_live, "car_live", torch.bool, (B, K, S), dev)
    check(scene_edges, "scene_edges", torch.float32, (B, E, 4), dev)
    check(scene_mask, "scene_mask", torch.bool, (B, E), dev)
    if E > MAX_EDGES:
        raise ValueError(f"swept_collide: E={E} edge slots, the kernel takes at most "
                         f"{MAX_EDGES}")
    for name, t in (("car_edges", car_edges), ("scene_edges", scene_edges)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    out = torch.empty((B, K), dtype=torch.bool, device=dev)
    KERNEL.launch(dev, ptr(car_edges), ptr(car_live), ptr(scene_edges),
                  ptr(scene_mask), ptr(out), B, K, S, E)
    return out
