"""Swept car outline vs obstacle edges: the CUDA kernel
``csrc/sweep_collide.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``hope_tpu/ops/sweep_collide.py:76``
(``swept_collide``). Bound on the H100: compute (up to ~1.8e10 float
operations at the battery's shapes, far fewer with its early exit, which
also cuts the car segments read); see the kernel source for the design.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check, ptr

KERNEL = CudaKernel("sweep_collide", "swept_collide",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


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
      go through the kernel; CPU tensors through :func:`swept_collide_plain`.
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
    for name, t in (("car_edges", car_edges), ("scene_edges", scene_edges)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: not 16-byte aligned")
    out = torch.empty((B, K), dtype=torch.bool, device=dev)
    KERNEL.launch(dev, ptr(car_edges), ptr(car_live), ptr(scene_edges),
                  ptr(scene_mask), ptr(out), B, K, S, E)
    return out
