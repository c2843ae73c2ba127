"""Batched ego-frame BEV rasterizer: the CUDA kernel ``csrc/raster_bev.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel ``hope_tpu/ops/raster_bev.py:306``
(``render_bev_batch``). On CUDA tensors :func:`render_bev_batch` is one
launch: the kernel takes the raw poses, boxes and edges, prepares and culls
the edges itself, counts crossings per (edge, image row) and writes the
image. Bound on the H100: bytes, the image write; see the kernel source for
the design.

The plain version, :func:`render_bev_batch_plain`, is the chain
:func:`ego_edge_params` → :func:`quad_coeffs` → :func:`raster_bev_plain`. The
crossing test runs in the ego frame: pixel coordinates are fixed functions of
the pixel index (v forward, u rightward) and each edge is transformed once.
:func:`ego_edge_params` classifies every edge, each class an exact
simplification: DROP (its v-interval misses the image, or it lies entirely
left of it: no pixel's +u ray crosses it), STRADDLE-ONLY (entirely right of
the image: ``u < ui`` holds for every straddling pixel), FULL. Live edges are
compacted to the front so the plain version loops over them only.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import ObsConfig, VehicleConfig
from ._build import CudaKernel, check, ptr

# reference colors (configs.py:80-84) / 255: background, obstacle, dest, car
PALETTE = np.asarray(
    [[0.0, 0.0, 0.0],
     [150.0, 150.0, 150.0],
     [69.0, 139.0, 0.0],
     [30.0, 144.0, 255.0]], np.float32) / 255.0


class _Palette(ctypes.Structure):
    """The kernel's by-value palette argument (12 floats)."""
    _fields_ = [("c", ctypes.c_float * 12)]


_PALETTE_ARG = _Palette((ctypes.c_float * 12)(*PALETTE.ravel().tolist()))
KERNEL = CudaKernel("raster_bev", "render_bev_batch",
                    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_int, _Palette, ctypes.c_void_p])
# the shared-memory check of the entry point in csrc/raster_bev.cu: 56 bytes
# per edge slot and 8 more in 227 KB a block, less 2.5 KB of the kernel's
# own; stated here so that the wrapper can refuse by name
MAX_EDGES = (227 * 1024 - 2560 - 8) // 56
IMG_SIZES = (16, 32, 64, 128)

_DROP_KEY = 1 << 24


def _center(poses, cx_off: float):
    c = torch.cos(poses[:, 2:3])                         # (B, 1)
    s = torch.sin(poses[:, 2:3])
    return c, s, poses[:, 0:1] + c * cx_off, poses[:, 1:2] + s * cx_off


def ego_edge_params(poses, edges, edge_mask, edge_poly, cx_off: float, n: int,
                    res: float, exact: bool):
    """Batched edge preparation: ((B, P, E) compacted crossing params, (B, 2)
    int32 counts (n_full, n_straddle)).

    Rows: v1, v2, slope su, intercept uc (+ in exact mode a last-edge-of-
    polygon flag). Global mode sorts full-test edges first, then
    straddle-only, then dropped. Exact mode sorts live edges grouped by
    polygon (straddle-only edges take the full test) and sets n_straddle to 0.
    The sort is stable; the order within a key is free, since parity counts do
    not depend on it.
    """
    B, E, _ = edges.shape
    c, s, cx, cy = _center(poses, cx_off)
    ex = edges.permute(0, 2, 1)                          # (B, 4, E)
    dx1, dy1 = ex[:, 0] - cx, ex[:, 1] - cy
    dx2, dy2 = ex[:, 2] - cx, ex[:, 3] - cy
    v1 = c * dx1 + s * dy1
    u1 = -s * dx1 + c * dy1
    v2 = c * dx2 + s * dy2
    u2 = -s * dx2 + c * dy2
    dv = v2 - v1
    su = (u2 - u1) / torch.where(dv == 0.0, 1.0, dv)
    uc = u1 - v1 * su
    live = edge_mask & (dv != 0.0)

    ext = float(np.float32((n - 1) / 2.0) * np.float32(res))  # pixel extreme
    drop = (~live
            | (torch.minimum(v1, v2) > ext)              # above the image
            | (torch.maximum(v1, v2) <= -ext)            # below it
            | (torch.maximum(u1, u2) <= -ext))           # entirely left
    right = ~drop & (torch.minimum(u1, u2) > ext)        # entirely right

    rows = [v1, v2, su, uc]
    if not exact:
        key = torch.where(drop, 2, torch.where(right, 1, 0)).to(torch.int32)
        order = torch.sort(key, dim=1, stable=True).indices
        params = torch.stack([torch.gather(r, 1, order) for r in rows], dim=1)
        nf = torch.sum(key == 0, dim=1, dtype=torch.int32)
        ns = torch.sum(key == 1, dim=1, dtype=torch.int32)
        return params.contiguous(), torch.stack([nf, ns], dim=1).contiguous()

    key = torch.where(drop, _DROP_KEY, edge_poly.to(torch.int32))
    ks, order = torch.sort(key, dim=1, stable=True)
    nxt = torch.cat([ks[:, 1:], torch.full((B, 1), -1, dtype=ks.dtype, device=ks.device)],
                    dim=1)
    flag = (ks != nxt).to(torch.float32)                 # last edge of its polygon
    params = torch.stack([torch.gather(r, 1, order) for r in rows] + [flag], dim=1)
    nf = torch.sum(~drop, dim=1, dtype=torch.int32)
    return params.contiguous(), torch.stack([nf, torch.zeros_like(nf)], dim=1).contiguous()


def quad_coeffs(poses, quads, cx_off: float):
    """(B, 4, 4) half-plane coefficients [beta (v), gamma (u), alpha, 0] of
    world CCW quads (B, 4, 2), affine in ego pixel coords (>= 0 inside)."""
    c, s, cx, cy = _center(poses, cx_off)
    a = quads
    b = torch.roll(quads, -1, dims=1)
    ex, ey = b[:, :, 0] - a[:, :, 0], b[:, :, 1] - a[:, :, 1]
    beta = ex * s - ey * c
    gamma = ex * c + ey * s
    alpha = ex * (cy - a[:, :, 1]) - ey * (cx - a[:, :, 0])
    return torch.stack([beta, gamma, alpha, torch.zeros_like(alpha)], dim=-1)


def pixel_coords(n: int, res: float, device=None):
    """(n*n,) ego-frame pixel coords (v forward, u right), row-major."""
    half = (n - 1) / 2.0
    idx = torch.arange(n * n, device=device)
    i = (idx // n).to(torch.float32)
    j = (idx % n).to(torch.float32)
    return (half - i) * res, (j - half) * res


def raster_bev_plain(params, cnt, quads, n: int, res: float, chunk: int = 16):
    """(B, n, n, 3) images from prepared edges (``params``, ``cnt`` of
    :func:`ego_edge_params`; P = 5 rows exact per-polygon parity, P = 4
    global even-odd) and quads ((B, 8, 4), dest then car, of
    :func:`quad_coeffs`), on any device, ``chunk`` envs at a time."""
    dev = params.device
    B, P, E = params.shape
    exact = P == 5
    v, u = pixel_coords(n, res, dev)
    vv, uu = v[None, :, None], u[None, :, None]
    pal = torch.as_tensor(PALETTE, device=dev)
    outs = []
    for b0 in range(0, B, chunk):
        p, ct, qd = params[b0:b0 + chunk], cnt[b0:b0 + chunk], quads[b0:b0 + chunk]
        nf, ns = ct[:, 0:1].long(), ct[:, 1:2].long()
        em = int((nf + ns).max()) if len(ct) else 0
        p = p[:, :, :em]
        e_idx = torch.arange(em, device=dev)[None, :]
        A, Bv = p[:, 0, None, :], p[:, 1, None, :]
        S, C = p[:, 2, None, :], p[:, 3, None, :]
        straddle = (A > vv) != (Bv > vv)                 # (b, npx, em)
        ui = vv * S + C
        full = e_idx < nf
        cross = straddle & (uu < ui) & full[:, None, :]
        if exact:
            flag = (p[:, 4] != 0.0) & full
            group = torch.cumsum(flag.long(), dim=1) - flag.long()
            counts = torch.zeros(cross.shape, dtype=torch.int32, device=dev)
            counts.scatter_add_(2, group[:, None, :].expand_as(cross), cross.to(torch.int32))
            obst = torch.any(counts % 2 == 1, dim=-1)
        else:
            strad = straddle & ((e_idx >= nf) & (e_idx < nf + ns))[:, None, :]
            obst = (cross.sum(-1) + strad.sum(-1)) % 2 == 1
        hp = (qd[:, :, None, 0] * v + qd[:, :, None, 1] * u + qd[:, :, None, 2]) >= 0.0
        dest = torch.all(hp[:, 0:4], dim=1)
        car = torch.all(hp[:, 4:8], dim=1)
        cls = torch.where(car, 3, torch.where(dest, 2, torch.where(obst, 1, 0)))
        outs.append(pal[cls])
    if not outs:
        return torch.empty((0, n, n, 3), device=dev)
    return torch.cat(outs).reshape(B, n, n, 3)




def _cx_off(vcfg: VehicleConfig) -> float:
    return (vcfg.front_hang + vcfg.wheel_base - vcfg.rear_hang) / 2.0


def render_bev_batch_plain(poses, vehicle_boxes, dest_boxes, edges, edge_mask, edge_poly,
                           obs_cfg: ObsConfig, vcfg: VehicleConfig, exact: bool | None = None):
    """Plain PyTorch version of :func:`render_bev_batch` (any device):
    :func:`ego_edge_params`, :func:`quad_coeffs`, then
    :func:`raster_bev_plain`."""
    n = obs_cfg.img_size
    if exact is None:
        exact = obs_cfg.raster_parity == "exact"
    cx_off = _cx_off(vcfg)
    params, cnt = ego_edge_params(poses, edges, edge_mask, edge_poly, cx_off, n,
                                  obs_cfg.img_res, exact)
    quads = torch.cat([quad_coeffs(poses, dest_boxes, cx_off),
                       quad_coeffs(poses, vehicle_boxes, cx_off)], dim=1)
    return raster_bev_plain(params, cnt, quads, n, obs_cfg.img_res)


def render_bev_batch(poses, vehicle_boxes, dest_boxes, edges, edge_mask, edge_poly,
                     obs_cfg: ObsConfig, vcfg: VehicleConfig, exact: bool | None = None):
    """Batched BEV render (same signature and output as the JAX package's).

    Args:
      poses: (B, 3) float32; vehicle_boxes / dest_boxes: (B, 4, 2) float32
        world CCW quads; edges: (B, E, 4) float32; edge_mask: (B, E) bool;
        edge_poly: (B, E) int32 polygon ids, in [0, 2**24) (exact mode only).
      exact: per-polygon parity vs global even-odd; defaults to
        ``obs_cfg.raster_parity``.

    Returns:
      (B, H, W, 3) float32 images. CUDA tensors go through the kernel, one
      launch, which takes contiguous inputs, ``img_size`` in ``IMG_SIZES``
      and at most ``MAX_EDGES`` edge slots, and raises otherwise; CPU tensors
      go through :func:`render_bev_batch_plain`.
    """
    dev = poses.device
    if dev.type == "cpu":
        return render_bev_batch_plain(poses, vehicle_boxes, dest_boxes, edges, edge_mask,
                                      edge_poly, obs_cfg, vcfg, exact)
    if dev.type != "cuda":
        raise ValueError(f"render_bev_batch: unsupported device {dev}")
    n = obs_cfg.img_size
    if exact is None:
        exact = obs_cfg.raster_parity == "exact"
    if n not in IMG_SIZES:
        raise ValueError(f"render_bev_batch: img_size {n}, the kernel takes {IMG_SIZES}")
    B, E = edges.shape[:2]
    check(poses, "poses", torch.float32, (B, 3), dev)
    check(vehicle_boxes, "vehicle_boxes", torch.float32, (B, 4, 2), dev)
    check(dest_boxes, "dest_boxes", torch.float32, (B, 4, 2), dev)
    check(edges, "edges", torch.float32, (B, E, 4), dev)
    check(edge_mask, "edge_mask", torch.bool, (B, E), dev)
    check(edge_poly, "edge_poly", torch.int32, (B, E), dev)
    if E > MAX_EDGES:
        raise ValueError(f"render_bev_batch: E={E} edge slots, the kernel takes at most "
                         f"{MAX_EDGES}")
    if edges.data_ptr() % 16:
        raise ValueError("edges: not 16-byte aligned")
    out = torch.empty((B, n, n, 3), dtype=torch.float32, device=dev)
    if B:
        KERNEL.launch(dev, ptr(poses), ptr(vehicle_boxes), ptr(dest_boxes), ptr(edges),
                      ptr(edge_mask), ptr(edge_poly), ptr(out), B, E, n,
                      ctypes.c_float(obs_cfg.img_res), ctypes.c_float(_cx_off(vcfg)),
                      int(exact), _PALETTE_ARG)
    return out
