"""The kernels' work and bounds, frozen from ``chip_smoke.py`` (``bound``,
``raster_work``, ``sweep_work`` and the count in ``_measure_mask``), so that
a later change to the program or to that script cannot move the yardstick.

A bound is the larger of the bytes over the H100's HBM rate and the float32
operations over its peak outside the tensor cores (NVIDIA's data sheet, SXM
part, 700 W). The raster's operations are counted on the frozen
``ego_edge_params`` of the raster's plain version, never on the program's.
"""
from __future__ import annotations

import math

import torch

# published H100 SXM peaks: HBM3 bytes/s, float32 operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over memory rate and float32
    operations over peak rate."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def mask_work(B: int, R: int, table_shape: tuple):
    """(bytes, operations) of ``mask_step_lengths`` on (B, R) rays and a
    (R*U, A, I) table: every input read once and the (B, A) output written;
    one compare per (env, upsampled ray, action, sub-step) and the
    upsample's 5 operations per (env, upsampled ray)."""
    RU, A, I = table_shape
    nbytes = 4 * (B * R + RU * A * I + B * A)
    ops = 1.0 * B * RU * A * I + 5.0 * B * RU
    return nbytes, ops


def raster_work(poses, vboxes, dboxes, edges, mask, poly, obs, vcfg):
    """(bytes, float operations) the raster needs on these inputs, in exact
    mode. Bytes: every input read once, the image written once. Operations:
    ~30 per edge slot to move it to the ego frame and cull it; per kept edge
    ~2 log2(n) compares to find the rows it straddles; per straddled (edge,
    image row) pair ~12; per pixel 8 half-planes of 5 and the class
    select."""
    from .reference import kernels as raster_bev

    n, B, E = obs.img_size, edges.shape[0], edges.shape[1]
    cx_off = (vcfg.front_hang + vcfg.wheel_base - vcfg.rear_hang) / 2.0
    params, cnt = raster_bev.ego_edge_params(poses, edges, mask, poly, cx_off, n, obs.img_res,
                                             True)
    kept = cnt[:, 0].to(torch.float64)
    v, _ = raster_bev.pixel_coords(n, obs.img_res, edges.device)
    v = v[::n]                                                           # (n,) rows
    slot = torch.arange(E, device=edges.device)[None, :] < cnt[:, :1]
    A, Bv = params[:, 0, :, None], params[:, 1, :, None]
    pairs = float((((A > v) != (Bv > v)) & slot[..., None]).sum())
    ops = (30.0 * B * E + 2.0 * math.log2(n) * float(kept.sum()) + 12.0 * pairs
           + 43.0 * B * n * n)
    nbytes = (sum(t.numel() * t.element_size() for t in (poses, vboxes, dboxes, edges, mask, poly))
              + B * n * n * 3 * 4)
    return nbytes, ops


def sweep_work(car_live, scene_edges, scene_mask, seg_hit):
    """(bytes, float operations) the sweep needs on this data, from the plain
    version's per-segment hits ``seg_hit`` (B, K, S). A clear path tests
    every live (segment, edge) pair; a colliding one stops at the first car
    segment that hits. Bytes: 16 per live segment tested, 1 per live flag
    read, the scene's edges and mask once, the output. Operations: ~20 per
    pair test."""
    S = car_live.shape[-1]
    hit = seg_hit.any(-1)
    first = seg_hit.to(torch.uint8).argmax(-1)
    n_edges = scene_mask.sum(dim=1).to(torch.float64)[:, None]       # (B, 1)
    segs = car_live.sum(dim=-1).to(torch.float64)                   # (B, K)
    live_before = torch.cumsum(car_live.to(torch.float64), dim=-1)  # (B, K, S)
    upto = torch.gather(live_before, -1, first[..., None]).squeeze(-1)
    segs = torch.where(hit, upto, segs)
    flags = torch.where(hit, first + 1, S).to(torch.float64)
    nbytes = (float((16.0 * segs + flags).sum()) + scene_edges.numel() * 4
              + scene_mask.numel() + hit.numel())
    return nbytes, 20.0 * float((segs * n_edges).sum())


def share(bound_ms_per_call: float, calls: int, kernel_seconds: float):
    """A kernel's share of its roofline, in %: the least time its calls could
    take over the time they took on the device. None where none ran."""
    if not calls or kernel_seconds <= 0.0:
        return None
    return 100.0 * bound_ms_per_call * calls / (kernel_seconds * 1e3)
