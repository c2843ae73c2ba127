"""The three kernels' plain versions and oracles, frozen: the action mask's
table and reduction, the BEV raster, and the RS sweep. Each is what the
port keeps beside its CUDA kernel as the kernel's definition (and matched
bit for bit on the card), copied here so that a later change to the program
cannot move the yardstick. Everything around the kernels (the lidar, the
dynamics, the rewards, the policy, the takeover, the iLQR) is written anew
in the other modules of this package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .spec import MASK, OBS, VEHICLE

_EPS = 1e-12

# ------------------------------------------------------------------ geometry


def pose_to_box(pose, corners):
    """(..., 3) poses and (4, 2) corners -> (..., 4, 2) world corners (the
    kernels' inputs are formed in this order of operations)."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    cx, cy = corners[:, 0], corners[:, 1]
    wx = c[..., None] * cx - s[..., None] * cy + x[..., None]
    wy = s[..., None] * cx + c[..., None] * cy + y[..., None]
    return torch.stack([wx, wy], dim=-1)


def box_to_edges(box):
    """(..., V, 2) ring -> (..., V, 4) closed-ring edges."""
    return torch.cat([box, torch.roll(box, shifts=-1, dims=-2)], dim=-1)


def _segment_points(e1, e2, tol: float = 1e-8):
    """Pairwise intersection points (..., M, N, 2), +inf where none."""
    p = e1[..., :, None, 0:2]
    r = e1[..., :, None, 2:4] - p
    q = e2[..., None, :, 0:2]
    s = e2[..., None, :, 2:4] - q
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    qpxr = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    qpxs = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    parallel = rxs == 0.0
    denom = torch.where(parallel, 1.0, rxs)
    t, u = qpxs / denom, qpxr / denom
    t_tol = tol / torch.clamp(torch.linalg.norm(r, dim=-1), min=_EPS)
    u_tol = tol / torch.clamp(torch.linalg.norm(s, dim=-1), min=_EPS)
    hit = (t >= -t_tol) & (t <= 1.0 + t_tol) & (u >= -u_tol) & (u <= 1.0 + u_tol) & ~parallel
    return torch.where(hit[..., None], p + t[..., None] * r, torch.inf)


def _ray_hits(angles, edges, max_range: float):
    """Distance along each ray (R,) to (..., E, 4) edges -> (..., R)."""
    c, s = torch.cos(angles), torch.sin(angles)
    q = edges[..., None, :, 0:2]
    e = edges[..., None, :, 2:4] - q
    rx, ry = c[..., :, None], s[..., :, None]
    rxs = rx * e[..., 1] - ry * e[..., 0]
    parallel = rxs == 0.0
    denom = torch.where(parallel, 1.0, rxs)
    t = (q[..., 0] * e[..., 1] - q[..., 1] * e[..., 0]) / denom
    u = (q[..., 0] * ry - q[..., 1] * rx) / denom
    valid = (~parallel) & (t >= 0.0) & (u >= 0.0) & (u <= 1.0)
    return torch.clamp(torch.amin(torch.where(valid, t, max_range), dim=-1), 0.0, max_range)


def beam_angles(device=None):
    n = OBS["n_beams"]
    return torch.as_tensor(np.arange(n) / n * 2 * math.pi, dtype=torch.float32, device=device)


def corners(device=None, dtype=torch.float32):
    return torch.as_tensor(VEHICLE["corners"], dtype=dtype, device=device)


def hull_base(device=None):
    """(R,) distance from the rear axle to the hull along each beam."""
    return _ray_hits(beam_angles(device), box_to_edges(corners(device)), OBS["max_range"])


# ---------------------------------------------------------------- the mask


def upsample_circular(x, rate: int, dim: int = -1):
    dim = dim % x.ndim
    nxt = torch.roll(x, -1, dims=dim)
    frac = torch.arange(rate, dtype=torch.float32, device=x.device) / rate
    frac = frac.reshape((rate,) + (1,) * (x.ndim - dim - 1))
    y = x.unsqueeze(dim + 1) * (1.0 - frac) + nxt.unsqueeze(dim + 1) * frac
    return y.flatten(dim, dim + 1)


def mask_step_lengths_plain(obs_ext, dist_star, n_iter: int, upsample: int, chunk: int = 32):
    """The mask kernel's definition: per action, the first sub-step whose
    clearance a ray blocks, min over the upsampled rays."""
    up = upsample_circular(obs_ext.to(torch.float32), upsample, dim=1)
    k = torch.arange(n_iter, dtype=torch.float32, device=obs_ext.device)
    outs = []
    for u in torch.split(up, chunk):
        w = torch.where(dist_star[None] > u[:, :, None, None], k, float(n_iter))
        outs.append(torch.amin(w, dim=(1, 3)))
    return torch.cat(outs)


def discrete_actions() -> np.ndarray:
    p, ms = MASK["precision"], VEHICLE["max_steer"]
    steers = ms - np.arange(2 * p + 1) * (ms / p)
    fwd = np.stack([steers, np.full_like(steers, MASK["step_speed"])], axis=1)
    bwd = np.stack([steers, np.full_like(steers, -MASK["step_speed"])], axis=1)
    return np.concatenate([fwd, bwd]).astype(np.float32)


def _future_boxes() -> np.ndarray:
    acts = discrete_actions()
    steer, speed = acts[:, 0], acts[:, 1]
    n_iter = MASK["n_iter"]
    ds = 0.5 * speed / n_iter
    curv = np.tan(steer) / VEHICLE["wheel_base"]
    k = np.arange(1, n_iter + 1)
    phi = np.outer(curv * ds, k)
    small = np.abs(curv) < 1e-9
    curv_safe = np.where(small, 1.0, curv)
    px = np.where(small[:, None], np.outer(ds, k), np.sin(phi) / curv_safe[:, None])
    py = np.where(small[:, None], 0.0, (1.0 - np.cos(phi)) / curv_safe[:, None])
    cn = np.asarray(VEHICLE["corners"])
    c, s = np.cos(phi), np.sin(phi)
    wx = c[..., None] * cn[:, 0] - s[..., None] * cn[:, 1] + px[..., None]
    wy = s[..., None] * cn[:, 0] + c[..., None] * cn[:, 1] + py[..., None]
    return np.stack([wx, wy], axis=-1).astype(np.float32)


class MaskTable(NamedTuple):
    dist_star: torch.Tensor      # (R*up, A, n_iter)
    hull_base: torch.Tensor      # (R,)


def mask_table(device=None) -> MaskTable:
    """The clearance table of every (upsampled ray, action, sub-step)."""
    R, far = OBS["n_beams"], OBS["max_range"] * 10.0
    ang = np.arange(R) / R * 2 * math.pi
    ray_edges = np.zeros((R, 4), np.float32)
    ray_edges[:, 2] = np.cos(ang) * far
    ray_edges[:, 3] = np.sin(ang) * far
    boxes = _future_boxes()
    box_edges = np.concatenate([np.roll(boxes, -1, axis=2), boxes], axis=-1).reshape(-1, 4)
    pts = _segment_points(torch.as_tensor(ray_edges, device=device),
                          torch.as_tensor(box_edges, device=device))
    d = torch.linalg.norm(pts, dim=-1)
    d = torch.where(torch.isinf(d), 0.0, d)
    A = 2 * (2 * MASK["precision"] + 1)
    dist_star = torch.amax(d.reshape(R, A, MASK["n_iter"], 4), dim=-1)
    return MaskTable(upsample_circular(dist_star, MASK["upsample"], dim=0).contiguous(),
                     hull_base(device))


def _min_filter5_reflect(x):
    n = x.shape[-1]
    p = torch.cat([torch.flip(x[..., :2], (-1,)), x, torch.flip(x[..., -2:], (-1,))], dim=-1)
    return torch.amin(torch.stack([p[..., i:i + n] for i in range(5)]), dim=0)


def action_mask(raw_lidar, table: MaskTable):
    """(B, R) lidar -> (B, A) mask: the kernel's counts, the edge penalty,
    a 5-wide erosion, normalized, with a floor where all are blocked."""
    n_iter = MASK["n_iter"]
    ext = torch.clamp(raw_lidar, 0.0, OBS["max_range"]) + table.hull_base
    steps = mask_step_lengths_plain(ext, table.dist_star, n_iter, MASK["upsample"])
    half = steps.shape[-1] // 2
    edge = torch.zeros(half, dtype=steps.dtype, device=steps.device)
    edge[0] = edge[half - 1] = 1.0
    fwd = _min_filter5_reflect(steps[..., :half] - edge)
    bwd = _min_filter5_reflect(steps[..., half:] - edge)
    mask = torch.clamp(torch.cat([fwd, bwd], dim=-1), 0.0, n_iter) / n_iter
    empty = torch.sum(mask, dim=-1, keepdim=True) == 0.0
    return torch.where(empty, torch.clamp(mask, 0.01, 1.0), mask)


# -------------------------------------------------------------- the raster

# background, obstacle, destination, car (HOPE configs.py:80-84) / 255
PALETTE = np.asarray([[0.0, 0.0, 0.0], [150.0, 150.0, 150.0], [69.0, 139.0, 0.0],
                      [30.0, 144.0, 255.0]], np.float32) / 255.0
_DROP_KEY = 1 << 24


def _center(poses, cx_off: float):
    c = torch.cos(poses[:, 2:3])
    s = torch.sin(poses[:, 2:3])
    return c, s, poses[:, 0:1] + c * cx_off, poses[:, 1:2] + s * cx_off


def ego_edge_params(poses, edges, edge_mask, edge_poly, cx_off: float, n: int, res: float,
                    exact: bool = True):
    """((B, P, E) crossing parameters of the live edges, grouped by polygon
    in exact mode; (B, 2) counts)."""
    B = edges.shape[0]
    c, s, cx, cy = _center(poses, cx_off)
    ex = edges.permute(0, 2, 1)
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
    ext = float(np.float32((n - 1) / 2.0) * np.float32(res))
    drop = (~live | (torch.minimum(v1, v2) > ext) | (torch.maximum(v1, v2) <= -ext)
            | (torch.maximum(u1, u2) <= -ext))
    right = ~drop & (torch.minimum(u1, u2) > ext)
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
    nxt = torch.cat([ks[:, 1:], torch.full((B, 1), -1, dtype=ks.dtype, device=ks.device)], dim=1)
    flag = (ks != nxt).to(torch.float32)
    params = torch.stack([torch.gather(r, 1, order) for r in rows] + [flag], dim=1)
    nf = torch.sum(~drop, dim=1, dtype=torch.int32)
    return params.contiguous(), torch.stack([nf, torch.zeros_like(nf)], dim=1).contiguous()


def _quad_coeffs(poses, quads, cx_off: float):
    c, s, cx, cy = _center(poses, cx_off)
    a, b = quads, torch.roll(quads, -1, dims=1)
    ex, ey = b[:, :, 0] - a[:, :, 0], b[:, :, 1] - a[:, :, 1]
    beta = ex * s - ey * c
    gamma = ex * c + ey * s
    alpha = ex * (cy - a[:, :, 1]) - ey * (cx - a[:, :, 0])
    return torch.stack([beta, gamma, alpha, torch.zeros_like(alpha)], dim=-1)


def pixel_coords(n: int, res: float, device=None):
    half = (n - 1) / 2.0
    idx = torch.arange(n * n, device=device)
    i = (idx // n).to(torch.float32)
    j = (idx % n).to(torch.float32)
    return (half - i) * res, (j - half) * res


def _raster(params, cnt, quads, n: int, res: float, chunk: int = 16):
    dev = params.device
    B = params.shape[0]
    v, u = pixel_coords(n, res, dev)
    vv, uu = v[None, :, None], u[None, :, None]
    pal = torch.as_tensor(PALETTE, device=dev)
    outs = []
    for b0 in range(0, B, chunk):
        p, ct, qd = params[b0:b0 + chunk], cnt[b0:b0 + chunk], quads[b0:b0 + chunk]
        nf = ct[:, 0:1].long()
        em = int(nf.max()) if len(ct) else 0
        p = p[:, :, :em]
        full = torch.arange(em, device=dev)[None, :] < nf
        straddle = (p[:, 0, None, :] > vv) != (p[:, 1, None, :] > vv)
        cross = straddle & (uu < vv * p[:, 2, None, :] + p[:, 3, None, :]) & full[:, None, :]
        flag = (p[:, 4] != 0.0) & full
        group = torch.cumsum(flag.long(), dim=1) - flag.long()
        counts = torch.zeros(cross.shape, dtype=torch.int32, device=dev)
        counts.scatter_add_(2, group[:, None, :].expand_as(cross), cross.to(torch.int32))
        obst = torch.any(counts % 2 == 1, dim=-1)
        hp = (qd[:, :, None, 0] * v + qd[:, :, None, 1] * u + qd[:, :, None, 2]) >= 0.0
        cls = torch.where(torch.all(hp[:, 4:8], dim=1), 3,
                          torch.where(torch.all(hp[:, 0:4], dim=1), 2, torch.where(obst, 1, 0)))
        outs.append(pal[cls])
    return torch.cat(outs).reshape(B, n, n, 3)


def cx_off() -> float:
    return (VEHICLE["front_hang"] + VEHICLE["wheel_base"] - VEHICLE["rear_hang"]) / 2.0


def render_bev(poses, vehicle_boxes, dest_boxes, edges, edge_mask, edge_poly):
    """(B, 3, n, n) images (per-polygon parity): the raster kernel's
    definition."""
    n, res = OBS["img_size"], OBS["img_res"]
    params, cnt = ego_edge_params(poses, edges, edge_mask, edge_poly, cx_off(), n, res)
    quads = torch.cat([_quad_coeffs(poses, dest_boxes, cx_off()),
                       _quad_coeffs(poses, vehicle_boxes, cx_off())], dim=1)
    return _raster(params, cnt, quads, n, res).permute(0, 3, 1, 2)


# --------------------------------------------------------------- the sweep


def swept_collide_plain(car_edges, car_live, scene_edges, scene_mask, chunk: int = 64,
                        per_segment: bool = False):
    """The sweep kernel's definition: the divide-free segment test of every
    (car segment, edge) pair; (B, K), or (B, K, S) per car segment."""
    qx = scene_edges[:, None, None, :, 0]
    qy = scene_edges[:, None, None, :, 1]
    sx = scene_edges[:, None, None, :, 2] - qx
    sy = scene_edges[:, None, None, :, 3] - qy
    em = scene_mask[:, None, None, :]
    B, K, S, _ = car_edges.shape
    out = torch.zeros((B, K), dtype=torch.bool, device=car_edges.device)
    segs = []
    for s0 in range(0, S, chunk):
        c = car_edges[:, :, s0:s0 + chunk, None, :]
        px, py = c[..., 0], c[..., 1]
        rx, ry = c[..., 2] - px, c[..., 3] - py
        live = car_live[:, :, s0:s0 + chunk, None]
        rxs = rx * sy - ry * sx
        qpx, qpy = qx - px, qy - py
        qpxr = qpx * ry - qpy * rx
        qpxs = qpx * sy - qpy * sx
        arxs = torch.abs(rxs)
        hit = ((qpxs * rxs >= 0.0) & (torch.abs(qpxs) <= arxs) & (qpxr * rxs >= 0.0)
               & (torch.abs(qpxr) <= arxs) & (rxs != 0.0) & live & em)
        if per_segment:
            segs.append(torch.any(hit, dim=-1))
        else:
            out |= torch.any(hit.flatten(2), dim=-1)
    return torch.cat(segs, dim=-1) if per_segment else out
