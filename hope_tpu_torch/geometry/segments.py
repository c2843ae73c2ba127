"""Batched segment / ray intersection tests
(counterpart of ``hope_tpu/geometry/segments.py``).

Every function broadcasts over leading batch dims. Padded (degenerate,
zero-length) edges never report intersections.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _cross2(ax, ay, bx, by):
    return ax * by - ay * bx


def _pair_terms(e1, e2):
    p = e1[..., :, None, 0:2]
    r = e1[..., :, None, 2:4] - p
    q = e2[..., None, :, 0:2]
    s = e2[..., None, :, 2:4] - q
    rxs = _cross2(r[..., 0], r[..., 1], s[..., 0], s[..., 1])
    qp = q - p
    qpxr = _cross2(qp[..., 0], qp[..., 1], r[..., 0], r[..., 1])
    qpxs = _cross2(qp[..., 0], qp[..., 1], s[..., 0], s[..., 1])
    return p, r, s, rxs, qpxr, qpxs


def segments_intersect(e1, e2, tol: float = 0.0):
    """(..., M, 4) x (..., N, 4) segments -> (..., M, N) bool, proper or touching
    intersection. Parallel (incl. collinear-overlapping) pairs report False."""
    _, _, _, rxs, qpxr, qpxs = _pair_terms(e1, e2)
    parallel = rxs == 0.0
    denom = torch.where(parallel, 1.0, rxs)
    t = qpxs / denom
    u = qpxr / denom
    lo, hi = -tol, 1.0 + tol
    return (t >= lo) & (t <= hi) & (u >= lo) & (u <= hi) & ~parallel


def segment_intersection_points(e1, e2, tol: float = 1e-8):
    """Pairwise intersection points (..., M, N, 2); +inf where none."""
    p, r, s, rxs, qpxr, qpxs = _pair_terms(e1, e2)
    parallel = rxs == 0.0
    denom = torch.where(parallel, 1.0, rxs)
    t = qpxs / denom
    u = qpxr / denom
    len1 = torch.clamp(torch.linalg.norm(r, dim=-1), min=_EPS)
    len2 = torch.clamp(torch.linalg.norm(s, dim=-1), min=_EPS)
    t_tol = tol / len1
    u_tol = tol / len2
    hit = ((t >= -t_tol) & (t <= 1.0 + t_tol) & (u >= -u_tol)
           & (u <= 1.0 + u_tol) & ~parallel)
    pts = p + t[..., None] * r
    return torch.where(hit[..., None], pts, torch.inf)


def ray_hits(angles, edges, max_range: float):
    """Distance from the origin along each ray (R,) to (..., E, 4) ego-frame
    edges -> (..., R), clipped to [0, max_range]."""
    c = torch.cos(angles)
    s = torch.sin(angles)
    q = edges[..., None, :, 0:2]
    e = edges[..., None, :, 2:4] - q
    rx = c[..., :, None]
    ry = s[..., :, None]
    rxs = rx * e[..., 1] - ry * e[..., 0]
    parallel = rxs == 0.0
    denom = torch.where(parallel, 1.0, rxs)
    qpx = q[..., 0]
    qpy = q[..., 1]
    t = (qpx * e[..., 1] - qpy * e[..., 0]) / denom
    u = (qpx * ry - qpy * rx) / denom
    valid = (~parallel) & (t >= 0.0) & (u >= 0.0) & (u <= 1.0)
    t = torch.where(valid, t, max_range)
    return torch.clamp(torch.amin(t, dim=-1), 0.0, max_range)
