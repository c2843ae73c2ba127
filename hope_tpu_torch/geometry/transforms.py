"""Pose / rigid-transform helpers over leading batch dims
(counterpart of ``hope_tpu/geometry/transforms.py``)."""
from __future__ import annotations

import torch


def pose_to_box(pose, corners):
    """(..., 3) poses [x, y, theta] and (4, 2) footprint corners -> (..., 4, 2)
    world-frame corners."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    cx = corners[:, 0]
    cy = corners[:, 1]
    wx = c[..., None] * cx - s[..., None] * cy + x[..., None]
    wy = s[..., None] * cx + c[..., None] * cy + y[..., None]
    return torch.stack([wx, wy], dim=-1)


def box_to_edges(box):
    """(..., V, 2) ring vertices -> (..., V, 4) closed-ring edges [x1, y1, x2, y2]."""
    nxt = torch.roll(box, shifts=-1, dims=-2)
    return torch.cat([box, nxt], dim=-1)


def world_to_ego(points, pose):
    """(..., 2) world points into the ego frame of broadcastable (..., 3) poses."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    dx = points[..., 0] - x
    dy = points[..., 1] - y
    ex = c * dx + s * dy
    ey = -s * dx + c * dy
    return torch.stack([ex, ey], dim=-1)


def edges_to_ego(edges, pose):
    """(..., E, 4) edges into the ego frame of (..., 3) poses."""
    p1 = world_to_ego(edges[..., 0:2], pose[..., None, :])
    p2 = world_to_ego(edges[..., 2:4], pose[..., None, :])
    return torch.cat([p1, p2], dim=-1)


def polygon_area(verts, mask=None):
    """Shoelace area of (..., V, 2) polygons; ``mask`` (..., V) selects live
    vertices (dead ones collapse onto the first vertex)."""
    x = verts[..., 0]
    y = verts[..., 1]
    if mask is not None:
        x = torch.where(mask, x, x[..., :1])
        y = torch.where(mask, y, y[..., :1])
    xn = torch.roll(x, -1, dims=-1)
    yn = torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))
