"""Intersection area of two convex quadrilaterals
(counterpart of ``hope_tpu/geometry/clip.py``), over leading batch dims: the
Liang–Barsky + Green's theorem form (``convex_clip_area``, the one the env
uses) and the Sutherland–Hodgman vertex-buffer form
(``convex_clip_area_sh``)."""
from __future__ import annotations

import torch

from .transforms import polygon_area

_MAXV = 8  # a convex quad clipped by 4 half-planes grows by at most 1 vertex a plane


def _clip_halfplane(verts, n, a, b):
    """Clip the convex polygons ``verts[..., :n]`` (..., _MAXV, 2) by the
    half-plane left of the directed edges a -> b (..., 2). Returns the new
    (verts, n): the kept vertices and the crossings in order, compacted to
    the front by a one-hot product as the JAX package forms it."""
    ex, ey = (b[..., 0] - a[..., 0])[..., None], (b[..., 1] - a[..., 1])[..., None]
    idx = torch.arange(_MAXV, device=verts.device)
    nxt_idx = torch.where(idx + 1 >= n[..., None], 0, idx + 1)
    cur = verts
    nxt = torch.gather(verts, -2, nxt_idx[..., None].expand(verts.shape))
    ax, ay = a[..., 0, None], a[..., 1, None]
    d_cur = ex * (cur[..., 1] - ay) - ey * (cur[..., 0] - ax)
    d_nxt = ex * (nxt[..., 1] - ay) - ey * (nxt[..., 0] - ax)
    in_cur = d_cur >= 0.0
    in_nxt = d_nxt >= 0.0
    denom = d_cur - d_nxt
    t = d_cur / torch.where(denom == 0.0, 1.0, denom)
    ip = cur + t[..., None] * (nxt - cur)
    active = idx < n[..., None]
    emit_cur = in_cur & active
    emit_ip = (in_cur != in_nxt) & active
    # interleave [cur_0, ip_0, cur_1, ip_1, ...], then compact by prefix sum
    pts = torch.stack([cur, ip], dim=-2).reshape(verts.shape[:-2] + (2 * _MAXV, 2))
    flags = torch.stack([emit_cur, emit_ip], dim=-1).reshape(verts.shape[:-2] + (2 * _MAXV,))
    pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
    pos = torch.where(flags, pos, -1)
    onehot = (pos[..., :, None] == idx).to(verts.dtype)                   # (..., 2M, M)
    return torch.matmul(onehot.transpose(-1, -2), pts), torch.sum(flags, dim=-1)


def convex_clip_area_sh(subject, clip):
    """Area of the intersection of (..., 4, 2) CCW quads ``subject`` and
    ``clip`` by Sutherland–Hodgman clipping (0 where they are disjoint)."""
    lead = subject.shape[:-2]
    verts = torch.zeros(lead + (_MAXV, 2), dtype=subject.dtype, device=subject.device)
    verts[..., :4, :] = subject
    n = torch.full(lead, 4, dtype=torch.int64, device=subject.device)
    for i in range(4):
        verts, n = _clip_halfplane(verts, n, clip[..., i, :], clip[..., (i + 1) % 4, :])
    mask = torch.arange(_MAXV, device=subject.device) < n[..., None]
    return torch.where(n >= 3, polygon_area(verts, mask), 0.0)


def _green_portions(P, Q, strict: bool):
    """Green's-theorem contribution (..., ) of the parts of P's edges inside Q.

    Each edge of P meets convex Q in one parameter interval [t0, t1]; summing
    ∮x dy over those parts and over Q's parts inside P gives the area of P∩Q.
    ``strict`` drops portions that run exactly along Q's boundary, so a shared
    collinear run is counted once.
    """
    d = torch.roll(P, -1, dims=-2) - P                     # (..., 4, 2)
    e = torch.roll(Q, -1, dims=-2) - Q
    nx, ny = -e[..., 1], e[..., 0]                         # inward normals (CCW)

    alpha = ((P[..., :, None, 0] - Q[..., None, :, 0]) * nx[..., None, :]
             + (P[..., :, None, 1] - Q[..., None, :, 1]) * ny[..., None, :])
    beta = d[..., :, None, 0] * nx[..., None, :] + d[..., :, None, 1] * ny[..., None, :]

    para = beta == 0.0
    tc = -alpha / torch.where(para, 1.0, beta)
    t0 = torch.amax(torch.where(beta > 0.0, tc, 0.0), dim=-1)
    t1 = torch.amin(torch.where(beta < 0.0, tc, 1.0), dim=-1)
    ok_para = torch.where(para, alpha > 0.0 if strict else alpha >= 0.0, True)
    valid = torch.all(ok_para, dim=-1) & (t1 > t0)
    t0 = torch.where(valid, torch.clamp(t0, min=0.0), 0.0)
    t1 = torch.where(valid, torch.clamp(t1, max=1.0), 0.0)
    return torch.sum(d[..., 1] * (P[..., 0] * (t1 - t0)
                                  + 0.5 * d[..., 0] * (t1 * t1 - t0 * t0)), dim=-1)


def convex_clip_area(subject, clip):
    """Area of the intersection of (..., 4, 2) CCW quads ``subject`` and ``clip``."""
    # ∮x dy is translation-sensitive in float32; centring removes the cancellation
    c = 0.5 * (torch.mean(subject, dim=-2, keepdim=True)
               + torch.mean(clip, dim=-2, keepdim=True))
    subject = subject - c
    clip = clip - c
    return torch.clamp(_green_portions(subject, clip, strict=False)
                       + _green_portions(clip, subject, strict=True), min=0.0)
