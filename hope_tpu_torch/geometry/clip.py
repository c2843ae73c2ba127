"""Intersection area of two convex quadrilaterals
(counterpart of ``hope_tpu/geometry/clip.py``, the Liang–Barsky + Green's
theorem form), over leading batch dims."""
from __future__ import annotations

import torch


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
