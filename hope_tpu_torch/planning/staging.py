"""Staging poses for the pure-MPC approach phase
(counterpart of ``hope_tpu/planning/staging.py``).

Receding-horizon iLQR aimed straight at the slot cannot steer the hardest
scenes into poses from which the Reeds-Shepp endgame validates. So, as a
person parking does, the approach drives to a *staging pose* near the slot from which
the final maneuver is known to work, and the RS endgame takes over there.

For each scenario a fixed set of candidate staging poses around the slot is
checked once: a dense polar grid (radii x position angles x headings, relative
to the slot), each valid where a collision-free RS path staging -> slot exists
within ``max_tries`` words; then the parallel-parking wiggle templates of
``parallel_park``, placed at the slot on the aisle side and swept against the
scene. The MPC runner then targets, each replan, the valid candidate that
minimizes distance-to-go + completion length (``pick_goal``), and tries to
latch a two-segment plan pose -> staging -> slot (``waypoint_latch``).

Where the reference scans its candidates one at a time, this module batches
them: the polar grid as (B * S_chunk) rows of one RS search, and the
templates as the word axis of the sweep kernel (``ops.swept_collide``), in
chunks.
"""
from __future__ import annotations

import math
from dataclasses import replace
from functools import lru_cache
from typing import NamedTuple

import torch

from ..geometry import box_to_edges, pose_to_box
from ..ops.sweep_collide import swept_collide
from . import reeds_shepp as rs_mod
from .parallel_park import N_WIGGLE_SEG, build_templates
from .rs_select import RSPath, _outbound, build_action_queue, find_path_batch

# dense polar grid around the slot: radii x position-angles x headings, all
# relative to the slot heading (the reference's grid)
_RADII = (2.0, 3.0, 4.5, 6.0, 8.0)
_N_ANGLES = 8
_N_HEADINGS = 8
N_STAGING = len(_RADII) * _N_ANGLES * _N_HEADINGS

# slow-maneuver penalty added to a wiggle template's L: valid polar
# completions are always < 20 m, so +30 ranks every wiggle below every valid
# single-RS completion while keeping wiggles inside the replan window
_WIGGLE_PENALTY = 30.0

# staging candidates (polar) and templates per chunk of the batched searches:
# the polar chunk keeps the repeated (rows, E, 4) edges near this many bytes,
# the template chunk keeps the swept outlines (B, T_chunk, 4 N, 4) near it
_CHUNK_BYTES = 100e6


def staging_candidates(dest, radii=_RADII, n_angles: int = _N_ANGLES,
                       n_headings: int = _N_HEADINGS):
    """Candidate staging poses: dest (..., 3) slot poses -> (..., S, 3),
    S = len(radii) * n_angles * n_headings, ordered radius, angle, heading."""
    thd = dest[..., 2:3]
    dev, dt = dest.device, dest.dtype
    r = torch.tensor(radii, dtype=dt).to(dev)                              # (R,)
    phi = thd + torch.arange(n_angles, dtype=dt, device=dev) * (2 * math.pi / n_angles)
    hd = thd + torch.arange(n_headings, dtype=dt, device=dev) * (2 * math.pi / n_headings)
    x = dest[..., 0, None, None] + r[:, None] * torch.cos(phi)[..., None, :]   # (..., R, A)
    y = dest[..., 1, None, None] + r[:, None] * torch.sin(phi)[..., None, :]
    xy = torch.stack([x, y], dim=-1).flatten(-3, -2)                       # (..., R*A, 2)
    n_xy = xy.shape[-2]
    return torch.cat([torch.repeat_interleave(xy, n_headings, dim=-2),
                      hd.tile(n_xy)[..., None]], dim=-1)


class StagingSet(NamedTuple):
    poses: torch.Tensor    # (B, S, 3)
    L: torch.Tensor        # (B, S) completion length, +inf where invalid
    lengths: torch.Tensor  # (B, S, K) completion segment lengths (signed, m)
    steers: torch.Tensor   # (B, S, K) completion segment steers {-1, 0, 1}


@lru_cache(maxsize=None)
def _templates(maxc: float, dims: tuple, device: torch.device):
    """``build_templates`` at these dims, as tensors on ``device`` (built once)."""
    tl, ts, tp = build_templates(maxc, dims=dims)
    return tuple(torch.as_tensor(a, device=device) for a in (tl, ts, tp))


def template_sweep(env, scenes, w_pose, w_len, w_steer):
    """(B, T) bool: the swept car of each placed template collides with a live
    edge or leaves the bounds (``traj_collides`` of the reference, with the
    sweep through ``ops.swept_collide``). w_pose (B, T, 3), w_len and w_steer
    (B, T, K) in metres and {-1, 0, 1}."""
    cfg = env.cfg
    maxc = cfg.vehicle.max_curvature
    poses, mask, _ = rs_mod.sample_path(w_len * maxc, w_steer, w_pose, maxc,
                                        cfg.rs_max_points, cfg.rs_step_size)   # (B, T, N, ·)
    B, T, N = poses.shape[:3]
    outbound = _outbound(poses, mask, scenes.bounds[:, None, :])
    car = box_to_edges(pose_to_box(poses, env.corners)).reshape(B, T, N * 4, 4)
    live4 = torch.repeat_interleave(mask, 4, dim=-1)
    return swept_collide(car.contiguous(), live4.contiguous(), scenes.edges.contiguous(),
                         scenes.edge_mask.contiguous()) | outbound


def _live_edges_first(scenes):
    """The scenes with each env's live edges moved to the front and the edge
    slots cut to the batch's largest live count (the searches' results do
    not depend on edge order, and dead slots never hit). One host read."""
    mask = scenes.edge_mask
    n = max(1, int(mask.sum(dim=1).max()))
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :n]
    return replace(scenes, edges=torch.gather(scenes.edges, 1, order[..., None].expand(-1, -1, 4)),
                   edge_mask=torch.gather(mask, 1, order),
                   edge_poly=torch.gather(scenes.edge_poly, 1, order))


def compute_staging(env, scenes, max_tries: int = 6,
                    parallel_templates: bool = True) -> StagingSet:
    """Validate every candidate's completion against the scene obstacles.

    Two candidate families share one StagingSet: the polar grid, each with
    its single-RS-word completion (valid iff a collision-free RS path staging
    -> dest exists within ``max_tries`` shortest words), and the multi-cusp
    parallel-parking templates (``parallel_park.build_templates``), each
    placed at the slot, mirrored to the aisle side, and swept. The winning
    completion's segments are kept (RS words padded to the template segment
    count), so the MPC runner can execute it after reaching the staging pose.
    """
    cfg = env.cfg
    maxc = cfg.vehicle.max_curvature
    scenes = _live_edges_first(scenes)
    B, E = scenes.edges.shape[:2]
    dest = scenes.dest
    cands = staging_candidates(dest)                                        # (B, S, 3)
    S = cands.shape[1]
    chunk = max(1, min(S, int(_CHUNK_BYTES // (B * E * 16))))
    found, L, lengths, steers = [], [], [], []
    for s0 in range(0, S, chunk):
        c = min(chunk, S - s0)
        def rep(t):
            return t[:, None].expand(B, c, *t.shape[1:]).reshape(B * c, *t.shape[1:])

        r = find_path_batch(cands[:, s0:s0 + c].reshape(B * c, 3), rep(dest), maxc, env.corners,
                            rep(scenes.edges), rep(scenes.edge_mask), rep(scenes.bounds),
                            n_points=cfg.rs_max_points, step_m=cfg.rs_step_size,
                            max_tries=max_tries)
        found.append(r.found.reshape(B, c))
        L.append(r.L.reshape(B, c))
        lengths.append(r.lengths.reshape(B, c, -1))
        steers.append(r.steers.reshape(B, c, -1))
    valid = torch.cat(found, dim=1)
    L = torch.where(valid, torch.cat(L, dim=1), torch.inf)
    lengths, steers = torch.cat(lengths, dim=1), torch.cat(steers, dim=1)
    if not parallel_templates:
        return StagingSet(poses=cands, L=L, lengths=lengths, steers=steers)

    v = cfg.vehicle
    tl, ts, tp = _templates(maxc, (v.rear_hang, v.front_hang + v.wheel_base, v.width / 2),
                            dest.device)
    T = tl.shape[0]
    thd = dest[:, 2]
    ax = torch.stack([torch.cos(thd), torch.sin(thd)], -1)                  # (B, 2) slot axis
    nx = torch.stack([-torch.sin(thd), torch.cos(thd)], -1)                 # (B, 2) slot normal
    # aisle side: the episode start pose is in the aisle by construction
    ysign = torch.where(torch.sum((scenes.start[:, :2] - dest[:, :2]) * nx, -1) >= 0, 1.0, -1.0)
    # mirror to the aisle side: (x, y, th) -> (x, -y, -th), steers flip
    w_pose = torch.cat([dest[:, None, :2] + tp[None, :, 0, None] * ax[:, None]
                        + (ysign[:, None] * tp[None, :, 1])[..., None] * nx[:, None],
                        (thd[:, None] + ysign[:, None] * tp[None, :, 2])[..., None]], dim=-1)
    w_steer = ts[None] * ysign[:, None, None]                                # (B, T, K)
    w_len = tl[None].expand(B, T, tl.shape[1])
    t_chunk = max(1, int(_CHUNK_BYTES // (B * cfg.rs_max_points * 4 * 16)))
    collide = torch.cat([template_sweep(env, scenes, w_pose[:, t0:t0 + t_chunk],
                                        w_len[:, t0:t0 + t_chunk], w_steer[:, t0:t0 + t_chunk])
                         for t0 in range(0, T, t_chunk)], dim=1)
    tw_L = torch.where(~collide, torch.sum(torch.abs(w_len), -1) + _WIGGLE_PENALTY, torch.inf)

    pad = (0, N_WIGGLE_SEG - lengths.shape[-1])
    return StagingSet(
        poses=torch.cat([cands, w_pose], dim=1),
        L=torch.cat([L, tw_L], dim=1),
        lengths=torch.cat([torch.nn.functional.pad(lengths, pad), w_len], dim=1),
        steers=torch.cat([torch.nn.functional.pad(steers, pad), w_steer], dim=1),
    )


def concat_queues(q1, n1, q2, n2, queue_len: int):
    """Concatenate two batches of fixed-shape action queues, [q1[:n1],
    q2[:n2]] per env, clamped to ``queue_len`` (a truncated plan ends
    mid-path and hands control back; the executed prefix is swept)."""
    idx = torch.arange(queue_len, device=q1.device)
    take2 = torch.clamp(idx - n1[:, None], 0, queue_len - 1)
    q2t = torch.gather(q2, 1, take2[..., None].expand(-1, -1, q2.shape[-1]).long())
    q = torch.where((idx < n1[:, None])[..., None], q1, q2t)
    n = torch.clamp(n1 + n2, max=queue_len)
    return q * (idx < n[:, None])[..., None], n


def _norm_xy(pose, staging: StagingSet):
    """(B, S) distance from each pose to each staging pose (as
    ``jnp.linalg.norm``: the square root of the sum of squares)."""
    d = pose[:, None, :2] - staging.poses[..., :2]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def waypoint_latch(env, staging: StagingSet, pose, scenes, hybrid, active,
                   step_ratio: float, k_best: int = 4, offset: int = 0):
    """Two-segment RS latch: try RS(pose -> staging_s) for the ``k_best``
    cheapest valid staging candidates, from rank ``offset`` on; the first
    collision-free one latches the concatenated plan [RS(pose -> s),
    completion(s -> dest)], both swept. The ``k_best`` searches run as one
    batched search of k_best * B rows.

    Returns (hybrid', latched (B,) bool)."""
    from ..agents.hybrid import HybridState

    cfg = env.cfg
    B = pose.shape[0]
    S = staging.poses.shape[1]
    Q = hybrid.queue.shape[1]
    ar = torch.arange(B, device=pose.device)

    # a stable sort: the many +inf candidates keep their order, as
    # jnp.argsort does; the slice start is clamped as dynamic_slice clamps it
    order_full = torch.argsort(_norm_xy(pose, staging) + staging.L, dim=1, stable=True)
    start = min(max(offset, 0), S - k_best)
    order = order_full[:, start:start + k_best]                             # (B, k)
    s_pose = staging.poses[ar[:, None], order]                              # (B, k, 3)
    rs1 = find_path_batch(pose[:, None].expand(B, k_best, 3).reshape(-1, 3),
                          s_pose.reshape(-1, 3), cfg.vehicle.max_curvature, env.corners,
                          *(t[:, None].expand(B, k_best, *t.shape[1:]).reshape(B * k_best,
                                                                                *t.shape[1:])
                            for t in (scenes.edges, scenes.edge_mask, scenes.bounds)),
                          n_points=cfg.rs_max_points, step_m=cfg.rs_step_size,
                          max_tries=cfg.rs_max_tries)
    ok = rs1.found.reshape(B, k_best) & torch.isfinite(staging.L[ar[:, None], order])
    found_any = torch.any(ok, dim=1)
    k = torch.argmax(ok.to(torch.uint8), dim=1)                             # first ok
    sel = lambda t: t.reshape(B, k_best, *t.shape[1:])[ar, k]  # noqa: E731
    sel_rs1 = RSPath(found=found_any,
                     lengths=torch.where(found_any[:, None], sel(rs1.lengths), 0.0),
                     steers=torch.where(found_any[:, None], sel(rs1.steers), 0.0),
                     L=torch.where(found_any, sel(rs1.L), torch.inf))
    sel_idx = torch.where(found_any, order[ar, k], 0)
    rs2 = RSPath(found=found_any, lengths=staging.lengths[ar, sel_idx],
                 steers=staging.steers[ar, sel_idx], L=staging.L[ar, sel_idx])
    q1, n1 = build_action_queue(sel_rs1, step_ratio, Q)
    q2, n2 = build_action_queue(rs2, step_ratio, Q)
    qc, nc = concat_queues(q1, n1, q2, n2, Q)

    take = found_any & active & ~hybrid.executing
    new = HybridState(queue=torch.where(take[:, None, None], qc, hybrid.queue),
                      length=torch.where(take, nc, hybrid.length),
                      cursor=torch.where(take, 0, hybrid.cursor).to(torch.int32))
    return new, take


def pick_goal(staging: StagingSet, pose, dest):
    """Per-replan approach target: the valid staging pose minimizing
    distance-to-go + completion length (the first such), the slot itself
    where none validates. Returns (goal (B, 3), has_staging (B,) bool)."""
    cost = _norm_xy(pose, staging) + staging.L                              # (B, S)
    best = torch.argmin(cost, dim=1)
    has = torch.isfinite(torch.amin(cost, dim=1))
    goal = staging.poses[torch.arange(pose.shape[0], device=pose.device), best]
    return torch.where(has[:, None], goal, dest), has
