"""Batched reward terms (counterpart of ``hope_tpu/envs/rewards.py``)."""
from __future__ import annotations

import math

import torch

from ..config import EnvConfig
from ..geometry import convex_clip_area, polygon_area

# status codes (reference env/vehicle.py:13-18)
CONTINUE, ARRIVED, COLLIDED, OUTBOUND, OUTTIME = 0, 1, 2, 3, 4


def angle_diff(a, b):
    """Heading difference folded to [0, pi/2]."""
    d = torch.arccos(torch.clamp(torch.cos(a - b), -1.0, 1.0))
    return torch.where(d < math.pi / 2, d, math.pi - d)


def step_reward_terms(prev_pose, cur_pose, t, vehicle_box, scene_dest, scene_start,
                      dest_box, accum_arrive, cfg: EnvConfig):
    """Per-step shaped reward terms for a batch.

    Args: poses (B, 3), t (B,) float step counter, vehicle_box / dest_box
    (B, 4, 2), accum_arrive (B,).

    Returns (terms (B, 5), new_accum (B,)): [time, rs_dist, dist, angle,
    box_union]; rs_dist is 0 unless its weight is non-zero.
    """
    time_cost = -torch.tanh(t / (10.0 * cfg.tolerant_time))

    if cfg.reward.w_rs_dist != 0.0:
        from ..planning import reeds_shepp as rs

        maxc = cfg.vehicle.max_curvature
        cur = rs.optimal_length(cur_pose, scene_dest, maxc)
        prev = rs.optimal_length(prev_pose, scene_dest, maxc)
        norm = rs.optimal_length(scene_start, scene_dest, maxc)
        rs_reward = torch.exp(-cur / norm) - torch.exp(-prev / norm)
    else:
        rs_reward = torch.zeros_like(time_cost)

    dist_norm = torch.clamp(torch.hypot(scene_dest[:, 0] - scene_start[:, 0],
                                        scene_dest[:, 1] - scene_start[:, 1]), min=10.0)
    d_cur = torch.hypot(cur_pose[:, 0] - scene_dest[:, 0], cur_pose[:, 1] - scene_dest[:, 1])
    d_prev = torch.hypot(prev_pose[:, 0] - scene_dest[:, 0], prev_pose[:, 1] - scene_dest[:, 1])
    dist_reward = (d_prev - d_cur) / dist_norm

    a_cur = angle_diff(cur_pose[:, 2], scene_dest[:, 2])
    a_prev = angle_diff(prev_pose[:, 2], scene_dest[:, 2])
    angle_reward = (a_prev - a_cur) / math.pi

    inter = convex_clip_area(vehicle_box, dest_box)
    dest_area = polygon_area(dest_box)
    ratio = inter / (2.0 * dest_area - inter)
    # monotonic accumulator (reference :221-226)
    grew = ratio >= accum_arrive
    box_union = torch.where(grew, ratio - accum_arrive, 0.0)
    new_accum = torch.where(grew, ratio, accum_arrive)

    terms = torch.stack([time_cost, rs_reward, dist_reward, angle_reward, box_union], dim=-1)
    return terms, new_accum


def shaped_reward(terms, status, cfg: EnvConfig):
    """(B,) scalar training reward (reference env_wrapper.reward_shaping)."""
    rc = cfg.reward
    w = torch.tensor([rc.w_time, rc.w_rs_dist, rc.w_dist, rc.w_angle, rc.w_box_union],
                     dtype=terms.dtype, device=terms.device)
    r = torch.sum(w * terms, dim=-1)
    for code, value in ((OUTTIME, rc.r_outtime), (OUTBOUND, rc.r_outbound),
                        (COLLIDED, rc.r_collided), (ARRIVED, rc.r_arrived)):
        r = torch.where(status == code, value, r)
    return r * rc.ratio
