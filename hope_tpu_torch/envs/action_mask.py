"""Collision-horizon action mask over the 42-action discrete set
(counterpart of ``hope_tpu/envs/action_mask.py``).

The ``dist_star`` table (lidar ray x action x future sub-step clearance) is
built once; per step, ``ops.mask_step_lengths`` reduces it against the lidar
and :func:`postprocess` turns the counts into the mask.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import ActionMaskConfig, LidarConfig, VehicleConfig
from ..device import resolve_device
from ..geometry import segment_intersection_points
from ..ops.mask_steps import mask_step_lengths, mask_step_lengths_plain, upsample_circular
from .lidar import vehicle_boundary


def discrete_actions(cfg: ActionMaskConfig, vcfg: VehicleConfig) -> np.ndarray:
    """The 42-entry [steer, speed] set: steer sweeps +max..-max in 2*precision+1
    bins, first with speed +1 then -1."""
    p = cfg.precision
    steers = vcfg.max_steer - np.arange(2 * p + 1) * (vcfg.max_steer / p)
    fwd = np.stack([steers, np.full_like(steers, cfg.step_speed)], axis=1)
    bwd = np.stack([steers, np.full_like(steers, -cfg.step_speed)], axis=1)
    return np.concatenate([fwd, bwd]).astype(np.float32)  # (42, 2)


def future_boxes(cfg: ActionMaskConfig, vcfg: VehicleConfig) -> np.ndarray:
    """(n_action, n_iter, 4, 2) corners of the vehicle after k+1 arc sub-steps
    of each action from the ego origin."""
    acts = discrete_actions(cfg, vcfg)
    steer, speed = acts[:, 0], acts[:, 1]
    ds = 0.5 * speed / cfg.n_iter
    curv = np.tan(steer) / vcfg.wheel_base
    k = np.arange(1, cfg.n_iter + 1)
    phi = np.outer(curv * ds, k)
    small = np.abs(curv) < 1e-9
    curv_safe = np.where(small, 1.0, curv)
    px = np.where(small[:, None], np.outer(ds, k), np.sin(phi) / curv_safe[:, None])
    py = np.where(small[:, None], 0.0, (1.0 - np.cos(phi)) / curv_safe[:, None])

    corners = vcfg.box_corners()
    c, s = np.cos(phi), np.sin(phi)
    wx = c[..., None] * corners[:, 0] - s[..., None] * corners[:, 1] + px[..., None]
    wy = s[..., None] * corners[:, 0] + c[..., None] * corners[:, 1] + py[..., None]
    return np.stack([wx, wy], axis=-1).astype(np.float32)


class ActionMaskTable(NamedTuple):
    """Precomputed constants; build once via :func:`build_table`."""

    dist_star: torch.Tensor      # (R*up, A, n_iter)
    hull_base: torch.Tensor      # (R,) vehicle hull distance per beam
    actions: torch.Tensor        # (A, 2) physical [steer, speed]
    actions_norm: torch.Tensor   # (A, 2) normalized to model units


def build_table(mask_cfg: ActionMaskConfig = ActionMaskConfig(),
                lidar_cfg: LidarConfig = LidarConfig(),
                vcfg: VehicleConfig = VehicleConfig(), device=None) -> ActionMaskTable:
    """Build dist_star (reference precompute) on ``device``, CUDA unless
    named (:func:`resolve_device`)."""
    device = resolve_device(device)
    R = lidar_cfg.n_beams
    far = lidar_cfg.max_range * 10.0
    ang = np.arange(R) / R * 2 * math.pi
    ray_edges = np.zeros((R, 4), np.float32)
    ray_edges[:, 2] = np.cos(ang) * far
    ray_edges[:, 3] = np.sin(ang) * far

    boxes = future_boxes(mask_cfg, vcfg)
    nxt = np.roll(boxes, -1, axis=2)
    box_edges = np.concatenate([nxt, boxes], axis=-1).reshape(-1, 4)

    pts = segment_intersection_points(torch.as_tensor(ray_edges, device=device),
                                      torch.as_tensor(box_edges, device=device),
                                      tol=1e-8)
    d = torch.linalg.norm(pts, dim=-1)
    d = torch.where(torch.isinf(d), 0.0, d)
    A = mask_cfg.n_actions
    dist_star = torch.amax(d.reshape(R, A, mask_cfg.n_iter, 4), dim=-1)
    dist_star = upsample_circular(dist_star, mask_cfg.upsample, dim=0)

    acts = discrete_actions(mask_cfg, vcfg)
    return ActionMaskTable(
        dist_star=dist_star.contiguous(),
        hull_base=vehicle_boundary(lidar_cfg, vcfg, device),
        actions=torch.as_tensor(acts, device=device),
        actions_norm=torch.as_tensor(
            acts / np.array([vcfg.max_steer, 1.0], np.float32), device=device),
    )


def _extend(raw_lidar, table: ActionMaskTable, lidar_cfg: LidarConfig):
    return torch.clamp(raw_lidar, 0.0, lidar_cfg.max_range) + table.hull_base


def step_lengths(raw_lidar, table: ActionMaskTable, cfg: ActionMaskConfig,
                 lidar_cfg: LidarConfig = LidarConfig()):
    """(B, R) raw lidar -> (B, A) collision-free sub-step counts through the
    plain version, on any device: min over (ray, k) of (blocked ? k : n_iter),
    which equals the per-ray first blocked sub-step, min over rays."""
    return mask_step_lengths_plain(_extend(raw_lidar, table, lidar_cfg),
                                   table.dist_star, cfg.n_iter, cfg.upsample)


def _min_filter5_reflect(x):
    """scipy minimum_filter1d(size=5, mode='reflect') along the last dim."""
    n = x.shape[-1]
    p = torch.cat([torch.flip(x[..., :2], (-1,)), x, torch.flip(x[..., -2:], (-1,))], dim=-1)
    return torch.amin(torch.stack([p[..., i:i + n] for i in range(5)]), dim=0)


@functools.lru_cache(maxsize=None)
def _edge_penalty(half: int, dtype: torch.dtype, dev: torch.device):
    """(half,) 1 at the first and last action of a half, else 0, built once
    per device: setting its two entries on every call copied each from the
    host, and each copy made the host wait for the card."""
    edge = torch.zeros(half, dtype=dtype, device=dev)
    edge[0] = 1.0
    edge[half - 1] = 1.0
    return edge


def postprocess(step_len, cfg: ActionMaskConfig):
    """(B, A) counts -> (B, A) mask: edge penalty, 5-wide erosion, normalization
    (reference post_process)."""
    half = cfg.n_actions // 2
    fwd, bwd = step_len[..., :half], step_len[..., half:]
    edge = _edge_penalty(half, step_len.dtype, step_len.device)
    fwd = _min_filter5_reflect(fwd - edge)
    bwd = _min_filter5_reflect(bwd - edge)
    mask = torch.clamp(torch.cat([fwd, bwd], dim=-1), 0.0, cfg.n_iter) / cfg.n_iter
    # degenerate all-blocked mask: tiny uniform floor (reference :182-183)
    empty = torch.sum(mask, dim=-1, keepdim=True) == 0.0
    return torch.where(empty, torch.clamp(mask, 0.01, 1.0), mask)


def get_steps(raw_lidar, table: ActionMaskTable, cfg: ActionMaskConfig,
              lidar_cfg: LidarConfig = LidarConfig()):
    """(B, R) raw lidar -> (B, A) mask in [0, 1]; the reduction runs through
    ``ops.mask_step_lengths`` (the CUDA kernel for CUDA tensors)."""
    ext = _extend(raw_lidar, table, lidar_cfg).contiguous()
    return postprocess(mask_step_lengths(ext, table.dist_star, cfg.n_iter, cfg.upsample),
                       cfg)


# sqrt(2 pi) rounded to float32 as the JAX package forms it (a float32 sqrt
# of float32 2 pi)
_SQRT_2PI = float(np.sqrt(np.float32(2 * math.pi)))


def gumbel(shape, generator: torch.Generator | None = None, device=None):
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), as
    ``jax.random.gumbel`` forms it."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def choose_action(mean, std, mask, table: ActionMaskTable, generator=None, noise=None):
    """Sample a discrete action per env by Gaussian log-prob x mask
    (reference choose_action), batched over B envs.

    Args:
      mean, std: (B, 2) the policy's moments in normalized action units.
      mask: (B, A) action mask in [0, 1].
      noise: (B, A) standard Gumbel noise; drawn from ``generator`` where
        None. The draw is argmax(log p + noise), as ``jax.random.categorical``
        makes it from ``jax.random.gumbel`` noise.

    Returns (actions_norm (B, 2), index (B,)).
    """
    z = (table.actions_norm - mean[:, None]) / std[:, None]          # (B, A, 2)
    logp = -0.5 * z ** 2 - torch.log(_SQRT_2PI * std[:, None])
    logp = torch.sum(torch.clamp(logp, -10.0, 10.0), dim=-1)        # (B, A)
    w = torch.exp(logp) * mask
    p = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    if noise is None:
        noise = gumbel(p.shape, generator, p.device)
    idx = torch.argmax(torch.log(torch.clamp(p, min=1e-30)) + noise, dim=-1)
    return table.actions_norm[idx], idx
