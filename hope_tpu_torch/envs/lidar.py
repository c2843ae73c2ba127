"""Batched 2-D lidar (counterpart of ``hope_tpu/envs/lidar.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import LidarConfig, VehicleConfig
from ..geometry import box_to_edges, edges_to_ego, ray_hits


def beam_angles(cfg: LidarConfig, device=None):
    """Beam i points at angle 2*pi*i/n in the ego frame (beam 0 = forward)."""
    return torch.as_tensor(np.arange(cfg.n_beams) / cfg.n_beams * 2 * math.pi,
                           dtype=torch.float32, device=device)


def vehicle_boundary(cfg: LidarConfig, vcfg: VehicleConfig, device=None):
    """(R,) distance from the rear-axle origin to the vehicle hull per beam."""
    corners = torch.as_tensor(vcfg.box_corners(), dtype=torch.float32, device=device)
    return ray_hits(beam_angles(cfg, device), box_to_edges(corners), cfg.max_range)


def lidar_observation(pose, edges, edge_mask, angles, boundary, cfg: LidarConfig):
    """Lidar readings for a batch.

    Args:
      pose: (B, 3) ego poses; edges: (B, E, 4) world segments; edge_mask: (B, E);
      angles: (R,) from :func:`beam_angles`; boundary: (R,) from
      :func:`vehicle_boundary`.

    Returns:
      (B, R) obstacle distance minus hull base, in [-hull, range].
    """
    ego = edges_to_ego(edges, pose)
    # collapse masked edges to degenerate points so they never reflect
    ego = torch.where(edge_mask[..., None], ego, 0.0)
    return ray_hits(angles, ego, cfg.max_range) - boundary
