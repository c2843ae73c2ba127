"""Kinematic single-track (bicycle) model in closed form
(counterpart of ``hope_tpu/dynamics/bicycle.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import VehicleConfig


@dataclass
class VehicleState:
    """Pose + actuation; every field shares the same leading dims."""

    x: torch.Tensor
    y: torch.Tensor
    heading: torch.Tensor
    speed: torch.Tensor
    steer: torch.Tensor

    @property
    def pose(self):
        return torch.stack([self.x, self.y, self.heading], dim=-1)

    @staticmethod
    def from_pose(pose):
        z = torch.zeros_like(pose[..., 0])
        return VehicleState(pose[..., 0], pose[..., 1], pose[..., 2], z, z)


def clip_action(action, cfg: VehicleConfig):
    """Clip [steer, speed] to the vehicle limits."""
    steer = torch.clamp(action[..., 0], -cfg.max_steer, cfg.max_steer)
    speed = torch.clamp(action[..., 1], -cfg.max_speed, cfg.max_speed)
    return steer, speed


def substep_trajectory(state: VehicleState, action, cfg: VehicleConfig,
                       n_substeps: int | None = None) -> VehicleState:
    """All ``n`` intermediate sub-step states of one control step for a batch.

    ``state`` fields are (B,), ``action`` (B, 2); every returned field is
    (B, n): the pose after k = 1..n sub-steps of the closed-form arc (the
    reference's 20 Euler iterations per sub-step, summed in closed form).
    """
    n = cfg.n_substep if n_substeps is None else n_substeps
    steer, speed = clip_action(action, cfg)
    m = cfg.euler_iters
    h = cfg.dt / m
    delta = (speed * torch.tan(steer) / cfg.wheel_base * h)[..., None]   # (B, 1)
    speed, steer = speed[..., None], steer[..., None]

    iters = torch.arange(1, n + 1, device=action.device, dtype=torch.int32) * m
    half = 0.5 * delta
    sin_half = torch.sin(half)
    tiny = torch.abs(sin_half) < 1e-7
    itf = iters.to(half.dtype)
    ratio = torch.where(tiny, itf,
                        torch.sin(itf * half) / torch.where(tiny, 1.0, sin_half))
    mid = state.heading[..., None] + (itf - 1) * half
    ones = torch.ones_like(ratio)
    return VehicleState(
        x=state.x[..., None] + speed * h * torch.cos(mid) * ratio,
        y=state.y[..., None] + speed * h * torch.sin(mid) * ratio,
        heading=state.heading[..., None] + itf * delta,
        speed=speed * ones,
        steer=steer * ones,
    )
