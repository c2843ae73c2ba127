"""Kinematic single-track (bicycle) model in closed form
(counterpart of ``hope_tpu/dynamics/bicycle.py``).

The reference integrates each 0.05 s sub-step with 20 explicit-Euler
iterations; with constant speed and steering that recurrence has a closed
form through ``sum_k cos(t0 + k d) = cos(t0 + (n - 1) d / 2) sin(n d / 2) /
sin(d / 2)``. ``substep_euler`` is the literal recurrence, kept as the
oracle of the closed form.
"""
from __future__ import annotations

import dataclasses
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


def substep_closed_form(state: VehicleState, action, cfg: VehicleConfig) -> VehicleState:
    """One dt-long sub-step (the reference's block of ``euler_iters`` Euler
    iterations) in closed form; fields of any leading dims, ``action``
    (..., 2)."""
    steer, speed = clip_action(action, cfg)
    n = cfg.euler_iters
    h = cfg.dt / n
    delta = speed * torch.tan(steer) / cfg.wheel_base * h   # heading change per iteration
    half = 0.5 * delta
    # sum over k < n of cos / sin(theta0 + k delta); the ratio -> n as delta -> 0
    sin_half = torch.sin(half)
    tiny = torch.abs(sin_half) < 1e-7
    ratio = torch.where(tiny, float(n), torch.sin(n * half) / torch.where(tiny, 1.0, sin_half))
    mid = state.heading + (n - 1) * half
    return VehicleState(
        x=state.x + speed * h * torch.cos(mid) * ratio,
        y=state.y + speed * h * torch.sin(mid) * ratio,
        heading=state.heading + n * delta,
        speed=speed,
        steer=steer,
    )


def substep_euler(state: VehicleState, action, cfg: VehicleConfig) -> VehicleState:
    """The literal ``euler_iters``-iteration Euler sub-step (the oracle of
    :func:`substep_closed_form`)."""
    steer, speed = clip_action(action, cfg)
    h = cfg.dt / cfg.euler_iters
    dth = speed * torch.tan(steer) / cfg.wheel_base * h
    x, y, th = state.x, state.y, state.heading
    for _ in range(cfg.euler_iters):
        x = x + speed * torch.cos(th) * h
        y = y + speed * torch.sin(th) * h
        th = th + dth
    return VehicleState(x, y, th, speed, steer)


def step(state: VehicleState, action, cfg: VehicleConfig, n_substeps: int | None = None,
         exact: bool = True) -> VehicleState:
    """One control step of ``n_substeps`` sub-steps. Speed and steering are
    constant over it, so the closed form takes them all at once (``exact``),
    else the sub-steps are chained."""
    n_substeps = cfg.n_substep if n_substeps is None else n_substeps
    if exact:
        scaled = dataclasses.replace(cfg, dt=cfg.dt * n_substeps,
                                     euler_iters=cfg.euler_iters * n_substeps)
        return substep_closed_form(state, action, scaled)
    out = state
    for _ in range(n_substeps):
        out = substep_closed_form(out, action, cfg)
    return out


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
