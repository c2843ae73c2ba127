"""The pure-MPC planner's trajectory optimizer, written out plainly in
float64: iterative LQR (Li & Todorov, ICINCO 2004; Tassa, Erez & Todorov,
IROS 2012) on the kinematic bicycle, at the settings the configuration file
states (``Spec``).

- The dynamics are the exact constant-control arc: the car turns by
  ``dth = v dt tan(steer) / wheel_base`` and moves along the chord, ``v dt
  sinc(dth / 2)`` long at the mid heading ``th + dth / 2``. Controls are
  clipped to the vehicle's bounds as ``min(max(u, -bound), bound)``.
- The stage cost is ``w_running_pos |p - g|^2 + w_control |u|^2 +
  w_steer_rate (steer - steer_prev)^2`` plus the clearance cost, the terminal
  cost ``w_terminal_pos |p - g|^2 + w_terminal_heading (1 - cos(th - g_th))``
  plus the clearance cost. The clearance cost is ``w_obstacle`` times the sum,
  over three discs along the body, of the squared amount by which a disc's
  clearance (its centre's distance to the nearest live edge, less its
  radius) falls short of ``obstacle_margin``.
- Every derivative is taken by ``torch.autograd.functional`` of the functions
  above: nothing is written in closed form.
- The backward pass is the Riccati recursion; the forward pass rolls out
  each line-search step size with the feedback gains, and keeps the first
  best if it lowers the cost.

Departures from the published method, each the configuration's own:
- the steer-rate term is differentiated with the previous control held
  fixed (the published method would carry that control in the state), and
  the first step's previous control is its own;
- the regularization is added to ``Q_uu`` (in the control space), starts at
  ``reg_init``, and is multiplied by 0.7 (not below 1e-6) after a step that
  lowers the cost and by 4 after one that does not;
- the line search evaluates every step size of ``alphas`` and takes the
  lowest cost, the first of equals, only where it is strictly lower than
  the current one (no sufficient-decrease ratio); a NaN cost is never taken;
- a fixed number of iterations, no convergence test;
- the clip's derivative on a bound is half (a minimum of a maximum, tied).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.autograd.functional import jacobian

from .spec import VEHICLE

F64 = torch.float64


class Spec(NamedTuple):
    """The iLQR's settings and the vehicle's dimensions, in float64."""

    dt: float
    n_iters: int
    w_terminal_pos: float
    w_terminal_heading: float
    w_running_pos: float
    w_control: float
    w_steer_rate: float
    w_obstacle: float
    obstacle_margin: float
    reg_init: float
    alphas: tuple
    disc_offsets: tuple
    disc_radius: float
    wheel_base: float
    max_steer: float
    max_speed: float


def spec_of(config: dict) -> Spec:
    """The configuration file's ``ilqr`` settings with HOPE's vehicle: three
    discs at the rear axle, mid-body and 0.4 m behind the front, each half
    the width plus 5 cm in radius; ``dt`` the control step, ``n_substep``
    sub-steps of the vehicle's ``dt``."""
    c = config["ilqr"]
    v = VEHICLE
    front = v["front_hang"] + v["wheel_base"]
    return Spec(dt=v["dt"] * v["n_substep"], n_iters=c["n_iters"],
                w_terminal_pos=c["w_terminal_pos"], w_terminal_heading=c["w_terminal_heading"],
                w_running_pos=c["w_running_pos"], w_control=c["w_control"],
                w_steer_rate=c["w_steer_rate"], w_obstacle=c["w_obstacle"],
                obstacle_margin=c["obstacle_margin"], reg_init=c["reg_init"],
                alphas=tuple(c["alphas"]), disc_offsets=(0.0, front / 2, front - 0.4),
                disc_radius=v["width"] / 2 + 0.05, wheel_base=v["wheel_base"],
                max_steer=v["max_steer"], max_speed=v["max_speed"])


def _clip(x, bound: float):
    return torch.minimum(torch.maximum(x, torch.full_like(x, -bound)),
                         torch.full_like(x, bound))


def step(x, u, sp: Spec):
    """(..., 3) poses, (..., 2) [steer, speed] -> (..., 3) after ``sp.dt``."""
    steer, v = _clip(u[..., 0], sp.max_steer), _clip(u[..., 1], sp.max_speed)
    dth = v * sp.dt * torch.tan(steer) / sp.wheel_base
    mid = x[..., 2] + dth / 2
    chord = v * sp.dt * torch.sinc(dth / (2 * math.pi))
    return torch.stack([x[..., 0] + chord * torch.cos(mid), x[..., 1] + chord * torch.sin(mid),
                        x[..., 2] + dth], dim=-1)


def clearance_cost(x, edges, emask, sp: Spec):
    """(...) cost of poses (..., 3) against live edges (..., E, 4) /
    (..., E) broadcast to the poses' leading dims."""
    offs = torch.tensor(sp.disc_offsets, dtype=F64, device=x.device)
    th = x[..., 2, None]
    p = torch.stack([x[..., 0, None] + torch.cos(th) * offs,
                     x[..., 1, None] + torch.sin(th) * offs], -1)                # (..., 3, 2)
    a, b = edges[..., None, :, 0:2], edges[..., None, :, 2:4]
    ab, ap = b - a, p[..., :, None, :] - a                                      # (..., 3, E, 2)
    t = ((ap * ab).sum(-1) / (ab * ab).sum(-1).clamp(min=1e-300)).clamp(0.0, 1.0)
    d2 = ((ap - t[..., None] * ab) ** 2).sum(-1)
    # the dead slots are left out before the root, so that no derivative
    # passes through a zero distance to one of them
    d = torch.sqrt(torch.where(emask[..., None, :], d2, torch.inf)).amin(-1)  # (..., 3)
    short = (sp.obstacle_margin - (d - sp.disc_radius)).clamp(min=0.0)
    return sp.w_obstacle * (short ** 2).sum(-1)


def stage_cost(x, u, u_prev, goal, edges, emask, sp: Spec):
    pos = sp.w_running_pos * ((x[..., :2] - goal[..., :2]) ** 2).sum(-1)
    ctrl = sp.w_control * (u ** 2).sum(-1)
    rate = sp.w_steer_rate * (u[..., 0] - u_prev[..., 0]) ** 2
    return pos + ctrl + rate + clearance_cost(x, edges, emask, sp)


def terminal_cost(x, goal, edges, emask, sp: Spec):
    pos = sp.w_terminal_pos * ((x[..., :2] - goal[..., :2]) ** 2).sum(-1)
    head = sp.w_terminal_heading * (1.0 - torch.cos(x[..., 2] - goal[..., 2]))
    return pos + head + clearance_cost(x, edges, emask, sp)


def rollout(x0, us, sp: Spec):
    """(B, 3), (B, ..., N, 2) -> (B, ..., N + 1, 3)."""
    lead = us.shape[:-2]
    xs = [x0.reshape(x0.shape[0], *[1] * (len(lead) - 1), 3).expand(*lead, 3)]
    for t in range(us.shape[-2]):
        xs.append(step(xs[-1], us[..., t, :], sp))
    return torch.stack(xs, -2)


def total_cost(xs, us, goal, edges, emask, sp: Spec):
    """The plan's cost: xs (B, R, N + 1, 3), us (B, R, N, 2) -> (B, R);
    ``goal`` (B, 3), ``edges`` (B, E, 4), ``emask`` (B, E)."""
    u_prev = torch.cat([us[..., :1, :], us[..., :-1, :]], -2)
    g, e, m = goal[:, None, None], edges[:, None, None], emask[:, None, None]
    stage = stage_cost(xs[..., :-1, :], us, u_prev, g, e, m, sp).sum(-1)
    return stage + terminal_cost(xs[..., -1, :], goal[:, None], edges[:, None],
                                 emask[:, None], sp)


def plan_cost(x0, us, goal, edges, emask, sp: Spec):
    """(B,) float64 cost of the controls ``us`` (B, N, 2) from ``x0``."""
    x0, us = x0.to(F64), us.to(F64)
    xs = rollout(x0, us[:, None], sp)
    return total_cost(xs, us[:, None], goal.to(F64), edges.to(F64), emask, sp)[:, 0]


def _grad(f, x):
    """Per-point gradient of a cost ``f`` that sums over points."""
    return jacobian(lambda z: f(z).sum(), x, create_graph=True)


def _per_point_jacobian(f, x):
    """(..., m, n): the Jacobian of ``f`` (..., n) -> (..., m), whose points
    do not interact, at every point of x."""
    lead = tuple(range(x.ndim - 1))
    return jacobian(lambda z: f(z).sum(lead), x, vectorize=True).movedim(0, -2)


def derivatives(xs, us, goal, edges, emask, sp: Spec):
    """What the backward pass needs at a plan xs (B, N + 1, 3), us (B, N, 2):
    the stage cost's lx, lu, lxx, luu (its x-u block is 0), the dynamics'
    fx, fu, and the terminal cost's gradient and Hessian."""
    x, xT = xs[:, :-1], xs[:, -1]
    u_prev = torch.cat([us[:, :1], us[:, :-1]], 1).detach()
    g, e, m = goal[:, None], edges[:, None], emask[:, None]

    def in_x(z):
        return stage_cost(z, us, u_prev, g, e, m, sp)

    def in_u(z):
        return stage_cost(x, z, u_prev, g, e, m, sp)

    def term(z):
        return terminal_cost(z, goal, edges, emask, sp)

    out = []
    for f, at in ((in_x, x), (in_u, us), (term, xT)):
        out.append(_grad(f, at).detach())
        out.append(_per_point_jacobian(lambda z, f=f: _grad(f, z), at).detach())
    (lx, lxx), (lu, luu), (Vx, Vxx) = out[0:2], out[2:4], out[4:6]
    fx = _per_point_jacobian(lambda z: step(z, us, sp), x).detach()
    fu = _per_point_jacobian(lambda z: step(x, z, sp), us).detach()
    return lx, lu, lxx, luu, fx, fu, Vx, Vxx


def backward_pass(d, reg):
    lx, lu, lxx, luu, fx, fu, Vx, Vxx = d
    N = lx.shape[1]
    Vx = Vx[..., None]
    eye = torch.eye(2, dtype=F64, device=lx.device)
    ks, Ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        A, Bm = fx[:, t], fu[:, t]
        At, Bt = A.transpose(-1, -2), Bm.transpose(-1, -2)
        Qx = lx[:, t, :, None] + At @ Vx
        Qu = lu[:, t, :, None] + Bt @ Vx
        Qxx = lxx[:, t] + At @ Vxx @ A
        Quu = luu[:, t] + Bt @ Vxx @ Bm + reg[:, None, None] * eye
        Qux = Bt @ Vxx @ A
        k = -torch.linalg.solve(Quu, Qu)
        K = -torch.linalg.solve(Quu, Qux)
        Kt = K.transpose(-1, -2)
        Vx = Qx + Kt @ Quu @ k + Kt @ Qu + Qux.transpose(-1, -2) @ k
        Vxx = Qxx + Kt @ Quu @ K + Kt @ Qux + Qux.transpose(-1, -2) @ K
        Vxx = (Vxx + Vxx.transpose(-1, -2)) / 2
        ks[t], Ks[t] = k[..., 0], K
    return torch.stack(ks, 1), torch.stack(Ks, 1)


def forward_pass(xs, us, ks, Ks, sp: Spec):
    """Every step size at once: (B, A, N + 1, 3), (B, A, N, 2)."""
    alphas = torch.tensor(sp.alphas, dtype=F64, device=xs.device)
    x = xs[:, None, 0].expand(-1, len(sp.alphas), 3)
    new_x, new_u = [x], []
    for t in range(us.shape[1]):
        u = (us[:, None, t] + alphas[None, :, None] * ks[:, None, t]
             + (Ks[:, None, t] @ (x - xs[:, None, t])[..., None])[..., 0])
        u = torch.stack([_clip(u[..., 0], sp.max_steer), _clip(u[..., 1], sp.max_speed)], -1)
        x = step(x, u, sp)
        new_x.append(x)
        new_u.append(u)
    return torch.stack(new_x, 2), torch.stack(new_u, 2)


class Plan(NamedTuple):
    xs: torch.Tensor      # (B, N + 1, 3)
    us: torch.Tensor      # (B, N, 2)
    cost: torch.Tensor    # (B,)


def solve(x0, goal, edges, emask, us_init, sp: Spec) -> Plan:
    """The iLQR from the warm start ``us_init`` (B, N, 2), every row at
    once, in float64."""
    x0, goal, edges = x0.to(F64), goal.to(F64), edges.to(F64)
    us = us_init.to(F64)
    xs = rollout(x0, us[:, None], sp)[:, 0]
    cost = total_cost(xs[:, None], us[:, None], goal, edges, emask, sp)[:, 0]
    reg = torch.full_like(cost, sp.reg_init)
    rows = torch.arange(x0.shape[0], device=x0.device)
    for _ in range(sp.n_iters):
        with torch.enable_grad():
            d = derivatives(xs, us, goal, edges, emask, sp)
        with torch.no_grad():
            ks, Ks = backward_pass(d, reg)
            xa, ua = forward_pass(xs, us, ks, Ks, sp)
            ca = torch.nan_to_num(total_cost(xa, ua, goal, edges, emask, sp), nan=torch.inf)
            pick = torch.argmin(torch.cat([cost[:, None], ca], 1), 1)
            better = (pick > 0) & ~torch.isnan(cost)
            a = (pick - 1).clamp(min=0)
            xs = torch.where(better[:, None, None], xa[rows, a], xs)
            us = torch.where(better[:, None, None], ua[rows, a], us)
            cost = torch.where(better, ca[rows, a], cost)
            reg = torch.where(better, (reg * 0.7).clamp(min=1e-6), reg * 4.0)
    return Plan(xs, us, cost)
