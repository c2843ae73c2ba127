"""Batched iLQR trajectory refinement for the kinematic bicycle
(counterpart of ``hope_tpu/planning/ilqr.py``).

The dynamics are the exact constant-control arc step. Where the reference
differentiates with ``jax.jacfwd`` / ``grad`` / ``hessian``, this module
forms the same derivatives in closed form on (B, N, ·) tensors: the arc
step's Jacobians, and the gradient and Hessian of the stage and terminal
costs (squared clearance violations of three body discs, each disc's
clearance its distance to the nearest live edge, plus quadratic goal and
control terms). ``torch.func``'s eager transforms took ~0.1 s of host time
per iteration at B = 4; these are a few dozen tensor operations. The Riccati
backward pass is a loop over the horizon, and the forward pass rolls out all
line-search alphas at once as (B, A) rows.

Derivatives at ties follow JAX's where they occur: a control on its clip
bound gets half the derivative (``jnp.clip`` is a min of a max, whose
derivative is 0.5 at a tie; ``clamp``'s would be 1). A violation exactly at
0 and two edges at exactly the same distance from different nearest points
(JAX: half each) are left out: they need equal float32 distances from
different geometry.

The arc step is taken as its chord (``_dynamics``), which stays exact to
float32 rounding for small heading changes. The JAX package divides by the
heading change instead, ``v dt / dth * (sin(th + dth) - sin(th))``, whose
float32 rounding grows as ``v dt * 6e-8 / dth``: where a plan passes through
gentle turns, its float32 iterates and this module's part after a few
iterations, and this module's keep to the float64 ones.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from ..config import VehicleConfig
from ..ops.ilqr_solve import ilqr_solve
from ..utils.profiling import count

_EPS = 1e-12
# half-turns below which ``_sinc`` takes its series
_SERIES = 0.5


class ILQRConfig(NamedTuple):
    horizon: int = 40
    dt: float = 0.25                  # control interval (s)
    n_iters: int = 12
    w_terminal_pos: float = 60.0
    w_terminal_heading: float = 20.0
    w_running_pos: float = 0.4
    w_control: float = 0.6
    w_steer_rate: float = 0.4
    w_obstacle: float = 30.0
    obstacle_margin: float = 0.35     # clearance target (m)
    reg_init: float = 1.0
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03)


def _disc_offsets(vcfg: VehicleConfig):
    """Offsets along the body of the 3 covering discs (collision proxy)."""
    return (0.0, (vcfg.front_hang + vcfg.wheel_base) * 0.5,
            vcfg.front_hang + vcfg.wheel_base - 0.4)


def _disc_radius(vcfg: VehicleConfig):
    return vcfg.width / 2.0 + 0.05


@lru_cache(maxsize=None)
def _constants(cfg: ILQRConfig, vcfg: VehicleConfig, device: torch.device) -> dict:
    """Small constant tensors, made once per (config, device): no host copy
    per solve."""
    w, w_c, w_r = cfg.w_running_pos, cfg.w_control, cfg.w_steer_rate
    return {"alphas": torch.tensor(cfg.alphas, dtype=torch.float32, device=device),
            "offsets": torch.tensor(_disc_offsets(vcfg), dtype=torch.float32, device=device),
            "eye2": torch.eye(2, device=device),
            "pos_h": torch.diag(torch.tensor([2.0 * w, 2.0 * w, 0.0], device=device)),
            "luu": torch.tensor([[2.0 * w_c + 2.0 * w_r, 0.0], [0.0, 2.0 * w_c]],
                                device=device)}


def _clip_grad(x, bound: float):
    """The derivative of ``jnp.clip(x, -bound, bound)``: 1 inside, 0.5 on a
    bound (a min of a max, tied), 0 outside."""
    inside = (torch.abs(x) < bound).to(x.dtype)
    return torch.where(torch.abs(x) == bound, 0.5, inside)


def _sinc(h):
    """(sin h / h, its derivative in h), elementwise: by their Taylor series
    (to h^8 and h^7) where |h| < ``_SERIES``, whose next terms are below
    float32 rounding there; in closed form elsewhere."""
    h2 = h * h
    small = torch.abs(h) < _SERIES
    hs = torch.where(small, 1.0, h)
    s_far = torch.sin(hs) / hs
    s = torch.where(small, 1.0 - h2 / 6.0 * (1.0 - h2 / 20.0 * (1.0 - h2 / 42.0 * (1.0 - h2 / 72.0))),
                    s_far)
    ds = torch.where(small, -h / 3.0 * (1.0 - h2 / 10.0 * (1.0 - h2 / 28.0 * (1.0 - h2 / 54.0))),
                     (torch.cos(hs) - s_far) / hs)
    return s, ds


def _dynamics(x, u, vcfg: VehicleConfig, dt: float, jac: bool = False):
    """Exact constant-control arc step of the bicycle (closed form):
    x (..., 3), u (..., 2) [steer, speed] -> (..., 3); with ``jac`` also the
    Jacobians fx (..., 3, 3) and fu (..., 3, 2).

    The chord of an arc that turns by ``dth`` is ``v dt sinc(dth / 2)`` long
    and points along the mid heading ``th + dth / 2``; written so, the step
    divides by nothing and is exact to float32 rounding for every turn,
    straight runs included (``sin(th + dth) - sin(th)`` over ``dth`` loses
    its digits as ``dth`` shrinks)."""
    steer = torch.clamp(u[..., 0], -vcfg.max_steer, vcfg.max_steer)
    v = torch.clamp(u[..., 1], -vcfg.max_speed, vcfg.max_speed)
    tan = torch.tan(steer)
    curv = tan / vcfg.wheel_base
    vdt = v * dt
    dth = vdt * curv
    th = x[..., 2]
    S, dS = _sinc(0.5 * dth)
    cm, sm = torch.cos(th + 0.5 * dth), torch.sin(th + 0.5 * dth)
    dx, dy = vdt * cm * S, vdt * sm * S
    nxt = torch.stack([x[..., 0] + dx, x[..., 1] + dy, th + dth], dim=-1)
    if not jac:
        return nxt
    # in the speed: the end heading's direction; in the curvature (the steer's
    # tangent over the wheel base): the chord's turn and its shortening
    g_s, g_v = _clip_grad(u[..., 0], vcfg.max_steer), _clip_grad(u[..., 1], vcfg.max_speed)
    dx_v, dy_v = dt * torch.cos(th + dth), dt * torch.sin(th + dth)
    half = 0.5 * vdt * vdt
    curv_s = (1.0 + tan * tan) / vcfg.wheel_base
    dx_s = half * (cm * dS - sm * S) * curv_s
    dy_s = half * (sm * dS + cm * S) * curv_s
    dth_s = vdt * curv_s
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    fx = torch.stack([torch.stack([one, zero, -dy], -1),
                      torch.stack([zero, one, dx], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    fu = torch.stack([torch.stack([dx_s * g_s, dx_v * g_v], -1),
                      torch.stack([dy_s * g_s, dy_v * g_v], -1),
                      torch.stack([dth_s * g_s, curv * dt * g_v], -1)], -2)
    return nxt, fx, fu


def _obstacle(x, edges, edge_mask, cfg: ILQRConfig, vcfg: VehicleConfig,
              derivs: bool = False):
    """Clearance cost of poses x (..., 3) against ``edges`` (..., E, 4) and
    ``edge_mask`` (..., E), which broadcast against x's leading dims: the cost
    (...), and with ``derivs`` also its gradient (..., 3) and Hessian
    (..., 3, 3)."""
    offs = _constants(cfg, vcfg, x.device)["offsets"]
    th = x[..., 2]
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    p = torch.stack([x[..., 0, None] + c * offs, x[..., 1, None] + s * offs], dim=-1)  # (..., 3, 2)
    a = edges[..., None, :, 0:2]
    ab = edges[..., None, :, 2:4] - a
    ap = p[..., :, None, :] - a                                          # (..., 3, E, 2)
    denom = torch.clamp(torch.sum(ab * ab, dim=-1), min=_EPS)
    t_raw = torch.sum(ap * ab, dim=-1) / denom
    diff = ap - torch.clamp(t_raw, 0.0, 1.0)[..., None] * ab
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    d = torch.where(edge_mask[..., None, :], d, torch.inf)
    dmin, idx = torch.min(d, dim=-1)                                     # (..., 3)
    viol = torch.clamp(cfg.obstacle_margin - (dmin - _disc_radius(vcfg)), min=0.0)
    cost = cfg.w_obstacle * torch.sum(viol ** 2, dim=-1)
    if not derivs:
        return cost
    # a disc's distance gradient in its centre: the unit vector from the
    # nearest point, with the component along the edge taken out where that
    # point lies inside it (as the chain rule through the projection does:
    # float32's rounding of ``diff`` leaves such a component, large against
    # ``d`` close to an edge); the Hessian is 0 there (the distance is
    # linear) and (I - n n^T) / d at an endpoint
    idx = idx[..., None, None]
    pick = lambda t: torch.gather(t.expand(*diff.shape), -2,  # noqa: E731
                                  idx.expand(*idx.shape[:-2], 1, 2)).squeeze(-2)
    dsel, absel = pick(diff), pick(ab)                                   # (..., 3, 2)
    t_sel = torch.gather(t_raw, -1, idx[..., 0]).squeeze(-1)
    den_sel = torch.gather(denom.expand(*t_raw.shape), -1, idx[..., 0]).squeeze(-1)
    inside = (t_sel > 0.0) & (t_sel < 1.0)
    along = torch.where(inside, torch.sum(dsel * absel, dim=-1) / den_sel, 0.0)
    live = viol > 0
    dsafe = torch.where(live, dmin, 1.0)
    n = (dsel - along[..., None] * absel) / dsafe[..., None]
    eye2 = _constants(cfg, vcfg, x.device)["eye2"]
    Hc = torch.where(~inside[..., None, None],
                     (eye2 - n[..., :, None] * n[..., None, :]) / dsafe[..., None, None],
                     0.0)
    # chain rule to (x, y, th): the centre is (x + o cos th, y + o sin th)
    jth = torch.stack([-s * offs, c * offs], dim=-1)                     # (..., 3, 2)
    gd = torch.cat([n, torch.sum(n * jth, dim=-1, keepdim=True)], dim=-1)  # (..., 3, 3)
    J = torch.cat([eye2.expand(*jth.shape[:-1], 2, 2), jth[..., :, None]], dim=-1)  # (..., 3, 2, 3)
    Hd = J.transpose(-1, -2) @ Hc @ J
    Hd[..., 2, 2] -= torch.sum(n * torch.stack([c * offs, s * offs], dim=-1), dim=-1)
    w = 2.0 * cfg.w_obstacle * live.to(x.dtype)
    grad = -torch.sum((w * viol)[..., None] * gd, dim=-2)
    hess = torch.sum(w[..., None, None] * (gd[..., :, None] * gd[..., None, :]
                                           - viol[..., None, None] * Hd), dim=-3)
    return cost, grad, hess


def make_costs(goal, edges, edge_mask, cfg: ILQRConfig, vcfg: VehicleConfig):
    """(stage_cost(x, u, u_prev), terminal_cost(x)) of one scenario or of a
    batch: ``goal`` (..., 3), ``edges`` (..., E, 4) and ``edge_mask`` (..., E)
    broadcast against the points' leading dims; each cost has the points'
    leading shape."""

    def stage_cost(x, u, u_prev):
        pos = cfg.w_running_pos * torch.sum((x[..., :2] - goal[..., :2]) ** 2, dim=-1)
        ctrl = cfg.w_control * torch.sum(u ** 2, dim=-1)
        rate = cfg.w_steer_rate * (u[..., 0] - u_prev[..., 0]) ** 2
        return pos + ctrl + rate + _obstacle(x, edges, edge_mask, cfg, vcfg)

    def terminal_cost(x):
        pos = cfg.w_terminal_pos * torch.sum((x[..., :2] - goal[..., :2]) ** 2, dim=-1)
        hd = cfg.w_terminal_heading * (1.0 - torch.cos(x[..., 2] - goal[..., 2]))
        return pos + hd + _obstacle(x, edges, edge_mask, cfg, vcfg)

    return stage_cost, terminal_cost


def quadraticize(xs, us, goal, edges, edge_mask, cfg: ILQRConfig, vcfg: VehicleConfig):
    """What the backward pass needs at xs (B, N+1, 3), us (B, N, 2): the stage
    cost's lx (B, N, 3), lu (B, N, 2), lxx (B, N, 3, 3) and luu (2, 2), the
    dynamics' fx (B, N, 3, 3) and fu (B, N, 3, 2), and the terminal cost's
    Vx (B, 3) and Vxx (B, 3, 3) (the reference's ``quadraticize`` and the
    terminal ``grad`` / ``hessian``)."""
    k = _constants(cfg, vcfg, xs.device)
    x = xs[:, :-1]
    _, lx, lxx = _obstacle(x, edges[:, None], edge_mask[:, None], cfg, vcfg, derivs=True)
    w = cfg.w_running_pos
    lx = lx + torch.cat([2.0 * w * (x[..., :2] - goal[:, None, :2]),
                         torch.zeros_like(x[..., 2:])], dim=-1)
    lxx = lxx + k["pos_h"]
    u_prev = torch.cat([us[:, :1], us[:, :-1]], dim=1)
    w_c, w_r = cfg.w_control, cfg.w_steer_rate
    lu = torch.stack([w_c * (2.0 * us[..., 0]) + w_r * (2.0 * (us[..., 0] - u_prev[..., 0])),
                      w_c * (2.0 * us[..., 1])], dim=-1)
    _, fx, fu = _dynamics(x, us, vcfg, cfg.dt, jac=True)
    xT = xs[:, -1]
    _, Vx, Vxx = _obstacle(xT, edges, edge_mask, cfg, vcfg, derivs=True)
    wp, wh = cfg.w_terminal_pos, cfg.w_terminal_heading
    dh = xT[:, 2] - goal[:, 2]
    Vx = Vx + torch.stack([2.0 * wp * (xT[:, 0] - goal[:, 0]), 2.0 * wp * (xT[:, 1] - goal[:, 1]),
                           wh * torch.sin(dh)], dim=-1)
    Vxx = Vxx + torch.diag_embed(torch.stack(
        [torch.full_like(dh, 2.0 * wp), torch.full_like(dh, 2.0 * wp), wh * torch.cos(dh)], -1))
    return lx, lu, lxx, k["luu"], fx, fu, Vx, Vxx


class ILQRResult(NamedTuple):
    xs: torch.Tensor        # (B, N+1, 3)
    us: torch.Tensor        # (B, N, 2)
    cost: torch.Tensor      # (B,)
    converged: torch.Tensor  # (B,) bool


class ILQRHistory(NamedTuple):
    """Per iteration (B, n_iters): the line-search pick (0 = no step, i = the
    i-th alpha), the regularization after it and the cost; and (B, n_iters,
    1 + A) the costs it chose from: the current one, then each alpha's."""
    pick: torch.Tensor
    reg: torch.Tensor
    cost: torch.Tensor
    candidates: torch.Tensor


def _inv2(m):
    """Closed-form inverse of (..., 2, 2) matrices (no host sync)."""
    a, b = m[..., 0, 0], m[..., 0, 1]
    c, d = m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return adj / det[..., None, None]


def _mT(m):
    return m.transpose(-1, -2)


def solve_batch(x0, goal, edges, edge_mask, us_init, cfg: ILQRConfig = ILQRConfig(),
                vcfg: VehicleConfig = VehicleConfig(), history: bool = False):
    """Lockstep batched solve: every argument has a leading scenario dim B.

    Args:
      x0: (B, 3) initial poses. goal: (B, 3) targets.
      edges: (B, E, 4) obstacle segments + (B, E) mask.
      us_init: (B, N, 2) warm-start controls [steer, speed].

    Returns an :class:`ILQRResult`, and with ``history`` also an
    :class:`ILQRHistory`.
    """
    B, N = us_init.shape[:2]
    k = _constants(cfg, vcfg, x0.device)
    alphas, eye2 = k["alphas"], k["eye2"]
    A = alphas.shape[0]
    dyn = lambda x, u: _dynamics(x, u, vcfg, cfg.dt)  # noqa: E731

    def rollout(us):
        xs = [x0]
        for t in range(N):
            xs.append(dyn(xs[-1], us[:, t]))
        return torch.stack(xs, dim=1)

    def total_cost(xs, us):
        """(B, R, N+1, 3), (B, R, N, 2) -> (B, R) for R rollouts a scene."""
        stage, _ = make_costs(goal[:, None, None], edges[:, None, None],
                              edge_mask[:, None, None], cfg, vcfg)
        _, terminal = make_costs(goal[:, None], edges[:, None], edge_mask[:, None], cfg, vcfg)
        u_prev = torch.cat([us[..., :1, :], us[..., :-1, :]], dim=-2)
        return torch.sum(stage(xs[..., :-1, :], us, u_prev), dim=-1) + terminal(xs[..., -1, :])

    def backward(xs, us, reg):
        lx, lu, lxx, luu, fx, fu, Vx, Vxx = quadraticize(xs, us, goal, edges, edge_mask, cfg,
                                                         vcfg)
        Vx = Vx[..., None]
        regI = reg[:, None, None] * eye2
        ks, Ks = [None] * N, [None] * N
        for t in reversed(range(N)):
            fx_t, fu_t = fx[:, t], fu[:, t]
            fxT, fuT = _mT(fx_t), _mT(fu_t)
            Qx = lx[:, t, :, None] + fxT @ Vx
            Qu = lu[:, t, :, None] + fuT @ Vx
            Qxx = lxx[:, t] + fxT @ Vxx @ fx_t
            Quu = luu + fuT @ Vxx @ fu_t + regI
            Qux = fuT @ Vxx @ fx_t
            Quu_inv = _inv2(Quu)
            k_t = -Quu_inv @ Qu
            K_t = -Quu_inv @ Qux
            KT, QuxT = _mT(K_t), _mT(Qux)
            Vx = Qx + KT @ Quu @ k_t + KT @ Qu + QuxT @ k_t
            Vxx = Qxx + KT @ Quu @ K_t + KT @ Qux + QuxT @ K_t
            Vxx = 0.5 * (Vxx + _mT(Vxx))
            ks[t], Ks[t] = k_t[..., 0], K_t
        return torch.stack(ks, dim=1), torch.stack(Ks, dim=1)

    def forward(xs, us, ks, Ks):
        """All alphas at once: (B, A, N+1, 3), (B, A, N, 2)."""
        x = xs[:, None, 0].expand(B, A, 3)
        xs_new, us_new = [x], []
        for t in range(N):
            dx = x - xs[:, None, t]
            u = (us[:, None, t] + alphas[None, :, None] * ks[:, None, t]
                 + (Ks[:, None, t] @ dx[..., None])[..., 0])
            u = torch.stack([torch.clamp(u[..., 0], -vcfg.max_steer, vcfg.max_steer),
                             torch.clamp(u[..., 1], -vcfg.max_speed, vcfg.max_speed)], dim=-1)
            x = dyn(x, u)
            xs_new.append(x)
            us_new.append(u)
        return torch.stack(xs_new, dim=2), torch.stack(us_new, dim=2)

    rows = torch.arange(B, device=x0.device)
    xs = rollout(us_init)
    us = us_init
    c0 = total_cost(xs[:, None], us[:, None])[:, 0]
    cost = c0
    reg = torch.full((B,), cfg.reg_init, dtype=x0.dtype, device=x0.device)
    hist = []
    for _ in range(cfg.n_iters):
        ks, Ks = backward(xs, us, reg)
        xs_a, us_a = forward(xs, us, ks, Ks)
        c_a = total_cost(xs_a, us_a)                                     # (B, A)
        # the alphas one after another, each taken only when strictly better
        # than the best so far, pick the first minimum; a NaN cost is never
        # taken, and a NaN current cost takes nothing
        cost_before = cost
        cand = torch.cat([cost[:, None], torch.nan_to_num(c_a, nan=torch.inf)], dim=1)
        pick = torch.argmin(cand, dim=1)
        pick = torch.where(torch.isnan(cost), 0, pick)
        improved = pick > 0
        a_idx = torch.clamp(pick - 1, min=0)
        xs = torch.where(improved[:, None, None], xs_a[rows, a_idx], xs)
        us = torch.where(improved[:, None, None], us_a[rows, a_idx], us)
        cost = torch.where(improved, c_a[rows, a_idx], cost)
        reg = torch.where(improved, torch.clamp(reg * 0.7, min=1e-6), reg * 4.0)
        if history:
            hist.append((pick, reg, cost, torch.cat([cost_before[:, None], c_a], dim=1)))
    converged = (c0 - cost) / torch.clamp(c0, min=1e-9) > 1e-3
    res = ILQRResult(xs=xs, us=us, cost=cost, converged=converged)
    if not history:
        return res
    return res, ILQRHistory(*(torch.stack(h, dim=1) for h in zip(*hist)))


def solve(x0, goal, edges, edge_mask, us_init, cfg: ILQRConfig = ILQRConfig(),
          vcfg: VehicleConfig = VehicleConfig()) -> ILQRResult:
    """Single-scenario solve: x0 (3,), goal (3,), edges (E, 4), edge_mask
    (E,), us_init (N, 2)."""
    res = solve_batch(x0[None], goal[None], edges[None], edge_mask[None], us_init[None],
                      cfg, vcfg)
    return ILQRResult(*(t[0] for t in res))


class ILQRSolver:
    """``solve_batch`` at one configuration. On a CUDA device a solve is one
    launch of the kernel ``ops.ilqr_solve`` (a block per row; in plain
    PyTorch a solve is some 50 000 small launches at the MPC CLI's
    settings); elsewhere it calls ``solve_batch``.

    Counters (kept while a profiler records): ``ilqr/kernel_solves``, one a
    solve through the kernel; ``ilqr/plain_solves``, one a solve through
    ``solve_batch``."""

    def __init__(self, cfg: ILQRConfig, vcfg: VehicleConfig):
        self.cfg, self.vcfg = cfg, vcfg

    def __call__(self, x0, goal, edges, edge_mask, us_init) -> ILQRResult:
        if x0.device.type == "cuda":
            count("ilqr/kernel_solves", 1)
            return ILQRResult(*ilqr_solve(*(t.contiguous() for t in (x0, goal, edges, edge_mask,
                                                                      us_init)),
                                          self.cfg, self.vcfg))
        count("ilqr/plain_solves", 1)
        return solve_batch(x0, goal, edges, edge_mask, us_init, self.cfg, self.vcfg)


__all__ = ["ILQRConfig", "ILQRResult", "ILQRHistory", "ILQRSolver", "make_costs", "quadraticize",
           "solve", "solve_batch"]
