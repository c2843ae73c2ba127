"""Faults planted under the timed path of the MPC cell, for the tests that
show its checks come out false on a broken program (``portbench/tests``)
and for the readings of its limits. A benchmark run plants none.

- ``old_arc``: the iLQR's arc step divided by the heading change,
  ``v dt / dth * (sin(th + dth) - sin(th))`` (with its Jacobians), as the
  program took it before its chord form: float32 loses the step's digits
  for gentle turns;
- ``bf16_solve``: the iLQR solved in bfloat16, its inputs rounded to it;
- ``wrong_latch``: an RS path latched where a plan is still executing.
"""
from __future__ import annotations

import contextlib
import importlib

import torch

FAULTS = ("old_arc", "bf16_solve", "wrong_latch")


def _old_arc(x, u, vcfg, dt: float, jac: bool = False):
    steer = torch.clamp(u[..., 0], -vcfg.max_steer, vcfg.max_steer)
    v = torch.clamp(u[..., 1], -vcfg.max_speed, vcfg.max_speed)
    tan = torch.tan(steer)
    curv = tan / vcfg.wheel_base
    dth = v * curv * dt
    th = x[..., 2]
    small = torch.abs(dth) < 1e-9
    r = torch.where(small, 1.0, v * dt / torch.where(small, 1.0, dth))
    c0, s0 = torch.cos(th), torch.sin(th)
    c1, s1 = torch.cos(th + dth), torch.sin(th + dth)
    dx = torch.where(small, v * dt * c0, r * (s1 - s0))
    dy = torch.where(small, v * dt * s0, -r * (c1 - c0))
    nxt = torch.stack([x[..., 0] + dx, x[..., 1] + dy, th + dth], dim=-1)
    if not jac:
        return nxt
    inside = lambda a, b: torch.where(torch.abs(a) == b, 0.5,  # noqa: E731
                                      (torch.abs(a) < b).to(a.dtype))
    g_s, g_v = inside(u[..., 0], vcfg.max_steer), inside(u[..., 1], vcfg.max_speed)
    dx_th = torch.where(small, -v * dt * s0, r * (c1 - c0))
    dy_th = torch.where(small, v * dt * c0, r * (s1 - s0))
    dx_v, dy_v = dt * torch.where(small, c0, c1), dt * torch.where(small, s0, s1)
    curv_s = (1.0 + tan * tan) / vcfg.wheel_base
    dth_s = v * dt * curv_s
    r_s = -curv_s / torch.where(small, 1.0, curv * curv)
    dx_s = torch.where(small, 0.0, r_s * (s1 - s0) + r * c1 * dth_s)
    dy_s = torch.where(small, 0.0, -r_s * (c1 - c0) + r * s1 * dth_s)
    one, zero = torch.ones_like(th), torch.zeros_like(th)
    fx = torch.stack([torch.stack([one, zero, dx_th], -1), torch.stack([zero, one, dy_th], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    fu = torch.stack([torch.stack([dx_s * g_s, dx_v * g_v], -1),
                      torch.stack([dy_s * g_s, dy_v * g_v], -1),
                      torch.stack([dth_s * g_s, curv * dt * g_v], -1)], -2)
    return nxt, fx, fu


def _bf16_constants(constants):
    def low(*args):
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in constants(*args).items()}
    return low


def _bf16_solver(ilqr):
    class Solver:
        def __init__(self, cfg, vcfg):
            self.cfg, self.vcfg = cfg, vcfg

        def __call__(self, *args):
            low = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in args]
            res = ilqr.solve_batch(*low, self.cfg, self.vcfg)
            return type(res)(*(t.float() if t.is_floating_point() else t for t in res))
    return Solver


def _wrong_latch(hybrid_mod):
    def latch(hs, rs, step_ratio):
        q, n = hybrid_mod.build_action_queue(rs, step_ratio, hs.queue.shape[1])
        take = rs.found
        return hybrid_mod.HybridState(queue=torch.where(take[:, None, None], q, hs.queue),
                                      length=torch.where(take, n, hs.length),
                                      cursor=torch.where(take, 0, hs.cursor).to(torch.int32))
    return latch


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` in place (nothing where None), for as
    long as the block runs; build the runner inside it."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; faults of this cell: {FAULTS}")
    ilqr = importlib.import_module("hope_tpu_torch.planning.ilqr")
    mpc = importlib.import_module("hope_tpu_torch.planning.mpc")
    hybrid = importlib.import_module("hope_tpu_torch.agents.hybrid")
    swaps = {"old_arc": [(ilqr, "_dynamics", _old_arc)],
             "bf16_solve": [(mpc, "ILQRSolver", _bf16_solver(ilqr)),
                            (ilqr, "_constants", _bf16_constants(ilqr._constants))],
             "wrong_latch": [(mpc, "latch", _wrong_latch(hybrid))]}[fault]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, value in swaps:
        setattr(mod, name, value)
    try:
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
