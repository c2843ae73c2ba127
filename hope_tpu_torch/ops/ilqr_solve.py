"""The batched iLQR solve in one launch: the CUDA kernel
``csrc/ilqr_solve.cu``, a block per row.

It replaces no Pallas TPU kernel (the JAX package leaves its iLQR to XLA):
its plain PyTorch twin is ``planning.ilqr.solve_batch``, which the CPU runs
and the tests hold it to. Bound on the H100: operations, ~29.5 GFLOP a
solve at the MPC configuration (``portbench/ilqr_work.py``), nearly all of
them the clearance cost's distances to the edges; the kernel keeps each
row's edges, iterate, candidates and derivatives in shared memory for the
whole solve (see the kernel source). :class:`planning.ilqr.ILQRSolver`
launches it for CUDA tensors.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import CudaKernel, check, ptr

MAX_ALPHAS = 16             # step sizes the kernel's by-value argument holds
SMEM_LIMIT = 227 * 1024     # shared memory a block may use on the H100


class _Params(ctypes.Structure):
    """The kernel's by-value configuration (``IlqrParams`` in the source)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "dt", "max_steer", "max_speed", "inv_wheel_base", "w_run", "w_control", "w_rate",
        "w_obstacle", "two_w_run", "luu00", "luu11", "w_term_pos", "w_term_heading",
        "two_w_term_pos", "two_w_obstacle", "margin", "radius")] + [
        ("offsets", ctypes.c_float * 3), ("reg_init", ctypes.c_float),
        ("alphas", ctypes.c_float * MAX_ALPHAS), ("n_alphas", ctypes.c_int),
        ("n_iters", ctypes.c_int)]


KERNEL = CudaKernel("ilqr_solve", "ilqr_solve",
                    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [_Params, ctypes.c_void_p])
# per row of the quad output: lx 3, lu 2, lxx 9, fx 9, fu 6 a step, then the
# terminal Vx 3 and Vxx 9
QUAD_STEP, QUAD_TERMINAL = 29, 12


def smem_bytes(N: int, E: int, A: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the kernel
    source, whose layout it mirrors)."""
    N1 = N + 1
    floats = (E + 3 * N1 + 2 * N + 6 * N1 + A * (3 * N1 + 2 * N + 6 * N1) + A * N1 + 27 * N1
              + 19 * N + 9 + 8 * N + 8)
    return 16 * E + 4 * floats


def params(cfg, vcfg) -> _Params:
    """``cfg`` (``ILQRConfig``) and ``vcfg`` (``VehicleConfig``) as the
    kernel's argument: each number in float32 as solve_batch's operations
    see it (a product of two settings is taken in Python's double first; a
    division by a setting is a product with its float32 reciprocal)."""
    from ..planning.ilqr import _disc_offsets, _disc_radius

    A = len(cfg.alphas)
    if not 1 <= A <= MAX_ALPHAS:
        raise ValueError(f"ilqr_solve: {A} step sizes, the kernel takes 1 to {MAX_ALPHAS}")
    if cfg.n_iters < 0:
        raise ValueError(f"ilqr_solve: n_iters {cfg.n_iters}")
    f32 = np.float32
    p = _Params(dt=cfg.dt, max_steer=vcfg.max_steer, max_speed=vcfg.max_speed,
                inv_wheel_base=float(f32(1.0) / f32(vcfg.wheel_base)),
                w_run=cfg.w_running_pos, w_control=cfg.w_control, w_rate=cfg.w_steer_rate,
                w_obstacle=cfg.w_obstacle, two_w_run=2.0 * cfg.w_running_pos,
                luu00=2.0 * cfg.w_control + 2.0 * cfg.w_steer_rate, luu11=2.0 * cfg.w_control,
                w_term_pos=cfg.w_terminal_pos, w_term_heading=cfg.w_terminal_heading,
                two_w_term_pos=2.0 * cfg.w_terminal_pos, two_w_obstacle=2.0 * cfg.w_obstacle,
                margin=cfg.obstacle_margin, radius=_disc_radius(vcfg),
                reg_init=cfg.reg_init, n_alphas=A, n_iters=cfg.n_iters)
    p.offsets[:] = _disc_offsets(vcfg)
    p.alphas[:A] = cfg.alphas
    return p


def ilqr_solve(x0, goal, edges, edge_mask, us_init, cfg, vcfg, record: bool = False):
    """``solve_batch(x0, goal, edges, edge_mask, us_init, cfg, vcfg)`` on the
    card, in one launch.

    Args:
      x0: (B, 3) float32 initial poses. goal: (B, 3) float32 targets.
      edges: (B, E, 4) float32 obstacle segments (16-byte aligned), edge_mask:
        (B, E) bool. us_init: (B, N, 2) float32 warm-start controls.
      All contiguous on one CUDA device; anything else raises before a
      launch.

    Returns (xs (B, N+1, 3), us (B, N, 2), cost (B,), converged (B,) bool);
    with ``record`` also the line search's picks (B, n_iters) int32 (0 = no
    step, i = the i-th step size) and the last iteration's quadraticization
    (formed at the nearest edges that the iterations before it kept) as a
    dict of ``quadraticize``'s names (lx, lu, lxx, fx, fu, Vx, Vxx).
    """
    dev = x0.device
    if us_init.dim() != 3 or edges.dim() != 3:
        raise ValueError(f"ilqr_solve: us_init {tuple(us_init.shape)}, edges "
                         f"{tuple(edges.shape)}; expected (B, N, 2) and (B, E, 4)")
    B, N = us_init.shape[:2]
    E = edges.shape[1]
    check(x0, "x0", torch.float32, (B, 3), dev)
    check(goal, "goal", torch.float32, (B, 3), dev)
    check(edges, "edges", torch.float32, (B, E, 4), dev)
    check(edge_mask, "edge_mask", torch.bool, (B, E), dev)
    check(us_init, "us_init", torch.float32, (B, N, 2), dev)
    if N < 1:
        raise ValueError("ilqr_solve: a horizon of at least one step")
    if edges.data_ptr() % 16:
        raise ValueError("edges: not 16-byte aligned")
    p = params(cfg, vcfg)
    smem = smem_bytes(N, E, p.n_alphas)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ilqr_solve: N={N}, E={E}, {p.n_alphas} step sizes need {smem} bytes "
                         f"of shared memory a row, more than {SMEM_LIMIT}")
    if dev.type != "cuda":
        raise ValueError(f"ilqr_solve: tensors on {dev}, the kernel takes CUDA tensors")
    xs = torch.empty((B, N + 1, 3), dtype=torch.float32, device=dev)
    us = torch.empty((B, N, 2), dtype=torch.float32, device=dev)
    cost = torch.empty((B,), dtype=torch.float32, device=dev)
    converged = torch.empty((B,), dtype=torch.bool, device=dev)
    picks = quad = None
    if record:
        picks = torch.zeros((B, cfg.n_iters), dtype=torch.int32, device=dev)
        quad = torch.zeros((B, QUAD_STEP * N + QUAD_TERMINAL), dtype=torch.float32, device=dev)
    none = ctypes.c_void_p(None)
    KERNEL.launch(dev, ptr(x0), ptr(goal), ptr(edges), ptr(edge_mask), ptr(us_init), ptr(xs),
                  ptr(us), ptr(cost), ptr(converged), ptr(picks) if record else none,
                  ptr(quad) if record else none, B, N, E, p)
    if not record:
        return xs, us, cost, converged
    steps = quad[:, :QUAD_STEP * N].reshape(B, N, QUAD_STEP)
    term = quad[:, QUAD_STEP * N:]
    q = {"lx": steps[..., 0:3], "lu": steps[..., 3:5], "lxx": steps[..., 5:14].reshape(B, N, 3, 3),
         "fx": steps[..., 14:23].reshape(B, N, 3, 3), "fu": steps[..., 23:29].reshape(B, N, 3, 2),
         "Vx": term[:, 0:3], "Vxx": term[:, 3:12].reshape(B, 3, 3)}
    return xs, us, cost, converged, picks, q
