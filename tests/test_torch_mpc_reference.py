"""The port's pure-MPC iLQR and runner against the benchmark's float64
reference (``portbench/reference``: ``ilqr.py``, the iLQR written from the
published method with autograd derivatives; ``mpc.py``, the runner's control
rule and latches replayed row by row), on the CPU at small sizes.

- the arc step and its Jacobians against float64 autograd of the exact
  step, for heading changes from 1e-8 to 1 rad: the chord form within float32
  rounding, the divided form it replaced (``portbench.mpc_faults``) not;
- ``solve_batch`` against the reference's iLQR on seeded scenes: the
  reported cost against the float64 cost of the port's own controls, and
  that cost against the reference's plan from the same warm start;
- a 24-step runner with staging, replayed: no control or latch mismatch,
  and a planted wrong latch counted.
"""
import math

import numpy as np
import pytest
import torch

from hope_tpu_torch.config import EnvConfig, ObsConfig, VehicleConfig
from hope_tpu_torch.envs import ParkingEnv, Scene
from hope_tpu_torch.planning import ilqr
from hope_tpu_torch.planning.mpc import build_mpc_runner
from hope_tpu_torch.planning.staging import compute_staging
from portbench import mpc_faults
from portbench.reference import ilqr as ref_ilqr
from portbench.reference import mpc as ref_mpc

from . import mpc_cases as mc
from .torch_threads import one_torch_thread  # noqa: F401

VCFG = VehicleConfig()
DT = VCFG.dt * VCFG.n_substep
F64 = torch.float64
CLI = {"w_terminal_pos": 300.0, "w_terminal_heading": 80.0, "w_running_pos": 0.05,
       "w_control": 0.05, "w_steer_rate": 0.2, "w_obstacle": 30.0, "obstacle_margin": 0.35,
       "reg_init": 1.0, "alphas": [1.0, 0.5, 0.25, 0.1, 0.03]}


def spec(horizon: int, n_iters: int):
    return ref_ilqr.spec_of({"ilqr": {"horizon": horizon, "n_iters": n_iters, **CLI}})


def port_cfg(horizon: int, n_iters: int):
    return ilqr.ILQRConfig(horizon=horizon, dt=DT, n_iters=n_iters,
                           **{k: v for k, v in CLI.items() if k != "alphas"})


def arc_points(n: int = 4000, seed: int = 0):
    """Poses and controls whose step turns by 1e-8 to 1 rad (log-uniform,
    either way, forward and back), with exactly straight steps among them."""
    g = torch.Generator().manual_seed(seed)
    turn = 10 ** (torch.rand(n, generator=g, dtype=F64) * 8 - 8)
    turn = turn * torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    v = (0.3 + 2.2 * torch.rand(n, generator=g, dtype=F64)) * torch.where(
        torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    steer = torch.atan(turn / (v * DT) * VCFG.wheel_base)
    steer[:8] = 0.0
    keep = steer.abs() < VCFG.max_steer
    x = torch.stack([(torch.rand(n, generator=g, dtype=F64) - 0.5) * 2,
                     (torch.rand(n, generator=g, dtype=F64) - 0.5) * 2,
                     (torch.rand(n, generator=g, dtype=F64) - 0.5) * 2 * math.pi], -1)
    return x[keep].float(), torch.stack([steer, v], -1)[keep].float()


def float64_step(x, u):
    """The exact step in float64 at the float32 inputs, and its Jacobians by
    autograd (the reference's)."""
    sp = spec(1, 1)
    xd, ud = x.double(), u.double()
    f = ref_ilqr.step(xd, ud, sp)
    fx = ref_ilqr._per_point_jacobian(lambda z: ref_ilqr.step(z, ud, sp), xd)
    fu = ref_ilqr._per_point_jacobian(lambda z: ref_ilqr.step(xd, z, sp), ud)
    return f, fx, fu


def worst_gaps(dynamics, x, u):
    """(step, Jacobian) worst gaps to float64: the step's against |x| + the
    distance it covers (float32 rounding is relative to that), the
    Jacobians' absolute (their entries are at most ~1)."""
    nxt, fx, fu = dynamics(x, u, VCFG, DT, jac=True)
    want, wfx, wfu = float64_step(x, u)
    size = x[:, :2].double().abs().amax(-1) + u[:, 1].double().abs() * DT
    step = float(((nxt[:, :2].double() - want[:, :2]).abs().amax(-1) / size).max())
    jac = max(float((fx.double() - wfx).abs().max()), float((fu.double() - wfu).abs().max()))
    return step, jac


@pytest.mark.parametrize("seed", [0, 1])
def test_arc_step_and_jacobians_match_float64(seed):
    """The chord form's step within 1e-6 of |x| + v dt of the exact float64
    step (measured 1.4e-7), its Jacobians within 1e-6 of float64 autograd
    (measured 1.7e-7), for every turn from 1e-8 to 1 rad, straight steps
    included."""
    x, u = arc_points(seed=seed)
    step, jac = worst_gaps(ilqr._dynamics, x, u)
    assert step <= 1e-6 and jac <= 1e-6, (step, jac)


def test_divided_arc_step_fails_the_bound():
    """The divided form ``v dt / dth * (sin(th + dth) - sin(th))`` that the
    chord form replaced misses the same bounds by orders of magnitude on the
    same points (measured 2.9 and 5.4e7: its step loses its digits as the
    turn shrinks, its steer derivative more so)."""
    x, u = arc_points(seed=0)
    step, jac = worst_gaps(mpc_faults._old_arc, x, u)
    assert step > 1e-2 and jac > 1e-2, (step, jac)


def seeded_problem(B: int = 4, E: int = 96, H: int = 16, seed: int = 9):
    """Scenes like tests/mpc_cases.py's seeded iLQR case at the MPC CLI's
    weights: 16-96 live edges, warm starts of full-lock or straight runs."""
    rng = np.random.default_rng(seed)
    x0 = np.stack([rng.uniform(-6, -2, B), rng.uniform(-2, 2, B), rng.uniform(-0.5, 0.5, B)], -1)
    goal = np.stack([rng.uniform(2, 6, B), rng.uniform(-1, 1, B), rng.uniform(-0.3, 0.3, B)], -1)
    mid = rng.uniform([-4, -6], [6, 6], (B, E, 2))
    ang = rng.uniform(0, np.pi, (B, E))
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.3, 1.5, (B, E, 1))
    edges = np.concatenate([mid - d, mid + d], -1)
    mask = np.arange(E)[None, :] < np.linspace(16, E, B).astype(int)[:, None]
    seg = np.repeat(rng.integers(-1, 2, (B, 4)), H // 4, axis=1) * VCFG.max_steer
    speed = np.repeat(rng.choice([-1.0, 1.0], (B, 4)), H // 4, axis=1) * VCFG.max_speed * 0.8
    us = np.stack([seg, speed], -1)
    return [torch.as_tensor(a, dtype=torch.float32) if a.dtype != bool else torch.as_tensor(a)
            for a in (x0, goal, edges, mask, us)]


@pytest.mark.parametrize("seed", [9, 10])
def test_solve_batch_against_float64_reference(seed):
    """On seeded scenes (B 4, H 16, 3 iterations, 96 edge slots), the port's
    reported cost is within 1e-4 of the float64 cost of its own controls
    (measured 3.7e-7), and that cost lies above the reference iLQR's from
    the same warm start by at most 5% of the warm start's cost on the mean
    of the rows (the cell's ``cost_excess``; its worst row measured 3.1e-3
    and 8.5e-7)."""
    from portbench.loops.mpc_battery import replan_gaps

    x0, goal, edges, mask, us = seeded_problem(seed=seed)
    res = ilqr.solve_batch(x0, goal, edges, mask, us, port_cfg(16, 3), VCFG)
    gap, excess = replan_gaps(x0, goal, edges, mask, us, res, spec(16, 3))
    assert gap <= 1e-4 and excess <= 0.05, (gap, excess)


def test_divided_arc_step_fails_cost_gap():
    """With the divided arc step the port's reported cost on gentle turns
    (a warm start steering 1e-6 rad) is far from the float64 cost of its
    own controls (measured 0.47; the chord form 2.9e-7): the cell's
    ``cost_gap`` fails."""
    from portbench.loops.mpc_battery import replan_gaps

    x0, goal, edges, mask, us = seeded_problem()
    us[..., 0] = 1e-6
    with mpc_faults.planted("old_arc"):
        res = ilqr.solve_batch(x0, goal, edges, mask, us, port_cfg(16, 3), VCFG)
    gap, _ = replan_gaps(x0, goal, edges, mask, us, res, spec(16, 3))
    assert gap > 1e-2, gap


def replay_runner(fault=None):
    """A 24-step run of the runner with staging on tests/test_mpc.py's open
    room (replan every 4 steps, H 12, 3 iterations), replayed by the
    reference for every row: (control mismatches, latch mismatches, rows
    that latched a plan)."""
    data = mc.load()
    env = ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False),
                               **mc.ROOM_ENV), device="cpu")
    sc = Scene.from_numpy(mc.scenes_of(data, "room"), "cpu")
    st = compute_staging(env, sc, max_tries=4)
    events = []
    with mpc_faults.planted(fault):
        run = build_mpc_runner(env, port_cfg(12, 3), 4, 24,
                               observe=lambda kind, **r: events.append((kind, r)))
        run(sc, st)
    rows = torch.arange(sc.dest.shape[0])
    rp = ref_mpc.Replay(rows, 12, 4, 64, st)
    latched = torch.zeros(len(rows), dtype=torch.bool)
    for kind, r in events:
        if kind == "replan":
            rp.replan(r["t"], r["pose"], r["goal"], r["us_init"], r["rs"], r["way"],
                      r["finished"], sc.dest, r["res"].us)
        elif kind == "step":
            i = r["i"]
        else:
            rp.step(i, r["applied"], r["executing"], r["hybrid"], r["srs"], r["finished"])
            latched |= r["executing"]
    return rp.control_bad, rp.latch_bad, int(latched.sum())


def test_runner_replay_matches_and_a_wrong_latch_fails():
    """The runner's applied controls, warm starts, goals and latches equal
    the reference's replay at every step of every row (and rows do execute
    latched plans); with an RS path latched over a running plan
    (``mpc_faults`` ``wrong_latch``) the replay counts latch mismatches."""
    control, latch, latched = replay_runner()
    assert (control, latch) == (0, 0) and latched > 0
    _, latch, _ = replay_runner("wrong_latch")
    assert latch > 0
