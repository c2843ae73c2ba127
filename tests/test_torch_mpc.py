"""The port's pure-MPC modules against the JAX package's, on the CPU: the
scene helpers, the iLQR solver, the parallel-parking templates, the staging
poses (valid sets, picks, two-segment latches), ``save_record``, and the two
repairs that the MPC path needs (``summarize``'s ``way_latched``, the eval
CLI on the port's own checkpoints).

Inputs come from numpy seeds or from the JAX package; the JAX outputs that
cost a compile of tens of seconds are read from ``tests/data/torch_jax_mpc.npz``
(``tests/mpc_cases.py``). Tolerances are stated per test; float32
throughout.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.envs import make_scene as jmake_scene
from hope_tpu.envs.scene import pack_polygons as jpack
from hope_tpu.envs import stack_scenes as jstack
from hope_tpu.planning import ilqr as jilqr
from hope_tpu_torch.config import EnvConfig, ObsConfig, VehicleConfig
from hope_tpu_torch.envs import ParkingEnv, Scene, make_scene, pack_polygons, stack_scenes
from hope_tpu_torch.planning import ilqr

from . import mpc_cases as mc
from .torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
FIELDS = [f.name for f in dataclasses.fields(Scene)]
VCFG = VehicleConfig()


@pytest.fixture(scope="module")
def data():
    return mc.load()


def port_env(settings: dict) -> ParkingEnv:
    return ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False),
                                **settings), device="cpu")


def port_scenes(data, name: str) -> Scene:
    return Scene.from_numpy(mc.scenes_of(data, name), "cpu")


# ------------------------------------------------------------ scene helpers


def test_scene_helpers_match_jax():
    """pack_polygons, make_scene and stack_scenes give JAX's arrays exactly,
    on tests/test_mpc.py's rooms (a closing vertex repeated in one ring; an
    edge budget that cuts a ring)."""
    rings = mc.room_rings() + [np.vstack([mc.BLOCK_RING, mc.BLOCK_RING[:1]])]
    for max_edges, max_polys in ((16, 2), (6, 2), (16, 1)):
        for a, b in zip(jpack(rings, max_edges, max_polys), pack_polygons(rings, max_edges,
                                                                          max_polys)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    dest_box = np.asarray(mc.jax_room().dest_box[0])
    args = (rings, [0.0, 0.0, 0.0], [4.0, 0.0, 0.0], [-14, 14, -10, 10], 0, 1, dest_box, 16, 2)
    want = jstack([jmake_scene(*args)] * 2)
    got = stack_scenes([make_scene(*args, device="cpu")] * 2)
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, f
        np.testing.assert_array_equal(w, g, err_msg=f)


# -------------------------------------------------------------------- iLQR


def _derivative_points(rng, B=3, N=20, E=12):
    edges = rng.uniform(-4, 8, (B, E, 4)).astype(np.float32)
    mask = rng.uniform(size=(B, E)) < 0.8
    goal = rng.uniform(0, 5, (B, 3)).astype(np.float32)
    xs = np.stack([rng.uniform(0, 5, (B, N + 1)), rng.uniform(-2, 2, (B, N + 1)),
                   rng.uniform(-1, 1, (B, N + 1))], -1).astype(np.float32)
    us = rng.uniform(-1.2, 1.2, (B, N, 2)).astype(np.float32)
    # controls on their clip bounds, where the derivative is halved
    us[:, :3, 0] = VCFG.max_steer
    us[:, 3:5, 0] = -VCFG.max_steer
    us[:, 5:7, 1] = -VCFG.max_speed
    us[:, 7, 1] = VCFG.max_speed
    return xs, us, goal, edges, mask


def _jax_quadraticize(xs, us, goal, edges, mask, cfg):
    """The reference's derivatives: grad / hessian of its stage and terminal
    costs, jacfwd of its arc step (``ilqr.solve``'s quadraticize)."""
    def one(x, u, g, e, m):
        stage, term = jilqr.make_costs(g, e, m, cfg, mc.VCFG)
        up = jnp.concatenate([u[:1], u[:-1]])
        dyn = lambda a, b: jilqr._dynamics(a, b, mc.VCFG, cfg.dt)  # noqa: E731
        return (jax.vmap(jax.grad(stage, 0))(x[:-1], u, up),
                jax.vmap(jax.grad(stage, 1))(x[:-1], u, up),
                jax.vmap(jax.hessian(stage, 0))(x[:-1], u, up),
                jax.vmap(jax.hessian(stage, 1))(x[:-1], u, up)[0],
                jax.vmap(jax.jacfwd(dyn, 0))(x[:-1], u), jax.vmap(jax.jacfwd(dyn, 1))(x[:-1], u),
                jax.grad(term)(x[-1]), jax.hessian(term)(x[-1]))
    return [np.asarray(a) for a in jax.vmap(one)(xs, us, goal, edges, mask)]


def test_ilqr_derivatives_match_jax():
    """The closed-form derivatives equal JAX's autodiff of the same costs and
    arc step on seeded points (3 scenes, 20 steps, 12 edges, 80% live). Per
    point, each of lx, lxx, Vx, Vxx within 2e-5 of that point's largest
    entry (measured: 1.3e-6 / 5.9e-6, float32 rounding of sums in another
    order); lu, luu exact; fx, fu within 1e-4 + 1e-7 / dth^2 absolute at a
    step that turns by dth (entries up to 1). JAX's arc step divides by dth:
    its derivative in the steer subtracts terms of size ~1/curv^2 whose
    difference is ~1, so its float32 rounding (6e-8 of sin / cos) comes out
    as ~8e-9 / dth^2; the port's chord form is within 2e-7 of float64
    (tests/test_torch_mpc_reference.py)."""
    rng = np.random.default_rng(3)
    pts = _derivative_points(rng)
    cfg = jilqr.ILQRConfig(horizon=20)
    want = _jax_quadraticize(*pts, cfg)
    got = ilqr.quadraticize(*(T(a) for a in pts), ilqr.ILQRConfig(horizon=20), VCFG)
    names = ("lx", "lu", "lxx", "luu", "fx", "fu", "Vx", "Vxx")
    for name, w, g in zip(names, want, got):
        g = g.numpy()
        if name == "luu":
            w = w[0]
        assert w.shape == g.shape, name
        if name in ("lu", "luu"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("fx", "fu"):
            bound = np.array([VCFG.max_steer, VCFG.max_speed])
            u = np.clip(pts[1], -bound, bound)
            dth = np.abs(u[..., 1] * np.tan(u[..., 0]) / VCFG.wheel_base * cfg.dt)
            tol = (1e-4 + 1e-7 / np.maximum(dth, 1e-9) ** 2)[..., None, None]
            assert (np.abs(g - w) <= tol).all(), name
        else:
            axes = tuple(range(w.ndim - (1 if name in ("lx", "Vx") else 2), w.ndim))
            scale = np.abs(w).max(axis=axes, keepdims=True)
            assert (np.abs(g - w) <= 2e-5 * scale + 1e-6).all(), name


def test_ilqr_clip_tie_jacobian_matches_jax():
    """At a control exactly on its clip bound the arc step's derivative in
    that control is half the inside one, as jnp.clip's (torch.clamp's would
    be whole): fu there equals JAX's jacfwd, to 1e-6. JAX's is taken in
    float64: in float32 its steer derivative subtracts terms of ~1 / curv^2
    and is 2.6e-6 off at these points, the port's chord form 1e-7."""
    x = np.array([[1.0, 2.0, 0.3]] * 4, np.float32)
    u = np.array([[VCFG.max_steer, 1.0], [-VCFG.max_steer, -1.0],
                  [0.2, VCFG.max_speed], [0.2, -VCFG.max_speed]], np.float32)
    dyn = lambda a, b: jilqr._dynamics(a, b, mc.VCFG, mc.DT)  # noqa: E731
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(jax.jacfwd(dyn, 1))(x.astype(np.float64),
                                                       u.astype(np.float64)))
    _, _, got = ilqr._dynamics(T(x), T(u), VCFG, mc.DT, jac=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the tied column is half the derivative just inside the bound
    inside = u.copy()
    inside[:2, 0] *= 1 - 1e-6
    inside[2:, 1] *= 1 - 1e-6
    _, _, full = ilqr._dynamics(T(x), T(inside), VCFG, mc.DT, jac=True)
    for row, col in ((0, 0), (1, 0), (2, 1), (3, 1)):
        np.testing.assert_allclose(got[row, :, col].numpy(), 0.5 * full[row, :, col].numpy(),
                                   rtol=1e-4, atol=1e-7)


@pytest.fixture
def jax_straight_steer_derivative(monkeypatch):
    """The port's solver with JAX's derivative of its arc step where that
    step runs straight (|dth| < 1e-9): JAX takes there the straight branch
    ``v dt (cos th, sin th)``, whose derivative in the steer is 0 in x and y,
    in float32 and float64 alike; the exact step's is ``-(v dt)^2 / 2 (sin
    th, -cos th) * dcurv/dsteer`` (``ilqr._dynamics``, held to float64
    autograd in tests/test_torch_mpc_reference.py). Every other derivative
    is the port's own."""
    exact = ilqr._dynamics

    def with_jax_branch(x, u, vcfg, dt, jac=False):
        out = exact(x, u, vcfg, dt, jac)
        if not jac:
            return out
        nxt, fx, fu = out
        steer = torch.clamp(u[..., 0], -vcfg.max_steer, vcfg.max_steer)
        v = torch.clamp(u[..., 1], -vcfg.max_speed, vcfg.max_speed)
        straight = torch.abs(v * (torch.tan(steer) / vcfg.wheel_base) * dt) < 1e-9
        fu = fu.clone()
        fu[..., :2, 0] = torch.where(straight[..., None], 0.0, fu[..., :2, 0])
        return nxt, fx, fu

    monkeypatch.setattr(ilqr, "_dynamics", with_jax_branch)


def _case(name):
    kw, x0, goal, edges, mask, us0 = mc.ilqr_case(name)
    return ilqr.ILQRConfig(**kw), [T(a) for a in (x0, goal, edges, mask, us0)]


@pytest.mark.parametrize("name", mc.ILQR_CASES)
def test_ilqr_iterations_match_jax(data, name, jax_straight_steer_derivative):
    """Each iteration, started from JAX's own iterate (its controls and
    regularization before that iteration), takes the same line-search step
    (0 = none, i = the i-th alpha) and leaves the same regularization (the
    same float32 operations), at a cost within 5e-2 relative of JAX's.

    The bound is JAX's arc step's float32 conditioning, not the solver's: a
    step that turns by dth divides by it, so a last-place rounding of sin or
    cos moves its car by ~v * dt * 6e-8 / dth (the port's chord form does
    not divide); the
    line search's rollouts pass through such steps, and the obstacle cost is
    steep (measured: <= 1.5e-4 on tests/test_ilqr.py's cases; on the seeded
    ones <= 3.8e-3 but for one iteration in 48 at 1.9e-2, same pick). A step that
    changes both frameworks' cost by less than 1e-5 relative is a tie at
    float32 rounding: there either pick may be taken (JAX's regularization
    is injected into the next iteration). The port's derivative in the steer
    at exactly straight steps is JAX's here (``jax_straight_steer_derivative``:
    JAX's branch gives 0, in float32 and float64 alike, the exact step's
    does not; without it the seeded case's iterations differ by up to 48%
    from JAX's float64 iterate). Cases: the three of
    tests/test_ilqr.py and 4 seeded scenes with 16-96 live edges at the MPC
    CLI's weights, warm started from RS-like controls (full-lock or straight
    runs)."""
    cfg, (x0, goal, edges, mask, _) = _case(name)
    ref = {k[len(f"ilqr/{name}/"):]: v for k, v in data.items() if k.startswith(f"ilqr/{name}/")}
    B = x0.shape[0]
    decided = 0
    for it in range(cfg.n_iters):
        for b in range(B):
            one = cfg._replace(n_iters=1, reg_init=float(ref["reg_before"][it, b]))
            _, h = ilqr.solve_batch(x0[b:b + 1], goal[b:b + 1], edges[b:b + 1], mask[b:b + 1],
                                    T(ref["us_before"][it, b:b + 1]), one, VCFG, history=True)
            where = f"{name}: iteration {it}, scene {b}"
            np.testing.assert_allclose(float(h.cost[0, 0]), ref["cost"][it, b], rtol=5e-2,
                                       err_msg=where)
            if int(h.pick[0, 0]) != ref["pick"][it, b]:
                c0 = ref["c0"][it, b]
                gain = max(abs(c0 - ref["cost"][it, b]), abs(c0 - float(h.cost[0, 0])))
                assert gain <= 1e-5 * abs(c0), where
                continue
            assert float(h.reg[0, 0]) == float(ref["reg"][it, b]), where
            decided += 1
    # the first iteration of every scene moves the cost, so it is decided
    assert decided >= B


def test_ilqr_solve_matches_jax(data, jax_straight_steer_derivative):
    """The whole solve, run freely, on tests/test_ilqr.py's cases (and its
    checks, on the port), with JAX's derivative at exactly straight steps
    (``jax_straight_steer_derivative``; without it the open case ends 3.0e-4
    from JAX's cost, float32 and float64 alike, the exact derivative's
    float64 solve 96.13142 against JAX's 96.10215). Where no step turns by
    less than ~1e-3 rad (the open-space and batched cases), the final cost
    is within 1e-5 relative of JAX's and the controls within 2e-2 (measured
    9e-7 and 1.4e-2). Where JAX's arc step is ill-conditioned (the wall
    case, whose warm start turns gently), the two frameworks' iterates part
    after a few iterations (ilqr.py's docstring): its final cost is held to
    within 10% of JAX's (measured 3.5%)."""
    for name in ("open", "batched"):
        cfg, args = _case(name)
        res = ilqr.solve_batch(*args, cfg, VCFG)
        pre = f"ilqr/{name}/"
        np.testing.assert_allclose(res.cost.numpy(), data[pre + "final_cost"], rtol=1e-5)
        np.testing.assert_allclose(res.us.numpy(), data[pre + "us"], rtol=0, atol=2e-2)
        np.testing.assert_array_equal(res.converged.numpy(), data[pre + "converged"])
    cfg, args = _case("open")
    res = ilqr.solve(*(a[0] for a in args), cfg, VCFG)
    assert np.hypot(float(res.xs[-1, 0]) - 6.0, float(res.xs[-1, 1]) - 2.0) < 0.3
    assert bool(res.converged)
    cfg, args = _case("wall")
    res = ilqr.solve(*(a[0] for a in args), cfg, VCFG)
    xs = res.xs.numpy()
    near = np.abs(xs[:, 0] - 4.0) < 0.8
    assert near.any() and np.abs(xs[near, 1]).max() > 0.8
    assert np.hypot(xs[-1, 0] - 8.0, xs[-1, 1]) < 0.6
    np.testing.assert_allclose(float(res.cost), data["ilqr/wall/final_cost"][0], rtol=0.1)
    cfg, args = _case("batched")
    res = ilqr.solve_batch(*args, cfg, VCFG)
    ends, goal = res.xs[:, -1].numpy(), args[1].numpy()
    assert (np.hypot(ends[:, 0] - goal[:, 0], ends[:, 1] - goal[:, 1]) < 0.5).all()


def test_ilqr_solver_and_reg_on_cpu():
    """On the CPU the runner's ILQRSolver is solve_batch, bit for bit."""
    cfg, args = _case("batched")
    want = ilqr.solve_batch(*args, cfg, VCFG)
    for w, g in zip(want, ilqr.ILQRSolver(cfg, VCFG)(*args)):
        assert torch.equal(w, g)


def test_ilqr_solver_counts_plain_solves_on_cpu():
    """On the CPU every solve of the runner's ILQRSolver goes through
    solve_batch: under a profiler it counts ``ilqr/plain_solves``, never
    ``ilqr/kernel_solves``."""
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.utils import profiling

    cfg, args = _case("batched")
    solver = ilqr.ILQRSolver(cfg, VCFG)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        solver(*args)
        solver(*args)
    counts = profiling.counters()
    profiling.reset_counters()
    assert counts.get("ilqr/plain_solves") == 2 and "ilqr/kernel_solves" not in counts


def _kernel_stand_in(reg_down=0.7, quad_at_first=False):
    """``ops.ilqr_solve.ilqr_solve``'s contract on the CPU, from solve_batch
    one iteration at a time (each row's reg carried: x ``reg_down``, floored
    at 1e-6, after a step taken, else x 4), the last iteration's
    quadraticization recorded (with ``quad_at_first``, the first's)."""

    def solve(x0, goal, edges, mask, us_init, cfg, vcfg, record=False):
        start = ilqr.solve_batch(x0, goal, edges, mask, us_init, cfg._replace(n_iters=0), vcfg)
        xs, us, cost = start.xs, us_init, start.cost
        reg = torch.full((x0.shape[0],), cfg.reg_init)
        picks, quads = [], []
        for _ in range(cfg.n_iters):
            quads.append(ilqr.quadraticize(xs, us, goal, edges, mask, cfg, vcfg))
            new = None
            for r in reg.unique():
                res, h = ilqr.solve_batch(x0, goal, edges, mask, us,
                                          cfg._replace(n_iters=1, reg_init=float(r)), vcfg,
                                          history=True)
                step = (res.xs, res.us, res.cost, h.pick[:, 0])
                rows = reg == r
                new = step if new is None else tuple(
                    torch.where(rows.view(-1, *[1] * (a.ndim - 1)), a, b) for a, b in zip(step, new))
            xs, us, cost, pick = new
            reg = torch.where(pick > 0, torch.clamp(reg * reg_down, min=1e-6), reg * 4.0)
            picks.append(pick)
        converged = (start.cost - cost) / torch.clamp(start.cost, min=1e-9) > 1e-3
        if not record:
            return xs, us, cost, converged
        q = quads[0 if quad_at_first else -1] if quads else [None] * 8
        names = ("lx", "lu", "lxx", "luu", "fx", "fu", "Vx", "Vxx")
        return (xs, us, cost, converged,
                torch.stack(picks, 1).int() if picks else torch.zeros(x0.shape[0], 0).int(),
                {k: v for k, v in zip(names, q) if k != "luu"})

    return solve


@pytest.mark.parametrize("planted", [None, "reg_rule", "stale_derivatives"])
def test_kernel_vs_plain_holds_the_iterations(monkeypatch, planted):
    """chip_smoke.py's ``kernel_vs_plain``, the card's hold of the iLQR
    kernel against solve_batch, run on the CPU with a stand-in for the
    kernel built from solve_batch one iteration at a time: the stand-in
    passes the first and the second step; with its reg falling by x0.5
    after a step taken (solve_batch: x0.7), or with the second iteration's
    derivatives recorded at the first iterate, the second step fails."""
    import chip_smoke
    from hope_tpu_torch.ops import ilqr_solve

    monkeypatch.setattr(ilqr_solve, "ilqr_solve", _kernel_stand_in(
        reg_down=0.5 if planted == "reg_rule" else 0.7,
        quad_at_first=planted == "stale_derivatives"))
    cfg, args = _case("batched")
    first = chip_smoke.kernel_vs_plain(args, cfg, VCFG, 1, agree_floor=0.9)
    second = chip_smoke.kernel_vs_plain(args, cfg, VCFG, 2, agree_floor=0.9)
    assert first["bad"] == [] and first["steps_taken"] > 0
    if planted is None:
        assert second["bad"] == []
    else:
        assert second["bad"], second


def _misaligned(t):
    """``t``'s values in a tensor whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype)
    out = buf[1:t.numel() + 1].view(t.shape)
    out.copy_(t)
    return out


# (what, index of the argument replaced, its replacement, config change, the
# message the binding raises with)
KERNEL_REFUSALS = {
    "x0 shape": (0, lambda t: t[:, :2].contiguous(), {}, "x0: shape"),
    "goal dtype": (1, lambda t: t.double(), {}, "goal: dtype"),
    "edges rank": (2, lambda t: t[..., 0].contiguous(), {}, r"expected \(B, N, 2\)"),
    "edges width": (2, lambda t: t[..., :3].contiguous(), {}, "edges: shape"),
    "edges not aligned": (2, _misaligned, {}, "16-byte"),
    "mask dtype": (3, lambda t: t.float(), {}, "edge_mask: dtype"),
    "us_init width": (4, lambda t: t[..., :1].contiguous(), {}, "us_init: shape"),
    "us_init strided": (4, lambda t: t.transpose(0, 1).contiguous().transpose(0, 1), {},
                        "not contiguous"),
    "too many step sizes": (None, None, {"alphas": (1.0,) * 17}, "step sizes"),
    "no step size": (None, None, {"alphas": ()}, "step sizes"),
    "shared memory": (2, lambda t: torch.zeros(t.shape[0], 16384, 4), {}, "shared memory"),
    "on the cpu": (None, None, {}, "CUDA tensors"),
}


@pytest.mark.parametrize("what", list(KERNEL_REFUSALS))
def test_ilqr_kernel_binding_refuses_before_a_launch(what):
    """The kernel's binding (``ops.ilqr_solve``) raises on inputs the kernel
    does not take, before any launch and without loading the kernel:
    wrong shapes, dtypes, strides or alignment, a step-size count it cannot
    hold, a shared-memory need past a block's, and tensors off the card."""
    from hope_tpu_torch.ops import ilqr_solve

    i, change, cfg_change, match = KERNEL_REFUSALS[what]
    cfg, args = _case("batched")
    cfg = cfg._replace(**cfg_change)
    if i is not None:
        args[i] = change(args[i])
        if what == "shared memory":
            args[3] = torch.ones(args[2].shape[:2], dtype=torch.bool)
    launches, loaded = ilqr_solve.KERNEL.launches, ilqr_solve.KERNEL._fn
    with pytest.raises(ValueError, match=match):
        ilqr_solve.ilqr_solve(*args, cfg, VCFG)
    assert ilqr_solve.KERNEL.launches == launches and ilqr_solve.KERNEL._fn is loaded is None


# -------------------------------------------------------- parallel parking


def test_templates_equal_jax():
    """The numpy copy of build_templates gives JAX's arrays exactly: 1844
    templates of 40 segments at the default dims, and at the env's vehicle
    dims (the reference's quirks kept: no length budget, dedup on lengths
    only)."""
    from hope_tpu.planning import parallel_park as jpp
    from hope_tpu_torch.planning import parallel_park as pp

    assert pp.N_WIGGLE_SEG == jpp.N_WIGGLE_SEG == 40
    maxc = VCFG.max_curvature
    dims = (VCFG.rear_hang, VCFG.front_hang + VCFG.wheel_base, VCFG.width / 2)
    for kw in ({}, {"dims": dims}):
        want, got = jpp.build_templates(maxc, **kw), pp.build_templates(maxc, **kw)
        assert got[0].shape == (1844, 40) and got[2].shape == (1844, 3)
        for w, g in zip(want, got):
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)


# ----------------------------------------------------------------- staging


def test_staging_candidates_match_jax():
    """The polar grid, in JAX's order, within 1e-6 (sin / cos of the same
    float32 angles)."""
    from hope_tpu.planning.staging import N_STAGING as JN, staging_candidates as jcands
    from hope_tpu_torch.planning.staging import N_STAGING, staging_candidates

    dest = np.random.default_rng(4).uniform(-10, 10, (5, 3)).astype(np.float32)
    want = np.asarray(jax.vmap(jcands)(dest))
    got = staging_candidates(T(dest)).numpy()
    assert N_STAGING == JN == got.shape[1] == 320
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,settings", [("room", mc.ROOM_ENV), ("blocked", mc.ROOM_ENV),
                                           ("extrem", dict(max_edges=96, max_obstacles=32)),
                                           ("dlp", mc.DLP_ENV)])
def test_staging_matches_jax(data, name, settings):
    """compute_staging on tests/test_mpc.py's open room (:57), its blocked ring
    (:86) and two Extrem scenes (:199) at 4 words a candidate, and on DLP case
    0 (512 slots, 216 live edges) at the CLI's 6: the valid sets equal JAX's,
    polar and template candidates alike (the templates swept by the
    divide-free sweep, JAX's by its divided ``traj_collides``), and poses and
    L within 1e-4 m (measured <= 7.6e-6 on L). On DLP one polar candidate's
    6 shortest RS words are cut from 8 that tie within 2e-6 m, and JAX's
    jitted search sweeps another 6 than its eager one; such a candidate may
    differ (``mc.rs_cut_ties``). Each valid candidate's completion (segment
    lengths within 1e-4 m, steers) is JAX's, except where RS words are
    equally short to float32 rounding and the port picks another (2 of the
    room's 640 polar candidates, 9 of DLP's 280 valid: L within 1.9e-6 m).
    The committed banks are held in tests/test_torch_mpc_banks.py."""
    assert mc.STAGING_CASES[name][2] == settings
    mc.check_staging(data, name)
    if name == "extrem":
        assert np.isfinite(data["staging/extrem/L"][:, 320:]).any()   # templates validate


def _jax_staging_set(data, prefix):
    from hope_tpu_torch.planning.staging import StagingSet

    return StagingSet(*(T(data[f"{prefix}/{f}"]) for f in StagingSet._fields))


def test_pick_goal_and_waypoint_latch_match_jax(data):
    """On JAX's own staging set of the open room: pick_goal's goal and flag
    (tests/test_mpc.py:77), and waypoint_latch's two-segment queue from
    (-8, 4, 2) at window offsets 0 and 4 (:128): latched flags and queue
    lengths equal, queues within 1e-6."""
    from hope_tpu_torch.agents import HybridState
    from hope_tpu_torch.planning.staging import pick_goal, waypoint_latch

    sc = port_scenes(data, "room")
    st = _jax_staging_set(data, "staging/room")
    goal, has = pick_goal(st, T([[-6.0, 0.0, 0.0]] * 2), sc.dest)
    np.testing.assert_array_equal(has.numpy(), data["pick/has"])
    np.testing.assert_allclose(goal.numpy(), data["pick/goal"], rtol=0, atol=1e-6)
    env = port_env(mc.LATCH_ENV)
    st = _jax_staging_set(data, "latch_staging")
    for off in (0, 4):
        hyb, latched, _ = waypoint_latch(env, st, T([[-8.0, 4.0, 2.0]] * 2), sc,
                                      HybridState.create(2, 64, "cpu"), torch.ones(2, dtype=bool),
                                      env.cfg.step_ratio, offset=off)
        np.testing.assert_array_equal(latched.numpy(), data[f"latch/{off}/latched"])
        np.testing.assert_array_equal(hyb.length.numpy(), data[f"latch/{off}/length"])
        np.testing.assert_allclose(hyb.queue.numpy(), data[f"latch/{off}/queue"], rtol=0,
                                   atol=1e-6)
    assert data["latch/0/latched"].all()


def test_concat_queues_and_orderings_match_jax():
    """concat_queues equals JAX's exactly on seeded queues (lengths 0 to
    beyond the budget); pick_goal's argmin and waypoint_latch's stable
    ordering keep JAX's order among the many +inf ties."""
    from hope_tpu.planning.staging import concat_queues as jconcat
    from hope_tpu_torch.planning.staging import concat_queues

    rng = np.random.default_rng(5)
    B, Q = 6, 16
    q1, q2 = (rng.uniform(-1, 1, (B, Q, 2)).astype(np.float32) for _ in range(2))
    n1 = np.array([0, 3, 16, 9, 7, 0], np.int32)
    n2 = np.array([5, 0, 4, 12, 9, 0], np.int32)
    wq, wn = jax.vmap(lambda a, b, c, d: jconcat(a, b, c, d, Q))(q1, n1, q2, n2)
    gq, gn = concat_queues(T(q1), T(n1), T(q2), T(n2), Q)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))
    cost = np.full((3, 40), np.inf, np.float32)
    cost[0, [5, 9]] = 1.0
    cost[1, [30, 2]] = 2.0
    want = np.asarray(jnp.argsort(jnp.asarray(cost), axis=1))
    np.testing.assert_array_equal(torch.argsort(T(cost), dim=1, stable=True).numpy(), want)
    np.testing.assert_array_equal(torch.argmin(T(cost), dim=1).numpy(),
                                  np.asarray(jnp.argmin(jnp.asarray(cost), axis=1)))


# --------------------------------------------------- records and repairs


def test_save_record_matches_jax(tmp_path):
    """save_record writes the same npz as JAX's from the same arrays (and
    from CPU tensors)."""
    from hope_tpu.evaluation.render import save_record as jsave
    from hope_tpu_torch.evaluation.render import save_record

    rng = np.random.default_rng(7)
    m = {"success": rng.uniform(size=5) < 0.5, "steps": rng.integers(0, 200, 5).astype(np.int32),
         "path_length": rng.uniform(0, 30, 5).astype(np.float32)}
    jsave(str(tmp_path / "j.npz"), m)
    save_record(str(tmp_path / "t.npz"), {k: T(v) for k, v in m.items()})
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("with_way", [True, False])
def test_summarize_way_latched_matches_jax(with_way):
    """The port's summarize gives JAX's dict on the same metrics, with the
    per-level way_latched entry where the metrics carry it and without it
    where they do not."""
    from hope_tpu.evaluation.evaluate import summarize as jsummarize
    from hope_tpu_torch.evaluation.evaluate import summarize

    rng = np.random.default_rng(8 + with_way)
    n = 12
    m = {"success": rng.uniform(size=n) < 0.6, "steps": rng.integers(1, 200, n).astype(np.int32),
         "path_length": rng.uniform(0, 30, n).astype(np.float32),
         "status": rng.integers(0, 5, n).astype(np.int32),
         "finished": rng.uniform(size=n) < 0.8, "rs_latched": rng.uniform(size=n) < 0.5,
         "level": np.repeat(np.array([0, 2, 3], np.int32), 4)}
    if with_way:
        m["way_latched"] = rng.uniform(size=n) < 0.5
    want = jsummarize(m, max_steps=200)
    got = summarize({k: T(v) for k, v in m.items()}, max_steps=200)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert all(("way_latched" in v) == with_way for v in got["per_level"].values())


def test_eval_cli_scores_train_sac_checkpoint(tmp_path):
    """train_sac --smoke --device cpu (2 chunks), then the eval CLI on its
    checkpoint directory (--no-img --no-dlp, as the run): the agent it builds
    holds the trained weights (not fresh ones), and its summary equals
    run_battery's on the in-memory state; 'random' builds fresh weights."""
    from hope_tpu_torch.evaluation import eval_mix_scene
    from hope_tpu_torch.train import train_sac

    log = tmp_path / "run"
    loop = train_sac.main(["--smoke", "--device", "cpu", "--no-tensorboard", "--max-chunks", "2",
                           "--log-dir", str(log), "--seed", "3"])["loop"]
    args = dict(device="cpu", no_img=True, no_dlp=True)
    _, _, loaded = eval_mix_scene.build(str(log / "ckpt"), **args)
    _, _, fresh = eval_mix_scene.build("random", **args)
    for a, b, c in zip(loop["state"].actor.parameters(), loaded.actor.parameters(),
                       fresh.actor.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert any(not torch.equal(a, c) for a, c in zip(loop["state"].actor.parameters(),
                                                     fresh.actor.parameters()))
    assert loaded.steps == loop["state"].steps > 0
    kw = dict(episodes=2, max_steps=3, seed=1)
    want = eval_mix_scene.run_battery(loop["env"], loop["agent"], loop["state"], "sac", out=None,
                                      levels=["Normal", "Extrem"], **kw)
    got = eval_mix_scene.main([str(log / "ckpt"), "--no-img", "--no-dlp", "--device", "cpu",
                               "--episodes", "2", "--max-steps", "3", "--seed", "1",
                               "--out", str(tmp_path / "eval")])
    assert list(got) == ["Extrem", "Complex", "Normal"]        # --no-dlp: no dlp level
    for level in want:
        w, g = dict(want[level]), dict(got[level])
        w.pop("rollout_seconds"), g.pop("rollout_seconds")
        assert g == w, level
    with pytest.raises(SystemExit):
        eval_mix_scene.main([str(log / "ckpt"), "--rs-tries", "x"])
