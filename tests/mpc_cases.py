"""Inputs and JAX reference outputs shared by the port's pure-MPC tests
(``tests/test_torch_mpc.py``, ``tests/test_torch_mpc_runner.py``).

Compiling the JAX runner, staging and iLQR chains costs minutes on the CPU,
so their outputs are saved once to ``tests/data/torch_jax_mpc.npz``:

    JAX_PLATFORMS=cpu python -m tests.mpc_cases --export

``test_jax_mpc_file`` (slow) computes them again and checks the file.
"""
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from hope_tpu.config import EnvConfig, ObsConfig, VehicleConfig
from hope_tpu.envs import ParkingEnv, make_scene, stack_scenes
from hope_tpu.geometry import pose_to_box

MPC_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jax_mpc.npz")
SCENE_FIELDS = ("edges", "edge_mask", "edge_poly", "n_polys", "start", "dest", "dest_box",
                "bounds", "level", "case_id")
VCFG = VehicleConfig()
DT = VCFG.dt * VCFG.n_substep
# the MPC CLI's parking-tuned iLQR weights
CLI_W = dict(w_terminal_pos=300.0, w_terminal_heading=80.0, w_running_pos=0.05, w_control=0.05,
             w_steer_rate=0.2)

# the env settings of tests/test_mpc.py (small rooms) and of the CLI
ROOM_ENV = dict(max_edges=16, max_obstacles=2, rs_max_points=64, rs_max_tries=4)
LATCH_ENV = dict(max_edges=16, max_obstacles=2, rs_max_points=220, rs_max_tries=4)
PROC_ENV = dict(max_edges=96, max_obstacles=32, rs_max_tries=12)
DLP_ENV = dict(max_edges=512, max_obstacles=128, rs_max_tries=12)

# staging cases: {name: (scenes, scene indices (None: all), env settings, RS
# words a candidate)}: tests/test_mpc.py's rooms and two Extrem scenes at 4
# words; DLP case 0 (512 slots) and the first 4 scenes of each committed bank
# (tests/data/torch_jax_banks.npz, padded to 96 slots) at the CLI's 6
BANK_LEVELS = ("Normal", "Complex", "Extrem")      # generate_bank keys 0, 1, 2
STAGING_CASES = {
    "room": ("room", None, ROOM_ENV, 4),
    "blocked": ("blocked", None, ROOM_ENV, 4),
    "extrem": ("extrem", None, dict(max_edges=96, max_obstacles=32), 4),
    "dlp": ("dlp", [0], DLP_ENV, 6),
    **{f"banks_{lv}": (f"banks_{lv}", [0, 1, 2, 3], PROC_ENV, 6) for lv in BANK_LEVELS},
}

# iLQR cases: tests/test_ilqr.py's three, and seeded poses with 16-96 live
# edges at the CLI's weights
ILQR_CASES = ("open", "wall", "batched", "seeded")
# runner cases: (scenes, env settings, iLQR config, runner options, with
# staging); the open-room ones are tests/test_mpc.py's
RUNNER_CASES = {
    "room_rs_exec": ("room", ROOM_ENV, dict(horizon=12, dt=DT, n_iters=3, **CLI_W),
                     dict(replan_every=4, max_steps=24), False),
    "room_ilqr_only": ("room", ROOM_ENV, dict(horizon=12, dt=DT, n_iters=3),
                       dict(replan_every=4, max_steps=16, rs_exec=False), False),
    "room_staging": ("room", ROOM_ENV, dict(horizon=12, dt=DT, n_iters=3, **CLI_W),
                     dict(replan_every=4, max_steps=24, step_rs=True, use_staging=True), True),
    "normal": ("normal", PROC_ENV, dict(horizon=16, dt=DT, n_iters=3, **CLI_W),
               dict(replan_every=8, max_steps=64), True),
    "dlp": ("dlp", DLP_ENV, dict(horizon=16, dt=DT, n_iters=3, **CLI_W),
            dict(replan_every=8, max_steps=24, use_staging=False), False),
}
RUNNER_KEYS = ("success", "steps", "path_length", "status", "finished", "rs_latched",
               "way_latched", "level", "case_id", "final_cost")


def jax_env(settings: dict) -> ParkingEnv:
    return ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False,
                                              mask_backend="xla"), **settings))


def room_rings():
    return [np.array([[-12.0, -8], [12, -8], [12, 8], [-12, 8]])]


def jax_room(ring=None, start=(0.0, 0.0, 0.0), B=2):
    """tests/test_mpc.py's open room (or the ring given), slot at (4, 0, 0)."""
    corners = jnp.asarray(VCFG.box_corners())
    dest = [4.0, 0.0, 0.0]
    dest_box = np.asarray(pose_to_box(jnp.asarray(dest), corners))
    scene = make_scene(ring or room_rings(), list(start), dest, [-14, 14, -10, 10], level=0,
                       case_id=1, dest_box=dest_box, max_edges=16, max_polys=2)
    return stack_scenes([scene] * B)


BLOCK_RING = np.array([[2.5, -1.5], [5.5, -1.5], [5.5, 1.5], [2.5, 1.5]])


def scene_arrays(sc) -> dict:
    return {f: np.asarray(getattr(sc, f)) for f in SCENE_FIELDS}


def jax_scenes() -> dict:
    """{name: scene arrays}: the open room, the blocked ring, 2 Extrem and 4
    Normal scenes of ``generate_bank`` (key 0; Normal padded to 96 slots),
    3 DLP cases (0, 57, 143) padded to 512, and the committed banks."""
    from hope_tpu.envs.dlp import DLPDataset
    from hope_tpu.envs.scenario_gen import generate_bank
    from hope_tpu.train.scene_pool import pad_scene_batch

    ext, _ = generate_bank(jax.random.PRNGKey(0), level="Extrem", n=4)
    normal, _ = generate_bank(jax.random.PRNGKey(0), level="Normal", n=4)
    ds = DLPDataset(env_cfg=EnvConfig(**DLP_ENV))
    dlp = ds.batch_reset(jax.random.split(jax.random.PRNGKey(1), 3), jnp.asarray([0, 57, 143]))
    return {"room": scene_arrays(jax_room()),
            "blocked": scene_arrays(jax_room([BLOCK_RING], start=(-8.0, 0.0, 0.0))),
            "extrem": {k: v[:2] for k, v in scene_arrays(ext).items()},
            "normal": scene_arrays(pad_scene_batch(normal, 96, 32)),
            "dlp": scene_arrays(pad_scene_batch(dlp, 512, 128)),
            **jax_bank_scenes()}


def jax_bank_scenes() -> dict:
    """{banks_<level>: scene arrays}: the whole scenes of the committed banks
    (``generate_bank`` at n = 64, keys 0, 1, 2, as tests/test_torch_scenario.py
    saves them in tests/data/torch_jax_banks.npz), padded to 96 slots; the
    fields that file keeps are checked equal to it."""
    from hope_tpu.envs.scenario_gen import generate_bank
    from hope_tpu.train.scene_pool import pad_scene_batch

    banks = os.path.join(os.path.dirname(MPC_NPZ), "torch_jax_banks.npz")
    out = {}
    with np.load(banks) as ref:
        for i, level in enumerate(BANK_LEVELS):
            sc, _ = generate_bank(jax.random.PRNGKey(i), level=level, n=64)
            arrays = scene_arrays(pad_scene_batch(sc, 96, 32))
            for f in ("start", "dest", "edges", "edge_mask", "edge_poly", "n_polys"):
                kept = ref[f"{level}/{f}"]
                np.testing.assert_array_equal(arrays[f][:, :kept.shape[1]] if kept.ndim > 1
                                              else arrays[f], kept, err_msg=f)
            out[f"banks_{level}"] = arrays
    return out


def as_jax_scene(arrays: dict):
    from hope_tpu.envs.scene import Scene

    return Scene(**{f: jnp.asarray(arrays[f]) for f in SCENE_FIELDS})


# ----------------------------------------------------------------- iLQR


def ilqr_case(name: str):
    """(config kwargs, x0 (B, 3), goal, edges (B, E, 4), mask, us_init)."""
    if name == "open":
        return (dict(horizon=30, n_iters=15), np.zeros((1, 3), np.float32),
                np.array([[6.0, 2.0, 0.0]], np.float32), np.zeros((1, 4, 4), np.float32),
                np.zeros((1, 4), bool), np.tile(np.float32([0.0, 1.0]), (1, 30, 1)))
    if name == "wall":
        e = np.array([[[4.0, -1.2, 4.0, 0.3]] + [[0.0] * 4] * 3], np.float32)
        return (dict(horizon=30, n_iters=15), np.zeros((1, 3), np.float32),
                np.array([[8.0, 0.0, 0.0]], np.float32), e,
                np.array([[True, False, False, False]]),
                np.tile(np.float32([0.06, 1.2]), (1, 30, 1)))
    if name == "batched":
        B = 4
        goal = np.stack([np.full(B, 5.0), np.linspace(-1, 1, B), np.zeros(B)], -1)
        return (dict(horizon=20, n_iters=8), np.zeros((B, 3), np.float32),
                goal.astype(np.float32), np.zeros((B, 4, 4), np.float32),
                np.zeros((B, 4), bool), np.tile(np.float32([0.0, 1.0]), (B, 20, 1)))
    rng = np.random.default_rng(6)
    B, E, H = 4, 96, 40
    x0 = np.stack([rng.uniform(-6, -2, B), rng.uniform(-2, 2, B), rng.uniform(-0.5, 0.5, B)], -1)
    goal = np.stack([rng.uniform(2, 6, B), rng.uniform(-1, 1, B), rng.uniform(-0.3, 0.3, B)], -1)
    mid = rng.uniform([-4, -6], [6, 6], (B, E, 2))
    ang = rng.uniform(0, np.pi, (B, E))
    half = rng.uniform(0.3, 1.5, (B, E, 1))
    d = np.stack([np.cos(ang), np.sin(ang)], -1) * half
    edges = np.concatenate([mid - d, mid + d], -1)
    mask = np.arange(E)[None, :] < np.array([16, 40, 64, 96])[:, None]
    # an RS plan's controls, as the MPC runner's warm start gives them: runs
    # of full-lock or straight steering at constant speed
    seg = np.repeat(rng.integers(-1, 2, (B, 5)), H // 5, axis=1) * VCFG.max_steer
    speed = np.repeat(rng.choice([-1.0, 1.0], (B, 5)), H // 5, axis=1) * VCFG.max_speed * 0.8
    us = np.stack([seg, speed], -1)
    return (dict(horizon=H, n_iters=12, dt=DT, **CLI_W), x0.astype(np.float32),
            goal.astype(np.float32), edges.astype(np.float32), mask, us.astype(np.float32))


def jax_ilqr(name: str) -> dict:
    """JAX's solve_batch on the case, and its iterations one at a time: each
    from the iterate before it (us, reg), as ``solve`` with n_iters = 1; the
    pick is read from ``solve`` with each alpha alone (it returns min(c0,
    c_alpha)) and with n_iters = 0 (c0)."""
    from hope_tpu.planning import ilqr

    kw, x0, goal, edges, mask, us0 = ilqr_case(name)
    cfg = ilqr.ILQRConfig(**kw)
    full = ilqr.solve_batch(*(jnp.asarray(a) for a in (x0, goal, edges, mask, us0)), cfg, VCFG)

    def make(n_iters, alphas):
        c = cfg._replace(n_iters=n_iters, alphas=alphas)

        @jax.jit
        def run(us, reg):
            return jax.vmap(lambda a, b, e, m, u, r: ilqr.solve(
                a, b, e, m, u, c._replace(reg_init=r), VCFG))(x0, goal, edges, mask, us, reg)
        return run

    step = make(1, cfg.alphas)
    c0_of = make(0, cfg.alphas)
    single = [make(1, (a,)) for a in cfg.alphas]
    us = jnp.asarray(us0)
    reg = jnp.full(x0.shape[0], cfg.reg_init, jnp.float32)
    rec = {k: [] for k in ("us_before", "reg_before", "c0", "pick", "reg", "cost")}
    for _ in range(cfg.n_iters):
        r = step(us, reg)
        c0 = np.asarray(c0_of(us, reg).cost)
        ck = np.asarray(r.cost)
        cj = np.stack([np.asarray(f(us, reg).cost) for f in single], 1)      # (B, A)
        hit = (cj == ck[:, None]) & (cj < c0[:, None])
        pick = np.where(ck < c0, np.argmax(hit, 1) + 1, 0)
        reg_new = np.where(pick > 0, np.maximum(np.asarray(reg) * np.float32(0.7),
                                                np.float32(1e-6)),
                           np.asarray(reg) * np.float32(4.0)).astype(np.float32)
        for k, v in (("us_before", np.asarray(us)), ("reg_before", np.asarray(reg)),
                     ("c0", c0), ("pick", pick), ("reg", reg_new), ("cost", ck)):
            rec[k].append(v)
        us, reg = r.us, jnp.asarray(reg_new)
    out = {k: np.stack(v) for k, v in rec.items()}
    out.update(xs=np.asarray(full.xs), us=np.asarray(full.us), final_cost=np.asarray(full.cost),
               converged=np.asarray(full.converged))
    return out


# -------------------------------------------------------------- staging


def staging_scenes(scenes: dict, case: str) -> dict:
    """The scene arrays of a STAGING_CASES entry."""
    name, idx = STAGING_CASES[case][:2]
    return {k: v if idx is None else v[idx] for k, v in scenes[name].items()}


def jax_staging(scenes: dict) -> dict:
    """compute_staging on every STAGING_CASES entry, and the valid
    candidates' L on the whole of each bank (64 scenes); waypoint_latch and
    pick_goal of tests/test_mpc.py:128,77."""
    from hope_tpu.agents import HybridState
    from hope_tpu.planning.staging import compute_staging, pick_goal, waypoint_latch

    out = {}
    for case, (_, _, settings, tries) in STAGING_CASES.items():
        st = compute_staging(jax_env(settings), as_jax_scene(staging_scenes(scenes, case)),
                             max_tries=tries)
        for f in st._fields:
            out[f"staging/{case}/{f}"] = np.asarray(getattr(st, f))
    for level in BANK_LEVELS:
        st = compute_staging(jax_env(PROC_ENV), as_jax_scene(scenes[f"banks_{level}"]),
                             max_tries=6)
        out[f"banks/{level}/L"] = np.asarray(st.L)
    env = jax_env(LATCH_ENV)
    sc = as_jax_scene(scenes["room"])
    st = compute_staging(env, sc, max_tries=4)
    pose = jnp.tile(jnp.asarray([[-8.0, 4.0, 2.0]]), (2, 1))
    for off in (0, 4):
        hyb, latched = waypoint_latch(env, st, pose, sc, HybridState.create(2, 64),
                                      jnp.ones(2, bool), env.cfg.step_ratio, offset=off)
        out.update({f"latch/{off}/queue": np.asarray(hyb.queue),
                    f"latch/{off}/length": np.asarray(hyb.length),
                    f"latch/{off}/latched": np.asarray(latched)})
    for f in st._fields:
        out[f"latch_staging/{f}"] = np.asarray(getattr(st, f))
    goal, has = pick_goal(st, jnp.tile(jnp.asarray([[-6.0, 0.0, 0.0]]), (2, 1)), sc.dest)
    out.update({"pick/goal": np.asarray(goal), "pick/has": np.asarray(has)})
    return out


def rs_cut_ties(poses, dest, maxc: float, tries: int, tol: float = 1e-5):
    """(B, S) bool: the RS words from each pose (B, S, 3) to its slot (B, 3)
    tie at the ``tries`` cut, the tries-th and the next shortest within
    ``tol`` m. Which words are swept there is decided by float32 rounding,
    which XLA's fusions change: JAX's jitted compute_staging and its eager
    find_path_batch differ on such a candidate of DLP case 0."""
    import torch

    from hope_tpu_torch.planning import reeds_shepp as rs

    B, S = poses.shape[:2]
    cand = rs.candidates(poses.reshape(B * S, 1, 3),
                         dest[:, None, None, :].expand(B, S, 1, 3).reshape(B * S, 1, 3), maxc)
    L = torch.sort(cand.L.squeeze(1) / maxc, dim=1).values
    return ((L[:, tries] - L[:, tries - 1] <= tol) & torch.isfinite(L[:, tries])).reshape(B, S)


def clearance(env, st, sc, rows, cols) -> np.ndarray:
    """Float64 closest approach (m) of the listed candidates' swept car
    outlines (each completion sampled from its pose, as staging sweeps it) to
    the scene's live edges."""
    from hope_tpu_torch.geometry import box_to_edges, pose_to_box
    from hope_tpu_torch.planning import reeds_shepp as rs

    cfg, maxc = env.cfg, env.cfg.vehicle.max_curvature
    poses, mask, _ = rs.sample_path(st.lengths[rows, cols] * maxc, st.steers[rows, cols],
                                    st.poses[rows, cols], maxc, cfg.rs_max_points,
                                    cfg.rs_step_size)
    car = box_to_edges(pose_to_box(poses, env.corners)).numpy().astype(np.float64)  # (n, N, 4, 4)
    out = []
    for i, r in enumerate(rows):
        a = car[i][mask[i].numpy()].reshape(-1, 1, 4)
        e = sc.edges[r][sc.edge_mask[r]].numpy().astype(np.float64)[None]
        out.append(min(_point_segment(a[..., 0:2], e), _point_segment(a[..., 2:4], e),
                       _point_segment(e[..., 0:2], a), _point_segment(e[..., 2:4], a)))
    return np.asarray(out)


def _point_segment(pts, seg) -> float:
    """Smallest distance of points (..., 2) to segments (..., 4), broadcast."""
    d = seg[..., 2:4] - seg[..., 0:2]
    L2 = np.maximum((d * d).sum(-1), 1e-300)
    t = np.clip(((pts - seg[..., 0:2]) * d).sum(-1) / L2, 0.0, 1.0)
    return float(np.hypot(*np.moveaxis(pts - seg[..., 0:2] - t[..., None] * d, -1, 0)).min())


def check_valid_sets(env, st, sc, ref_L, tries: int):
    """A port StagingSet's valid sets against JAX's L (B, S): equal, but
    where float32 rounding decides, which is where JAX's jitted
    compute_staging and its eager functions disagree with each other too: a
    polar candidate whose RS words tie at the ``tries`` cut
    (``rs_cut_ties``), or a candidate whose swept outline (the port's
    completion) touches a live edge, closest approach under 1e-5 m. L within
    1e-4 m where both are valid. Returns (both valid, validity differs),
    (B, S)."""
    import torch

    from hope_tpu_torch.planning.staging import N_STAGING

    valid, got = np.isfinite(ref_L), torch.isfinite(st.L).numpy()
    differ = valid != got
    if differ.any():
        ties = np.zeros_like(differ)
        ties[:, :N_STAGING] = rs_cut_ties(st.poses[:, :N_STAGING], sc.dest,
                                          env.cfg.vehicle.max_curvature, tries).numpy()
        rows, cols = np.nonzero(differ & ~ties)
        if len(rows):
            assert (clearance(env, st, sc, rows, cols) < 1e-5).all(), list(zip(rows, cols))
    both = valid & got
    np.testing.assert_allclose(st.L.numpy()[both], ref_L[both], rtol=0, atol=1e-4)
    return both, differ


def check_staging(data: dict, case: str) -> None:
    """The port's compute_staging on a STAGING_CASES entry against JAX's:
    valid sets equal but where float32 rounding decides
    (``check_valid_sets``); L and poses within 1e-4 m; completions equal
    (lengths within 1e-4 m, steers)
    but where the port picked another RS word as short as JAX's to float32
    rounding (L within 1e-5 m; the port's segments summing to its L)."""
    from hope_tpu_torch.config import EnvConfig as TEnvConfig, ObsConfig as TObsConfig
    from hope_tpu_torch.envs import ParkingEnv as TParkingEnv, Scene as TScene
    from hope_tpu_torch.planning.staging import compute_staging

    name, idx, settings, tries = STAGING_CASES[case]
    arrays = {f: data[f"scenes/{name}/{f}"] for f in SCENE_FIELDS}
    env = TParkingEnv(TEnvConfig(obs=TObsConfig(use_img=False, use_action_mask=False),
                                 **settings), device="cpu")
    sc = TScene.from_numpy({f: v if idx is None else v[idx] for f, v in arrays.items()}, "cpu")
    st = compute_staging(env, sc, max_tries=tries)
    ref = {f: data[f"staging/{case}/{f}"] for f in ("poses", "L", "lengths", "steers")}
    both, differ = check_valid_sets(env, st, sc, ref["L"], tries)
    np.testing.assert_allclose(st.poses.numpy(), ref["poses"], rtol=0, atol=1e-4)
    same = ((np.abs(st.lengths.numpy() - ref["lengths"]) <= 1e-4).all(-1)
            & (st.steers.numpy() == ref["steers"]).all(-1))
    assert (~same <= both | differ).all()
    other = ~same & both
    L = st.L.numpy()
    np.testing.assert_allclose(L[other], ref["L"][other], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.abs(st.lengths.numpy()[other]).sum(-1), L[other], rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------- runner


def jax_runner(scenes: dict) -> dict:
    from hope_tpu.planning.ilqr import ILQRConfig
    from hope_tpu.planning.mpc import build_mpc_runner
    from hope_tpu.planning.staging import compute_staging

    out = {}
    for case, (sname, settings, ikw, rkw, staged) in RUNNER_CASES.items():
        env = jax_env(settings)
        sc = as_jax_scene(scenes[sname])
        run = build_mpc_runner(env, ILQRConfig(**ikw), **rkw)
        m = run(sc, compute_staging(env, sc, max_tries=6 if sname == "normal" else 4)) \
            if staged else run(sc)
        out.update({f"runner/{case}/{k}": np.asarray(m[k]) for k in RUNNER_KEYS})
    return out


def jax_cli_keys() -> dict:
    """The keys of result_mpc.json (as '/'-joined paths, per_level's level
    names left out) and of record_mpc.npz that the JAX CLI writes in
    --smoke --no-dlp mode."""
    import json

    from hope_tpu.planning.mpc import main

    with tempfile.TemporaryDirectory() as d:
        main(["--smoke", "--no-dlp", "--out", d])
        with open(os.path.join(d, "result_mpc.json")) as f:
            result = json.load(f)
        with np.load(os.path.join(d, "record_mpc.npz")) as f:
            record = sorted(f.files)
    return {"cli/result_keys": np.asarray(sorted(json_paths(result))),
            "cli/record_keys": np.asarray(record)}


def json_paths(d, prefix=""):
    """'/'-joined key paths of a JSON dict; the per-level entries under one
    name ('<level>')."""
    out = set()
    for k, v in d.items():
        k = "<level>" if prefix.endswith("per_level/") else k
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= json_paths(v, prefix + k + "/")
    return out


def export(path: str = MPC_NPZ) -> str:
    scenes = jax_scenes()
    data = {f"scenes/{n}/{f}": v for n, d in scenes.items() for f, v in d.items()}
    for name in ILQR_CASES:
        data.update({f"ilqr/{name}/{k}": v for k, v in jax_ilqr(name).items()})
    data.update(jax_staging(scenes))
    data.update(jax_runner(scenes))
    data.update(jax_cli_keys())
    np.savez_compressed(path, **data)
    return path


def load() -> dict:
    with np.load(MPC_NPZ) as f:
        return {k: f[k] for k in f.files}


def scenes_of(data: dict, name: str) -> dict:
    return {f: data[f"scenes/{name}/{f}"] for f in SCENE_FIELDS}


if __name__ == "__main__":
    if "--export" not in sys.argv:
        sys.exit("usage: python -m tests.mpc_cases --export")
    print(export())
