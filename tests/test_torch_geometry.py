"""Port parity, small modules: config, geometry, dynamics, lidar, rewards
(hope_tpu_torch vs hope_tpu on the same numpy inputs, on the CPU).

Tolerances: both sides compute in float32, but XLA's and torch's float32
sin/cos/atan2/arccos differ in the last place, and sums run in different
orders; so values derived from angles are held to atol 1e-5 (about 100 ulps
at the scene's 10 m scale), the rest exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hope_tpu.config as jcfg
import hope_tpu_torch.config as tcfg
from hope_tpu import geometry as jg
from hope_tpu.dynamics import VehicleState as JVS
from hope_tpu.dynamics import substep_trajectory as jtraj
from hope_tpu.envs import rewards as jrew
from hope_tpu.envs.lidar import beam_angles as jbeams
from hope_tpu.envs.lidar import lidar_observation as jlidar
from hope_tpu.envs.lidar import vehicle_boundary as jhull
from hope_tpu_torch import geometry as tg
from hope_tpu_torch.dynamics import VehicleState as TVS
from hope_tpu_torch.dynamics import substep_trajectory as ttraj
from hope_tpu_torch.envs import rewards as trew
from hope_tpu_torch.envs.lidar import beam_angles, lidar_observation, vehicle_boundary

from .torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
T = torch.as_tensor
J = jnp.asarray


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------- config

@pytest.mark.parametrize("name", [
    "VehicleConfig", "LidarConfig", "ActionMaskConfig", "ObsConfig", "RewardConfig",
    "EnvConfig", "ScenarioConfig", "AttentionConfig", "NetConfig", "SACConfig", "PPOConfig"])
def test_config_defaults_identical(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_config_derived_identical():
    for level in ("Normal", "Complex", "Extrem"):
        assert (dataclasses.asdict(tcfg.ScenarioConfig.for_level(level))
                == dataclasses.asdict(jcfg.ScenarioConfig.for_level(level)))
    assert (dataclasses.asdict(tcfg.actor_net_config())
            == dataclasses.asdict(jcfg.actor_net_config()))
    v = tcfg.VehicleConfig()
    np.testing.assert_array_equal(v.box_corners(), jcfg.VehicleConfig().box_corners())
    assert v.max_curvature == jcfg.VehicleConfig().max_curvature


# -------------------------------------------------------------------- geometry

@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


def test_transforms(rng):
    pose = rng.normal(size=(7, 3)).astype(np.float32) * 5
    corners = jcfg.VehicleConfig().box_corners().astype(np.float32)
    close(tg.pose_to_box(T(pose), T(corners)), jg.pose_to_box(J(pose), J(corners)))
    box = rng.normal(size=(7, 4, 2)).astype(np.float32)
    np.testing.assert_array_equal(tg.box_to_edges(T(box)), jg.box_to_edges(J(box)))
    close(tg.polygon_area(T(box)), jg.polygon_area(J(box)))
    edges = rng.normal(size=(7, 20, 4)).astype(np.float32) * 8
    close(tg.edges_to_ego(T(edges), T(pose)),
          jax.vmap(jg.edges_to_ego)(J(edges), J(pose)), atol=1e-4)


def test_segments(rng):
    e1 = rng.normal(size=(30, 4)).astype(np.float32) * 3
    e2 = rng.normal(size=(40, 4)).astype(np.float32) * 3
    e2[:5] = 0.0                                   # padded, degenerate edges
    want = np.asarray(jg.segments_intersect(J(e1), J(e2)))
    np.testing.assert_array_equal(tg.segments_intersect(T(e1), T(e2)), want)
    assert want.any() and not want[:, :5].any()
    pts_t = tg.segment_intersection_points(T(e1), T(e2)).numpy()
    pts_j = np.asarray(jg.segment_intersection_points(J(e1), J(e2)))
    np.testing.assert_array_equal(np.isinf(pts_t), np.isinf(pts_j))
    fin = np.isfinite(pts_j)
    close(pts_t[fin], pts_j[fin])
    ang = np.array(jbeams(jcfg.LidarConfig()))
    close(tg.ray_hits(T(ang), T(e2), 10.0), jg.ray_hits(J(ang), J(e2), 10.0))


def test_convex_clip_area(rng):
    corners = jcfg.VehicleConfig().box_corners().astype(np.float32)
    base = rng.normal(size=(64, 3)).astype(np.float32) * [1.0, 1.0, 0.5]
    other = base + rng.normal(size=(64, 3)).astype(np.float32) * [3.0, 1.5, 0.3]
    a = np.array(jg.pose_to_box(J(base), J(corners)))
    b = np.array(jg.pose_to_box(J(other), J(corners)))
    want = np.asarray(jax.vmap(jg.convex_clip_area)(J(a), J(b)))
    close(tg.convex_clip_area(T(a), T(b)), want, atol=1e-4)   # areas up to ~11 m^2
    assert (want > 0).mean() > 0.3 and (want == 0).any()
    close(tg.convex_clip_area(T(a), T(a)), tg.polygon_area(T(a)), atol=1e-4)


# -------------------------------------------------------------------- dynamics

def test_substep_trajectory(rng):
    vcfg = jcfg.VehicleConfig()
    pose = rng.normal(size=(16, 3)).astype(np.float32) * 4
    action = rng.uniform(-1.2, 1.2, (16, 2)).astype(np.float32) * [0.8, 3.0]
    action[0] = [0.0, 2.0]                        # straight: the tiny-angle branch
    want = jax.vmap(lambda p, a: jtraj(JVS.from_pose(p), a, vcfg))(J(pose), J(action))
    got = ttraj(TVS.from_pose(T(pose)), T(action), tcfg.VehicleConfig())
    for f in ("x", "y", "heading", "speed", "steer"):
        close(getattr(got, f), getattr(want, f))


# ------------------------------------------------------------- lidar / rewards

def test_lidar_observation(rng):
    lcfg, vcfg = jcfg.LidarConfig(), jcfg.VehicleConfig()
    close(vehicle_boundary(tcfg.LidarConfig(), tcfg.VehicleConfig()), jhull(lcfg, vcfg))
    np.testing.assert_array_equal(beam_angles(tcfg.LidarConfig()), jbeams(lcfg))
    pose = rng.normal(size=(5, 3)).astype(np.float32)
    edges = rng.normal(size=(5, 48, 4)).astype(np.float32) * 6
    mask = rng.random((5, 48)) > 0.2
    ang, hull = jbeams(lcfg), jhull(lcfg, vcfg)
    want = jax.vmap(lambda p, e, m: jlidar(p, e, m, ang, hull, lcfg))(J(pose), J(edges), J(mask))
    got = lidar_observation(T(pose), T(edges), T(mask), T(np.array(ang)),
                            T(np.array(hull)), tcfg.LidarConfig())
    close(got, want, atol=2e-5)                  # distances up to 10 m


@pytest.mark.parametrize("w_rs_dist", [0.0, 1.0])
def test_reward_terms_and_shaping(rng, w_rs_dist):
    env_j = jcfg.EnvConfig(reward=jcfg.RewardConfig(w_rs_dist=w_rs_dist))
    env_t = tcfg.EnvConfig(reward=tcfg.RewardConfig(w_rs_dist=w_rs_dist))
    B = 12
    corners = jcfg.VehicleConfig().box_corners().astype(np.float32)
    dest = rng.normal(size=(B, 3)).astype(np.float32) * 3
    start = dest + rng.normal(size=(B, 3)).astype(np.float32) * 8
    prev = dest + rng.normal(size=(B, 3)).astype(np.float32) * 2
    cur = prev + rng.normal(size=(B, 3)).astype(np.float32) * 0.3
    t = rng.integers(1, 200, B).astype(np.float32)
    accum = rng.uniform(0, 0.3, B).astype(np.float32)
    vbox = np.array(jg.pose_to_box(J(cur), J(corners)))
    dbox = np.array(jg.pose_to_box(J(dest), J(corners)))
    want, wacc = jax.vmap(lambda *a: jrew.step_reward_terms(*a, env_j))(
        J(prev), J(cur), J(t), J(vbox), J(dest), J(start), J(dbox), J(accum))
    got, gacc = trew.step_reward_terms(T(prev), T(cur), T(t), T(vbox), T(dest), T(start),
                                       T(dbox), T(accum), env_t)
    close(got, want)
    close(gacc, wacc)
    status = np.arange(B, dtype=np.int32) % 5
    close(trew.shaped_reward(got, T(status), env_t),
          jax.vmap(lambda x, s: jrew.shaped_reward(x, s, env_j))(want, J(status)))


def test_env_raster_edge_budget_matches_jax():
    """ObsConfig(raster_edge_budget=96): the JAX env renders from the
    polygons its prefilter keeps, the port's env from all edges through
    ops.raster_bev (which culls per edge, exactly, and reads the budget for
    nothing); their reset images on the committed procedural scenes are
    equal, as tests/test_raster.py's test_env_raster_edge_budget_identical_obs
    holds budget 96 to budget 0."""
    from hope_tpu.envs import ParkingEnv as JEnv
    from hope_tpu.envs.scene import Scene as JScene
    from hope_tpu.train.scene_pool import pad_scene_batch as jpad
    from hope_tpu_torch.envs import ParkingEnv, Scene

    from .test_torch_ops import SCENE_FIELDS, SCENES_NPZ

    with np.load(SCENES_NPZ) as f:
        sc = {k: f[k] for k in SCENE_FIELDS}
    js = jpad(JScene(**{k: J(v[:4]) for k, v in sc.items()}), 96, 32)
    ts = Scene.from_numpy({k: np.asarray(getattr(js, k)) for k in sc}, "cpu")
    jenv = JEnv(jcfg.EnvConfig(obs=jcfg.ObsConfig(raster_edge_budget=96, mask_backend="xla"),
                               max_edges=96, max_obstacles=32))
    want = np.asarray(jax.jit(jenv.batch_reset)(js)[1]["img"])
    tenv = ParkingEnv(tcfg.EnvConfig(obs=tcfg.ObsConfig(raster_edge_budget=96),
                                     max_edges=96, max_obstacles=32), device="cpu")
    np.testing.assert_array_equal(tenv.batch_reset(ts)[1]["img"].numpy(), want)


# ------------------------------------------------------- box collision, SH clip

def test_boxes_collide_matches_jax(rng):
    """Batched boxes against padded obstacle edges, exactly as JAX (the same
    divided segment test), and JAX's probes: a box wholly inside an obstacle
    ring without a crossing is no collision, a crossing edge is one, a
    masked-out edge is none."""
    corners = jcfg.VehicleConfig().box_corners().astype(np.float32)
    poses = (rng.normal(size=(32, 3)) * [4.0, 4.0, 1.0]).astype(np.float32)
    box_edges = np.asarray(jg.box_to_edges(jg.pose_to_box(J(poses), J(corners))))
    obst = (rng.normal(size=(32, 24, 4)) * 5).astype(np.float32)
    mask = rng.uniform(size=(32, 24)) < 0.7
    want = np.asarray(jax.vmap(jg.boxes_collide)(J(box_edges), J(obst), J(mask)))
    np.testing.assert_array_equal(tg.boxes_collide(T(box_edges), T(obst), T(mask)).numpy(), want)
    assert want.any() and not want.all()
    box = tg.box_to_edges(tg.pose_to_box(torch.zeros(3), T(corners)))
    giant = torch.tensor([[-50.0, -50, 50, -50], [50, -50, 50, 50], [50, 50, -50, 50],
                          [-50, 50, -50, -50]])
    crossing = torch.tensor([[0.0, -10.0, 0.0, 10.0]])
    assert not bool(tg.boxes_collide(box, giant))
    assert bool(tg.boxes_collide(box, crossing))
    assert not bool(tg.boxes_collide(box, crossing, torch.tensor([False])))


def test_convex_clip_area_sh_matches_jax(rng):
    """The Sutherland–Hodgman area of 200 random convex quad pairs, batched,
    against JAX's per pair (1e-6: the same float32 arithmetic, the final
    shoelace sum in another order), and against the port's Green's-theorem
    area as the JAX tests hold the two forms (rtol 1e-4, atol 1e-5); the
    probes: identical boxes give the box area, disjoint ones 0, containment
    the smaller area."""
    from hope_tpu.geometry.clip import convex_clip_area_sh as jsh

    from . import oracle

    a = np.stack([oracle.random_convex_quad(rng) for _ in range(200)]).astype(np.float32)
    b = np.stack([oracle.random_convex_quad(rng) for _ in range(200)]).astype(np.float32)
    got = tg.convex_clip_area_sh(T(a), T(b)).numpy()
    want = np.asarray(jax.vmap(jsh)(J(a), J(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, tg.convex_clip_area(T(a), T(b)).numpy(), rtol=1e-4, atol=1e-5)
    assert (want > 0).mean() > 0.3 and (want == 0).any()
    sq = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    assert float(tg.convex_clip_area_sh(sq, sq)) == pytest.approx(1.0, rel=1e-6)
    assert float(tg.convex_clip_area_sh(sq, sq + 100.0)) == 0.0
    small = sq * 0.5 + 0.25
    assert float(tg.convex_clip_area_sh(sq, small)) == pytest.approx(0.25, rel=1e-6)
    assert float(tg.convex_clip_area_sh(small, sq)) == pytest.approx(0.25, rel=1e-6)

