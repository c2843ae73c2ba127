"""The port's three kernel modules (hope_tpu_torch/ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions to the Pallas kernels. The CUDA kernels
themselves are held to the plain versions on the card, by
tests/test_torch_card.py and chip_smoke.py.

The procedural scenes are the JAX package's ``generate_bank`` output, saved
once to ``tests/data/torch_procedural_scenes.npz`` (compiling the generator
costs ~50 s on the CPU) by:

    JAX_PLATFORMS=cpu python -m tests.test_torch_ops --export
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.config import ActionMaskConfig, EnvConfig, LidarConfig, ObsConfig, VehicleConfig
from hope_tpu.envs import build_table as jbuild_table
from hope_tpu.envs import get_steps as jget_steps
from hope_tpu.envs.action_mask import step_lengths as jstep_lengths
from hope_tpu.envs.scene import Scene as JScene
from hope_tpu.geometry import pose_to_box as jpose_to_box
from hope_tpu.ops import mask_step_lengths as jmask_step_lengths
from hope_tpu.ops import raster_bev as jrb
from hope_tpu.ops.sweep_collide import swept_collide as jswept_collide
from hope_tpu_torch.envs.action_mask import ActionMaskTable, build_table, get_steps, step_lengths
from hope_tpu_torch.geometry import pose_to_box
from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

from .torch_raster_cases import adversarial_edges

OBS = ObsConfig()
VCFG = VehicleConfig()
CX_OFF = (VCFG.front_hang + VCFG.wheel_base - VCFG.rear_hang) / 2.0
T = torch.as_tensor
SCENES_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_procedural_scenes.npz")
SCENE_FIELDS = ("edges", "edge_mask", "edge_poly", "n_polys", "start", "dest", "dest_box",
                "bounds", "level", "case_id")


def export_scenes(path: str = SCENES_NPZ):
    """Save 6 Complex and 4 Normal ``generate_bank`` scenes (numpy)."""
    from hope_tpu.envs.scenario_gen import generate_bank

    parts = [generate_bank(jax.random.PRNGKey(0), level="Complex", n=6)[0],
             generate_bank(jax.random.PRNGKey(2), level="Normal", n=4)[0]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{f: np.concatenate([np.asarray(getattr(s, f)) for s in parts])
                      for f in SCENE_FIELDS})
    return path


def load_scenes():
    """The saved procedural scenes as a JAX Scene."""
    with np.load(SCENES_NPZ) as f:
        return JScene(**{k: jnp.asarray(f[k]) for k in SCENE_FIELDS})


@pytest.fixture(scope="module")
def jtable():
    return jbuild_table()


# ------------------------------------------------------------ mask_step_lengths

def test_build_table_matches_jax(jtable):
    """dist_star: segment intersection distances, then a circular upsample;
    hull_base: rays cast from the beam angles. Tolerance rtol 1e-6 (about
    8 float32 ulps): XLA's and torch's float32 sin/cos differ in the last
    place for some beam angles (hull_base differs by 1 ulp on 5 of 120
    beams); dist_star agrees bit for bit here."""
    t = build_table(device="cpu")
    np.testing.assert_allclose(t.dist_star.numpy(), np.asarray(jtable.dist_star),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.hull_base.numpy(), np.asarray(jtable.hull_base),
                               rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t.actions_norm.numpy(), np.asarray(jtable.actions_norm))


def test_mask_step_lengths_plain_matches_pallas(jtable):
    """Exact: compares and a min over the same float32 upsample arithmetic;
    the mask post-processing (edge penalty, erosion, scaling) too."""
    rng = np.random.default_rng(0)
    cfg, lcfg = ActionMaskConfig(), LidarConfig()
    B = 9  # not a multiple of either side's env block
    raw = rng.uniform(0, 12, (B, lcfg.n_beams)).astype(np.float32)
    ext = jnp.clip(jnp.asarray(raw), 0.0, lcfg.max_range) + jtable.hull_base
    want = jmask_step_lengths(ext, jtable.dist_star, cfg.n_iter, cfg.upsample,
                              interpret=True)
    got = mask_steps.mask_step_lengths(T(np.array(ext)), T(np.array(jtable.dist_star)),
                                       cfg.n_iter, cfg.upsample)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.float32 and got.shape == (B, cfg.n_actions)
    assert got.min() < cfg.n_iter and got.max() == cfg.n_iter   # both branches taken

    # the per-env JAX path (step_lengths, then postprocess) from raw lidar,
    # with the JAX table's arrays so both start from the same bits
    table = ActionMaskTable(*(T(np.array(a)) for a in jtable))
    jsteps = jax.vmap(lambda l: jstep_lengths(l, jtable, cfg, lcfg))(jnp.asarray(raw))
    np.testing.assert_array_equal(step_lengths(T(raw), table, cfg, lcfg).numpy(),
                                  np.asarray(jsteps))
    jmask = jax.vmap(lambda l: jget_steps(l, jtable, cfg, lcfg))(jnp.asarray(raw))
    np.testing.assert_array_equal(get_steps(T(raw), table, cfg, lcfg).numpy(),
                                  np.asarray(jmask))


# ---------------------------------------------------------------- swept_collide

def _sweep_both(car, live, scene, mask):
    want = np.asarray(jswept_collide(jnp.asarray(car), jnp.asarray(live), jnp.asarray(scene),
                                     jnp.asarray(mask), interpret=True))
    got = sweep_collide.swept_collide(T(car), T(live), T(scene), T(mask)).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_swept_collide_plain_matches_pallas_random(seed):
    """Exact: the same divide-free products and compares in float32."""
    rng = np.random.default_rng(seed)
    B, K, S, E = 4, 3, 40, 24
    car = rng.normal(size=(B, K, S, 4)).astype(np.float32) * 4
    live = rng.random((B, K, S)) > 0.3
    scene = rng.normal(size=(B, E, 4)).astype(np.float32) * 4
    mask = rng.random((B, E)) > 0.3
    got, want = _sweep_both(car, live, scene, mask)
    np.testing.assert_array_equal(got, want)
    assert want.any()
    # per-segment hits (chunks of 16 straddle S = 40): each segment alone is a
    # one-segment word, and their any is the word's result
    seg = sweep_collide.swept_collide_plain(T(car), T(live), T(scene), T(mask), chunk=16,
                                            per_segment=True)
    alone = sweep_collide.swept_collide_plain(T(car).reshape(B, K * S, 1, 4),
                                              T(live).reshape(B, K * S, 1), T(scene), T(mask))
    np.testing.assert_array_equal(seg.reshape(B, K * S).numpy(), alone.numpy())
    np.testing.assert_array_equal(seg.any(-1).numpy(), want)


def test_swept_collide_masked_and_parallel():
    car = np.zeros((1, 3, 1, 4), np.float32)
    car[0, 0, 0] = [-1, 0, 1, 0]          # crosses the edge
    car[0, 1, 0] = [-1, 0, 1, 0]          # crosses it, but dead
    car[0, 2, 0] = [-1, 2, 1, 2]          # collinear with an overlapping edge
    scene = np.asarray([[[0, -1, 0, 1], [-0.5, 2, 0.5, 2]]], np.float32)
    live = np.asarray([[[True], [False], [True]]])
    mask = np.ones((1, 2), bool)
    got, want = _sweep_both(car, live, scene, mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[True, False, False]])
    got, want = _sweep_both(car, live, scene, ~mask)
    np.testing.assert_array_equal(got, want)
    assert not got.any()


# ------------------------------- properties the redesigned CUDA kernels lean on

def test_mask_sign_form_equals_compare():
    """csrc/mask_steps.cu keeps `table > lidar` as the sign bit of
    `lidar - table`, OR-ed over the rays, and applies k once at the end. Both
    steps are exact: in IEEE float32 without flush-to-zero a non-zero
    difference never rounds to zero and x - x is +0 (the kernel adds 0.0 to
    the lidar first, so that -0 - +0 = -0 can not occur), and for one column
    the select yields only k or n_iter."""
    rng = np.random.default_rng(3)
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 1.17549435e-38, 3.0, 3.0000002,
                        np.inf, 1e38, 10.0], np.float32)
    t = np.concatenate([rng.choice(special, 4000), rng.uniform(0, 12, 4000).astype(np.float32)])
    # (inf - inf is a NaN whose sign differs between processors; the card test
    # tests/test_torch_card.py holds the kernel itself to the compare there)
    u = np.concatenate([rng.choice(special[np.isfinite(special)], 4000),
                        rng.uniform(0, 12, 4000).astype(np.float32)])
    u[-1000:] = t[-1000:]                                     # equal pairs
    u[-2000:-1000] = np.nextafter(t[-2000:-1000], np.float32(np.inf))   # one ulp apart
    tt, uu = T(t)[:, None], T(u)[None, :]
    assert not torch.equal(torch.signbit(uu - tt), tt > uu)           # -0 - +0
    assert torch.equal(torch.signbit((uu + 0.0) - tt), tt > uu)

    # the whole reduction in predicate form against the plain version
    R, U, A, I = 7, 3, 6, 5
    tab = T(rng.uniform(0, 10, (R * U, A, I)).astype(np.float32))
    tab = torch.where(T(rng.random((R * U, A, I)) < 0.05), tab, 0.0)
    ext = T(rng.uniform(0, 10, (11, R)).astype(np.float32))
    up = mask_steps.upsample_circular(ext, U, dim=1)                       # (B, RU)
    neg = torch.signbit((up + 0.0)[:, :, None, None] - tab[None]).any(dim=1)   # (B, A, I)
    first = torch.where(neg.any(-1), neg.to(torch.uint8).argmax(-1), I).to(torch.float32)
    want = mask_steps.mask_step_lengths_plain(ext, tab, I, U)
    assert torch.equal(first, want)
    assert want.min() < I and want.max() == I


def test_mask_table_and_lidar_are_non_negative():
    """The battery's inputs to the mask kernel: clearances and hull-extended
    lidar are non-negative and finite, so no NaN reaches the sign form."""
    t = build_table(device="cpu")
    assert torch.isfinite(t.dist_star).all() and (t.dist_star >= 0).all()
    assert (t.hull_base > 0).all()


def _pair_hits(car, scene):
    """(S, 4) x (E, 4) -> (S, E) bool: the exact test of swept_collide_plain,
    per pair, without the masks."""
    px, py = car[:, None, 0], car[:, None, 1]
    rx, ry = car[:, None, 2] - px, car[:, None, 3] - py
    qx, qy = scene[None, :, 0], scene[None, :, 1]
    sx, sy = scene[None, :, 2] - qx, scene[None, :, 3] - qy
    rxs = rx * sy - ry * sx
    qpx, qpy = qx - px, qy - py
    qpxr = qpx * ry - qpy * rx
    qpxs = qpx * sy - qpy * sx
    arxs = torch.abs(rxs)
    return ((qpxs * rxs >= 0.0) & (torch.abs(qpxs) <= arxs) & (qpxr * rxs >= 0.0)
            & (torch.abs(qpxr) <= arxs) & (rxs != 0.0))


def _broad_phase_keep(car, live, scene, group: int = 32):
    """The broad phase of csrc/sweep_collide.cu in plain PyTorch: for each
    group of ``group`` consecutive car segments and each edge, False where
    the kernel drops the edge for the whole group. Same float32 operations,
    in the kernel's order."""
    S = car.shape[0]
    pad = (-S) % group
    car = torch.cat([car, car.new_zeros((pad, 4))]).reshape(-1, group, 4)
    live = torch.cat([live, live.new_zeros(pad)]).reshape(-1, group)
    inf = torch.tensor(float("inf"))
    px, py = car[..., 0], car[..., 1]
    rx, ry = car[..., 2] - px, car[..., 3] - py
    lo = lambda v: torch.where(live, v, inf).amin(1)[:, None]      # noqa: E731
    hi = lambda v: torch.where(live, v, -inf).amax(1)[:, None]     # noqa: E731
    px_lo, px_hi, py_lo, py_hi = lo(px), hi(px), lo(py), hi(py)
    rx_max = torch.where(live, rx.abs(), 0.0).amax(1)[:, None]
    ry_max = torch.where(live, ry.abs(), 0.0).amax(1)[:, None]
    qx, qy = scene[None, :, 0], scene[None, :, 1]
    sx, sy = scene[None, :, 2] - qx, scene[None, :, 3] - qy
    bound = rx_max * sy.abs() + ry_max * sx.abs()
    ax, bx = (qx - px_hi) * sy, (qx - px_lo) * sy
    ay, by = (qy - py_hi) * sx, (qy - py_lo) * sx
    a_lo, a_hi = torch.where(sy >= 0, ax, bx), torch.where(sy >= 0, bx, ax)
    b_lo, b_hi = torch.where(sx >= 0, ay, by), torch.where(sx >= 0, by, ay)
    d_lo, d_hi = a_lo - b_hi, a_hi - b_lo
    return ~(d_lo > bound) & ~(d_hi < -bound) & live.any(1)[:, None]   # (G, E)


def _assert_never_drops(car, live, scene, group: int = 32):
    keep = _broad_phase_keep(car, live, scene, group)
    hits = _pair_hits(car, scene) & live[:, None]
    pad = (-hits.shape[0]) % group
    hits = torch.cat([hits, hits.new_zeros((pad, hits.shape[1]))])
    hit_in_group = hits.reshape(-1, group, hits.shape[1]).any(1)            # (G, E)
    assert not (hit_in_group & ~keep).any()
    return keep, hit_in_group


def test_sweep_broad_phase_never_drops_a_hit_dlp():
    """RS sweeps through real DLP scenes: every pair the exact test accepts
    lies in a (group, edge) the broad phase keeps, and the broad phase does
    drop most of the rest."""
    from hope_tpu_torch.config import EnvConfig as TEnvConfig
    from hope_tpu_torch.envs.dlp import DLPDataset as TDLPDataset
    from hope_tpu_torch.geometry import box_to_edges, pose_to_box
    from hope_tpu_torch.planning import reeds_shepp as rs

    cfg = TEnvConfig(max_edges=512, max_obstacles=128)
    ds = TDLPDataset(env_cfg=cfg, device="cpu")
    gen = torch.Generator().manual_seed(4)
    B = 4
    sc = ds.batch_reset(torch.arange(B) * 53, gen)
    a = T(np.random.default_rng(4).uniform(0.0, 0.8, (B, 1)).astype(np.float32))
    pose = sc.start * (1 - a) + sc.dest * a
    maxc = cfg.vehicle.max_curvature
    cand = rs.candidates(pose[:, None], sc.dest[:, None], maxc)
    cand = rs.RSCandidates(*(t.squeeze(1) for t in cand))
    idx = torch.sort(cand.L, dim=1, stable=True).indices[:, :3]
    gi = idx[..., None].expand(-1, -1, rs.N_SEG)
    poses, live, _ = rs.sample_path(torch.gather(cand.lengths, 1, gi),
                                    torch.gather(cand.steers, 1, gi), pose[:, None],
                                    maxc, cfg.rs_max_points, cfg.rs_step_size)
    corners = T(np.asarray(VCFG.box_corners(), np.float32))
    car = box_to_edges(pose_to_box(poses, corners)).reshape(B, 3, -1, 4)
    live4 = torch.repeat_interleave(live, 4, dim=-1)
    kept = total = hits = 0
    for b in range(B):
        scene = sc.edges[b][sc.edge_mask[b]]
        for k in range(3):
            keep, hit = _assert_never_drops(car[b, k], live4[b, k], scene)
            groups = live4[b, k].reshape(-1, 32).any(1)
            kept += int(keep[groups].sum())
            total += int(groups.sum()) * scene.shape[0]
            hits += int(hit.sum())
    assert hits > 0                       # some sweeps do collide
    assert kept < 0.5 * total             # and the broad phase is worth having


@pytest.mark.parametrize("scale", [1.0, 1e3, 1e6])
def test_sweep_broad_phase_never_drops_a_hit_adversarial(scale):
    """Segments that touch, nearly touch, overlap on one line or lie one ulp
    apart, at small and large coordinates, and random clutter: the broad
    phase evaluates the exact test's own float32 operations at the ends of a
    group's ranges, so rounding can not make it drop an accepted pair."""
    rng = np.random.default_rng(int(scale) % 97)
    f = np.float32
    E = 96
    scene = (rng.normal(size=(E, 4)) * 4).astype(f)
    scene[: E // 3, 2:] = scene[: E // 3, :2] + (rng.normal(size=(E // 3, 2)) * 0.5).astype(f)
    scene[E // 3: E // 2, 3] = scene[E // 3: E // 2, 1]          # axis-aligned edges
    car = []
    for q in scene:                        # built to touch or nearly touch edge q
        q0, q1 = q[:2], q[2:]
        mid = (q0 + q1) / f(2)
        d = (rng.normal(size=2) * 2).astype(f)
        car += [np.r_[q0, q0 + d],                                   # starts on an end point
                np.r_[mid - d, mid],                                 # ends on the edge
                np.r_[np.nextafter(mid, f(np.inf)), mid + d],        # one ulp off the edge
                np.r_[q0 + (q1 - q0) * f(0.25), q0 + (q1 - q0) * f(1.5)],   # same line, overlaps
                np.r_[q1 + (q1 - q0) * f(1e-7), q1 + (q1 - q0)],     # same line, a hair apart
                np.r_[mid - d, mid + d]]                             # crosses
    car = np.asarray(car, f)
    car = np.concatenate([car, (rng.normal(size=(200, 4)) * 4).astype(f)])
    rng.shuffle(car)
    shift = (rng.normal(size=2) * scale).astype(f)
    car = T((car * f(scale if scale < 1e6 else 1.0) + np.r_[shift, shift]).astype(f))
    scene = T((scene * f(scale if scale < 1e6 else 1.0) + np.r_[shift, shift]).astype(f))
    live = T(rng.random(car.shape[0]) > 0.2)
    for group in (32, 4):
        keep, hit = _assert_never_drops(car, live, scene, group)
        assert hit.any()


# ------------------------------------------------------------------- raster_bev

@pytest.fixture(scope="module")
def procedural():
    scenes = load_scenes()
    a = jax.random.uniform(jax.random.PRNGKey(3), (scenes.start.shape[0], 1),
                           minval=0.3, maxval=0.8)
    poses = {"start": scenes.start, "dest": scenes.dest,
             "mid": scenes.start * (1 - a) + scenes.dest * a}
    return scenes, poses


@pytest.fixture(scope="module")
def dlp_scenes():
    from hope_tpu.envs.dlp import DLPDataset

    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    ds = DLPDataset(env_cfg=cfg)
    return ds.batch_reset(jax.random.split(jax.random.PRNGKey(1), 2), jnp.asarray([0, 57]))


def _render_both(poses, dest_box, edges, mask, poly, exact):
    vbox = jpose_to_box(poses, jnp.asarray(VCFG.box_corners(), jnp.float32))
    want = np.asarray(jrb.render_bev_batch(poses, vbox, dest_box, edges, mask, poly, OBS,
                                           VCFG, exact=exact, interpret=True))
    n = lambda x: T(np.array(x))  # noqa: E731
    got = raster_bev.render_bev_batch(n(poses), n(vbox), n(dest_box), n(edges), n(mask),
                                      n(poly), OBS, VCFG, exact=exact).numpy()
    return got, want


@pytest.mark.parametrize("exact", [True, False])
def test_raster_plain_matches_pallas_same_params(procedural, exact):
    """The kernel's arithmetic alone, fed the JAX edge preparation: exact."""
    scenes, poses = procedural
    p = poses["mid"]
    params, cnt = jrb._ego_edge_params(p, scenes.edges, scenes.edge_mask, scenes.edge_poly,
                                       CX_OFF, OBS.img_size, OBS.img_res, exact)
    vbox = jpose_to_box(p, jnp.asarray(VCFG.box_corners(), jnp.float32))
    quads = jnp.concatenate([jrb._quad_coeffs(p, scenes.dest_box, CX_OFF),
                             jrb._quad_coeffs(p, vbox, CX_OFF)], axis=1)
    cls = jrb._raster_classes(params, cnt, quads, OBS.img_size, OBS.img_res, exact,
                              interpret=True)
    want = jrb._PALETTE[np.asarray(cls).astype(int)]
    got = raster_bev.raster_bev_plain(T(np.array(params)), T(np.array(cnt)),
                                      T(np.array(quads)), OBS.img_size, OBS.img_res)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("where", ["start", "mid", "dest"])
def test_render_bev_batch_matches_pallas_procedural(procedural, exact, where):
    """End to end with each side's own edge preparation (sin/cos of the pose,
    the ego transform, the sort). Exact: XLA and torch agree on these float32
    results here, so every pixel matches."""
    scenes, poses = procedural
    got, want = _render_both(poses[where], scenes.dest_box, scenes.edges, scenes.edge_mask,
                             scenes.edge_poly, exact)
    np.testing.assert_array_equal(got, want)


def test_render_bev_batch_matches_pallas_dlp(dlp_scenes):
    """512-edge DLP scenes, both parity modes, exact."""
    sc = dlp_scenes
    for poses in (sc.start, sc.dest):
        for exact in (True, False):
            got, want = _render_both(poses, sc.dest_box, sc.edges, sc.edge_mask,
                                     sc.edge_poly, exact)
            np.testing.assert_array_equal(got, want)


def test_render_bev_overlapping_squares():
    """Two overlapping obstacle squares: exact mode keeps the overlap filled,
    global even-odd clears it; both match the Pallas kernel."""
    def square(cx, cy, r):
        return [[cx - r, cy - r, cx + r, cy - r], [cx + r, cy - r, cx + r, cy + r],
                [cx + r, cy + r, cx - r, cy + r], [cx - r, cy + r, cx - r, cy - r]]

    edges = jnp.asarray([square(3.0, 0.0, 2.0) + square(4.5, 0.5, 2.0)], jnp.float32)
    mask = jnp.ones((1, 8), bool)
    poly = jnp.asarray([[0] * 4 + [1] * 4], jnp.int32)
    pose = jnp.asarray([[-3.0, 0.0, 0.0]], jnp.float32)
    dest_box = jpose_to_box(jnp.asarray([[-6.0, 4.0, 0.0]], jnp.float32),
                            jnp.asarray(VCFG.box_corners(), jnp.float32))
    out = {}
    for exact in (True, False):
        out[exact], want = _render_both(pose, dest_box, edges, mask, poly, exact)
        np.testing.assert_array_equal(out[exact], want)
    assert np.any(out[True] != out[False])


# ------------------------------- the formulation of the redesigned raster kernel

def _raster_rows(poses, vbox, dbox, edges, mask, poly, obs, exact):
    """csrc/raster_bev.cu's formulation in plain PyTorch and Python integers:
    per-slot preparation and culling with the kernel's compares (conjunctions
    in place of min / max), kept edges in storage order or, in exact mode
    where their ids decrease somewhere, sorted by (id, position), and grouped
    by polygon (exact) or one group (global); only the (edge, row) pairs
    where the edge straddles the row (the plain compares), with
    J = #{j : u_j < ui} by compares with the exact u_j; a word of n bits per
    (group, row), the first J bits XORed in (all n for a RIGHT edge in global
    mode), then ORed over the groups of a row; the quads and palette as the
    plain version. Returns the image and counts of the special cases met on
    straddled pairs."""
    n, f32 = obs.img_size, torch.float32
    half = torch.tensor((n - 1) / 2.0, dtype=f32)
    res = torch.tensor(obs.img_res, dtype=f32)
    ext = half * res
    c, s = torch.cos(poses[:, 2:3]), torch.sin(poses[:, 2:3])
    cx, cy = poses[:, 0:1] + c * CX_OFF, poses[:, 1:2] + s * CX_OFF
    dx1, dy1 = edges[..., 0] - cx, edges[..., 1] - cy
    dx2, dy2 = edges[..., 2] - cx, edges[..., 3] - cy
    v1, u1 = c * dx1 + s * dy1, (-s) * dx1 + c * dy1
    v2, u2 = c * dx2 + s * dy2, (-s) * dx2 + c * dy2
    dv = v2 - v1
    su = (u2 - u1) / torch.where(dv == 0.0, 1.0, dv)
    uc = u1 - v1 * su
    kept = (mask & (dv != 0.0) & ~((v1 > ext) & (v2 > ext)) & ~((v1 <= -ext) & (v2 <= -ext))
            & ~((u1 <= -ext) & (u2 <= -ext)))
    right = (u1 > ext) & (u2 > ext)
    v = (half - torch.arange(n).to(f32)) * res                      # row coordinates
    u = (torch.arange(n).to(f32) - half) * res                      # column coordinates
    stats = dict(nan=0, pinf=0, ninf=0, ui_on_column=0, end_on_row=0, unsorted=0, pairs=0)
    obst = np.zeros((poses.shape[0], n, n), bool)
    for b in range(poses.shape[0]):
        ks = torch.nonzero(kept[b]).flatten().tolist()
        ids = poly[b, ks].tolist()
        if exact and any(x > y for x, y in zip(ids, ids[1:])):
            stats["unsorted"] += 1
            ks = sorted(ks, key=lambda e: int(poly[b, e]))             # stable
            ids = poly[b, ks].tolist()
        group = np.cumsum([0] + [int(x != y) for x, y in zip(ids, ids[1:])])
        A, Bv = v1[b, ks], v2[b, ks]
        strad = (A[None] > v[:, None]) != (Bv[None] > v[:, None])     # (n, K)
        ui = v[:, None] * su[b, ks][None] + uc[b, ks][None]
        J = (u[None, None, :] < ui[..., None]).sum(-1)                # by compares
        if not exact:
            J = torch.where(right[b, ks][None], n, J)
        words = {}
        for i, k in torch.nonzero(strad).tolist():
            g = (i, int(group[k]) if exact else 0)
            words[g] = words.get(g, 0) ^ ((1 << int(J[i, k])) - 1)
            x = float(ui[i, k])
            stats["pairs"] += 1
            stats["nan"] += x != x
            stats["pinf"] += x == float("inf")
            stats["ninf"] += x == float("-inf")
            stats["ui_on_column"] += bool((u == ui[i, k]).any())
            stats["end_on_row"] += bool((A[k] == v[i]) | (Bv[k] == v[i]))
        rows = [0] * n
        for (i, _), w in words.items():
            rows[i] |= w                  # exact: OR of the polygons; global: one word
        for i, w in enumerate(rows):
            obst[b, i] = np.unpackbits(np.frombuffer(w.to_bytes(n // 8, "little"), np.uint8),
                                       bitorder="little")
    pv, pu = raster_bev.pixel_coords(n, obs.img_res)
    qd = torch.cat([raster_bev.quad_coeffs(poses, dbox, CX_OFF),
                    raster_bev.quad_coeffs(poses, vbox, CX_OFF)], dim=1)
    hp = (qd[:, :, None, 0] * pv + qd[:, :, None, 1] * pu + qd[:, :, None, 2]) >= 0.0
    dest, car = hp[:, 0:4].all(1), hp[:, 4:8].all(1)
    cls = torch.where(car, 3, torch.where(dest, 2, T(obst.reshape(len(obst), -1)).long()))
    return T(raster_bev.PALETTE)[cls].reshape(-1, n, n, 3), stats


def _rows_vs_plain(poses, dbox, edges, mask, poly, exact, obs=OBS):
    poses, dbox, edges = (T(np.array(x, np.float32)) for x in (poses, dbox, edges))
    mask, poly = T(np.array(mask, bool)), T(np.array(poly, np.int32))
    vbox = pose_to_box(poses, T(np.asarray(VCFG.box_corners(), np.float32)))
    got, stats = _raster_rows(poses, vbox, dbox, edges, mask, poly, obs, exact)
    want = raster_bev.render_bev_batch_plain(poses, vbox, dbox, edges, mask, poly, obs, VCFG,
                                             exact)
    assert torch.equal(got, want)
    return want, stats


@pytest.mark.parametrize("exact", [True, False])
def test_raster_row_words_match_plain_dlp(dlp_scenes, exact):
    """512-slot DLP scenes at start and goal: the per-row formulation gives
    the plain version's image, bit for bit."""
    sc = dlp_scenes
    for poses in (sc.start, sc.dest):
        _, stats = _rows_vs_plain(poses, sc.dest_box, sc.edges, sc.edge_mask, sc.edge_poly,
                                  exact)
        assert stats["pairs"] > 0


@pytest.mark.parametrize("exact", [True, False])
def test_raster_row_words_match_plain_procedural(procedural, exact):
    scenes, poses = procedural
    _rows_vs_plain(poses["mid"], scenes.dest_box, scenes.edges, scenes.edge_mask,
                   scenes.edge_poly, exact)


def test_raster_row_words_match_plain_shuffled_ids(dlp_scenes):
    """Slots in random order and polygon ids shuffled: ids out of order,
    interleaved, one id repeated far apart (as the DLP loader's clamp to
    max_obstacles - 1 can give)."""
    sc = dlp_scenes
    rng = np.random.default_rng(12)
    perm = rng.permutation(np.asarray(sc.edges).shape[1])
    poly = np.asarray(sc.edge_poly)[:, perm]
    ids = rng.permutation(int(poly.max()) + 1)
    poly = ids[poly] % 40                          # merges polygons: repeated ids
    for n in (32, 128):
        for exact in (True, False):
            _, stats = _rows_vs_plain(sc.start, sc.dest_box, np.asarray(sc.edges)[:, perm],
                                      np.asarray(sc.edge_mask)[:, perm], poly, exact,
                                      ObsConfig(img_size=n))
            assert stats["unsorted"] == (2 if exact else 0)


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_raster_row_words_match_plain_adversarial(n):
    """ui exactly on a column, end points on a row, dv == 0, near-horizontal
    edges giving ui = NaN, +inf and -inf, zeros of both signs, RIGHT and LEFT
    edges, ids shuffled and interleaved, with the ego frame equal to the world
    frame, at -0 heading, and at a generic pose; both modes."""
    rng = np.random.default_rng(n)
    edges = adversarial_edges(n, OBS.img_res, rng)
    E = len(edges)
    poses = np.asarray([[-CX_OFF, 0.0, 0.0], [-CX_OFF, -0.0, -0.0], [0.3, -0.2, 0.7]],
                       np.float32)
    B = len(poses)
    boxes = np.asarray(jpose_to_box(jnp.asarray([[1.0, 1.0, 0.3]] * B),
                                    jnp.asarray(VCFG.box_corners(), jnp.float32)))
    mask = rng.random((B, E)) > 0.1
    poly = np.tile(rng.integers(0, 5, E), (B, 1))
    poly[:, -3:] = (1 << 24) - 1
    total = dict.fromkeys(("nan", "pinf", "ninf", "ui_on_column", "end_on_row", "unsorted"), 0)
    for exact in (True, False):
        img, stats = _rows_vs_plain(poses, boxes, np.tile(edges, (B, 1, 1)), mask, poly, exact,
                                    ObsConfig(img_size=n))
        for k in total:
            total[k] += stats[k]
        assert (img == T(raster_bev.PALETTE[1])).all(-1).any()
    assert all(total.values()), total             # every special case was met


if __name__ == "__main__":
    if "--export" not in sys.argv:
        sys.exit("usage: python -m tests.test_torch_ops --export")
    print(export_scenes())
