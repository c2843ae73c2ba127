"""The port's procedural scenario generator, scene pool and curriculum
against the JAX package's (hope_tpu_torch vs hope_tpu on the CPU).

The deterministic helpers are held to their JAX counterparts on the same
inputs. The generator's draws come from a ``torch.Generator`` and differ
from ``jax.random``'s by design, so banks are compared by what they must
satisfy and by distribution: every feasible scene's start is clear of every
active edge and of the destination box (checked with the JAX geometry), the
slot gap lies in the level's range, the histogram of the JAX package's
``get_map_level`` over port banks is near its histogram over JAX banks, and
the feasible share is no lower than JAX's by more than a margin.

The JAX banks (n = 64 per level, ``generate_bank`` with keys 0, 1, 2) are
saved once to ``tests/data/torch_jax_banks.npz``, because compiling the JAX
generator costs ~40 s per level on the CPU; ``test_jax_banks_file`` (slow)
regenerates them and checks the file. Export:

    JAX_PLATFORMS=cpu python -m tests.test_torch_scenario --export
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.config import ScenarioConfig, VehicleConfig
from hope_tpu.envs import scenario_gen as jgen
from hope_tpu.envs.map_level import get_map_level
from hope_tpu.geometry import box_to_edges as jbox_to_edges
from hope_tpu.geometry import pose_to_box as jpose_to_box
from hope_tpu.geometry import segments_intersect as jsegments_intersect
from hope_tpu.train import curriculum as jcur
from hope_tpu_torch.config import EnvConfig
from hope_tpu_torch.envs import scenario_gen as tgen
from hope_tpu_torch.train import curriculum as tcur
from hope_tpu_torch.train.scene_pool import ScenePool, pad_scene_batch

from .torch_threads import one_torch_thread  # noqa: F401

BANKS_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "torch_jax_banks.npz")
LEVELS = ("Normal", "Complex", "Extrem")
N = 64
VCFG = VehicleConfig()
CORNERS = np.asarray(VCFG.box_corners(), np.float32)
BANK_FIELDS = ("start", "dest", "edges", "edge_mask", "edge_poly", "n_polys")
# total-variation distance allowed between the port's and JAX's level
# histograms over 64 scenes each: two samples of 64 from one distribution
# differ by about 0.1 in TV at the 95th percentile where two classes share
# the mass (Normal: ~95% / 5% here), so 0.15 leaves room for noise only
TV_MAX = 0.15
# feasible share: JAX's banks are 100% feasible at n = 64; 5 points of
# margin allow 3 infeasible draws of 64
OK_MARGIN = 0.05



def jax_banks():
    """{level: {field: array}} of JAX ``generate_bank`` banks, n = 64, with
    the 72 procedural edge slots only."""
    out = {}
    for i, level in enumerate(LEVELS):
        sc, ok = jgen.generate_bank(jax.random.PRNGKey(i), level=level, n=N)
        d = {f: np.asarray(getattr(sc, f)) for f in BANK_FIELDS}
        for f in ("edges", "edge_mask", "edge_poly"):
            d[f] = d[f][:, :tgen.N_EDGES]
        out[level] = {**d, "ok": np.asarray(ok)}
    return out


def export_banks(path: str = BANKS_NPZ):
    np.savez_compressed(path, **{f"{lv}/{k}": v for lv, d in jax_banks().items()
                                 for k, v in d.items()})
    return path


def load_banks():
    with np.load(BANKS_NPZ) as f:
        return {lv: {k: f[f"{lv}/{k}"] for k in (*BANK_FIELDS, "ok")} for lv in LEVELS}


# ------------------------------------------------------------ helpers

def _boxes(rng, n):
    pose = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n), rng.uniform(-np.pi, np.pi, n)],
                    -1).astype(np.float32)
    return np.array(jpose_to_box(jnp.asarray(pose), jnp.asarray(CORNERS))), pose


def test_box_matches_jax():
    """pose_to_box through sin/cos: XLA's and torch's float32 sin/cos differ
    in the last place (ROADMAP.md section 3), so corners at up to ~8 m are
    held to 1e-6 (1-2 ulp), not to equality."""
    rng = np.random.default_rng(0)
    want, pose = _boxes(rng, 256)
    got = tgen._box(torch.as_tensor(CORNERS), torch.as_tensor(pose)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_quad_helpers_match_jax():
    """_quad_dist and _quads_cross on the same quads (identical, overlapping
    and apart): exactly equal (the same float32 operations, no
    transcendental)."""
    rng = np.random.default_rng(1)
    a, _ = _boxes(rng, 200)
    b, _ = _boxes(rng, 200)
    b[:20] = a[:20]                                  # identical quads
    b[20:40] = a[20:40] + np.float32(0.5)            # overlapping
    want_d = np.asarray(jax.vmap(jgen._quad_dist)(jnp.asarray(a), jnp.asarray(b)))
    want_x = np.asarray(jax.vmap(jgen._quads_cross)(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_array_equal(tgen._quads_cross(ta, tb).numpy(), want_x)
    assert want_x.any() and (~want_x).any()
    np.testing.assert_array_equal(tgen._quad_dist(ta, tb).numpy(), want_d)
    assert (want_d == 0).any() and (want_d > 0).any()


def test_min_corner_y_matches_jax():
    """Through pose_to_box's sin/cos: 1 ulp (1e-6), as test_box_matches_jax."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-8, 8, 128).astype(np.float32)
    yaw = rng.uniform(-np.pi, np.pi, 128).astype(np.float32)
    for idx in ((0, 3), (0, 1)):
        want = np.asarray(jax.vmap(lambda x, y: jgen._min_corner_y(
            jnp.asarray(CORNERS), x, y, *idx))(jnp.asarray(x), jnp.asarray(yaw)))
        got = tgen._min_corner_y(torch.as_tensor(CORNERS), torch.as_tensor(x),
                                 torch.as_tensor(yaw), *idx).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ------------------------------------------------------------ banks

@pytest.fixture(scope="module")
def port_banks():
    g = torch.Generator().manual_seed(0)
    out = {}
    for level in LEVELS:
        sc, ok = tgen.generate_bank(g, level=level, n=N)
        out[level] = ({f: getattr(sc, f).numpy() for f in BANK_FIELDS}, ok.numpy(), sc)
    return out


def _levels(bank, ok):
    return np.bincount([get_map_level(bank["start"][i], bank["dest"][i], bank["edges"][i],
                                      bank["edge_mask"][i], bank["edge_poly"][i],
                                      int(bank["n_polys"][i]))
                        for i in np.flatnonzero(ok)], minlength=3)[:3]


@pytest.mark.parametrize("level", LEVELS)
def test_bank_scenes_valid(port_banks, level):
    """Every feasible scene: the start box crosses no active edge and not the
    destination box (JAX geometry), start and destination lie in the bounds,
    72 edge slots with polygon ids slot // 4, and the slot gap between the
    destination and the two critical obstacles lies in the level's range."""
    bank, ok, sc = port_banks[level]
    cfg = ScenarioConfig.for_level(level)
    assert ok.any()
    assert sc.edges.shape == (N, EnvConfig().max_edges, 4)
    assert not sc.edge_mask[:, tgen.N_EDGES:].any()
    np.testing.assert_array_equal(bank["edge_poly"][:, :tgen.N_EDGES],
                                  np.tile(np.arange(tgen.N_EDGES) // 4, (N, 1)))
    bay = sc.case_id.numpy() == 0
    if level == "Extrem":
        assert not bay.any()
    i = np.flatnonzero(ok)
    e = jnp.asarray(bank["edges"][i, :tgen.N_EDGES])
    m = jnp.asarray(bank["edge_mask"][i, :tgen.N_EDGES])
    sbox = jpose_to_box(jnp.asarray(bank["start"][i]), jnp.asarray(CORNERS))
    dbox = jpose_to_box(jnp.asarray(bank["dest"][i]), jnp.asarray(CORNERS))
    hit = jnp.any(jsegments_intersect(jbox_to_edges(sbox), e) & m[:, None, :], axis=(1, 2))
    assert not np.asarray(hit).any(), i[np.asarray(hit)]
    assert not np.asarray(jax.vmap(jgen._quads_cross)(sbox, dbox)).any()
    b = sc.bounds.numpy()[i]
    for p in (bank["start"][i], bank["dest"][i]):
        assert ((b[:, 0] <= p[:, 0]) & (p[:, 0] <= b[:, 1])
                & (b[:, 2] <= p[:, 1]) & (p[:, 1] <= b[:, 3])).all()
    polys = e.reshape(-1, 18, 4, 4)[..., :2]
    gap = np.asarray(jax.vmap(jgen._quad_dist)(dbox, polys[:, 1])
                     + jax.vmap(jgen._quad_dist)(dbox, polys[:, 2]))
    lo = np.where(bay[i], cfg.min_lot_width - VCFG.width, cfg.min_lot_len - VCFG.length)
    hi = np.where(bay[i], cfg.max_lot_width - VCFG.width, cfg.max_lot_len - VCFG.length)
    # the destination box is rebuilt from the (possibly flipped) pose:
    # 1e-4 m of sin/cos rounding
    assert ((lo - 1e-4 <= gap) & (gap <= hi + 1e-4)).all(), (gap, lo, hi)


@pytest.mark.parametrize("level", LEVELS)
def test_bank_distribution_matches_jax(port_banks, level):
    """get_map_level's histogram over the port's feasible scenes against the
    JAX bank's (total-variation distance <= TV_MAX), and the feasible share no
    lower than JAX's by more than OK_MARGIN."""
    bank, ok, _ = port_banks[level]
    ref = load_banks()[level]
    h_port = _levels(bank, ok) / ok.sum()
    h_jax = _levels(ref, ref["ok"]) / ref["ok"].sum()
    tv = 0.5 * np.abs(h_port - h_jax).sum()
    assert tv <= TV_MAX, (level, h_port, h_jax)
    assert ok.mean() >= ref["ok"].mean() - OK_MARGIN, (ok.mean(), ref["ok"].mean())


@pytest.mark.slow
def test_jax_banks_file():
    """The committed JAX banks are what generate_bank gives today."""
    ref, want = load_banks(), jax_banks()
    for level in LEVELS:
        for k, v in want[level].items():
            np.testing.assert_array_equal(ref[level][k], v, err_msg=f"{level}/{k}")


def test_pad_scene_batch_matches_jax(port_banks):
    """Pad to 96 and 512 slots, truncate a padded tail, refuse to cut live
    edges: as the JAX function does."""
    from hope_tpu.envs.scene import Scene as JScene
    from hope_tpu.train.scene_pool import pad_scene_batch as jpad

    sc = port_banks["Normal"][2].map(lambda x: x[:4])
    jsc = JScene(**{f: jnp.asarray(getattr(sc, f).numpy()) for f in sc.__dataclass_fields__})
    for e in (96, 512, 256):
        got, want = pad_scene_batch(sc, e, 32), jpad(jsc, e, 32)
        for f in sc.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    with pytest.raises(ValueError, match="live edges"):
        pad_scene_batch(sc, 40, 32)


def test_scene_pool_swaps_failed_draws(monkeypatch):
    """A failed draw is replaced by a clone of the first valid scene, and the
    pool is [Normal | Complex | Extrem] of per_level scenes each."""
    import hope_tpu_torch.train.scene_pool as sp

    real = sp.generate_bank

    def failing(g, level, n):
        sc, ok = real(g, level=level, n=n)
        return sc, ok & (torch.arange(n) % 3 != 1)

    monkeypatch.setattr(sp, "generate_bank", failing)
    pool = ScenePool(EnvConfig(max_edges=96, max_obstacles=32), per_level=6,
                     include_dlp=False, device="cpu")
    assert pool.pool.edges.shape == (18, 96, 4)
    np.testing.assert_array_equal(pool.pool.level.numpy(), np.repeat([0, 1, 2], 6))
    for lv in range(3):
        seg = pool.gather(pool.flat_index(np.full(6, lv), np.arange(6)))
        for bad in (1, 4):
            np.testing.assert_array_equal(seg.start[bad].numpy(), seg.start[0].numpy())
    # with no DLP segment there is nothing to stream
    assert ScenePool(EnvConfig(max_edges=96, max_obstacles=32), per_level=2, include_dlp=False,
                     stream_dlp=True, device="cpu").stream is None


# ------------------------------------------------------------ curriculum

def test_curriculum_matches_jax():
    """SceneChoose and DlpCaseChoose: the same numpy seeds and the same
    recorded outcomes give the same draws, weights and statistics."""
    pairs = [(cls(rng=np.random.default_rng(7)), tcls(rng=np.random.default_rng(7)))
             for cls, tcls in ((jcur.SceneChoose, tcur.SceneChoose),
                               (jcur.DlpCaseChoose, tcur.DlpCaseChoose))]
    (js, ts), (jd, td) = pairs
    outcome = np.random.default_rng(3)
    for _ in range(700):
        lv, ok = int(outcome.integers(0, 4)), int(outcome.random() < 0.7)
        for s in (js, ts):
            s.record_episode(lv, ok)
        case = int(outcome.integers(0, 248))
        for d in (jd, td):
            d.update_success_record(ok, case)
    np.testing.assert_array_equal(js.sample_levels(300), ts.sample_levels(300))
    np.testing.assert_array_equal(js.choose_batch(50), ts.choose_batch(50))
    np.testing.assert_array_equal(js.recent_success(), ts.recent_success())
    np.testing.assert_array_equal(js.window_counts(), ts.window_counts())
    assert [jd.choose_case() for _ in range(50)] == [td.choose_case() for _ in range(50)]
    ids = np.arange(0, 248, 3)
    np.testing.assert_array_equal(jd.slot_weights(ids), td.slot_weights(ids))
    assert tcur.LEVELS == jcur.LEVELS
    np.testing.assert_array_equal(tcur.TARGET_SUCCESS, jcur.TARGET_SUCCESS)


if __name__ == "__main__" and "--export" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
    print(export_banks())
