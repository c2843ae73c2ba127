"""Port parity, Reeds-Shepp planning and the hybrid agent state
(hope_tpu_torch.planning / agents.hybrid vs hope_tpu, on the CPU).

Tolerances: RS word lengths come from float32 trig (atan2, arcsin, arccos,
tan) whose last places differ between XLA and torch, so lengths are held to
atol 1e-4 (normalized units, about 0.04 mm) plus rtol 2e-5 (words through
tan(phi) near its pole amplify a last-place angle difference: up to 7.5e-6
relative on lengths ~100 here), and sampled poses to atol 1e-4; validity
flags, masks, chosen words and action queues are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.agents import hybrid as jhybrid
from hope_tpu.config import EnvConfig, VehicleConfig
from hope_tpu.envs.dlp import DLPDataset as JDLP
from hope_tpu.planning import RSPath as JRSPath
from hope_tpu.planning import build_action_queue as jqueue
from hope_tpu.planning import find_path_batch as jfind
from hope_tpu.planning import reeds_shepp as jrs
from hope_tpu.planning import traj_collides as jtraj_collides
from hope_tpu_torch.agents import hybrid
from hope_tpu_torch.planning import RSPath, build_action_queue, find_path_batch, traj_collides
from hope_tpu_torch.planning import reeds_shepp as rs

VCFG = VehicleConfig()
MAXC = VCFG.max_curvature
CORNERS = VCFG.box_corners().astype(np.float32)
T = torch.as_tensor
J = jnp.asarray


def close(got, want, atol=1e-4, rtol=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(4)
    n = 64
    start = np.zeros((n, 3), np.float32)
    start[:, :2] = rng.normal(size=(n, 2)) * 3
    start[:, 2] = rng.uniform(-np.pi, np.pi, n)
    # generic pairs: a goal in line with the start (local y ~ 0) puts word
    # validity on a last-place sign, covered exactly by the ties test below
    goal = start + rng.normal(size=(n, 3)).astype(np.float32) * [4.0, 4.0, 1.5]
    return start, goal


@pytest.fixture(scope="module")
def jcands(pairs):
    start, goal = pairs
    return jax.vmap(lambda s, g: jrs.candidates(s, g, MAXC))(J(start), J(goal))


def test_candidates(pairs, jcands):
    start, goal = pairs
    got = rs.candidates(T(start), T(goal), MAXC)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jcands.valid))
    np.testing.assert_array_equal(got.steers.numpy(), np.asarray(jcands.steers))
    close(got.lengths, jcands.lengths)
    v = np.asarray(jcands.valid)
    close(got.L.numpy()[v], np.asarray(jcands.L)[v])
    assert np.isinf(got.L.numpy()[~v]).all()
    assert v.sum(1).min() >= 4                      # every pair has several words


def test_sample_path(pairs, jcands):
    """Same words in (the JAX candidates), poses out."""
    start, _ = pairs
    lengths, steers = np.asarray(jcands.lengths), np.asarray(jcands.steers)
    i = np.argmin(np.asarray(jcands.L), axis=1)
    l, s = lengths[np.arange(len(i)), i], steers[np.arange(len(i)), i]
    want = jax.vmap(lambda a, b, c: jrs.sample_path(a, b, c, MAXC, 288, 0.1))(
        J(l), J(s), J(start))
    got = rs.sample_path(T(l), T(s), T(start), MAXC, 288, 0.1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    close(got[0][..., :2], want[0][..., :2])
    dth = np.angle(np.exp(1j * (got[0][..., 2].numpy() - np.asarray(want[0][..., 2]))))
    assert np.abs(dth).max() < 1e-4                 # headings, modulo 2 pi
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.fixture(scope="module")
def dlp():
    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    ds = JDLP(env_cfg=cfg)
    sc = ds.batch_reset(jax.random.split(jax.random.PRNGKey(5), 6), jnp.arange(6) * 40)
    a = jax.random.uniform(jax.random.PRNGKey(6), (6, 1), minval=0.5, maxval=0.95)
    return sc, sc.start * (1 - a) + sc.dest * a


def test_find_path_batch_dlp(dlp):
    """Real DLP scenes, poses on the way in: the same words are chosen."""
    sc, pose = dlp
    want = jfind(pose, sc.dest, MAXC, J(CORNERS), sc.edges, sc.edge_mask, sc.bounds)
    n = lambda x: T(np.array(x))  # noqa: E731
    got = find_path_batch(n(pose), n(sc.dest), MAXC, T(CORNERS), n(sc.edges),
                          n(sc.edge_mask), n(sc.bounds))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    assert got.found.any()
    np.testing.assert_array_equal(got.steers.numpy(), np.asarray(want.steers))
    close(got.lengths, want.lengths)
    f = np.asarray(want.found)
    close(got.L.numpy()[f], np.asarray(want.L)[f])


def test_find_path_batch_ties():
    """Goals straight ahead / behind in open space: mirror-image words tie in
    length, and the lower word index must win, as jax.lax.top_k picks it
    (a stable ascending sort; torch.topk promises no order among ties)."""
    start = np.zeros((4, 3), np.float32)
    goal = np.asarray([[4, 0, 0], [7, 0, 0], [-3, 0, 0], [0, 0, np.pi]], np.float32)
    edges = np.zeros((4, 8, 4), np.float32)
    mask = np.zeros((4, 8), bool)
    bounds = np.tile(np.asarray([-30, 30, -30, 30], np.float32), (4, 1))
    L = np.asarray(jax.vmap(lambda s, g: jrs.candidates(s, g, MAXC))(J(start), J(goal)).L)
    srt = np.sort(L, axis=1)
    assert (srt[:, 1:6] == srt[:, :5]).any()        # the setup does produce ties
    want = jfind(J(start), J(goal), MAXC, J(CORNERS), J(edges), J(mask), J(bounds))
    got = find_path_batch(T(start), T(goal), MAXC, T(CORNERS), T(edges), T(mask), T(bounds))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_array_equal(got.steers.numpy(), np.asarray(want.steers))
    close(got.lengths, want.lengths)


def test_traj_collides(dlp):
    """The divided-form sweep (plain ``traj_collides``) vs JAX's: exact."""
    sc, pose = dlp
    cand = jrs.candidates(pose[0], sc.dest[0], MAXC)
    order = np.argsort(np.asarray(cand.L))[:6]
    for i in order:
        p, m, _ = jrs.sample_path(cand.lengths[i], cand.steers[i], pose[0], MAXC, 288, 0.1)
        want = bool(jtraj_collides(p, m, J(CORNERS), sc.edges[0], sc.edge_mask[0],
                                   sc.bounds[0]))
        got = bool(traj_collides(T(np.array(p)), T(np.array(m)), T(CORNERS),
                                 T(np.array(sc.edges[0])), T(np.array(sc.edge_mask[0])),
                                 T(np.array(sc.bounds[0]))))
        assert got == want


def _random_paths(seed, B=16):
    rng = np.random.default_rng(seed)
    lengths = (rng.normal(size=(B, 5)) * 3).astype(np.float32)
    lengths[:, 3:] *= rng.random((B, 2)) > 0.5
    lengths[:3] *= 4.0                              # longer than the queue
    steers = rng.integers(-1, 2, (B, 5)).astype(np.float32)
    found = rng.random(B) > 0.3
    L = np.abs(lengths).sum(1)
    return lengths, steers, found, L


def test_build_action_queue():
    """Exact: floor, compares and a right-sided searchsorted."""
    lengths, steers, found, L = _random_paths(0)
    want_q, want_n = jax.vmap(lambda l, s, f, LL: jqueue(JRSPath(f, l, s, LL), 1.25, 32))(
        J(lengths), J(steers), J(found), J(L))
    got_q, got_n = build_action_queue(RSPath(T(found), T(lengths), T(steers), T(L)), 1.25, 32)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert (got_n.numpy() == 32).any() and (got_n.numpy() == 0).any()


def test_hybrid_latch_and_act():
    """Two rounds of latch + act from the same RS paths and policy actions."""
    B = 16
    jhs, ths = jhybrid.HybridState.create(B, 32), hybrid.HybridState.create(B, 32)
    for seed in (1, 2):
        lengths, steers, found, L = _random_paths(seed, B)
        jhs = jhybrid.latch(jhs, JRSPath(J(found), J(lengths), J(steers), J(L)), 1.25)
        ths = hybrid.latch(ths, RSPath(T(found), T(lengths), T(steers), T(L)), 1.25)
        pa = np.random.default_rng(seed).uniform(-1, 1, (B, 2)).astype(np.float32)
        lp = np.arange(B, dtype=np.float32)
        ja, jl, jhs = jhybrid.act(jhs, J(pa), J(lp), J(-lp))
        ta, tl, ths = hybrid.act(ths, T(pa), T(lp), T(-lp))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        for f in ("queue", "length", "cursor"):
            np.testing.assert_array_equal(getattr(ths, f).numpy(), np.asarray(getattr(jhs, f)))
