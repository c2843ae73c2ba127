"""Port parity, the slice as a whole: DLP resets, the batched env, and the
DLP evaluation path of the committed SAC actor (hope_tpu_torch vs hope_tpu on
the CPU).

Tolerances: both sides run float32, but XLA's and torch's float32
transcendentals differ in the last place, the actor's reductions run in other
orders, and each step feeds the next, so continuous values are held to
atol 1e-4 (target, pose: metres or unit vectors), the reward to atol 1e-3
(its box-overlap term scales overlap differences of ~1e-4 near the slot by
10 x 0.1), lidar to atol
2e-3 m (a beam grazing an edge turns the ~1e-5 m pose difference into up to
~8e-4 m of range), RS path lengths to atol 1e-3 m (near-singular words
amplify it to ~1.4e-4 m here), and the image and action mask to a budget of 0.2% of
their entries; status, RS ``found``, queue lengths and final step counts must
be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.agents import hybrid as jhybrid
from hope_tpu.config import EnvConfig
from hope_tpu.envs import ParkingEnv as JEnv
from hope_tpu.envs.dlp import DLPDataset as JDLP
from hope_tpu.evaluation.evaluate import build_episode_runner as jrunner
from hope_tpu_torch.agents import SACAgent, hybrid
from hope_tpu_torch.config import EnvConfig as TEnvConfig
from hope_tpu_torch.config import SACConfig, actor_net_config
from hope_tpu_torch.envs import ParkingEnv, Scene
from hope_tpu_torch.envs.dlp import DLPDataset, DLPDraws
from hope_tpu_torch.envs.env import select
from hope_tpu_torch.evaluation.evaluate import build_episode_runner

from .test_torch_weights import NPZ, restore_r3b
from .torch_threads import one_torch_thread  # noqa: F401

CFG = EnvConfig(max_edges=512, max_obstacles=128)
TCFG = TEnvConfig(max_edges=512, max_obstacles=128)
FIELDS = [f.name for f in dataclasses.fields(Scene)]
ATOL = 1e-4
LIDAR_ATOL = 2e-3
RS_ATOL = 1e-3
REWARD_ATOL = 1e-3
BUDGET = 0.002
N_STEPS = 30


def jax_draws(keys, n_starts):
    """The draws jax scene_from_case_arrays makes from each reset key."""
    si, z, fd, fs = [], [], [], []
    for k, n in zip(keys, n_starts):
        ks, kj, kfd, kfs = jax.random.split(k, 4)
        si.append(int(jax.random.randint(ks, (), 0, n)))
        z.append(np.asarray(jax.random.normal(kj, (3,))))
        fd.append(bool(jax.random.uniform(kfd) > 0.5))
        fs.append(bool(jax.random.uniform(kfs) > 0.5))
    return DLPDraws(torch.as_tensor(si), torch.as_tensor(np.stack(z)),
                    torch.as_tensor(fd), torch.as_tensor(fs))


@pytest.fixture(scope="module")
def jds():
    return JDLP(env_cfg=CFG)


def test_dlp_reset_matches_jax(jds):
    """The same draws give the same scenes: edges, masks and polygon ids
    exactly, poses and bounds to atol 1e-4 (the flip goes through sin/cos)."""
    ids = np.asarray([0, 3, 57, 100, 131, 200, 247, 12])
    keys = jax.random.split(jax.random.PRNGKey(9), len(ids))
    want = jds.batch_reset(keys, jnp.asarray(ids))
    ds = DLPDataset(env_cfg=TCFG, device="cpu")
    draws = jax_draws(keys, ds.n_starts[torch.as_tensor(ids)].tolist())
    assert draws.flip_dest.any() and (~draws.flip_dest).any()
    got = ds.batch_reset(torch.as_tensor(ids), draws=draws)
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.fixture(scope="module")
def scenes(jds):
    # cases where the mean policy never repeats a target obs while running
    # (the stuck detector stays silent) and every episode ends within 30 steps
    pick = jnp.asarray([1, 2, 4, 9])
    keys = jax.random.split(jax.random.PRNGKey(4), 16)[pick]
    sc = jds.batch_reset(keys, pick * 15 + 3)
    return sc, Scene.from_numpy({f: np.asarray(getattr(sc, f)) for f in FIELDS}, "cpu")


@pytest.fixture(scope="module")
def agents():
    jagent, jst = restore_r3b()
    from hope_tpu_torch.models.convert import load_actor_npz

    actor, st = load_actor_npz(NPZ, actor_net_config(), "cpu")
    return (jagent, jst), (SACAgent(actor, SACConfig()), st)


def _assert_obs(got, want, step):
    for k, atol in (("lidar", LIDAR_ATOL), ("target", ATOL)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=f"{k} @ step {step}")
    for k in ("img", "action_mask"):
        bad = np.mean(np.abs(got[k].numpy() - np.asarray(want[k])) > 1e-6)
        assert bad <= BUDGET, f"{k} @ step {step}: {bad:.4%} of entries differ"


def test_rollout_matches_jax(scenes, agents):
    """~30 control steps of the evaluation loop (mean actions, RS takeover,
    freezing of finished envs) in both packages, compared at every step."""
    jsc, tsc = scenes
    (jagent, jst), (tagent, tst) = agents
    jenv, tenv = JEnv(CFG), ParkingEnv(TCFG, device="cpu")
    B = 4
    ratio = CFG.step_ratio

    @jax.jit
    def jstep(state, obs, hs, finished, last_tgt):
        mean, _ = jagent._dist(jst, obs)
        # a finished env's frozen obs repeats; only running envs matter
        stuck = jnp.all(jnp.abs(obs["target"] - last_tgt) < 1e-12, axis=-1) & ~finished
        action, _, hs = jhybrid.act(hs, mean, jnp.zeros(B), jnp.zeros(B))
        new_state, new_obs, r, done, info = jenv.batch_step(state, jenv.rescale_action(action))
        hs = jhybrid.latch(hs, info["rs"], ratio)
        fin = finished | done
        sel = lambda a, b: jax.tree.map(  # noqa: E731
            lambda x, y: jnp.where(fin.reshape((B,) + (1,) * (x.ndim - 1)), x, y), a, b)
        return (sel(state, new_state), sel(obs, new_obs), hs, fin, obs["target"],
                r, info, stuck)

    js, jo = jenv.batch_reset(jsc)
    ts, to = tenv.batch_reset(tsc)
    _assert_obs(to, jo, 0)
    jhs, ths = jhybrid.HybridState.create(B, 32), hybrid.HybridState.create(B, 32)
    jfin, tfin = jnp.zeros(B, bool), torch.zeros(B, dtype=torch.bool)
    jlast = jnp.full((B, 5), jnp.inf)
    rs_seen = 0
    for step in range(1, N_STEPS + 1):
        js, jo, jhs, jfin, jlast, jr, jinfo, stuck = jstep(js, jo, jhs, jfin, jlast)
        # the stuck detector's random action cannot match across frameworks
        assert not bool(stuck.any()), f"stuck detector fired at step {step}"

        mean, _ = tagent.dist(tst, to)
        action, _, ths = hybrid.act(ths, mean, torch.zeros(B), torch.zeros(B))
        nts, nto, tr, tdone, tinfo = tenv.batch_step(ts, tenv.rescale_action(action))
        ths = hybrid.latch(ths, tinfo["rs"], ratio)
        tfin = tfin | tdone
        ts, to = select(tfin, ts, nts), select(tfin, to, nto)

        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=REWARD_ATOL, rtol=0,
                                   err_msg=f"reward @ step {step}")
        np.testing.assert_array_equal(tinfo["status"].numpy(), np.asarray(jinfo["status"]))
        np.testing.assert_array_equal(tinfo["rs"].found.numpy(), np.asarray(jinfo["rs"].found))
        f = np.asarray(jinfo["rs"].found)
        rs_seen += int(f.sum())
        np.testing.assert_allclose(tinfo["rs"].L.numpy()[f], np.asarray(jinfo["rs"].L)[f],
                                   atol=RS_ATOL, rtol=0)
        np.testing.assert_array_equal(ths.length.numpy(), np.asarray(jhs.length))
        np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
        np.testing.assert_allclose(ts.vehicle.pose.numpy(), np.asarray(js.vehicle.pose),
                                   atol=ATOL, rtol=0, err_msg=f"pose @ step {step}")
        _assert_obs(to, jo, step)
    assert rs_seen > 0                      # the RS takeover was exercised
    assert tfin.all()                       # and every episode finished


def test_runner_final_metrics_match_jax(scenes, agents):
    """Both packages' own episode runners with the mean action: the same
    final steps, status and success over a 30-step cap."""
    jsc, tsc = scenes
    (jagent, jst), (tagent, tst) = agents

    def jact(obs, key):
        mean, _ = jagent._dist(jst, obs)
        return mean, jnp.zeros(mean.shape[0])

    want = jrunner(JEnv(CFG), jact, lambda obs, a: jnp.zeros(a.shape[0]), N_STEPS)(
        jsc, jax.random.PRNGKey(0))
    got = build_episode_runner(
        ParkingEnv(TCFG, device="cpu"),
        lambda obs, g: (tagent.dist(tst, obs)[0], torch.zeros(obs["target"].shape[0])),
        N_STEPS)(tsc, torch.Generator().manual_seed(0))
    for k in ("steps", "status", "success", "finished", "rs_latched"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["path_length"].numpy(), np.asarray(want["path_length"]),
                               atol=1e-3, rtol=0)
    assert got["success"].any()


def test_entry_points_default_to_cuda():
    """With no device named, entry points ask for CUDA and raise without it;
    they never fall back to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    from hope_tpu_torch.envs.action_mask import build_table
    from hope_tpu_torch.models.convert import actor_from_flax, load_actor_npz, unflatten

    with np.load(NPZ) as f:
        tree = unflatten({k: f[k] for k in f.files})
    for make in (lambda: ParkingEnv(TCFG), lambda: DLPDataset(env_cfg=TCFG),
                 lambda: build_table(),
                 lambda: load_actor_npz(NPZ, actor_net_config()),
                 lambda: actor_from_flax({"params": tree["params"]}, tree["log_std"],
                                         tree["norm"], actor_net_config())):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_eval_cli_dlp_battery_on_cpu(tmp_path):
    """The CLI runs the DLP battery alone (tiny here) when asked for that
    level, and refuses a level it does not know."""
    from hope_tpu_torch.evaluation import eval_mix_scene

    with pytest.raises(SystemExit) as e:
        eval_mix_scene.main([NPZ, "--levels", "Hard", "--device", "cpu"])
    assert e.value.code == 2
    res = eval_mix_scene.main([NPZ, "--levels", "dlp", "--episodes", "3", "--max-steps", "4",
                               "--device", "cpu", "--out", str(tmp_path)])
    assert list(res) == ["dlp"] and res["dlp"]["n"] == 3
    assert (tmp_path / "result_dlp.json").exists()


# ----------------------------------------------------- single-env entry points

def test_single_env_entry_points_match_jax(scenes):
    """ParkingEnv.reset / step / observe on one scene (the port's batched
    path at B = 1) against the JAX package's single-env functions (the XLA
    mask and world-frame raster, the single-env RS search): 12 steps of a
    fixed action sequence, at the module's tolerances; and against the
    port's own batched row, exactly."""
    jsc, tsc = scenes
    jenv, tenv = JEnv(CFG), ParkingEnv(TCFG, device="cpu")
    i = 2
    js, jo = jax.jit(jenv.reset)(jax.tree.map(lambda x: x[i], jsc))
    one = tsc.map(lambda x: x[i])
    ts, to = tenv.reset(one)
    _assert_obs({k: v[None] for k, v in to.items()}, {k: v[None] for k, v in jo.items()}, 0)
    bs, bo = tenv.batch_reset(tsc)
    for k, v in to.items():
        assert torch.equal(v, bo[k][i]), k
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(3)
    acts = rng.uniform([-0.75, -2.5], [0.75, 2.5], (12, 2)).astype(np.float32)
    found = 0
    for step, a in enumerate(acts, 1):
        js, jo, jr, jdone, jinfo = jstep(js, jnp.asarray(a))
        ts, to, tr, tdone, tinfo = tenv.step(ts, torch.as_tensor(a))
        assert to["lidar"].shape == (TCFG.lidar.n_beams,) and tr.ndim == 0
        _assert_obs({k: v[None] for k, v in to.items()}, {k: v[None] for k, v in jo.items()}, step)
        assert float(tr) == pytest.approx(float(jr), abs=REWARD_ATOL)
        assert bool(tdone) == bool(jdone) and int(tinfo["status"]) == int(jinfo["status"])
        assert bool(tinfo["rs"].found) == bool(jinfo["rs"].found)
        if bool(jinfo["rs"].found):
            found += 1
            assert float(tinfo["rs"].L) == pytest.approx(float(jinfo["rs"].L), abs=RS_ATOL)
        np.testing.assert_allclose(ts.vehicle.pose.numpy(), np.asarray(js.vehicle.pose),
                                   atol=ATOL)
        assert torch.equal(tenv.observe(ts)["target"], to["target"])
        if bool(tdone):
            break


def test_find_path_matches_jax(scenes):
    """The single-scenario RS search (find_path, the batched search at B = 1)
    against JAX's, from poses between each scene's start and destination."""
    from hope_tpu.planning import find_path as jfind
    from hope_tpu_torch.planning import find_path

    jsc, tsc = scenes
    corners = CFG.vehicle.box_corners()
    hits = 0
    for i in range(4):
        for t in (0.5, 0.8, 0.95):
            start = (1 - t) * np.asarray(jsc.start[i]) + t * np.asarray(jsc.dest[i])
            start = start.astype(np.float32)
            args = (jsc.dest[i], CFG.vehicle.max_curvature, jnp.asarray(corners), jsc.edges[i],
                    jsc.edge_mask[i], jsc.bounds[i])
            want = jfind(jnp.asarray(start), *args, n_points=CFG.rs_max_points,
                         step_m=CFG.rs_step_size)
            got = find_path(torch.as_tensor(start), tsc.dest[i], TCFG.vehicle.max_curvature,
                            torch.as_tensor(corners, dtype=torch.float32), tsc.edges[i],
                            tsc.edge_mask[i], tsc.bounds[i], n_points=TCFG.rs_max_points,
                            step_m=TCFG.rs_step_size)
            assert bool(got.found) == bool(want.found), (i, t)
            if bool(want.found):
                hits += 1
                np.testing.assert_array_equal(got.steers.numpy(), np.asarray(want.steers))
                np.testing.assert_allclose(got.lengths.numpy(), np.asarray(want.lengths),
                                           atol=RS_ATOL)
                assert float(got.L) == pytest.approx(float(want.L), abs=RS_ATOL)
    assert hits > 0


def test_sac_choose_action_matches_jax(scenes, agents):
    """SACAgent.choose_action (the masked discrete choice) on the scenes'
    first observations, with JAX's per-env Gumbel noise replayed: identical
    actions; log-probs to 1e-4 (the r3b actor's std is small, and the
    log-prob scales the ~1e-6 difference of the two frameworks' means by
    (action - mean) / std^2)."""
    jsc, tsc = scenes
    (jagent, jst), (tagent, tst) = agents
    jenv, tenv = JEnv(CFG), ParkingEnv(TCFG, device="cpu")
    _, jo = jax.jit(jenv.batch_reset)(jsc)
    _, to = tenv.batch_reset(tsc)
    key = jax.random.PRNGKey(8)
    want_a, want_lp = jagent.choose_action(jst, jo, key)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (42,)))(jax.random.split(key, 4))
    agent = SACAgent(tagent.actor, SACConfig(), mask_table=tenv.mask_table)
    got_a, got_lp = agent.choose_action(tst, to, noise=torch.as_tensor(np.asarray(noise)))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="mask_table"):
        tagent.choose_action(tst, to)
