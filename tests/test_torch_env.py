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
    """The CLI runs the DLP battery (tiny here) and refuses procedural levels,
    naming what they wait for."""
    from hope_tpu_torch.evaluation import eval_mix_scene

    with pytest.raises(SystemExit) as e:
        eval_mix_scene.main([NPZ, "--levels", "Normal", "--device", "cpu"])
    assert "scenario_gen" in str(e.value.code)
    res = eval_mix_scene.main([NPZ, "--episodes", "3", "--max-steps", "4", "--device", "cpu",
                               "--out", str(tmp_path)])
    assert res["dlp"]["n"] == 3 and (tmp_path / "result_dlp.json").exists()
