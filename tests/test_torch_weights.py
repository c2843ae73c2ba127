"""The committed SAC actor carried from the JAX package to the port.

``hope_tpu_torch/assets/sac_r3b_actor.npz`` is exported from the orbax
checkpoint ``results/ckpt_sac_r3b`` by this module:

    JAX_PLATFORMS=cpu python -m tests.test_torch_weights --export

The tests restore the checkpoint once, assert that the npz holds exactly its
actor, log_std and normalizer, and run both actors on the same observations.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hope_tpu.agents import SACAgent as JSACAgent
from hope_tpu.config import EnvConfig, ObsConfig, SACConfig, actor_net_config, critic_net_config
from hope_tpu.envs import ParkingEnv as JEnv
from hope_tpu_torch.agents import SACAgent
from hope_tpu_torch.models.convert import load_actor_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "ckpt_sac_r3b")
NPZ = os.path.join(ROOT, "hope_tpu_torch", "assets", "sac_r3b_actor.npz")
OBS = ObsConfig()


def _jax_agent():
    env = JEnv(EnvConfig(obs=OBS, max_edges=512, max_obstacles=128))
    return JSACAgent(actor_net_config(OBS), critic_net_config(OBS, action_input=True),
                     SACConfig(), env.observation_shape, env.mask_table)


def restore_r3b():
    """(JAX agent, restored SACState) of the committed checkpoint."""
    from hope_tpu.utils.checkpoint import load_checkpoint

    agent = _jax_agent()
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one),
        jax.eval_shape(agent.init, jax.random.PRNGKey(0)))
    return agent, load_checkpoint(CKPT, abstract)


def actor_arrays(st) -> dict:
    """Flat {"/"-joined path: array} of the actor, log_std and normalizer."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(st.actor)[0]:
        out["/".join(k.key for k in path)] = np.asarray(leaf)
    out["log_std"] = np.asarray(st.log_std)
    for part in ("mean", "S"):
        for k, v in getattr(st.norm, part).items():
            out[f"norm/{part}/{k}"] = np.asarray(v)
    out["norm/n"] = np.asarray(st.norm.n)
    return out


def export(path: str = NPZ):
    _, st = restore_r3b()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **actor_arrays(st))
    return path


@pytest.fixture(scope="module")
def r3b():
    return restore_r3b()


def test_npz_equals_checkpoint(r3b):
    _, st = r3b
    want = actor_arrays(st)
    with np.load(NPZ) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    n_params = sum(v.size for k, v in want.items() if k.startswith("params/"))
    assert 0.8e6 < n_params < 1.0e6


def test_r3b_actor_matches_jax(r3b):
    """Mean and std of the carried actor vs the JAX actor on the same
    observations. Tolerance 1e-5: float32 on both sides, with reductions
    (matmul, layer norm, softmax) summed in different orders; TF32 is off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent, st = r3b
    rng = np.random.default_rng(3)
    B = 6
    obs = {"lidar": rng.uniform(-2, 10, (B, 120)).astype(np.float32),
           "action_mask": rng.uniform(0, 1, (B, 42)).astype(np.float32),
           "img": (rng.uniform(0, 1, (B, 3, 64, 64)) > 0.7).astype(np.float32),
           "target": rng.normal(size=(B, 5)).astype(np.float32)}
    jmean, jstd = agent._dist(st, {k: jax.numpy.asarray(v) for k, v in obs.items()})

    actor, state = load_actor_npz(NPZ, actor_net_config(OBS), "cpu")
    tagent = SACAgent(actor, SACConfig())
    mean, std = tagent.dist(state, {k: torch.as_tensor(v) for k, v in obs.items()})
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-5, rtol=0)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), atol=1e-6, rtol=1e-6)
    assert np.abs(np.asarray(jmean)).max() > 0.05   # not a degenerate comparison


if __name__ == "__main__":
    if "--export" not in sys.argv:
        sys.exit("usage: python -m tests.test_torch_weights --export")
    print(export())
