"""Port parity, models and the acting agent: a Flax-initialised actor carried
into the port (models/convert.py), the Welford normalizer, and SAC log-probs
(hope_tpu_torch vs hope_tpu on the CPU).

Tolerance 1e-5 on network outputs: float32 on both sides, with matmuls,
layer norms (Flax computes the variance as E[x^2] - E[x]^2, torch in two
passes) and softmaxes reduced in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hope_tpu.config as jcfg
from hope_tpu.agents import state_norm as jnorm
from hope_tpu.agents.sac import SACAgent as JSAC
from hope_tpu.models import MultiObsEmbedding as JNet
from hope_tpu_torch.agents import ActorState, NormState, SACAgent, norm_update, normalize
from hope_tpu_torch.config import AttentionConfig, NetConfig, SACConfig
from hope_tpu_torch.models.convert import actor_from_flax

T = torch.as_tensor


def small_cfg(attention: bool, tanh: bool = True):
    kw = dict(lidar_dim=120, target_dim=5, action_mask_dim=42, img_shape=(3, 16, 16),
              embed_dim=16, hidden_dim=32, n_hidden_layers=3, img_conv_channels=(2, 4),
              img_fc_sizes=(32,), use_tanh_activation=tanh)
    att = dict(depth=2, heads=2, dim_head=8, mlp_dim=16, hidden_dim=16)
    return (jcfg.NetConfig(attention=jcfg.AttentionConfig(**att) if attention else None, **kw),
            NetConfig(attention=AttentionConfig(**att) if attention else None, **kw))


def _obs(rng, B, img_hw):
    return {"lidar": rng.uniform(-1, 3, (B, 120)).astype(np.float32),
            "target": rng.normal(size=(B, 5)).astype(np.float32),
            "action_mask": rng.uniform(0, 1, (B, 42)).astype(np.float32),
            "img": rng.uniform(0, 1, (B, 3, img_hw, img_hw)).astype(np.float32)}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("attention,tanh", [(True, True), (False, False)])
def test_small_actor_carried_from_flax(attention, tanh):
    jc, tc = small_cfg(attention, tanh)
    rng = np.random.default_rng(7)
    obs = _obs(rng, 5, 16)
    net = JNet(jc)
    params = net.init(jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in obs.items()})
    # re-draw every leaf so biases and scales are not their zero / one inits
    leaves, tree = jax.tree.flatten(params)
    params = jax.tree.unflatten(tree, [rng.normal(size=x.shape).astype(np.float32) * 0.3
                                       for x in leaves])
    want = np.asarray(net.apply(params, {k: jnp.asarray(v) for k, v in obs.items()}))
    norm = {"mean": {}, "S": {}, "n": 0}
    actor, _ = actor_from_flax(_to_np(params), np.zeros((1, 2), np.float32), norm, tc,
                               device="cpu")
    with torch.no_grad():
        got = actor({k: T(v) for k, v in obs.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(want).max() > 0.1


def test_state_norm_and_sac_log_prob():
    """Welford update + normalize and the SAC gaussian log-prob, with the same
    observations and actions on both sides."""
    rng = np.random.default_rng(8)
    shape = {"lidar": (120,), "target": (5,), "img": (3, 4, 4)}
    jst = jnorm.NormState.create(shape)
    tst = NormState.create(shape)
    for b in (7, 13):
        batch = {"lidar": rng.normal(size=(b, 120)).astype(np.float32) * 3 + 2,
                 "target": rng.normal(size=(b, 5)).astype(np.float32),
                 "img": rng.normal(size=(b, 3, 4, 4)).astype(np.float32)}
        jst = jnorm.update(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst = norm_update(tst, {k: T(v) for k, v in batch.items()})
    for k in ("lidar", "target"):
        np.testing.assert_allclose(tst.mean[k].numpy(), np.asarray(jst.mean[k]), atol=1e-5)
        np.testing.assert_allclose(tst.S[k].numpy(), np.asarray(jst.S[k]), rtol=1e-5)
    assert int(tst.n) == int(jst.n) == 20
    got = normalize({k: T(v) for k, v in batch.items()}, tst)
    want = jnorm.normalize({k: jnp.asarray(v) for k, v in batch.items()}, jst)
    for k in batch:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5)

    mean = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    log_std = np.asarray([[-2.8, -3.1]], np.float32)
    action = np.clip(mean + rng.normal(size=(6, 2)).astype(np.float32) * 0.1, -1, 1)
    std = np.exp(log_std) * np.ones_like(mean)
    want = np.asarray(JSAC._log_prob(jnp.asarray(mean), jnp.asarray(std), jnp.asarray(action)))
    got = SACAgent._log_prob(T(mean), T(std), T(action)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-6)


def test_get_action_is_a_clipped_gaussian_around_the_mean():
    """The port's sampler (its noise comes from a torch.Generator, so it is
    checked by its law, not against JAX): clipped to [-1, 1], centred on the
    policy mean with the policy std, reproducible from the generator's seed."""
    class Const(torch.nn.Module):
        def forward(self, obs):
            return torch.full((obs["lidar"].shape[0], 2), 0.3)

    agent = SACAgent(Const(), SACConfig(state_norm=False))
    st = ActorState(log_std=torch.tensor([[-2.0, -2.0]]), norm=None)
    obs = {"lidar": torch.zeros(20000, 1)}
    a, logp = agent.get_action(st, obs, torch.Generator().manual_seed(3))
    b, _ = agent.get_action(st, obs, torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and a.abs().max() <= 1.0
    assert abs(float(a.mean()) - 0.3) < 0.01
    assert abs(float(a.std()) - np.exp(-2.0)) < 0.005
    np.testing.assert_allclose(logp.numpy(), agent.log_prob(st, obs, a).numpy(), rtol=1e-6)
