"""The port's PPO slice against the JAX package's, on the CPU: the masked
action sampler, the three policy families, the update, one whole training
chunk, the committed r5 actor, the train_ppo CLI and the PPO battery.

``hope_tpu_torch/assets/ppo_r5_actor.npz`` is exported from the orbax
checkpoint ``results/ckpt_ppo_r5`` by this module:

    JAX_PLATFORMS=cpu python -m tests.test_torch_ppo --export

Inputs come from numpy seeds; the draws the two packages make differently
(jax.random keys vs torch generators) are made with jax.random and injected
into the port: the Gumbel noise of the categorical draws and the update's
permutations. Tolerances are stated per test: float32 throughout, so a value
computed by the same operations in another order differs by ~1e-7 relative
per operation.
"""
import dataclasses
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu import config as jc
from hope_tpu.agents import HybridState as JHybrid
from hope_tpu.agents import PPOAgent as JPPO
from hope_tpu.agents.state_norm import NormState as JNorm
from hope_tpu.config import ObsConfig, PPOConfig, actor_net_config, critic_net_config
from hope_tpu.envs.action_mask import build_table as jbuild_table
from hope_tpu.envs.action_mask import choose_action as jchoose
from hope_tpu.train.chunked import build_ppo_chunk as jbuild_chunk
from hope_tpu_torch import config as tc
from hope_tpu_torch.agents import HybridState, PPOAgent
from hope_tpu_torch.envs import Scene
from hope_tpu_torch.envs.action_mask import build_table, choose_action
from hope_tpu_torch.models.convert import load_ppo_actor_npz, ppo_state_from_flax
from hope_tpu_torch.train.chunked import PPOChunkDraws, build_ppo_chunk

from .test_torch_train import _chunk_setup, assert_net, assert_tree, envs, pool  # noqa: F401
from .test_torch_train import rand_obs, small, to_tc
from .test_torch_weights import actor_arrays
from .torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
FIELDS = [f.name for f in dataclasses.fields(Scene)]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "results", "ckpt_ppo_r5")
NPZ = os.path.join(ROOT, "hope_tpu_torch", "assets", "ppo_r5_actor.npz")
FAMILIES = ["gaussian", "beta", "categorical"]
SHAPE = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
FULL_SHAPE = {"lidar": (120,), "action_mask": (42,), "img": (3, 64, 64), "target": (5,)}


@pytest.fixture(scope="module")
def tables():
    """(JAX, port) action-mask tables."""
    return jbuild_table(), build_table(device="cpu")


def agents(dist_type, tables, obs_cfg=ObsConfig(img_size=16), shape=SHAPE, **kw):
    """(JAX agent, port agent) with narrow nets."""
    cfg = dict(dist_type=dist_type, **kw)
    acfg = small(actor_net_config(obs_cfg), jc)
    ccfg = small(critic_net_config(obs_cfg), jc)
    return (JPPO(acfg, ccfg, PPOConfig(**cfg), shape, tables[0]),
            PPOAgent(to_tc(acfg), to_tc(ccfg), tc.PPOConfig(**cfg), tables[1]))


def random_ppo_state(agent: JPPO, rng, scale=0.1):
    """A JAX PPOState with every parameter drawn N(0, scale^2) from ``rng``
    (a target 0.01 off the critic), fresh optimizers and statistics (no JAX
    init to compile)."""
    shapes = jax.eval_shape(agent.init, jax.random.PRNGKey(0))

    def draw(s):
        return jnp.asarray((scale * rng.normal(size=s.shape)).astype(np.float32))

    actor, critic = (jax.tree.map(draw, getattr(shapes, n)) for n in ("actor", "critic"))
    log_std = jnp.asarray(rng.uniform(-0.5, 0.0, (1, 2)).astype(np.float32))
    return shapes.replace(
        actor=actor, log_std=log_std, critic=critic,
        critic_target=jax.tree.map(lambda x: x + 0.01, critic),
        opt_actor=agent.tx_actor.init((actor, log_std)), opt_critic=agent.tx_critic.init(critic),
        norm=JNorm.create(agent.obs_shape), steps=jnp.zeros((), jnp.int32))


def obs_pair(rng, B, img=16):
    o = rand_obs(rng, B, img=img)
    return {k: jnp.asarray(v) for k, v in o.items()}, {k: T(v) for k, v in o.items()}


def with_norm(jst, rng, B=16):
    """``jst`` with observation statistics folded from B random observations
    (so that acting normalizes by a real spread)."""
    from hope_tpu.agents.state_norm import update as jnorm_update

    o, _ = obs_pair(rng, B)
    return jst.replace(norm=jnorm_update(jst.norm, o))


def family_states(dist_type, tables, seed, **kw):
    """(JAX agent, port agent, JAX state, port state) from one numpy seed."""
    ja, ta = agents(dist_type, tables, **kw)
    rng = np.random.default_rng(seed)
    jst = with_norm(random_ppo_state(ja, rng), rng)
    return ja, ta, jst, ppo_state_from_flax(jax.tree.map(np.asarray, jst), ta, "cpu")


# ----------------------------------------------------------------- acting

def test_mask_choose_action_matches_jax(tables):
    """The batched sampler against the JAX package's per-env one, with the
    JAX Gumbel noise replayed: identical indices and actions (B = 64, random
    masks with a few all-zero rows, moments in and beyond [-1, 1])."""
    rng = np.random.default_rng(11)
    B = 64
    mean = rng.uniform(-1.5, 1.5, (B, 2)).astype(np.float32)
    std = rng.uniform(0.05, 1.0, (B, 2)).astype(np.float32)
    mask = (rng.uniform(size=(B, 42)) * (rng.uniform(size=(B, 42)) < 0.6)).astype(np.float32)
    mask[:3] = 0.0
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want_a, want_i = jax.vmap(lambda k, m, s, mk: jchoose(k, m, s, mk, tables[0]))(
        keys, mean, std, mask)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (42,)))(keys)
    got_a, got_i = choose_action(T(mean), T(std), T(mask), tables[1], noise=T(np.asarray(noise)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert len(np.unique(np.asarray(want_i))) > 10          # not a degenerate draw


@pytest.mark.parametrize("dist_type", FAMILIES)
def test_agent_choose_action_matches_jax(dist_type, tables):
    """PPOAgent.choose_action with JAX's Gumbel noise replayed (per env from
    split keys for gaussian and beta, one (B, 42) draw for categorical):
    identical indices, log-probs to 1e-5 (one float32 forward pass in another
    reduction order)."""
    ja, ta, jst, tst = family_states(dist_type, tables, 12)
    rng = np.random.default_rng(13)
    B = 24
    jo, to = obs_pair(rng, B)
    key = jax.random.PRNGKey(7)
    want_a, want_lp = ja.choose_action(jst, jo, key)
    if dist_type == "categorical":
        noise = jax.random.gumbel(key, (B, 42))
    else:
        noise = jax.vmap(lambda k: jax.random.gumbel(k, (42,)))(jax.random.split(key, B))
    got_a, got_lp = ta.choose_action(tst, to, noise=T(np.asarray(noise)))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-5, rtol=1e-5)
    assert len(np.unique(np.asarray(want_a), axis=0)) > 3


@pytest.mark.parametrize("dist_type", FAMILIES)
def test_acting_matches_jax(dist_type, tables):
    """Raw head, log_prob of given actions (continuous ones for categorical,
    snapped to the nearest table action), entropy and, for gaussian and beta,
    the moments: to 1e-5 (absolute and relative; lgamma / digamma of the
    beta family through other float32 approximations). get_action: its
    log-prob equals log_prob of its action; the draws are held to their
    distribution: beta sample means and variances (3000 draws for each of 3
    envs) within
    5 standard errors of Beta(a, b)'s, categorical frequencies within 5
    standard errors of softmax(raw), gaussian actions are the clipped mean +
    std * N(0, 1) (standardized residuals of unclipped draws: mean 0, std 1
    within 5 standard errors)."""
    ja, ta, jst, tst = family_states(dist_type, tables, 14)
    rng = np.random.default_rng(15)
    B = 12
    jo, to = obs_pair(rng, B)
    act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    act[0] = np.asarray(tables[0].actions_norm)[3]             # on a table action
    act[1] = (np.asarray(tables[0].actions_norm)[3] + np.asarray(tables[0].actions_norm)[4]) / 2
    @jax.jit
    def ref(st, o, a):
        raw = ja._raw(st.actor, st, o)
        moments = ja._moments(raw, st.log_std) if dist_type != "categorical" else ()
        return raw, ja.log_prob(st, o, a), ja._entropy(raw, st.log_std), moments

    raw_j, lp_j, ent_j, mom_j = ref(jst, jo, jnp.asarray(act))
    raw_t = ta._raw(tst.actor, tst.norm, to).detach()
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ta.log_prob(tst, to, T(act)).numpy(), np.asarray(lp_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ta._entropy(raw_t, tst.log_std.detach()).numpy(),
                               np.asarray(ent_j), atol=1e-5, rtol=1e-5)
    if dist_type != "categorical":
        for g, w in zip(ta._moments(raw_t, tst.log_std.detach()), mom_j):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-5)

    gen = torch.Generator().manual_seed(16)
    a, lp = ta.get_action(tst, to, gen)
    assert a.shape == (B, 2) and a.abs().max() <= 1.0
    np.testing.assert_allclose(lp.numpy(), ta.log_prob(tst, to, a).numpy(), atol=1e-6)
    n, B = 3000, 3
    raw_t = raw_t[:B]
    big = {k: v[:B].repeat_interleave(n, dim=0) for k, v in to.items()}
    draws = ta.get_action(tst, big, gen)[0].reshape(B, n, 2).double()
    if dist_type == "beta":
        from hope_tpu_torch.agents.ppo import _beta_params

        al, be = (x.double() for x in _beta_params(raw_t))
        x = (draws + 1) / 2
        mu = al / (al + be)
        var = al * be / ((al + be) ** 2 * (al + be + 1))
        assert ((x.mean(1) - mu).abs() <= 5 * (var / n).sqrt()).all()
        m4 = 3 * var ** 2                      # at most a normal's fourth moment
        assert ((x.var(1) - var).abs() <= 5 * (m4 / n).sqrt()).all()
    elif dist_type == "categorical":
        table = tables[1].actions_norm.double()
        idx = torch.argmin(((draws[..., None, :] - table) ** 2).sum(-1), dim=-1)
        freq = torch.nn.functional.one_hot(idx, 42).double().mean(1)
        p = torch.softmax(raw_t.double(), -1)
        assert ((freq - p).abs() <= 5 * (p * (1 - p) / n).sqrt() + 1e-12).all()
    else:
        mean, std = (x.double() for x in ta._moments(raw_t, tst.log_std.detach()))
        z = (draws - mean[:, None]) / std[:, None]
        free = draws.abs() < 1.0
        zs = z[free]
        assert abs(float(zs.mean())) < 5 / math.sqrt(zs.numel())
        # clipping cuts the tails: the unclipped residuals have std <= 1
        assert 0.5 < float(zs.std()) <= 1.0 + 5 / math.sqrt(zs.numel())


def test_softplus_without_linear_branch():
    """jax.nn.softplus is logaddexp(x, 0); torch's softplus turns linear above
    20 and differs there by ~2e-9 relative. The port's beta head uses
    logaddexp: equal to JAX's softplus at and around 20 to float32 rounding."""
    from hope_tpu_torch.agents.ppo import _softplus

    x = np.linspace(-30, 40, 701).astype(np.float32)
    np.testing.assert_allclose(_softplus(T(x)).numpy(), np.asarray(jax.nn.softplus(x)),
                               rtol=2e-7, atol=0)


# ----------------------------------------------------------------- update

def tiny_buffer(ja, jst, tables, rng, dist_type, Tn=4, B=6):
    """A (T, B) buffer of random normalized observations, actions (table
    actions for categorical), rewards and dones, its log_prob the actor's
    own (so that the first minibatch's KL is ~0)."""
    buf = {}
    for p in ("obs", "next_obs"):
        o = rand_obs(rng, Tn * B, prefix=p + "/")
        buf.update({k: v.reshape((Tn, B) + v.shape[1:]) for k, v in o.items()})
    if dist_type == "categorical":
        act = np.asarray(tables[0].actions_norm)[rng.integers(0, 42, (Tn, B))]
    else:
        act = rng.uniform(-0.9, 0.9, (Tn, B, 2))
    buf["action"] = act.astype(np.float32)
    o = {k[4:]: jnp.asarray(v.reshape((Tn * B,) + v.shape[2:]))
         for k, v in buf.items() if k.startswith("obs/")}
    raw = ja.actor_net.apply(jst.actor, o)
    buf["log_prob"] = np.asarray(ja._logp_of(raw, jst.log_std, jnp.asarray(
        buf["action"].reshape(-1, 2)))).reshape(Tn, B)
    buf["reward"] = (5 * rng.normal(size=(Tn, B))).astype(np.float32)
    buf["done"] = rng.uniform(size=(Tn, B)) < 0.2
    return buf


def assert_ppo_state(tst, jst, ta, atol=1e-5, lr=1e-3):
    """Every parameter (ADAM_NOISE as test_torch_train), log_std, the update
    count and both Adams' counts against the JAX state."""
    from hope_tpu_torch.agents.ppo import adam_count

    assert_net(tst.actor, jst.actor["params"], ta.actor_cfg, atol, err="actor", lr=lr)
    for n in ("critic", "critic_target"):
        assert_net(getattr(tst, n), getattr(jst, n)["params"], ta.critic_cfg, atol, err=n, lr=lr)
    np.testing.assert_allclose(tst.log_std.detach().numpy(), np.asarray(jst.log_std), atol=1e-6)
    assert tst.steps == int(jst.steps)
    assert adam_count(tst.opt_actor) == int(jst.opt_actor[0].count)
    assert adam_count(tst.opt_critic) == int(jst.opt_critic[0].count)


# with lr 1e-3 this target trips each family's KL guard after 1-3 applied
# minibatches of 8 (gaussian after 2, beta after 3, categorical after 1);
# every family's trip point holds for targets from 0.002 to 0.02, so the
# decision has a wide margin against rounding
TARGET_KL = 0.01


@pytest.mark.parametrize("dist_type", FAMILIES)
def test_ppo_update_matches_jax(dist_type, tables):
    """One full-buffer update per family at a small size (T = 4, B = 6,
    minibatch 6, 2 epochs, image tower at 16x16, lr 1e-3), with JAX's
    permutations injected, gradient_clip on and a target_kl that trips mid-
    pass: the minibatch that overshoots is not applied and both Adams stop
    counting (their counts equal JAX's), the target's per-epoch Polyak update
    goes on; metrics to 1e-5 relative (1e-6 absolute), kl_stopped exactly,
    every parameter to 1e-5 (ADAM_NOISE as test_torch_train)."""
    kw = dict(mini_batch=6, mini_epoch=2, lr_actor=1e-3, lr_critic=1e-3, gradient_clip=True,
              target_kl=TARGET_KL)
    ja, ta, jst, tst = family_states(dist_type, tables, 1, **kw)
    buf = tiny_buffer(ja, jst, tables, np.random.default_rng(2), dist_type)
    key = jax.random.PRNGKey(3)
    perms = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(key, e), 24))
                      for e in range(2)])
    jst, jm = ja.update(jst, {k: jnp.asarray(v) for k, v in buf.items()}, key)
    tm = ta.update(tst, {k: T(v) for k, v in buf.items()}, perms=T(perms))
    assert float(jm["kl_stopped"]) == float(tm["kl_stopped"]) == 1.0
    assert 0 < int(jst.opt_actor[0].count) < 8                  # tripped mid-pass
    for k in ("actor_loss", "critic_loss", "approx_kl"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), k
    assert_ppo_state(tst, jst, ta)


def test_gradient_clip_is_global_norm():
    """The clip scales all gradients of a group by min(1, 0.5 / max(norm,
    1e-9)) of their joint norm, exactly as the JAX package's clip_gn (no 1e-6
    added, unlike clip_grad_norm_); gradients below the norm stay as they
    are."""
    from hope_tpu_torch.agents.ppo import PPOAgent as P

    rng = np.random.default_rng(4)
    for scale in (3.0, 0.01):
        gs = [scale * rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,), (1, 2))]
        ps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
        for p, g in zip(ps, gs):
            p.grad = T(g.copy())
        P._clip_global_norm(ps)
        gn = jnp.sqrt(sum(jnp.sum(jnp.asarray(g) ** 2) for g in gs))
        s = jnp.minimum(1.0, 0.5 / jnp.maximum(gn, 1e-9))
        for p, g in zip(ps, gs):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(g * s), rtol=1e-6, atol=0)


# -------------------------------------------------------------- the chunk

def _ppo_chunk_setup(pool):
    """test_sac_chunk_matches_jax's scenes with env 1's start moved 1 cm off
    the obstacle edge it sits on: with the rear axle exactly on an edge, the
    lidar beams along it hit at t = 0 or miss by the last place of a float32
    product (JAX reads 10 m on a beam where the port reads 0; the SAC chunk's
    ring overwrites that first transition, the PPO buffer keeps it)."""
    js, _ = _chunk_setup(pool)
    start = np.array(js.start)
    e = np.asarray(js.edges[1])[np.asarray(js.edge_mask[1])][0]
    n = np.array([e[1] - e[3], e[2] - e[0]]) / math.hypot(e[2] - e[0], e[3] - e[1])
    start[1, :2] += 0.01 * n
    js = js.replace(start=jnp.asarray(start))
    return js, Scene.from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu")


def test_ppo_chunk_matches_jax(pool, envs, tables):
    """One PPO chunk (B = 4, T = 8 collect steps, then the update of the
    (8, 4) buffer: minibatch 8, 2 epochs, lr 1e-3) against build_ppo_chunk,
    with JAX's Gumbel noise per step and permutations per epoch replayed into
    the port, on test_sac_chunk_matches_jax's set-up (env 0 starts on its
    destination and arrives within the chunk; env 1, moved 1 cm off the
    obstacle edge it starts on (see _ppo_chunk_setup), ends at its first
    step):
    the (T, B) logs (done, status, pool
    index exactly; reward to 1e-3 as test_rollout_matches_jax), the env and
    hybrid state after the chunk (poses 1e-4, observations 2e-3), the
    observation statistics (1e-3 absolute or 1e-4 relative, as the SAC
    chunk), the update's metrics (1e-4 relative: the critic passes see lidar
    normalized from those statistics) and every parameter (1e-5, ADAM_NOISE
    as test_torch_train)."""
    js, ts = _ppo_chunk_setup(pool)
    B, K = 4, 8
    jcfg, tcfg, jenv, tenv = envs
    obs_cfg = jcfg.obs
    kw = dict(mini_batch=8, mini_epoch=2, lr_actor=1e-3, lr_critic=1e-3)
    ja = JPPO(small(actor_net_config(obs_cfg), jc), small(critic_net_config(obs_cfg), jc),
              PPOConfig(**kw), jenv.observation_shape, jenv.mask_table)
    ta = PPOAgent(to_tc(ja.actor_net.cfg), to_tc(ja.critic_net.cfg), tc.PPOConfig(**kw),
                  tenv.mask_table)
    jst = random_ppo_state(ja, np.random.default_rng(8))
    tst = ppo_state_from_flax(jax.tree.map(np.asarray, jst), ta, "cpu")

    pool_idx = np.arange(B, dtype=np.int32)
    jstate, jobs = jax.jit(jenv.batch_reset)(jax.tree.map(lambda x: x[:B], js))
    tstate, tobs = tenv.batch_reset(ts.map(lambda x: x[:B]))
    queue = (np.arange(B * K, dtype=np.int32) + 4) % 10
    key = jax.random.PRNGKey(12)
    out = jbuild_chunk(jenv, ja, jcfg.step_ratio, K)(
        jst, jstate, JHybrid.create(B, jcfg.rs_queue_len), jobs, jnp.asarray(pool_idx), js,
        jnp.asarray(queue), key)
    jst, jstate, jhyb, jobs, jpool_idx, jlogs, jm = out

    # JAX's draws, as build_ppo_chunk makes them
    step_keys = jax.random.split(jax.random.fold_in(key, 0), K)
    gumbel = np.stack([np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (42,)))(
        jax.random.split(k, B))) for k in step_keys])
    ukey = jax.random.fold_in(key, 1)
    perms = np.stack([np.asarray(jax.random.permutation(jax.random.fold_in(ukey, e), B * K))
                      for e in range(2)])
    chunk = build_ppo_chunk(tenv, ta, tcfg.step_ratio, K)
    (_, tstate, thyb, tobs, tpool_idx, tlogs, tm, tbuf) = chunk(
        tst, tstate, HybridState.create(B, tcfg.rs_queue_len), tobs, T(pool_idx), ts,
        T(queue), None, draws=PPOChunkDraws(gumbel=T(gumbel), perms=T(perms)))

    for k in ("done", "status", "pool_idx"):
        np.testing.assert_array_equal(tlogs[k].numpy(), np.asarray(jlogs[k]), err_msg=k)
    np.testing.assert_allclose(tlogs["reward"].numpy(), np.asarray(jlogs["reward"]), atol=1e-3)
    assert tlogs["done"][:, 0].any() and tlogs["done"][0, 1]        # the reset path ran
    np.testing.assert_array_equal(tpool_idx.numpy(), np.asarray(jpool_idx))
    assert {k: tuple(v.shape) for k, v in tbuf.items()} == {
        **{f"{p}/{k}": (K, B) + s for p in ("obs", "next_obs")
           for k, s in jenv.observation_shape.items()},
        "action": (K, B, 2), "reward": (K, B), "done": (K, B), "log_prob": (K, B)}
    assert_tree(tstate.vehicle, jstate.vehicle, 1e-4, "vehicle")
    for k in ("t", "status"):
        np.testing.assert_array_equal(getattr(tstate, k).numpy(), np.asarray(getattr(jstate, k)))
    assert_tree(thyb, jhyb, 1e-4, "hybrid")
    assert_tree(tobs, jobs, 2e-3, "obs")
    for part in ("mean", "S"):
        for k, v in getattr(tst.norm, part).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(getattr(jst.norm, part)[k]),
                                       atol=1e-3, rtol=1e-4, err_msg=f"norm {part} {k}")
    assert int(tst.norm.n) == int(jst.norm.n) == B * K
    for k in ("actor_loss", "critic_loss", "approx_kl", "kl_stopped"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-5), k
    assert_ppo_state(tst, jst, ta)


# ---------------------------------------------------------------- r5 actor

def restore_r5():
    """(JAX agent, restored PPOState) of the committed checkpoint: the full
    observation, ``PPOConfig()`` (gaussian; the run's clip and KL guard do
    not change the state's structure)."""
    from hope_tpu.utils.checkpoint import load_checkpoint

    obs = ObsConfig()
    agent = JPPO(actor_net_config(obs), critic_net_config(obs), PPOConfig(), FULL_SHAPE, None)
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    abstract = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=one),
        jax.eval_shape(agent.init, jax.random.PRNGKey(0)))
    return agent, load_checkpoint(CKPT, abstract)


def export(path: str = NPZ):
    _, st = restore_r5()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **actor_arrays(st))
    return path


@pytest.fixture(scope="module")
def r5():
    return restore_r5()


def test_r5_npz_equals_checkpoint(r5):
    """The npz holds exactly the checkpoint's actor, log_std and normalizer."""
    _, st = r5
    want = actor_arrays(st)
    with np.load(NPZ) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(want["norm/n"]) > 10 ** 6                       # a trained normalizer


def test_r5_actor_matches_jax(r5, tables):
    """The carried r5 actor against the JAX actor on the same observations:
    the raw head (the clamped gaussian mean) and the log-prob of given
    actions to 1e-5 (float32, reductions in other orders), std exactly as
    exp(log_std); and the masked choose_action with JAX's Gumbel noise
    replayed picks the same table actions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    agent, st = r5
    agent.mask_table = tables[0]
    rng = np.random.default_rng(3)
    B = 6
    obs = {"lidar": rng.uniform(-2, 10, (B, 120)).astype(np.float32),
           "action_mask": rng.uniform(0, 1, (B, 42)).astype(np.float32),
           "img": (rng.uniform(0, 1, (B, 3, 64, 64)) > 0.7).astype(np.float32),
           "target": rng.normal(size=(B, 5)).astype(np.float32)}
    act = rng.uniform(-1, 1, (B, 2)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jo = {k: jnp.asarray(v) for k, v in obs.items()}
    raw_j = agent._raw(st.actor, st, jo)
    lp_j = agent.log_prob(st, jo, jnp.asarray(act))
    a_j, _ = agent.choose_action(st, jo, key)

    obs_cfg = tc.ObsConfig()
    ta = PPOAgent(tc.actor_net_config(obs_cfg), tc.critic_net_config(obs_cfg), tc.PPOConfig(),
                  tables[1])
    actor = load_ppo_actor_npz(NPZ, ta, "cpu")
    to = {k: T(v) for k, v in obs.items()}
    raw_t = ta._raw(actor.actor, actor.norm, to).detach()
    np.testing.assert_allclose(raw_t.numpy(), np.asarray(raw_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(actor.log_std.numpy(), np.asarray(st.log_std))
    np.testing.assert_allclose(ta.log_prob(actor, to, T(act)).numpy(), np.asarray(lp_j),
                               atol=1e-5, rtol=1e-5)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (42,)))(jax.random.split(key, B))
    a_t, _ = ta.choose_action(actor, to, noise=T(np.asarray(noise)))
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    assert np.abs(np.asarray(raw_j)).max() > 0.05               # not a degenerate comparison



# ------------------------------------------------------------------- CLIs

def test_train_ppo_cli_smoke_on_cpu(tmp_path, capsys):
    """--smoke --device cpu runs 3 chunks of 8 steps x 4 envs (2 epochs of
    minibatch 8 each), prints the JAX CLI's keys, writes config.json,
    metrics.jsonl and a checkpoint that loads back."""
    import json

    from hope_tpu_torch.train import train_ppo
    from hope_tpu_torch.utils.checkpoint import load_checkpoint

    res = train_ppo.main(["--smoke", "--device", "cpu", "--max-chunks", "3", "--no-tensorboard",
                          "--log-dir", str(tmp_path)])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    logs = [x for x in lines if "chunk" in x]
    assert [x["chunk"] for x in logs] == [1, 2, 3]
    for x in logs:
        assert {"chunk", "episodes", "steps", "reward", "success", "actor_loss", "critic_loss",
                "elapsed", "approx_kl", "kl_stopped"} <= set(x)
        assert math.isfinite(x["actor_loss"]) and math.isfinite(x["critic_loss"])
    assert set(logs[0]["success"]) == {"Normal", "Complex", "Extrem", "dlp"}
    assert [r["sgd_steps"] for r in res["chunks"]] == [8, 8, 8]
    loop = res["loop"]
    st = loop["state"]
    assert st.steps == 3 and int(st.norm.n) == 3 * 32
    from hope_tpu_torch.agents.ppo import adam_count

    assert adam_count(st.opt_actor) == adam_count(st.opt_critic) == 3 * 8
    assert loop["buffer"]["reward"].shape == (8, 4)
    cfg = json.loads((tmp_path / "config.json").read_text())
    assert cfg["ppo"]["mini_batch"] == 8 and cfg["ppo"]["mini_epoch"] == 2
    assert (tmp_path / "metrics.jsonl").exists()
    before = st.critic.state_dict()["fusion.fc2.weight"].clone()
    with torch.no_grad():
        st.critic.fusion.fc2.weight.add_(1.0)
        st.log_std.add_(1.0)
    load_checkpoint(str(tmp_path / "ckpt"), st)
    assert torch.equal(st.critic.state_dict()["fusion.fc2.weight"], before)
    assert float(st.log_std.detach().abs().max()) < 1.0 and st.steps == 3
    assert adam_count(st.opt_actor) == 3 * 8


@pytest.mark.parametrize("argv,says", [
    (["--devices", "3", "--batch-envs", "4"], "divisible by --devices"),
    (["--devices", "0"], "at least 1"),
    (["--num-processes", "2", "--process-id", "0"], "needs --coordinator"),
    (["--num-processes", "2", "--process-id", "2", "--coordinator", "h:1"], "--process-id"),
    (["--devices", "3", "--num-processes", "2", "--process-id", "0", "--coordinator", "h:1"],
     "not a multiple of --num-processes")])
def test_train_ppo_cli_refuses_bad_parallel_flags(argv, says, capsys):
    """The multi-process flags' checks (JAX's divisibility of --batch-envs by
    --devices, and the launch's own), before any work."""
    from hope_tpu_torch.train import train_ppo

    with pytest.raises(SystemExit) as e:
        train_ppo.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def test_train_ppo_cli_defaults_to_cuda():
    from hope_tpu_torch.train import train_ppo

    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ppo.main(["--smoke"])


def test_eval_cli_ppo_one_level_on_cpu(tmp_path):
    """The port's eval_mix_scene takes the PPO actor by its file name (the
    masked choose_action, once a step) and runs one level (tiny) on the
    CPU."""
    from hope_tpu_torch.evaluation import eval_mix_scene
    from hope_tpu_torch.agents import PPOAgent as P

    calls = []
    orig = P.choose_action

    def spy(self, *a, **k):
        calls.append(1)
        return orig(self, *a, **k)

    P.choose_action = spy
    try:
        res = eval_mix_scene.main([NPZ, "--episodes", "2", "--max-steps", "3", "--device", "cpu",
                                   "--levels", "Normal", "--out", str(tmp_path)])
    finally:
        P.choose_action = orig
    assert list(res) == ["Normal"] and res["Normal"]["n"] == 2
    assert len(calls) == 3 and (tmp_path / "result_Normal.json").exists()
    assert eval_mix_scene.agent_type_of(NPZ) == "ppo"


if __name__ == "__main__":
    if "--export" not in sys.argv:
        sys.exit("usage: python -m tests.test_torch_ppo --export")
    print(export())
