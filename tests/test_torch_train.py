"""The port's SAC training slice against the JAX package's, on the CPU:
the critic and its init, the lr schedule, the replay ring, the auto-reset
pieces, three SAC updates, one whole training chunk, and the CLIs.

Inputs come from numpy seeds; random draws the two packages make differently
(jax.random keys vs torch generators) are made once with jax.random and
injected into the port. Tolerances are stated per test: float32 throughout,
so a value computed by the same operations in another order (XLA's and
torch's reductions, matrix products and convolutions) differs by ~1e-7
relative per operation.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hope_tpu import config as jc
from hope_tpu.agents import SACAgent as JSAC
from hope_tpu.agents import HybridState as JHybrid
from hope_tpu.agents import hybrid_reset_done as jreset_done
from hope_tpu.agents import replay as jreplay
from hope_tpu.agents.schedules import lr_schedule as jlr_schedule
from hope_tpu.agents.state_norm import NormState as JNorm
from hope_tpu.config import EnvConfig, ObsConfig, SACConfig
from hope_tpu.config import actor_net_config, critic_net_config
from hope_tpu.envs import ParkingEnv as JEnv
from hope_tpu.envs.scene import Scene as JScene
from hope_tpu.models import Critic as JCritic
from hope_tpu.train.chunked import build_sac_chunk as jbuild_chunk
from hope_tpu.train.scene_pool import pad_scene_batch as jpad
from hope_tpu_torch import config as tc
from hope_tpu_torch.agents import HybridState, SACAgent, replay
from hope_tpu_torch.agents import hybrid_reset_done
from hope_tpu_torch.agents.schedules import lr_schedule
from hope_tpu_torch.envs import ParkingEnv, Scene
from hope_tpu_torch.models import Critic, MultiObsEmbedding
from hope_tpu_torch.models.convert import _torch_state, critic_from_flax, sac_state_from_flax
from hope_tpu_torch.train.chunked import ChunkDraws, build_sac_chunk

from .test_torch_ops import SCENES_NPZ, SCENE_FIELDS
from .test_torch_weights import NPZ
from .torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
FIELDS = [f.name for f in dataclasses.fields(Scene)]



def small(cfg, module=None):
    """A narrow copy of a NetConfig (either package's)."""
    att = (module or tc).AttentionConfig(depth=1, heads=2, dim_head=8, mlp_dim=32, hidden_dim=32)
    return dataclasses.replace(cfg, embed_dim=32, hidden_dim=32, img_fc_sizes=(32,),
                               attention=att)


def to_tc(cfg):
    """The port's NetConfig with the same fields as a JAX one."""
    d = dataclasses.asdict(cfg)
    att = d.pop("attention")
    return tc.NetConfig(**d, attention=att and tc.AttentionConfig(**att))


def rand_obs(rng, B, img=16, prefix=""):
    return {f"{prefix}lidar": rng.normal(size=(B, 120)).astype(np.float32),
            f"{prefix}action_mask": rng.uniform(size=(B, 42)).astype(np.float32),
            **({f"{prefix}img": (rng.integers(0, 256, (B, 3, img, img)) / 255).astype(np.float32)}
               if img else {}),
            f"{prefix}target": rng.normal(size=(B, 5)).astype(np.float32)}


def random_sac_state(agent: JSAC, rng, scale=0.1):
    """A JAX SACState with every parameter drawn N(0, scale^2) from ``rng``
    and fresh optimizers (no JAX init to compile)."""
    shapes = jax.eval_shape(agent.init, jax.random.PRNGKey(0))

    def draw(s):
        return jnp.asarray((scale * rng.normal(size=s.shape)).astype(np.float32))

    actor, c1, c2 = (jax.tree.map(draw, getattr(shapes, n))
                     for n in ("actor", "critic1", "critic2"))
    log_std = jnp.asarray(rng.uniform(-0.5, 0.0, (1, 2)).astype(np.float32))
    log_alpha = jnp.asarray(math.log(0.05), jnp.float32)
    return shapes.replace(
        actor=actor, log_std=log_std, critic1=c1, critic2=c2,
        target1=jax.tree.map(lambda x: x + 0.01, c1), target2=jax.tree.map(lambda x: x - 0.01, c2),
        log_alpha=log_alpha, opt_actor=agent.tx_actor.init((actor, log_std)),
        opt_critic1=agent.tx_critic.init(c1), opt_critic2=agent.tx_critic.init(c2),
        opt_alpha=agent.tx_alpha.init(log_alpha), norm=JNorm.create(agent.obs_shape),
        steps=jnp.zeros((), jnp.int32))


# Adam's step is lr * g / (|g| + eps) on the first update: where a gradient
# entry is itself at float32 rounding level (|g| ~ 1e-9, eps = 1e-8; measured:
# one entry of 27k, g = -3e-9), a rounding difference dg ~ 1e-9 between the two
# frameworks moves that entry by up to lr * dg / eps = 0.1 lr. Such entries
# may differ by ADAM_NOISE * lr; all others must meet the test's atol, and at
# most 1 in 10^4 entries may need the looser bound.
ADAM_NOISE = 0.1


def assert_net(module, flax_tree, cfg, atol, prefix="", err="", lr=0.0):
    """Every parameter of ``module`` against the Flax tree's, in torch layout
    (after Adam steps at rate ``lr``: see ADAM_NOISE)."""
    sd = module.state_dict()
    n = n_loose = 0
    for k, v in _torch_state(jax.tree.map(np.asarray, flax_tree), cfg).items():
        d = np.abs(sd[prefix + k].cpu().numpy() - v)
        assert d.max() <= max(atol, ADAM_NOISE * lr), (err, k, d.max())
        n, n_loose = n + d.size, n_loose + int((d > atol).sum())
    assert n_loose <= 1e-4 * n, (err, n_loose, n)


# ------------------------------------------------------------------ critic

def test_critic_forward_matches_flax():
    """A small Flax Critic carried over by critic_from_flax gives the same
    Q on the same observations and actions, to 1e-5 (float32, products and
    convolutions in another order)."""
    obs_cfg = ObsConfig(img_size=16)
    cfg = small(critic_net_config(obs_cfg, action_input=True), jc)
    rng = np.random.default_rng(0)
    net = JCritic(cfg)
    obs = rand_obs(rng, 8)
    act = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), obs, act)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.2, shapes)
    want = np.asarray(net.apply(params, obs, act))
    got = critic_from_flax(params, to_tc(cfg), "cpu")({k: T(v) for k, v in obs.items()}, T(act))
    assert got.shape == (8, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=0)


def _kernel(w):
    """A torch weight (out, in[, kh, kw]) as a (fan_in, out) matrix, the Flax
    kernel's layout."""
    return w.reshape(w.shape[0], -1).T


def _is_orthogonal(k):
    """Orthonormal columns where in >= out, orthonormal rows otherwise."""
    g = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
    return np.abs(g - np.eye(len(g))).max() < 1e-5


def test_fresh_init_matches_flax():
    """The port's fresh Critic at full width (every layer kind of both nets)
    against a Flax init: the same 15 Dense kernels orthogonal on the Flax
    (in, out) layout, every bias 0, LayerNorm scale 1. The other 7 kernels
    (convolutions, image fc and heads) are truncated lecun-normal: pooled
    over 40 fresh image towers, each kernel's std is within 10% of
    sqrt(1 / fan_in) (the smallest, 12 values a draw, has a sampling error of
    ~3% over 480) and no value lies beyond the truncation at 2 std; Flax's
    own draw is within 10% where it has >= 1000 values."""
    from hope_tpu_torch.models.policy import ImgEncoder, flax_init_

    cfg = critic_net_config(ObsConfig(), action_input=True)
    flax = jax.jit(JCritic(cfg).init)(jax.random.PRNGKey(0), rand_obs(
        np.random.default_rng(0), 1, img=64), jnp.zeros((1, 2)))
    ref = _torch_state(jax.tree.map(np.asarray, flax)["params"]["net"], cfg)
    port = {k[4:]: v.numpy() for k, v in
            Critic(to_tc(cfg), torch.Generator().manual_seed(0)).state_dict().items()}
    assert set(port) == set(ref)
    lecun = []
    for k, w in port.items():
        f = ref[k]
        if k.endswith("bias"):
            assert not w.any() and not f.any(), k
        elif w.ndim == 1:                                       # LayerNorm scale
            assert (w == 1).all() and (f == 1).all(), k
        elif _is_orthogonal(_kernel(f)):
            assert _is_orthogonal(_kernel(w)), k
        else:
            assert not _is_orthogonal(_kernel(w)), k
            lecun.append(k)
    assert len(lecun) == 7 and all(k.startswith("embed_img.") for k in lecun), lecun
    assert sum(w.ndim > 1 for w in port.values()) == 22

    g = torch.Generator().manual_seed(1)
    towers = [flax_init_(ImgEncoder(to_tc(cfg)), g).state_dict() for _ in range(40)]
    for k in lecun:
        name = k[len("embed_img."):]
        w = np.stack([t[name].numpy() for t in towers])
        want = math.sqrt(1.0 / _kernel(ref[k]).shape[0])
        assert abs(w.std() / want - 1) < 0.1, (k, w.std(), want)
        assert np.abs(w).max() <= 2 * want / 0.87962566103423978 * (1 + 1e-6), k
        if ref[k].size >= 1000:
            assert abs(ref[k].std() / want - 1) < 0.1, (k, ref[k].std(), want)


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize("decay", [None, "linear", "exp"])
def test_lr_schedule_matches_jax(decay):
    """At t = 0, 1 and T/2, to float32 rounding (1e-7 relative: the JAX
    schedule runs in float32, the port's in double)."""
    jf, tf = jlr_schedule(3e-4, decay, 1000), lr_schedule(3e-4, decay, 1000)
    for t in (0, 1, 500):
        want = float(jf(jnp.asarray(t, jnp.int32))) if callable(jf) else jf
        assert tf(t) == pytest.approx(want, rel=1e-7, abs=0)


def test_adam_counts_schedule_as_optax():
    """optax reads a schedule at the count before the update: after two
    steps of a linearly decayed Adam (rate 0.5 over T = 2: the first step at
    0.5, the second at 0.25) the port's parameters equal optax's to 2.5e-5,
    5e-5 of the rate: optax forms the bias correction 1 - 0.999^t in
    float32, which at t = 2 carries ~3e-5 relative error (torch's in
    double). A count read after the increment would be off by 0.125."""
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2)]
    tx = optax.adam(jlr_schedule(0.5, "linear", 2), eps=1e-8)
    p, opt = jnp.asarray(p0), None
    opt = tx.init(p)
    for g in grads:
        u, opt = tx.update(jnp.asarray(g), opt, p)
        p = optax.apply_updates(p, u)
    agent = SACAgent(None, tc.SACConfig(lr_decay="linear", max_train_steps=2))
    w = torch.nn.Parameter(T(p0.copy()))
    adam = torch.optim.Adam([w], lr=0.5, eps=1e-8)
    for t, g in enumerate(grads):
        agent._step(adam, (w * T(g)).sum(), 0.5, t)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), atol=2.5e-5, rtol=0)


# ------------------------------------------------------------------ replay

def test_replay_matches_jax():
    """Three pushes of 4 into a ring of 10 (the third wraps), then a sample
    at the same indices: every field equal, images through the uint8 round
    trip exactly, ``done`` stored as bool."""
    rng = np.random.default_rng(4)
    ex = {"obs/img": np.zeros((3, 8, 8), np.float32), "obs/lidar": np.zeros(120, np.float32),
          "action": np.zeros(2, np.float32), "done": np.zeros((), bool)}
    jb = jreplay.create(10, {k: jnp.asarray(v) for k, v in ex.items()})
    tb = replay.create(10, {k: T(v) for k, v in ex.items()})
    for _ in range(3):
        batch = {"obs/img": (rng.integers(0, 256, (4, 3, 8, 8)) / 255.0).astype(np.float32),
                 "obs/lidar": rng.normal(size=(4, 120)).astype(np.float32),
                 "action": rng.uniform(-1, 1, (4, 2)).astype(np.float32),
                 "done": rng.uniform(size=4) < 0.5}
        jb = jreplay.push_batch(jb, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = replay.push_batch(tb, {k: T(v) for k, v in batch.items()})
        assert (tb.cursor, tb.size) == (int(jb.cursor), int(jb.size))
    assert tb.data["obs/img"].dtype == torch.uint8 and tb.data["done"].dtype == torch.bool
    for k in ex:
        np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(jb.data[k]), err_msg=k)
    key = jax.random.PRNGKey(8)
    want = jreplay.sample(jb, key, 16)
    idx = jax.random.randint(key, (16,), 0, jnp.maximum(jb.size, 1))
    got = replay.sample(tb, 16, idx=T(np.array(idx)).long())
    for k in ex:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    # the uint8 round trip is exact for every colour k / 255 the rasterizer makes
    colours = T((np.arange(256) / 255.0).astype(np.float32))
    assert torch.equal(replay._decode("img", replay._encode("img", colours)), colours)
    obs = replay.unflatten_obs(got, "obs")
    assert set(obs) == {"img", "lidar"}
    assert set(replay.flatten_obs(obs, "next_obs")) == {"next_obs/img", "next_obs/lidar"}


# --------------------------------------------------------------- auto-reset

@pytest.fixture(scope="module")
def pool():
    """The committed procedural scenes in 96 edge slots: (JAX Scene, port
    Scene)."""
    with np.load(SCENES_NPZ) as f:
        arrays = {k: f[k] for k in SCENE_FIELDS}
    js = jpad(JScene(**{k: jnp.asarray(v) for k, v in arrays.items()}), 96, 32)
    return js, Scene.from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu")


@pytest.fixture(scope="module")
def envs():
    """The JAX and port envs of the chunk test's set-up (test_train_chunked's:
    no image, 96 edge slots, 64 RS points): (JAX cfg, port cfg, JAX env,
    port env). Building the JAX env's mask table costs seconds, so once."""
    jcfg = EnvConfig(obs=ObsConfig(use_img=False, mask_backend="xla"), max_edges=96,
                     max_obstacles=32, rs_max_points=64)
    tcfg = tc.EnvConfig(obs=tc.ObsConfig(use_img=False), max_edges=96, max_obstacles=32,
                        rs_max_points=64)
    return jcfg, tcfg, JEnv(jcfg), ParkingEnv(tcfg, device="cpu")


def assert_tree(got, want, atol=0.0, err=""):
    """A port dataclass / dict tree against a JAX one, leaf by leaf."""
    if isinstance(got, torch.Tensor):
        g, w = got.detach().numpy(), np.asarray(want)
        if atol and g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=err)
        else:
            np.testing.assert_array_equal(g, w, err_msg=err)
    elif isinstance(got, dict):
        for k in got:
            assert_tree(got[k], want[k], atol, f"{err}/{k}")
    else:
        for f in dataclasses.fields(got):
            assert_tree(getattr(got, f.name), getattr(want, f.name), atol, f"{err}.{f.name}")


def test_reset_pieces_match_jax(pool, envs):
    """_init_state, reset_where and hybrid reset_done: exactly equal."""
    js, ts = pool
    jenv = envs[2]

    def sub(s, i):
        return s.map(lambda x: x[i]) if isinstance(s, Scene) else jax.tree.map(lambda x: x[i], s)

    a, b = np.arange(4), np.arange(4, 8)
    jfresh = jax.vmap(jenv._init_state)(sub(js, b))
    tfresh = ParkingEnv._init_state(sub(ts, T(b)))
    assert_tree(tfresh, jfresh)
    jold = jax.vmap(jenv._init_state)(sub(js, a))
    jold = jold.replace(t=jold.t + 5, status=jold.status + 1)
    told = ParkingEnv._init_state(sub(ts, T(a)))
    told = dataclasses.replace(told, t=told.t + 5, status=told.status + 1)
    done = np.array([True, False, False, True])
    assert_tree(ParkingEnv.reset_where(told, tfresh, T(done)),
                JEnv.reset_where(jold, jfresh, jnp.asarray(done)))
    rng = np.random.default_rng(5)
    q = rng.normal(size=(4, 32, 2)).astype(np.float32)
    n, c = np.array([5, 0, 7, 3], np.int32), np.array([2, 0, 7, 1], np.int32)
    jh = JHybrid(queue=jnp.asarray(q), length=jnp.asarray(n), cursor=jnp.asarray(c))
    th = HybridState(queue=T(q), length=T(n), cursor=T(c))
    assert_tree(hybrid_reset_done(th, T(done)), jreset_done(jh, jnp.asarray(done)))


# -------------------------------------------------------------- SAC update

def test_three_sac_updates_match_jax():
    """Three consecutive updates from the same parameters, batches and
    normals (image tower on at 16x16, learned temperature, linear lr decay,
    a rate of 1e-3 so that every step moves every parameter): losses, alpha,
    entropy, every updated parameter and both targets agree to 1e-5 (losses
    relative 1e-5): each value is one float32 forward / backward pass in
    another reduction order per update, ~1e-6 measured; entries whose
    gradient is at rounding level to ADAM_NOISE * lr (see there)."""
    obs_cfg = ObsConfig(img_size=16)
    acfg, ccfg = (small(actor_net_config(obs_cfg), jc),
                  small(critic_net_config(obs_cfg, action_input=True), jc))
    shape = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
    kw = dict(lr_actor=1e-3, lr_critic=1e-3, lr_alpha=1e-3, lr_decay="linear",
              max_train_steps=10, learn_temperature=True)
    jagent = JSAC(acfg, ccfg, SACConfig(**kw), shape)
    rng = np.random.default_rng(6)
    jst = random_sac_state(jagent, rng)
    agent = SACAgent(MultiObsEmbedding(to_tc(acfg)), tc.SACConfig(**kw), to_tc(ccfg))
    tst = sac_state_from_flax(jax.tree.map(np.asarray, jst), agent, "cpu")
    B = 16
    for i in range(3):
        b = {**rand_obs(rng, B, prefix="obs/"), **rand_obs(rng, B, prefix="next_obs/"),
             "action": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             "reward": rng.normal(size=B).astype(np.float32), "done": rng.uniform(size=B) < 0.2}
        key = jax.random.PRNGKey(100 + i)
        k1, k2 = jax.random.split(key)
        noise = [T(np.array(jax.random.normal(k, (B, 2)))) for k in (k1, k2)]
        jst, jm = jagent.update(jst, {k: jnp.asarray(v) for k, v in b.items()}, key)
        tm = agent.update(tst, {k: T(v) for k, v in b.items()}, noise=noise)
        for k in ("actor_loss", "critic_loss", "alpha", "entropy"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), (i, k)
    assert tst.steps == int(jst.steps) == 3
    assert_net(tst.actor, jst.actor["params"], to_tc(acfg), 1e-5, err="actor", lr=1e-3)
    for n in ("critic1", "critic2", "target1", "target2"):
        assert_net(getattr(tst, n), getattr(jst, n)["params"]["net"], to_tc(ccfg), 1e-5,
                   prefix="net.", err=n, lr=1e-3)
    np.testing.assert_allclose(tst.log_std.detach().numpy(), np.asarray(jst.log_std), atol=1e-6)
    assert tst.log_alpha.dtype == torch.float32 and tst.log_alpha.ndim == 0
    assert float(tst.log_alpha.detach()) == pytest.approx(float(jst.log_alpha), abs=1e-6)


def test_sac_refuses_frozen_encoder():
    """With freeze_img_encoder an update refuses to move the image encoders:
    every embed_img parameter of the actor and both critics keeps its bits,
    while their Adam moments advance and every other group moves."""
    obs_cfg = tc.ObsConfig(img_size=16)
    agent = SACAgent(MultiObsEmbedding(small(tc.actor_net_config(obs_cfg), tc)),
                     tc.SACConfig(freeze_img_encoder=True, lr_actor=1e-3, lr_critic=1e-3),
                     small(tc.critic_net_config(obs_cfg, action_input=True), tc))
    shape = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
    st = agent.init(shape, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    B = 8
    batch = {**rand_obs(rng, B, prefix="obs/"), **rand_obs(rng, B, prefix="next_obs/"),
             "action": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             "reward": rng.normal(size=B).astype(np.float32), "done": rng.uniform(size=B) < 0.2}
    nets = ("actor", "critic1", "critic2")
    before = {n: {k: v.clone() for k, v in getattr(st, n).state_dict().items()} for n in nets}
    agent.update(st, {k: T(v) for k, v in batch.items()}, torch.Generator().manual_seed(2))
    for n in nets:
        frozen = {id(p) for p in agent.frozen(getattr(st, n))}
        assert frozen, n
        moved_rest = 0.0
        for (k, p) in getattr(st, n).named_parameters():
            if id(p) in frozen:
                assert torch.equal(p.detach(), before[n][k]), (n, k)
                opt = getattr(st, "opt_" + ("actor" if n == "actor" else n))
                if p.grad is not None and p.grad.abs().max() > 0:
                    assert opt.state[p]["exp_avg"].abs().max() > 0, (n, k)
            else:
                moved_rest = max(moved_rest, float((p.detach() - before[n][k]).abs().max()))
        assert moved_rest > 0, n


# -------------------------------------------------------------- the chunk

def _chunk_setup(pool):
    """The test_train_chunked set-up on the committed scenes: B = 4, no image,
    96 edge slots; env 0 starts on its destination (it arrives at once and
    takes a reset), env 1 across an obstacle edge (it collides at once)."""
    js, _ = pool
    start = np.array(js.start)
    start[0] = np.asarray(js.dest[0])
    e = np.asarray(js.edges[1])[np.asarray(js.edge_mask[1])][0]
    start[1] = [(e[0] + e[2]) / 2, (e[1] + e[3]) / 2, math.atan2(e[3] - e[1], e[2] - e[0]) + 0.7]
    js = js.replace(start=jnp.asarray(start))
    ts = Scene.from_numpy({f: np.asarray(getattr(js, f)) for f in FIELDS}, "cpu")
    return js, ts


def test_sac_chunk_matches_jax(pool, envs):
    """One SAC chunk (K = 3 collect steps, U = 2 updates, sgd batch 8, a ring
    of 10 that wraps) against build_sac_chunk, with JAX's policy normals,
    sample indices and update normals replayed into the port: the (K, B) logs
    (done, status, pool index exactly; reward to 1e-3 as
    test_rollout_matches_jax), the replay ring (lidar 2e-3 m raw, and so
    normalized lidar to 2e-3 / std where the batch's spread is small:
    held to 2e-2; the rest 1e-4), the env and hybrid state after the chunk
    (poses 1e-4, observations as the rollout test), the observation
    statistics (1e-3 absolute or 1e-4 relative: S sums squares of lidar
    values that differ by up to 2e-3 m), the last update's metrics (1e-4
    relative) and every parameter (1e-5, ADAM_NOISE as
    test_three_sac_updates_match_jax). Where every env reads the same range
    on a beam the batch's spread is a rounding residue (std ~1e-8) and the
    normalized lidar is that residue over ~1e-8, large in both packages: it
    is also held to 1e-5 relative."""
    js, ts = _chunk_setup(pool)
    B, K, U, SGD, MEM = 4, 3, 2, 8, 10
    jcfg, tcfg, jenv, tenv = envs
    obs_cfg = jcfg.obs
    acfg, ccfg = (small(actor_net_config(obs_cfg), jc),
                  small(critic_net_config(obs_cfg, action_input=True), jc))
    kw = dict(memory_size=MEM, batch_size=SGD, lr_actor=1e-3, lr_critic=1e-3)
    jagent = JSAC(acfg, ccfg, SACConfig(**kw), jenv.observation_shape, jenv.mask_table)
    jst = random_sac_state(jagent, np.random.default_rng(7))
    agent = SACAgent(MultiObsEmbedding(to_tc(acfg)), tc.SACConfig(**kw), to_tc(ccfg))
    tst = sac_state_from_flax(jax.tree.map(np.asarray, jst), agent, "cpu")

    pool_idx = np.arange(B, dtype=np.int32)
    jstate, jobs = jax.jit(jenv.batch_reset)(jax.tree.map(lambda x: x[:B], js))
    tstate, tobs = tenv.batch_reset(ts.map(lambda x: x[:B]))
    ex = {**{f"{p}/{k}": v[0] for p in ("obs", "next_obs") for k, v in jobs.items()},
          "action": jnp.zeros(2), "reward": jnp.zeros(()), "done": jnp.zeros((), bool),
          "log_prob": jnp.zeros(())}
    jring = jreplay.create(MEM, ex)
    tring = replay.create(MEM, {k: T(np.array(v)) for k, v in ex.items()})
    queue = (np.arange(B * K, dtype=np.int32) + 4) % 10
    key = jax.random.PRNGKey(11)
    out = jbuild_chunk(jenv, jagent, jcfg.step_ratio, K, U, SGD)(
        jst, jstate, JHybrid.create(B, jcfg.rs_queue_len), jobs, jnp.asarray(pool_idx), jring,
        js, jnp.asarray(queue), key, warmup=False)
    jst, jstate, jhyb, jobs, jpool_idx, jring, jlogs, jm = out

    # JAX's draws, as build_sac_chunk makes them
    act_keys = jax.random.split(jax.random.fold_in(key, 0), K)
    upd_keys = jax.random.split(jax.random.fold_in(key, 1), U)
    size = jnp.asarray(min(B * K, MEM), jnp.int32)
    draws = ChunkDraws(
        actions=T(np.stack([np.asarray(jax.random.normal(k, (B, 2))) for k in act_keys])),
        sample_idx=T(np.stack([np.asarray(jax.random.randint(k, (SGD,), 0, size))
                               for k in upd_keys])).long(),
        update_noise=T(np.stack([[np.asarray(jax.random.normal(k, (SGD, 2)))
                                  for k in jax.random.split(jax.random.fold_in(ku, 1))]
                                 for ku in upd_keys])))
    chunk = build_sac_chunk(tenv, agent, tcfg.step_ratio, K, U, SGD)
    (_, tstate, thyb, tobs, tpool_idx, tring, tlogs, tm) = chunk(
        tst, tstate, HybridState.create(B, tcfg.rs_queue_len), tobs, T(pool_idx), tring, ts,
        T(queue), None, warmup=False, draws=draws)

    for k in ("done", "status", "pool_idx"):
        np.testing.assert_array_equal(tlogs[k].numpy(), np.asarray(jlogs[k]), err_msg=k)
    np.testing.assert_allclose(tlogs["reward"].numpy(), np.asarray(jlogs["reward"]), atol=1e-3)
    assert tlogs["done"][0, 0] and tlogs["done"][0, 1]             # the reset path ran
    np.testing.assert_array_equal(tpool_idx.numpy(), np.asarray(jpool_idx))
    assert (tring.cursor, tring.size) == (int(jring.cursor), int(jring.size)) == (2, MEM)
    for k, v in tring.data.items():
        atol, rtol = (2e-2, 1e-5) if k.endswith("lidar") else (1e-4, 0)
        np.testing.assert_allclose(v.numpy().astype(np.float64),
                                   np.asarray(jring.data[k]).astype(np.float64),
                                   atol=atol, rtol=rtol, err_msg=k)
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
    for k in ("actor_loss", "critic_loss", "alpha", "entropy"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4, abs=1e-5), k
    assert_net(tst.actor, jst.actor["params"], to_tc(acfg), 1e-5, err="actor", lr=1e-3)
    for n in ("critic1", "critic2", "target1", "target2"):
        assert_net(getattr(tst, n), getattr(jst, n)["params"]["net"], to_tc(ccfg), 1e-5,
                   prefix="net.", err=n, lr=1e-3)


# ------------------------------------------------------------------- CLIs

def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    """--smoke --device cpu runs 3 chunks (1 warm-up), prints the JAX CLI's
    keys, writes config.json, metrics.jsonl and an agent checkpoint."""
    import json

    from hope_tpu_torch.train import train_sac
    from hope_tpu_torch.utils.checkpoint import load_checkpoint

    res = train_sac.main(["--smoke", "--device", "cpu", "--max-chunks", "3", "--log-every", "1",
                          "--no-tensorboard", "--log-dir", str(tmp_path)])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    logs = [x for x in lines if "chunk" in x]
    assert [x["chunk"] for x in logs] == [1, 2, 3]
    for x in logs[1:]:
        assert {"chunk", "episodes", "steps", "reward", "success", "alpha", "actor_loss",
                "critic_loss", "env_steps_per_sec"} <= set(x)
    assert set(logs[0]["success"]) == {"Normal", "Complex", "Extrem", "dlp"}
    assert [r["warmup"] for r in res["chunks"]] == [True, False, False]
    st = res["loop"]["state"]
    assert st.steps == 2 * 4 and res["loop"]["replay"].size == 3 * 4 * 4
    assert (tmp_path / "config.json").exists() and (tmp_path / "metrics.jsonl").exists()
    before = st.critic1.state_dict()["net.fusion.fc2.weight"].clone()
    with torch.no_grad():
        st.critic1.net.fusion.fc2.weight.add_(1.0)
    load_checkpoint(str(tmp_path / "ckpt"), st)
    assert torch.equal(st.critic1.state_dict()["net.fusion.fc2.weight"], before)


@pytest.mark.parametrize("argv,says", [
    (["--devices", "3", "--batch-envs", "4"], "divisible by --devices"),
    (["--devices", "2", "--memory", "7"], "divisible by --devices"),
    (["--num-processes", "2", "--process-id", "0"], "needs --coordinator"),
    (["--num-processes", "2", "--process-id", "2", "--coordinator", "h:1"], "--process-id"),
    (["--devices", "3", "--num-processes", "2", "--process-id", "0", "--coordinator", "h:1"],
     "not a multiple of --num-processes")])
def test_train_cli_refuses_bad_parallel_flags(argv, says, capsys):
    """The multi-process flags' checks (JAX's divisibility of --batch-envs
    and --memory by --devices, and the launch's own), before any work."""
    from hope_tpu_torch.train import train_sac

    with pytest.raises(SystemExit) as e:
        train_sac.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def test_train_cli_defaults_to_cuda():
    from hope_tpu_torch.train import train_sac

    if torch.cuda.is_available():
        pytest.skip("the refusal shows only where CUDA is missing")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_sac.main(["--smoke"])


def test_eval_battery_four_levels_on_cpu(tmp_path):
    """The port's eval_mix_scene runs the whole 4-level battery (tiny) in the
    JAX CLI's order, with each level's scenes of that level."""
    from hope_tpu_torch.evaluation import eval_mix_scene

    res = eval_mix_scene.main([NPZ, "--episodes", "2", "--max-steps", "3", "--device", "cpu",
                               "--out", str(tmp_path)])
    assert list(res) == ["Extrem", "dlp", "Complex", "Normal"]
    for level, r in res.items():
        assert r["n"] == 2 and (tmp_path / f"result_{level}.json").exists()
        if level != "dlp":
            assert set(r["per_level"]) == {level}
