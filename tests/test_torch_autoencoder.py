"""The port's BEV autoencoders, encoder graft and frozen-encoder SAC against
the JAX package's, on the CPU, at a small width (16x16 images).

JAX's ``AEConv`` / ``VAEConv`` parameters (drawn with numpy) are carried
over by ``models/convert.ae_from_flax``; the VAE's latent noise is JAX's,
injected. Float32 throughout: a value computed by the same operations in
another order differs by ~1e-7 relative per operation; each test states its
bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hope_tpu.agents import SACAgent as JSAC
from hope_tpu.config import ObsConfig, SACConfig, actor_net_config, critic_net_config
from hope_tpu.models import Critic as JCritic
from hope_tpu.models import MultiObsEmbedding as JNet
from hope_tpu.models.autoencoder import AEConv as JAE
from hope_tpu.models.autoencoder import VAEConv as JVAE
from hope_tpu.models.autoencoder import ae_loss as jae_loss
from hope_tpu.models.autoencoder import graft_encoder_params as jgraft
from hope_tpu.models.autoencoder import vae_loss as jvae_loss
from hope_tpu_torch import config as tc
from hope_tpu_torch.agents import SACAgent
from hope_tpu_torch.models import MultiObsEmbedding
from hope_tpu_torch.models.autoencoder import ae_loss, graft_encoder_params, vae_loss
from hope_tpu_torch.models.convert import (_img_encoder_state, actor_from_flax, ae_from_flax,
                                           critic_from_flax, sac_state_from_flax)

from .test_torch_train import ADAM_NOISE, assert_net, rand_obs, random_sac_state, small, to_tc
from .torch_threads import one_torch_thread  # noqa: F401

T = torch.as_tensor
OBS = ObsConfig(img_size=16)
CFG = dataclasses.replace(actor_net_config(OBS), embed_dim=32, hidden_dim=32, img_fc_sizes=(32,))


def draw_params(module, rng, *args, scale=0.3):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree.map(lambda s: (scale * rng.normal(size=s.shape)).astype(np.float32), shapes)


def imgs(rng, B=4):
    return rng.uniform(size=(B, 3, 16, 16)).astype(np.float32)


def grads_of(model):
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in model.named_parameters()}


@pytest.mark.parametrize("vae", [False, True])
def test_autoencoder_forward_loss_and_grads_match_flax(vae):
    """Reconstruction (and the VAE's mean, log_var) to 2e-6; the loss to
    1e-5 relative; every gradient to 1e-4 of its tensor's largest entry
    (reductions over the batch and the image in another order)."""
    rng = np.random.default_rng(1 if vae else 0)
    jm = (JVAE if vae else JAE)(CFG)
    x = imgs(rng)
    args = (jnp.zeros((1, 3, 16, 16)),) + ((jax.random.PRNGKey(0),) if vae else ())
    params = draw_params(jm, rng, *args)
    tm = ae_from_flax(params, to_tc(CFG), "cpu", vae=vae)
    if vae:
        key = jax.random.PRNGKey(4)
        noise = T(np.array(jax.random.normal(key, (4, CFG.embed_dim))))
        jout = jm.apply(params, jnp.asarray(x), key)
        tout = tm(T(x), noise=noise)
        for a, b in zip(jout, tout):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=2e-6)
        jl, jg = jax.jit(jax.value_and_grad(jvae_loss), static_argnums=1)(
            params, jm, jnp.asarray(x), key)
        tl = vae_loss(tm, T(x), noise=noise)
    else:
        np.testing.assert_allclose(tm(T(x)).detach().numpy(),
                                   np.asarray(jm.apply(params, jnp.asarray(x))), atol=2e-6)
        jl, jg = jax.jit(jax.value_and_grad(jae_loss), static_argnums=1)(
            params, jm, jnp.asarray(x))
        tl = ae_loss(tm, T(x))
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tl.backward()
    want = ae_from_flax(jax.tree.map(np.asarray, jg), to_tc(CFG), "cpu", vae=vae)
    got = grads_of(tm)
    for k, w in want.state_dict().items():
        d = float((got[k] - w).abs().max())
        assert d <= 1e-4 * max(float(w.abs().max()), 1e-8), (k, d)


def test_one_pretraining_adam_step_matches_optax():
    """One optax.adam(1e-4) step of the AE loss against torch's Adam: every
    parameter to 1e-7 (one float32 ulp at the parameters' scale), except
    where the gradient itself is at rounding level (|g| < 1e-6, i.e. within
    100 eps of Adam's denominator): those to ADAM_NOISE * lr
    (test_torch_train.ADAM_NOISE; 565 of 12702 entries here)."""
    rng = np.random.default_rng(2)
    jm = JAE(CFG)
    params = draw_params(jm, rng, jnp.zeros((1, 3, 16, 16)))
    x = imgs(rng, 8)
    lr = 1e-4
    tx = optax.adam(lr)
    g = jax.jit(jax.grad(jae_loss), static_argnums=1)(params, jm, jnp.asarray(x))
    u, _ = tx.update(g, tx.init(params), params)
    jnew = jax.tree.map(np.asarray, optax.apply_updates(params, u))
    tm = ae_from_flax(params, to_tc(CFG), "cpu")
    opt = torch.optim.Adam(tm.parameters(), lr=lr, eps=1e-8)
    ae_loss(tm, T(x)).backward()
    opt.step()
    want = ae_from_flax(jnew, to_tc(CFG), "cpu").state_dict()
    grads = grads_of(tm)
    for k, v in tm.state_dict().items():
        d = (v - want[k]).abs()
        rounding = grads[k].abs() < 1e-6
        assert float(d.max()) <= ADAM_NOISE * lr, k
        assert float(torch.where(rounding, 0.0, d).max()) <= 1e-7, k


def test_graft_matches_jax_by_outputs():
    """graft_encoder_params into an actor and a critic: each computes what
    JAX's grafted network computes (to 1e-5), from tensors of its own; a
    network without an image tower, or one whose tower does not fit,
    raises."""
    rng = np.random.default_rng(3)
    acfg = small(actor_net_config(OBS))
    ccfg = small(critic_net_config(OBS, action_input=True))
    ae_params = draw_params(JAE(acfg), rng, jnp.zeros((1, 3, 16, 16)))
    obs = rand_obs(rng, 6)
    act = rng.uniform(-1, 1, (6, 2)).astype(np.float32)
    jobs = {k: jnp.asarray(v) for k, v in obs.items()}
    a_params = draw_params(JNet(acfg), rng, jobs)
    c_params = draw_params(JCritic(ccfg), rng, jobs, jnp.asarray(act))
    ja = np.asarray(JNet(acfg).apply(jgraft(a_params, ae_params), jobs))
    jc = np.asarray(JCritic(ccfg).apply(jgraft(c_params, ae_params), jobs, jnp.asarray(act)))

    ae = ae_from_flax(ae_params, to_tc(acfg), "cpu")
    actor, _ = actor_from_flax(a_params, np.zeros((1, 2)),
                               {"mean": {}, "S": {}, "n": 0}, to_tc(acfg), "cpu")
    critic = critic_from_flax(c_params, to_tc(ccfg), "cpu")
    n_enc = len(ae.encoder.state_dict())
    assert graft_encoder_params(actor, ae) == graft_encoder_params(critic, ae) == n_enc
    tobs = {k: T(v) for k, v in obs.items()}
    with torch.no_grad():
        np.testing.assert_allclose(actor(tobs).numpy(), ja, atol=1e-5)
        np.testing.assert_allclose(critic(tobs, T(act)).numpy(), jc, atol=1e-5)
    enc = {id(p) for p in ae.parameters()}
    assert not enc & {id(p) for p in actor.parameters()}
    assert not enc & {id(p) for p in critic.parameters()}

    with pytest.raises(ValueError, match="matched no parameters"):
        graft_encoder_params(MultiObsEmbedding(to_tc(small(actor_net_config(
            ObsConfig(use_img=False))))), ae)
    wide = ae_from_flax(draw_params(JAE(dataclasses.replace(acfg, img_fc_sizes=(48,))), rng,
                                    jnp.zeros((1, 3, 16, 16))),
                        to_tc(dataclasses.replace(acfg, img_fc_sizes=(48,))), "cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        graft_encoder_params(actor, wide)


def test_three_frozen_sac_updates_match_jax():
    """Three SAC updates with freeze_img_encoder, against JAX's
    chain(adam, masked(set_to_zero)): the image encoders of the actor and
    critics keep their bits in both; their Adam moments advance as optax's
    (first moments to 1e-4 and second to 1e-3 of each tensor's largest:
    sums of float32 gradients that agree to ~1e-6 relative); the rest,
    targets included, as test_three_sac_updates_match_jax (1e-5, ADAM_NOISE)."""
    acfg, ccfg = (small(actor_net_config(OBS)),
                  small(critic_net_config(OBS, action_input=True)))
    shape = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
    kw = dict(lr_actor=1e-3, lr_critic=1e-3, lr_alpha=1e-3, freeze_img_encoder=True)
    jagent = JSAC(acfg, ccfg, SACConfig(**kw), shape)
    rng = np.random.default_rng(6)
    jst = random_sac_state(jagent, rng)
    jst0 = jax.tree.map(np.asarray, jst)
    agent = SACAgent(MultiObsEmbedding(to_tc(acfg)), tc.SACConfig(**kw), to_tc(ccfg))
    tst = sac_state_from_flax(jst0, agent, "cpu")
    B = 16
    update = jax.jit(jagent.update)
    for i in range(3):
        b = {**rand_obs(rng, B, prefix="obs/"), **rand_obs(rng, B, prefix="next_obs/"),
             "action": rng.uniform(-1, 1, (B, 2)).astype(np.float32),
             "reward": rng.normal(size=B).astype(np.float32), "done": rng.uniform(size=B) < 0.2}
        key = jax.random.PRNGKey(200 + i)
        noise = [T(np.array(jax.random.normal(k, (B, 2)))) for k in jax.random.split(key)]
        jst, jm = update(jst, {k: jnp.asarray(v) for k, v in b.items()}, key)
        tm = agent.update(tst, {k: T(v) for k, v in b.items()}, noise=noise)
        for k in ("actor_loss", "critic_loss", "alpha", "entropy"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5, abs=1e-6), (i, k)

    nets = {"actor": ("", to_tc(acfg), lambda t: t["params"], jst.opt_actor, lambda m: m[0]),
            "critic1": ("net.", to_tc(ccfg), lambda t: t["params"]["net"], jst.opt_critic1,
                        lambda m: m),
            "critic2": ("net.", to_tc(ccfg), lambda t: t["params"]["net"], jst.opt_critic2,
                        lambda m: m)}
    for name, (prefix, cfg, sub, jopt, tree) in nets.items():
        net = getattr(tst, name)
        enc0 = _img_encoder_state(jax.tree.map(np.asarray, sub(getattr(jst0, name))["embed_img"]),
                                  cfg)
        enc = _img_encoder_state(jax.tree.map(np.asarray, sub(getattr(jst, name))["embed_img"]),
                                 cfg)
        sd = net.state_dict()
        for k, v in enc0.items():
            np.testing.assert_array_equal(enc[k], v, err_msg=f"JAX {name} {k}")
            np.testing.assert_array_equal(sd[f"{prefix}embed_img.{k}"].numpy(), v,
                                          err_msg=f"{name} {k}")
        adam = jopt[0][0]
        params = dict(net.named_parameters())
        opt = getattr(tst, "opt_" + name)
        for moment, flax_m, rel in (("exp_avg", adam.mu, 1e-4), ("exp_avg_sq", adam.nu, 1e-3)):
            want = _img_encoder_state(jax.tree.map(np.asarray, sub(tree(flax_m))["embed_img"]),
                                      cfg)
            for k, w in want.items():
                state = opt.state[params[f"{prefix}embed_img.{k}"]]
                if not state:       # no gradient reaches it (the unused std head)
                    assert k.startswith("std.") and not w.any(), (name, moment, k)
                    continue
                got = state[moment].numpy()
                scale = float(np.abs(w).max())
                assert scale > 0 and float(np.abs(got - w).max()) <= rel * scale, \
                    (name, moment, k)
    assert_net(tst.actor, jst.actor["params"], to_tc(acfg), 1e-5, err="actor", lr=1e-3)
    for n in ("critic1", "critic2", "target1", "target2"):
        assert_net(getattr(tst, n), getattr(jst, n)["params"]["net"], to_tc(ccfg), 1e-5,
                   prefix="net.", err=n, lr=1e-3)
    np.testing.assert_allclose(tst.log_std.detach().numpy(), np.asarray(jst.log_std), atol=1e-6)


def test_pretrain_cli_then_train_sac_graft(tmp_path, capsys):
    """pretrain_autoencoder --smoke writes a checkpoint that train_sac
    --img-encoder grafts; with --freeze-img-encoder the actor's and critics'
    encoders still equal the AE's after an update chunk. --img-encoder
    without the image exits."""
    from hope_tpu_torch.models.autoencoder import AEConv
    from hope_tpu_torch.train import pretrain_autoencoder, train_sac
    from hope_tpu_torch.utils.checkpoint import load_checkpoint

    res = pretrain_autoencoder.main(["--smoke", "--device", "cpu",
                                     "--log-dir", str(tmp_path / "ae")])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    ckpt = str(tmp_path / "ae" / "ckpt")
    ae = load_checkpoint(ckpt, AEConv(tc.actor_net_config(tc.ObsConfig())))
    for k, v in res["model"].state_dict().items():
        assert torch.equal(ae.state_dict()[k], v), k
    argv = ["--device", "cpu", "--no-tensorboard", "--batch-envs", "2", "--chunk-steps", "2",
            "--warmup-chunks", "1", "--updates-per-step", "1", "--sgd-batch", "4",
            "--memory", "16", "--pool-per-level", "2", "--no-dlp", "--max-chunks", "2",
            "--log-dir", str(tmp_path / "sac"), "--img-encoder", ckpt]
    st = train_sac.main(argv + ["--freeze-img-encoder"])["loop"]["state"]
    assert st.steps == 2
    enc = ae.encoder.state_dict()
    for net in (st.actor, st.critic1.net, st.critic2.net):
        for k, v in net.embed_img.state_dict().items():
            assert torch.equal(v, enc[k]), k
    with pytest.raises(SystemExit, match="image modality"):
        train_sac.main(argv + ["--no-img"])
