"""Carry Flax parameters into the port: an actor into ``MultiObsEmbedding``,
a critic into ``Critic`` (SAC's Q) or ``ValueNet`` (PPO's V), a whole SAC or
PPO training state into a ``SACState`` or ``PPOState``, a BEV autoencoder
into ``AEConv`` / ``VAEConv``.

Layout changes: Flax ``Dense`` kernels are (in, out), ``nn.Linear.weight``
is (out, in); Flax ``Conv`` kernels are HWIO, torch's OIHW. The image
encoder's first fc layer needs no permutation, because the port flattens its
feature map in the same (h, w, c) order as the Flax encoder. The actor file
format is an ``.npz`` whose keys are the Flax paths joined by "/" (e.g.
``params/embed_lidar/Dense_0/kernel``), plus ``log_std`` and
``norm/{mean,S}/{lidar,target}``, ``norm/n``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..agents.ppo import PPOActor, PPOAgent, PPOState
from ..agents.sac import ActorState, SACAgent, SACState
from ..agents.state_norm import NormState
from ..config import NetConfig
from ..device import resolve_device
from .autoencoder import AEConv, VAEConv
from .policy import Critic, MultiObsEmbedding, ValueNet


def _dense(tree):
    return {"weight": np.asarray(tree["kernel"]).T,
            **({"bias": np.asarray(tree["bias"])} if "bias" in tree else {})}


def _conv(tree):
    return {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1),
            "bias": np.asarray(tree["bias"])}


def _img_encoder_state(img: dict, cfg: NetConfig) -> dict:
    """A Flax ``ImgEncoder`` subtree -> the port's ``ImgEncoder`` state."""
    out = {}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    for i in range(len(cfg.img_conv_channels)):
        put(f"blocks.{i}.conv", _conv(img[f"ConvBlock_{i}"]["Conv_0"]))
        put(f"blocks.{i}.shortcut", _conv(img[f"ConvBlock_{i}"]["Conv_1"]))
    n_fc = len(cfg.img_fc_sizes)
    for i in range(n_fc):
        put(f"fc.{i}", _dense(img[f"Dense_{i}"]))
    put("mean", _dense(img[f"Dense_{n_fc}"]))
    put("std", _dense(img[f"Dense_{n_fc + 1}"]))
    return out


def _torch_state(p: dict, cfg: NetConfig) -> dict:
    """Flax ``params`` subtree -> {torch state_dict name: array}."""
    out = {}

    def put(prefix, d):
        for k, v in d.items():
            out[f"{prefix}.{k}"] = v

    def embed(name):
        for i in range(cfg.n_embed_layers):
            put(f"{name}.layers.{i}", _dense(p[name][f"Dense_{i}"]))

    embed("embed_lidar")
    embed("embed_tgt")
    if cfg.action_mask_dim:
        embed("embed_am")
    if cfg.action_input_dim:
        embed("embed_action")
    if cfg.img_shape is not None:
        img = _img_encoder_state(p["embed_img"], cfg)
        out.update({f"embed_img.{k}": v for k, v in img.items()})
        put("re_embed_img", _dense(p["re_embed_img"]))
    fusion = p["fusion"]
    if cfg.attention is not None:
        enc = fusion["TransformerEncoder_0"]
        for i in range(cfg.attention.depth):
            mha = enc[f"MultiHeadAttention_{i}"]
            ff = enc[f"FeedForward_{i}"]
            for ln, flax_ln in (("ln1", f"LayerNorm_{2 * i}"), ("ln2", f"LayerNorm_{2 * i + 1}")):
                out[f"fusion.layers.{i}.{ln}.weight"] = np.asarray(enc[flax_ln]["scale"])
                out[f"fusion.layers.{i}.{ln}.bias"] = np.asarray(enc[flax_ln]["bias"])
            put(f"fusion.layers.{i}.attn.to_qkv", _dense(mha["to_qkv"]))
            put(f"fusion.layers.{i}.attn.to_out", _dense(mha["to_out"]))
            put(f"fusion.layers.{i}.ff.fc1", _dense(ff["Dense_0"]))
            put(f"fusion.layers.{i}.ff.fc2", _dense(ff["Dense_1"]))
        put("fusion.fc1", _dense(fusion["Dense_0"]))
        put("fusion.fc2", _dense(fusion["Dense_1"]))
    else:
        for i in range(len([k for k in fusion if k.startswith("Dense_")])):
            put(f"fusion.layers.{i}", _dense(fusion[f"Dense_{i}"]))
    return out


def _tensors(state: dict) -> dict:
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in state.items()}


def _norm_state(norm, device) -> NormState:
    """``norm``: a mapping or object with mean, S ({k: arr}) and n."""
    def get(k):
        return norm[k] if isinstance(norm, dict) else getattr(norm, k)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    return NormState(mean={k: t(v) for k, v in get("mean").items()},
                     S={k: t(v) for k, v in get("S").items()},
                     n=torch.as_tensor(int(np.asarray(get("n"))), device=device))


def critic_from_flax(params: dict, cfg: NetConfig, device=None) -> Critic:
    """The port's ``Critic`` from a Flax critic tree ``{"params": {"net":
    {...}}}`` (numpy leaves); ``cfg`` has ``action_input_dim`` set."""
    device = resolve_device(device)
    net = Critic(cfg)
    state = {f"net.{k}": v for k, v in _tensors(_torch_state(params["params"]["net"], cfg)).items()}
    net.load_state_dict(state, strict=True)
    return net.to(device)


def sac_state_from_flax(st, agent: SACAgent, device=None) -> SACState:
    """A ``SACState`` from a JAX ``SACState`` (numpy or JAX leaves): the
    actor (loaded into ``agent.actor``, in place), log_std, both critics and
    targets, log_alpha, the observation statistics and the update count. The
    Adams start fresh, as they are after the JAX ``init``."""
    device = resolve_device(device)
    agent.actor.load_state_dict(_tensors(_torch_state(st.actor["params"], agent.actor.cfg)),
                                strict=True)
    agent.actor.to(device)
    nets = [critic_from_flax(getattr(st, n), agent.critic_cfg, device)
            for n in ("critic1", "critic2", "target1", "target2")]
    log_std = torch.as_tensor(np.array(st.log_std, np.float32), device=device).requires_grad_()
    log_alpha = torch.as_tensor(np.array(st.log_alpha, np.float32),
                                device=device).requires_grad_()
    return agent.make_state(nets[:2], log_std, log_alpha, _norm_state(st.norm, device),
                            targets=nets[2:], steps=int(np.asarray(st.steps)))


def value_net_from_flax(params: dict, cfg: NetConfig, device=None) -> ValueNet:
    """The port's ``ValueNet`` from a Flax ``MultiObsEmbedding`` tree
    ``{"params": {...}}`` (numpy leaves) with no action input."""
    device = resolve_device(device)
    net = ValueNet(cfg)
    net.load_state_dict(_tensors(_torch_state(params["params"], cfg)), strict=True)
    return net.to(device)


def ppo_state_from_flax(st, agent: PPOAgent, device=None) -> PPOState:
    """A ``PPOState`` from a JAX ``PPOState`` (numpy or JAX leaves): the
    actor with the head of ``agent``'s dist type, log_std, the critic and its
    target, the observation statistics and the update count. The Adams start
    fresh, as they are after the JAX ``init``."""
    device = resolve_device(device)
    actor = MultiObsEmbedding(agent.actor_cfg)
    actor.load_state_dict(_tensors(_torch_state(st.actor["params"], agent.actor_cfg)),
                          strict=True)
    critic, target = (value_net_from_flax(getattr(st, n), agent.critic_cfg, device)
                      for n in ("critic", "critic_target"))
    log_std = torch.as_tensor(np.array(st.log_std, np.float32), device=device).requires_grad_()
    return agent.make_state(actor.to(device), log_std, critic, _norm_state(st.norm, device),
                            critic_target=target, steps=int(np.asarray(st.steps)))


def actor_from_flax(params: dict, log_std, norm: dict, cfg: NetConfig, device=None):
    """(MultiObsEmbedding, ActorState) from a Flax actor.

    Args:
      params: the Flax actor tree ``{"params": {...}}`` (numpy leaves).
      log_std: (1, action_dim) learned log std.
      norm: ``{"mean": {k: arr}, "S": {k: arr}, "n": int}`` Welford stats.
      cfg: the actor's ``NetConfig``.
      device: where the actor and its state go; CUDA unless named
        (:func:`resolve_device`).
    """
    device = resolve_device(device)
    net = MultiObsEmbedding(cfg)
    net.load_state_dict(_tensors(_torch_state(params["params"], cfg)), strict=True)
    net = net.to(device).eval()
    st = ActorState(log_std=torch.as_tensor(np.array(log_std, np.float32), device=device),
                    norm=_norm_state(norm, device))
    return net, st


def ae_from_flax(params: dict, cfg: NetConfig, device=None, vae: bool = False):
    """The port's ``AEConv`` (``VAEConv`` where ``vae``) from the Flax
    autoencoder tree ``{"params": {"encoder": ..., "decoder": ...}}`` (numpy
    leaves). The decoder's ``ConvTranspose`` kernels (stride 1, not
    transposed) apply as stored, so they load as ``Conv2d`` weights."""
    device = resolve_device(device)
    p = params["params"]
    state = {f"encoder.{k}": v for k, v in _img_encoder_state(p["encoder"], cfg).items()}
    dec = p["decoder"]
    n_fc = len(cfg.img_fc_sizes)
    for i in range(n_fc):
        state.update({f"decoder.fc.{i}.{k}": v for k, v in _dense(dec[f"Dense_{i}"]).items()})
    state.update({f"decoder.to_map.{k}": v for k, v in _dense(dec[f"Dense_{n_fc}"]).items()})
    for i in range(len(cfg.img_conv_channels)):
        blk = dec[f"DeConvBlock_{i}"]
        for name, flax_name in (("deconv", "ConvTranspose_0"), ("conv", "Conv_0"),
                                ("sc_deconv", "ConvTranspose_1"), ("sc_conv", "Conv_1")):
            state.update({f"decoder.blocks.{i}.{name}.{k}": v
                          for k, v in _conv(blk[flax_name]).items()})
    net = (VAEConv if vae else AEConv)(cfg)
    net.load_state_dict(_tensors(state), strict=True)
    return net.to(device)


def unflatten(flat: dict) -> dict:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def load_actor_npz(path: str, cfg: NetConfig, device=None):
    """(MultiObsEmbedding, ActorState) from an actor ``.npz`` (module docstring),
    on CUDA unless ``device`` names another."""
    device = resolve_device(device)
    with np.load(path) as f:
        tree = unflatten({k: f[k] for k in f.files})
    return actor_from_flax({"params": tree["params"]}, tree["log_std"], tree["norm"],
                           cfg, device)


def load_ppo_actor_npz(path: str, agent: PPOAgent, device=None) -> PPOActor:
    """A :class:`PPOActor` (actor with the head of ``agent``'s dist type,
    log_std, normalizer) from an actor ``.npz`` (module docstring), on CUDA
    unless ``device`` names another."""
    actor, st = load_actor_npz(path, agent.actor_cfg, device)
    return PPOActor(actor=actor, log_std=st.log_std, norm=st.norm)
