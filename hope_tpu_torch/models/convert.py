"""Carry a Flax actor's parameters into the port's ``MultiObsEmbedding``.

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

from ..agents.sac import ActorState
from ..agents.state_norm import NormState
from ..config import NetConfig
from ..device import resolve_device
from .policy import MultiObsEmbedding


def _dense(tree):
    return {"weight": np.asarray(tree["kernel"]).T,
            **({"bias": np.asarray(tree["bias"])} if "bias" in tree else {})}


def _conv(tree):
    return {"weight": np.asarray(tree["kernel"]).transpose(3, 2, 0, 1),
            "bias": np.asarray(tree["bias"])}


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
    if cfg.img_shape is not None:
        img = p["embed_img"]
        for i in range(len(cfg.img_conv_channels)):
            put(f"embed_img.blocks.{i}.conv", _conv(img[f"ConvBlock_{i}"]["Conv_0"]))
            put(f"embed_img.blocks.{i}.shortcut", _conv(img[f"ConvBlock_{i}"]["Conv_1"]))
        n_fc = len(cfg.img_fc_sizes)
        for i in range(n_fc):
            put(f"embed_img.fc.{i}", _dense(img[f"Dense_{i}"]))
        put("embed_img.mean", _dense(img[f"Dense_{n_fc}"]))
        put("embed_img.std", _dense(img[f"Dense_{n_fc + 1}"]))
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
    state = {k: torch.as_tensor(np.array(v, np.float32))
             for k, v in _torch_state(params["params"], cfg).items()}
    net.load_state_dict(state, strict=True)
    net = net.to(device).eval()
    t = lambda a: torch.as_tensor(np.array(a, np.float32), device=device)  # noqa: E731
    st = ActorState(
        log_std=t(log_std),
        norm=NormState(mean={k: t(v) for k, v in norm["mean"].items()},
                       S={k: t(v) for k, v in norm["S"].items()},
                       n=torch.as_tensor(int(np.asarray(norm["n"])), device=device)))
    return net, st


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
