"""Multi-modal observation-fusion network, actor side
(counterpart of ``hope_tpu/models/policy.py``; the ``Critic`` comes with the
training slice).

Layouts follow the JAX package at the public boundary: images arrive CHW and
the image encoder flattens its last feature map in (h, w, c) order, as the
Flax encoder does after its NHWC convolutions, so converted Dense weights
apply unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NetConfig
from .attention import AttentionFusion


def _act(cfg: NetConfig):
    return torch.tanh if cfg.use_tanh_activation else F.leaky_relu


class EmbedMLP(nn.Module):
    """n_embed_layers-deep MLP to embed_dim."""

    def __init__(self, cfg: NetConfig, in_dim: int):
        super().__init__()
        self.act = _act(cfg)
        dims = [in_dim] + [cfg.embed_dim] * cfg.n_embed_layers
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        x = self.layers[0](x)
        for layer in self.layers[1:]:
            x = layer(self.act(x))
        return x


class ConvBlock(nn.Module):
    """conv-act-maxpool with a conv1x1 + avgpool residual shortcut."""

    def __init__(self, cin: int, cout: int, k: int, use_tanh: bool = True):
        super().__init__()
        self.act = torch.tanh if use_tanh else F.leaky_relu
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)   # Flax SAME, odd k
        self.shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        y = F.max_pool2d(self.act(self.conv(x)), 2)
        return y + F.avg_pool2d(self.shortcut(x), 2)


class ImgEncoder(nn.Module):
    """Conv stack -> fc -> (mean, std) heads; the fusion net uses the mean."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        c, h, w = cfg.img_shape
        self.act = _act(cfg)
        chans = [c] + list(cfg.img_conv_channels)
        self.blocks = nn.ModuleList(
            ConvBlock(a, b, cfg.img_conv_kernel, cfg.use_tanh_activation)
            for a, b in zip(chans[:-1], chans[1:]))
        scale = 2 ** len(cfg.img_conv_channels)
        dims = [chans[-1] * (h // scale) * (w // scale)] + list(cfg.img_fc_sizes)
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.mean = nn.Linear(dims[-1], cfg.embed_dim)
        self.std = nn.Linear(dims[-1], cfg.embed_dim)

    def forward(self, img_chw):
        x = img_chw
        for block in self.blocks:
            x = block(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) order
        for layer in self.fc:
            x = self.act(layer(x))
        return self.mean(x), self.std(x)


class MLPFusion(nn.Module):
    """Concat trunk used when attention is disabled."""

    def __init__(self, cfg: NetConfig, in_dim: int):
        super().__init__()
        self.act = _act(cfg)
        if cfg.n_hidden_layers == 1:
            dims = [in_dim, cfg.output_dim]
        else:
            dims = [in_dim] + [cfg.hidden_dim] * (cfg.n_hidden_layers - 1) + [cfg.output_dim]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, tokens):
        x = self.layers[0](tokens.reshape(tokens.shape[0], -1))
        for layer in self.layers[1:-1]:
            x = layer(self.act(x))
        return self.layers[-1](x) if len(self.layers) > 1 else x


class MultiObsEmbedding(nn.Module):
    """The fusion network. Call with an obs dict: lidar (B, 120), target
    (B, 5), optional action_mask (B, 42) and img (B, 3, H, W)."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.cfg = cfg
        self.act = _act(cfg)
        self.embed_lidar = EmbedMLP(cfg, cfg.lidar_dim)
        self.embed_tgt = EmbedMLP(cfg, cfg.target_dim)
        self.embed_am = EmbedMLP(cfg, cfg.action_mask_dim) if cfg.action_mask_dim else None
        if cfg.img_shape is not None:
            self.embed_img = ImgEncoder(cfg)
            self.re_embed_img = nn.Linear(cfg.embed_dim, cfg.embed_dim)
        else:
            self.embed_img = self.re_embed_img = None
        if cfg.action_input_dim:
            raise ValueError("the action modality belongs to the critic")
        n_tok = cfg.n_modal
        if cfg.attention is not None:
            a = cfg.attention
            self.fusion = AttentionFusion(cfg.embed_dim, n_tok, a.depth, a.heads,
                                          a.dim_head, a.mlp_dim, a.hidden_dim,
                                          cfg.output_dim)
        else:
            self.fusion = MLPFusion(cfg, cfg.embed_dim * n_tok)

    def forward(self, obs: dict):
        tokens = [self.embed_lidar(obs["lidar"]), self.embed_tgt(obs["target"])]
        if self.embed_am is not None:
            tokens.append(self.embed_am(obs["action_mask"]))
        if self.embed_img is not None:
            mean, _ = self.embed_img(obs["img"])
            tokens.append(self.re_embed_img(self.act(mean)))
        out = self.fusion(torch.stack(tokens, dim=1))
        return torch.tanh(out) if self.cfg.use_tanh_output else out
