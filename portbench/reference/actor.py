"""HOPE's SAC actor, forward only, from the actor ``.npz`` (Flax layout:
kernels (in, out), convolutions HWIO), in float64.

Tokens: lidar and target (each normalized by the running statistics the
file holds), the action mask, and the image (two conv blocks, a dense
layer, the mean head, re-embedded), each embedded to 128 wide; one
pre-norm transformer layer of 8 heads of 32 over the four tokens; the
flattened tokens through a 128-wide tanh layer to 2 outputs, tanh. The
action is the mean clipped to [-1, 1] plus the standard deviation times the
run's Gaussian draw, clipped again; its log-probability is the Gaussian's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

F64 = torch.float64
HEADS, DIM_HEAD, LN_EPS = 8, 32, 1e-6


class Actor:
    def __init__(self, path: str, device):
        with np.load(path) as f:
            self.p = {k: torch.as_tensor(f[k], dtype=F64, device=device) for k in f.files}

    def _dense(self, x, name):
        return x @ self.p[name + "/kernel"] + self.p[name + "/bias"]

    def _embed(self, x, name):
        return self._dense(torch.tanh(self._dense(x, f"params/{name}/Dense_0")),
                           f"params/{name}/Dense_1")

    def _conv(self, x, name, pad):
        w = self.p[name + "/kernel"].permute(3, 2, 0, 1)         # HWIO -> OIHW
        return F.conv2d(x, w, self.p[name + "/bias"], padding=pad)

    def _image(self, img):
        x = img.to(F64)
        for i in range(2):
            blk = f"params/embed_img/ConvBlock_{i}"
            x = (F.max_pool2d(torch.tanh(self._conv(x, blk + "/Conv_0", 1)), 2)
                 + F.avg_pool2d(self._conv(x, blk + "/Conv_1", 0), 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)        # (h, w, c) order
        x = torch.tanh(self._dense(x, "params/embed_img/Dense_0"))
        mean = self._dense(x, "params/embed_img/Dense_1")
        return self._dense(torch.tanh(mean), "params/re_embed_img")

    def _norm(self, x, key):
        n = max(float(self.p["norm/n"]), 1.0)
        std = torch.sqrt(self.p[f"norm/S/{key}"] / n)
        return (x.to(F64) - self.p[f"norm/mean/{key}"]) / (std + 1e-8)

    def _layer_norm(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        scale, bias = self.p[name + "/scale"], self.p[name + "/bias"]
        return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias

    def _encoder(self, x):
        enc = "params/fusion/TransformerEncoder_0"
        h = self._layer_norm(x, enc + "/LayerNorm_0")
        b, n, _ = h.shape
        qkv = h @ self.p[enc + "/MultiHeadAttention_0/to_qkv/kernel"]
        q, k, v = (t.reshape(b, n, HEADS, DIM_HEAD).transpose(1, 2) for t in qkv.chunk(3, -1))
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(DIM_HEAD), -1)
        o = (att @ v).transpose(1, 2).reshape(b, n, HEADS * DIM_HEAD)
        x = x + self._dense(o, enc + "/MultiHeadAttention_0/to_out")
        h = self._layer_norm(x, enc + "/LayerNorm_1")
        ff = enc + "/FeedForward_0"
        return x + self._dense(torch.tanh(self._dense(h, ff + "/Dense_0")), ff + "/Dense_1")

    def mean_std(self, obs):
        tokens = torch.stack([self._embed(self._norm(obs["lidar"], "lidar"), "embed_lidar"),
                              self._embed(self._norm(obs["target"], "target"), "embed_tgt"),
                              self._embed(obs["action_mask"].to(F64), "embed_am"),
                              self._image(obs["img"])], dim=1)
        x = self._encoder(tokens).reshape(tokens.shape[0], -1)
        x = self._dense(torch.tanh(self._dense(x, "params/fusion/Dense_0")),
                        "params/fusion/Dense_1")
        mean = torch.tanh(x).clamp(-1.0, 1.0)
        return mean, torch.exp(self.p["log_std"]).expand_as(mean)

    def act(self, obs, noise):
        """(action, log-probability) under the standard normal ``noise``."""
        mean, std = self.mean_std(obs)
        a = (mean + std * noise.to(F64)).clamp(-1.0, 1.0)
        logp = (-((a - mean) ** 2) / (2 * std ** 2) - torch.log(std)
                - 0.5 * math.log(2 * math.pi)).sum(-1)
        return a, logp
