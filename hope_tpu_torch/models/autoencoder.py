"""BEV-image autoencoders for encoder pretraining (counterpart of
``hope_tpu/models/autoencoder.py``: ``DeConvBlock``, ``ImgDecoder``,
``AEConv``, ``VAEConv``, ``graft_encoder_params`` and the two losses).

The encoder is the policy's :class:`ImgEncoder`, so a pretrained encoder's
parameters graft into the image tower of the actor and the critics
(:func:`graft_encoder_params`). The decoder works in NHWC as the Flax one does
and returns CHW images; its transposed convolutions are Flax
``ConvTranspose`` at stride 1 with the default ``transpose_kernel=False``,
which is a plain correlation with the kernel as stored, so they are
``nn.Conv2d`` here (``models/convert.ae_from_flax`` carries the kernels over
unflipped). ``jax.image.resize(..., "bilinear")`` at 2x upsampling samples at
half-pixel centres with the borders clamped: ``F.interpolate(mode="bilinear",
align_corners=False)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import NetConfig
from .policy import ImgEncoder, _act, _lecun_normal_, flax_init_


class DeConvBlock(nn.Module):
    """(transposed) conv + act + bilinear upsample + conv, with a 1x1 conv,
    upsample, 1x1 conv residual shortcut. NCHW in and out."""

    def __init__(self, cin: int, cout: int, k: int, upsample: int, use_tanh: bool = True):
        super().__init__()
        self.act = torch.tanh if use_tanh else F.leaky_relu
        self.upsample = upsample
        self.deconv = nn.Conv2d(cin, cout, k, padding=k // 2)   # Flax SAME, odd k
        self.conv = nn.Conv2d(cout, cout, k, padding=k // 2)
        self.sc_deconv = nn.Conv2d(cin, cout, 1)
        self.sc_conv = nn.Conv2d(cout, cout, 1)

    def _up(self, x):
        return F.interpolate(x, size=(self.upsample, self.upsample), mode="bilinear",
                             align_corners=False)

    def forward(self, x):
        y = self.conv(self._up(self.act(self.deconv(x))))
        return y + self.sc_conv(self._up(self.sc_deconv(x)))


class ImgDecoder(nn.Module):
    """fc stack -> deconv stack -> sigmoid image (B, C, H, W)."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        self.act = _act(cfg)
        chans = list(cfg.img_conv_channels)
        c_img, h, _ = cfg.img_shape
        self.base = h // (2 ** len(chans))
        dims = [cfg.embed_dim] + list(reversed(cfg.img_fc_sizes))
        self.fc = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.to_map = nn.Linear(dims[-1], self.base * self.base * chans[-1])
        outs = list(reversed(chans[:-1])) + [c_img]
        ins = [chans[-1]] + outs[:-1]
        self.blocks = nn.ModuleList(
            DeConvBlock(a, b, cfg.img_conv_kernel, self.base * 2 ** (i + 1),
                        cfg.use_tanh_activation)
            for i, (a, b) in enumerate(zip(ins, outs)))

    def forward(self, z):
        x = z
        for layer in self.fc:
            x = self.act(layer(x))
        x = self.act(self.to_map(x))
        # the Flax decoder reshapes to NHWC; as NCHW that is a permute
        x = x.reshape(x.shape[0], self.base, self.base, -1).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = block(x)
        return torch.sigmoid(x)


def _init_(ae: nn.Module, generator: torch.Generator | None):
    """Flax's initializers: the encoder as the policy's, every decoder layer
    truncated lecun_normal with zero biases."""
    flax_init_(ae.encoder, generator)
    with torch.no_grad():
        for m in ae.decoder.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                _lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)


class AEConv(nn.Module):
    """Deterministic conv autoencoder: CHW image -> reconstruction."""

    def __init__(self, cfg: NetConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ImgEncoder(cfg)
        self.decoder = ImgDecoder(cfg)
        _init_(self, generator)

    def forward(self, img_chw):
        mean, _ = self.encoder(img_chw)
        return self.decoder(mean)


class VAEConv(nn.Module):
    """Variational conv autoencoder: returns (reconstruction, mean,
    log_var). The latent's standard normals come from ``generator``, or are
    given as ``noise`` (B, embed_dim)."""

    def __init__(self, cfg: NetConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = ImgEncoder(cfg)
        self.decoder = ImgDecoder(cfg)
        _init_(self, generator)

    def forward(self, img_chw, generator: torch.Generator | None = None, noise=None):
        mean, log_var = self.encoder(img_chw)
        std = torch.exp(0.5 * log_var)
        if noise is None:
            noise = torch.randn(std.shape, generator=generator, device=std.device)
        return self.decoder(mean + std * noise), mean, log_var


@torch.no_grad()
def graft_encoder_params(net: nn.Module, ae: nn.Module, net_name: str = "embed_img") -> int:
    """Copy the autoencoder's encoder into every ``net_name`` module of
    ``net`` (the actor's ``embed_img``, a critic's ``net.embed_img``), in
    place, each parameter into its own tensor. Returns the number of tensors
    copied; raises on a shape mismatch or when nothing matched."""
    enc = ae.encoder.state_dict()
    n = 0
    for name, m in net.named_modules():
        if name.split(".")[-1] != net_name:
            continue
        for k, v in m.state_dict(keep_vars=True).items():
            if k in enc:
                if v.shape != enc[k].shape:
                    raise ValueError(f"graft shape mismatch at {name}.{k}: policy "
                                     f"{tuple(v.shape)} vs AE {tuple(enc[k].shape)}")
                v.copy_(enc[k])
                n += 1
    if n == 0:
        raise ValueError("graft_encoder_params matched no parameters")
    return n


def ae_loss(model: AEConv, imgs):
    return torch.mean((model(imgs) - imgs) ** 2)


def vae_loss(model: VAEConv, imgs, generator: torch.Generator | None = None, noise=None,
             beta: float = 1e-4):
    recon, mean, log_var = model(imgs, generator, noise)
    rec = torch.mean((recon - imgs) ** 2)
    kl = -0.5 * torch.mean(1 + log_var - mean ** 2 - torch.exp(log_var))
    return rec + beta * kl
