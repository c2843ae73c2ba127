"""Soft Actor-Critic, acting half (counterpart of ``hope_tpu/agents/sac.py``
``_dist``, ``get_action``, ``log_prob``): a state-independent learnable
log_std around the actor's clipped mean, after state normalization. The
update arrives with the training slice."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..config import SACConfig
from .state_norm import NormState, normalize


@dataclass
class ActorState:
    log_std: torch.Tensor    # (1, action_dim)
    norm: NormState


class SACAgent:
    def __init__(self, actor: nn.Module, cfg: SACConfig = SACConfig()):
        self.actor = actor
        self.cfg = cfg

    @torch.no_grad()
    def dist(self, st: ActorState, obs: dict):
        """Policy mean and std (B, action_dim)."""
        obs = normalize(obs, st.norm) if self.cfg.state_norm else obs
        mean = torch.clamp(self.actor(obs), -1.0, 1.0)
        std = torch.exp(st.log_std)
        return mean, std.expand_as(mean)

    @staticmethod
    def _log_prob(mean, std, action):
        var = std ** 2
        return -((action - mean) ** 2) / (2 * var) - torch.log(std) - 0.5 * math.log(2 * math.pi)

    def get_action(self, st: ActorState, obs: dict, generator: torch.Generator):
        """Unmasked gaussian sample, clipped, and its log-prob."""
        mean, std = self.dist(st, obs)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = torch.clamp(mean + std * noise, -1.0, 1.0)
        return action, torch.sum(self._log_prob(mean, std, action), dim=-1)

    def log_prob(self, st: ActorState, obs: dict, action):
        mean, std = self.dist(st, obs)
        return torch.sum(self._log_prob(mean, std, action), dim=-1)
