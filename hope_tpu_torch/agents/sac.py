"""Soft Actor-Critic with twin critics, a learnable temperature and a
state-independent learnable log_std (counterpart of
``hope_tpu/agents/sac.py``).

The acting half (``dist``, ``get_action``, ``log_prob``) reads the agent's
actor and a state's ``log_std`` and ``norm``: an :class:`ActorState` for a
loaded actor, or the :class:`SACState` of a training run, whose ``actor`` is
the agent's actor. The learning half (``init``, ``observe_norm``,
``update``) updates the modules of a :class:`SACState` in place, with one
``torch.optim.Adam`` per network as the JAX package keeps one optax Adam per
network.

With ``SACConfig.freeze_img_encoder`` every parameter under an ``embed_img``
module (the actor's and the critics' image encoders) stays as it is, as
optax's ``chain(adam, masked(set_to_zero))`` keeps it: Adam still steps, so
its moments for those parameters advance with their gradients, and only the
applied update is dropped.

Across the W ranks of a ``parallel.mesh.Mesh`` every rank receives the same
minibatch and computes the loss of its even share of the rows, summed and
divided by the whole minibatch's size; one sum over the ranks per network
(the gradients flattened into one bucket, with the logged losses) gives
each rank the whole minibatch's gradient, so every rank takes the same Adam
step and the ranks stay bitwise identical.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..config import NetConfig, SACConfig
from ..envs.action_mask import ActionMaskTable
from ..envs.action_mask import choose_action as mask_choose
from ..models.policy import Critic, MultiObsEmbedding
from ..parallel.mesh import Mesh, all_reduce_sum
from ..utils.profiling import annotated
from .schedules import lr_schedule
from .state_norm import NormState, normalize, update as norm_update

@dataclass
class ActorState:
    log_std: torch.Tensor    # (1, action_dim)
    norm: NormState


@dataclass
class SACState:
    """A training run's agent: the networks (updated in place), the
    temperature, one Adam per network, the observation statistics and the
    count of updates taken."""

    actor: nn.Module
    log_std: torch.Tensor        # (1, action_dim) float32 leaf
    critic1: nn.Module
    critic2: nn.Module
    target1: nn.Module
    target2: nn.Module
    log_alpha: torch.Tensor      # () float32 leaf
    opt_actor: torch.optim.Adam  # actor parameters and log_std
    opt_critic1: torch.optim.Adam
    opt_critic2: torch.optim.Adam
    opt_alpha: torch.optim.Adam
    norm: NormState
    steps: int


class SACAgent:
    def __init__(self, actor: nn.Module, cfg: SACConfig = SACConfig(),
                 critic_cfg: NetConfig | None = None,
                 mask_table: ActionMaskTable | None = None):
        """``critic_cfg`` (with ``action_input_dim`` set) is needed only to
        train (:meth:`init`), ``mask_table`` only for
        :meth:`choose_action`."""
        self.actor = actor
        self.cfg = cfg
        self.critic_cfg = critic_cfg
        self.mask_table = mask_table

    # ---------------------------------------------------------------- acting

    @torch.no_grad()
    def dist(self, st, obs: dict):
        """Policy mean and std (B, action_dim)."""
        obs = normalize(obs, st.norm) if self.cfg.state_norm else obs
        mean = torch.clamp(self.actor(obs), -1.0, 1.0)
        std = torch.exp(st.log_std)
        return mean, std.expand_as(mean)

    @staticmethod
    def _log_prob(mean, std, action):
        var = std ** 2
        return -((action - mean) ** 2) / (2 * var) - torch.log(std) - 0.5 * math.log(2 * math.pi)

    @annotated("policy/act")
    def get_action(self, st, obs: dict, generator: torch.Generator):
        """Unmasked gaussian sample, clipped, and its log-prob."""
        mean, std = self.dist(st, obs)
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
        action = torch.clamp(mean + std * noise, -1.0, 1.0)
        return action, torch.sum(self._log_prob(mean, std, action), dim=-1)

    @annotated("policy/act")
    def choose_action(self, st, obs: dict, generator: torch.Generator | None = None, noise=None):
        """Masked discrete choice (the reference's choose_action): a table
        action per env drawn by the policy's gaussian log-prob times the
        action mask, and its log-prob under the policy. ``noise``: (B, A)
        standard Gumbel noise of the draw, else drawn from ``generator``."""
        if self.mask_table is None:
            raise ValueError("SACAgent.choose_action needs the agent's mask_table")
        mean, std = self.dist(st, obs)
        action, _ = mask_choose(mean, std, obs["action_mask"], self.mask_table, generator, noise)
        return action, torch.sum(self._log_prob(mean, std, action), dim=-1)

    def log_prob(self, st, obs: dict, action):
        mean, std = self.dist(st, obs)
        return torch.sum(self._log_prob(mean, std, action), dim=-1)

    # ---------------------------------------------------------------- init

    def init(self, obs_shape: dict, generator: torch.Generator | None = None) -> SACState:
        """Fresh weights for the actor (in place) and two new critics, drawn
        from ``generator`` (CPU) as Flax would initialize them; targets equal
        to the critics; log_std 0; log_alpha = log(initial_temperature);
        fresh Adams and observation statistics, on the actor's device."""
        cfg = self.cfg
        if self.critic_cfg is None:
            raise ValueError("SACAgent.init needs critic_cfg")
        dev = next(self.actor.parameters()).device
        with torch.no_grad():
            fresh = MultiObsEmbedding(self.actor.cfg, generator)
            for p, q in zip(self.actor.parameters(), fresh.parameters()):
                p.copy_(q)
        critics = [Critic(self.critic_cfg, generator).to(dev) for _ in range(2)]
        log_std = torch.zeros((1, cfg.action_dim), device=dev, requires_grad=True)
        log_alpha = torch.tensor(math.log(cfg.initial_temperature), dtype=torch.float32,
                                 device=dev, requires_grad=True)
        return self.make_state(critics, log_std, log_alpha, NormState.create(obs_shape, dev))

    def make_state(self, critics, log_std, log_alpha, norm: NormState, targets=None,
                   steps: int = 0) -> SACState:
        """A :class:`SACState` around the agent's actor and these critics
        (targets: copies of the critics unless given), with fresh Adams."""
        cfg = self.cfg
        critic1, critic2 = critics
        target1, target2 = targets or (copy.deepcopy(critic1), copy.deepcopy(critic2))
        for t in (target1, target2):
            t.requires_grad_(False)
        self.actor.train()

        def adam(params, lr):
            return torch.optim.Adam(params, lr=lr, eps=1e-8)

        return SACState(
            actor=self.actor, log_std=log_std, critic1=critic1, critic2=critic2,
            target1=target1, target2=target2, log_alpha=log_alpha,
            opt_actor=adam([*self.actor.parameters(), log_std], cfg.lr_actor),
            opt_critic1=adam(critic1.parameters(), cfg.lr_critic),
            opt_critic2=adam(critic2.parameters(), cfg.lr_critic),
            opt_alpha=adam([log_alpha], cfg.lr_alpha),
            norm=norm, steps=steps)

    # ---------------------------------------------------------------- update

    def observe_norm(self, st: SACState, next_obs: dict) -> SACState:
        """Fold fresh next-obs into the Welford stats (only next_obs, as the
        reference's push does)."""
        if self.cfg.state_norm:
            st.norm = norm_update(st.norm, next_obs)
        return st

    def _sample_with_logp(self, actor, log_std, obs, noise):
        mean = torch.clamp(actor(obs), -1.0, 1.0)
        std = torch.exp(log_std).expand_as(mean)
        a = torch.clamp(mean + std * noise, -1.0, 1.0)
        return a, torch.sum(self._log_prob(mean, std, a), dim=-1, keepdim=True)

    def frozen(self, net: nn.Module) -> list:
        """The parameters of ``net`` that no update moves: those under an
        ``embed_img`` module where ``freeze_img_encoder`` is set, else none."""
        if not self.cfg.freeze_img_encoder:
            return []
        return [p for name, m in net.named_modules() if name.split(".")[-1] == "embed_img"
                for p in m.parameters()]

    def _step(self, opt: torch.optim.Adam, loss, lr: float, t: int, frozen=(),
              mesh: Mesh | None = None, logged=()):
        """One Adam step on ``loss`` at the schedule's rate for update count
        ``t`` (the count before this update, as optax reads it); the
        ``frozen`` parameters keep their values (Adam's moments for them
        still advance). Across ranks the gradients, and the ``logged``
        values with them, are summed over the ranks first (in place)."""
        rate = lr_schedule(lr, self.cfg.lr_decay, self.cfg.max_train_steps)(t)
        for g in opt.param_groups:
            g["lr"] = rate
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None and mesh.sharded:
            grads = [p.grad for g in opt.param_groups for p in g["params"]
                     if p.grad is not None]
            all_reduce_sum(grads + list(logged), mesh)
        kept = [p.detach().clone() for p in frozen]
        opt.step()
        with torch.no_grad():
            for p, v in zip(frozen, kept):
                p.copy_(v)

    def update(self, st: SACState, batch: dict, generator: torch.Generator | None = None,
               noise=None, mesh: Mesh | None = None):
        """One SAC step, in place on ``st``. ``batch``: obs/*, action,
        reward, done, next_obs/* (already state-normalized). ``noise``: the
        (B, action_dim) standard normals for the target actions and for the
        actor loss, else drawn from ``generator``. Across the ranks of
        ``mesh`` each rank is given the same ``batch`` and ``noise`` and
        takes its share of the rows (the module docstring).

        Returns the metrics as 0-d device tensors: actor_loss, critic_loss
        (sum of both critics'), alpha (after the step) and entropy."""
        cfg = self.cfg
        n = batch["action"].shape[0]
        if noise is None:
            noise = [torch.randn(batch["action"].shape, generator=generator,
                                 device=batch["action"].device) for _ in range(2)]
        split = mesh is not None and mesh.sharded
        if split:
            batch = {k: mesh.rows(v) for k, v in batch.items()}
            noise = [mesh.rows(z) for z in noise]

        def mean(x):
            # a rank's share of the whole minibatch's mean
            return torch.sum(x) / n if split else torch.mean(x)

        obs = {k[4:]: v for k, v in batch.items() if k.startswith("obs/")}
        next_obs = {k[9:]: v for k, v in batch.items() if k.startswith("next_obs/")}
        action = batch["action"]
        reward = batch["reward"][:, None]
        done = batch["done"][:, None].to(torch.float32)
        n_target, n_actor = noise
        t = st.steps

        alpha = torch.exp(st.log_alpha).detach()

        # targets: the old actor and the target nets
        with torch.no_grad():
            next_a, next_logp = self._sample_with_logp(st.actor, st.log_std, next_obs,
                                                       n_target)
            q_next = torch.minimum(st.target1(next_obs, next_a), st.target2(next_obs, next_a))
            q_target = reward + (1 - done) * cfg.gamma * (q_next - alpha * next_logp)

        l1 = mean((st.critic1(obs, action) - q_target) ** 2)
        logged = {"l1": l1.detach().reshape(1).clone()}
        self._step(st.opt_critic1, l1, cfg.lr_critic, t, self.frozen(st.critic1), mesh,
                   [logged["l1"]])
        l2 = mean((st.critic2(obs, action) - q_target) ** 2)
        logged["l2"] = l2.detach().reshape(1).clone()
        self._step(st.opt_critic2, l2, cfg.lr_critic, t, self.frozen(st.critic2), mesh,
                   [logged["l2"]])

        # actor, against the UPDATED critics; no gradient reaches them
        st.critic1.requires_grad_(False)
        st.critic2.requires_grad_(False)
        try:
            a, logp = self._sample_with_logp(st.actor, st.log_std, obs, n_actor)
            q = torch.minimum(st.critic1(obs, a), st.critic2(obs, a))
            la = mean(alpha * logp - q)
            logged["la"] = la.detach().reshape(1).clone()
            logged["entropy"] = -mean(logp.detach()).reshape(1)
            self._step(st.opt_actor, la, cfg.lr_actor, t, self.frozen(st.actor), mesh,
                       [logged["la"], logged["entropy"]])
        finally:
            st.critic1.requires_grad_(True)
            st.critic2.requires_grad_(True)

        if cfg.learn_temperature:
            ent_err = (-logp - cfg.target_entropy).detach()
            self._step(st.opt_alpha, mean(torch.exp(st.log_alpha) * ent_err),
                       cfg.lr_alpha, t, mesh=mesh)

        # Polyak: the NEW critics blended into the targets
        with torch.no_grad():
            for tgt, src in ((st.target1, st.critic1), (st.target2, st.critic2)):
                tp = list(tgt.parameters())
                torch._foreach_mul_(tp, 1 - cfg.tau)
                torch._foreach_add_(tp, list(src.parameters()), alpha=cfg.tau)
        st.steps += 1
        return {"actor_loss": logged["la"][0], "critic_loss": logged["l1"][0] + logged["l2"][0],
                "alpha": torch.exp(st.log_alpha).detach(), "entropy": logged["entropy"][0]}
