"""PPO with clipped surrogate, GAE and a Polyak critic target (counterpart
of ``hope_tpu/agents/ppo.py``).

Three policy families, as in the JAX package: gaussian (clamped mean and a
global ``log_std``), beta (softplus + 1 parameters, actions scaled from
(0, 1) to [-1, 1]) and categorical (logits over the 42 discrete actions).

The acting half (``choose_action``, ``get_action``, ``log_prob``) reads a
state's ``actor``, ``log_std`` and ``norm``: a :class:`PPOActor` for a loaded
actor, or the :class:`PPOState` of a training run. ``update`` is the
full-buffer update: GAE over the (T, B) buffer, then ``mini_epoch`` passes of
shuffled minibatches over the N = T * B flattened transitions, updating the
modules of a :class:`PPOState` in place with one ``torch.optim.Adam`` for the
actor and ``log_std`` and one for the critic, as the JAX package keeps one
optax Adam for each.

Across the W ranks of a ``parallel.mesh.Mesh`` every rank holds the whole
(T, B) buffer (gathered along B), so GAE, the advantage normalization and
the permutations mean what they mean in one process; each rank computes the
loss of its even share of each minibatch's rows, summed and divided by the
minibatch size, and the gradients are summed over the ranks before the
global-norm clip and the Adam steps. The KL early stop decides on the KL
summed over the ranks, so every rank stops at the same minibatch.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass

import torch
from torch import nn

from ..config import NetConfig, PPOConfig
from ..envs.action_mask import ActionMaskTable, gumbel
from ..envs.action_mask import choose_action as mask_choose
from ..models.policy import MultiObsEmbedding, ValueNet
from ..parallel.mesh import Mesh, all_reduce_sum
from ..utils.profiling import annotated
from .schedules import lr_schedule
from .state_norm import NormState, normalize, update as norm_update

_BETA_EPS = 1e-5
# the critic passes over the whole buffer run this many transitions at a time
_VALUE_CHUNK = 1024


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no linear
    branch (torch's softplus turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _beta_params(raw):
    a, b = torch.chunk(raw, 2, dim=-1)
    return _softplus(a) + 1.0, _softplus(b) + 1.0


def _algdiv(a, b):
    """log(gamma(b)) - log(gamma(a + b)) for b >= 8 and a <= b, as the JAX
    package's ``betaln`` computes it (scipy's cdflib ``algdiv``)."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def betaln(a, b):
    """log B(a, b), with the JAX package's two branches (lgamma below 8,
    ``algdiv`` from 8)."""
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


def _beta_logpdf(x, a, b):
    x = torch.clamp(x, _BETA_EPS, 1.0 - _BETA_EPS)
    return (a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x) - betaln(a, b)


def _beta_entropy(a, b):
    dg = torch.special.digamma
    return (betaln(a, b) - (a - 1) * dg(a) - (b - 1) * dg(b) + (a + b - 2) * dg(a + b))


def _gaussian_log_prob(mean, std, a):
    return -((a - mean) ** 2) / (2 * std ** 2) - torch.log(std) - 0.5 * math.log(2 * math.pi)


@dataclass
class PPOActor:
    """A loaded actor: what the acting half reads."""

    actor: nn.Module
    log_std: torch.Tensor        # (1, action_dim)
    norm: NormState


@dataclass
class PPOState:
    """A training run's agent: the networks (updated in place), one Adam for
    the actor and ``log_std``, one for the critic, the observation statistics
    and the count of updates taken."""

    actor: nn.Module
    log_std: torch.Tensor          # (1, action_dim) float32 leaf
    critic: nn.Module
    critic_target: nn.Module
    opt_actor: torch.optim.Adam    # actor parameters and log_std
    opt_critic: torch.optim.Adam
    norm: NormState
    steps: int


def adam_count(opt: torch.optim.Optimizer) -> int:
    """The number of steps ``opt`` has applied (optax's count): torch's Adam
    keeps it per parameter, the first parameter's is read."""
    first = opt.param_groups[0]["params"][0]
    state = opt.state.get(first)
    return int(state["step"]) if state else 0


class PPOAgent:
    def __init__(self, actor_cfg: NetConfig, critic_cfg: NetConfig,
                 cfg: PPOConfig = PPOConfig(), mask_table: ActionMaskTable | None = None):
        if critic_cfg.action_input_dim:
            raise ValueError("the PPO critic is V(s): critic_cfg.action_input_dim must be 0")
        if cfg.dist_type not in ("gaussian", "beta", "categorical"):
            raise ValueError(f"unknown dist_type {cfg.dist_type!r}")
        self.cfg = cfg
        self.mask_table = mask_table
        # the actor's head width follows the distribution family
        if cfg.dist_type == "beta":
            actor_cfg = dataclasses.replace(actor_cfg, output_dim=2 * cfg.action_dim,
                                            use_tanh_output=False)
        elif cfg.dist_type == "categorical":
            actor_cfg = dataclasses.replace(actor_cfg, output_dim=cfg.n_discrete,
                                            use_tanh_output=False)
        self.actor_cfg = actor_cfg
        self.critic_cfg = critic_cfg

    # ---------------------------------------------------------------- init

    def init(self, obs_shape: dict, generator: torch.Generator | None = None,
             device=None) -> PPOState:
        """Fresh actor and critic drawn from ``generator`` (CPU) as Flax would
        initialize them, the target equal to the critic, log_std 0, fresh
        Adams and observation statistics, on ``device`` (the CPU unless
        named)."""
        actor = MultiObsEmbedding(self.actor_cfg, generator).to(device)
        critic = ValueNet(self.critic_cfg, generator).to(device)
        log_std = torch.zeros((1, self.cfg.action_dim), device=device, requires_grad=True)
        return self.make_state(actor, log_std, critic, NormState.create(obs_shape, device))

    def make_state(self, actor, log_std, critic, norm: NormState, critic_target=None,
                   steps: int = 0) -> PPOState:
        """A :class:`PPOState` around these modules (the target a copy of the
        critic unless given), with fresh Adams."""
        cfg = self.cfg
        critic_target = critic_target or copy.deepcopy(critic)
        critic_target.requires_grad_(False)
        actor.train()
        return PPOState(
            actor=actor, log_std=log_std, critic=critic, critic_target=critic_target,
            opt_actor=torch.optim.Adam([*actor.parameters(), log_std], lr=cfg.lr_actor,
                                       eps=1e-8),
            opt_critic=torch.optim.Adam(critic.parameters(), lr=cfg.lr_critic, eps=1e-8),
            norm=norm, steps=steps)

    # ---------------------------------------------------------------- acting

    def _raw(self, actor, norm: NormState, obs: dict):
        obs = normalize(obs, norm) if self.cfg.state_norm else obs
        return actor(obs)

    def _moments(self, raw, log_std):
        """Mean and std of the policy in normalized [-1, 1] action units (for
        the masked discrete projection)."""
        if self.cfg.dist_type == "gaussian":
            mean = torch.clamp(raw, -1.0, 1.0)
            return mean, torch.exp(log_std).expand_as(mean)
        if self.cfg.dist_type == "beta":
            a, b = _beta_params(raw)
            mu = a / (a + b)
            var = a * b / ((a + b) ** 2 * (a + b + 1))
            return 2 * mu - 1, 2 * torch.sqrt(var)
        raise ValueError("categorical has no gaussian moments")

    def _logp_of(self, raw, log_std, action):
        """Log-prob (B,) of a normalized [-1, 1] action under the policy."""
        if self.cfg.dist_type == "gaussian":
            mean = torch.clamp(raw, -1.0, 1.0)
            std = torch.exp(log_std).expand_as(mean)
            return torch.sum(_gaussian_log_prob(mean, std, action), dim=-1)
        if self.cfg.dist_type == "beta":
            a, b = _beta_params(raw)
            x = (action + 1.0) / 2.0
            # d(action)/dx = 2: less log 2 per dimension
            return torch.sum(_beta_logpdf(x, a, b) - math.log(2.0), dim=-1)
        # categorical: the nearest table action (the first on ties), as the
        # RS queue's continuous actions need an index
        table = self.mask_table.actions_norm                         # (A, 2)
        idx = torch.argmin(torch.sum((action[..., None, :] - table) ** 2, dim=-1), dim=-1)
        logp = torch.log_softmax(raw, dim=-1)
        return torch.gather(logp, -1, idx[..., None])[..., 0]

    def _entropy(self, raw, log_std):
        if self.cfg.dist_type == "gaussian":
            std = torch.exp(log_std).expand_as(raw)
            return torch.sum(0.5 * torch.log(2 * math.pi * math.e * std ** 2), dim=-1)
        if self.cfg.dist_type == "beta":
            a, b = _beta_params(raw)
            return torch.sum(_beta_entropy(a, b), dim=-1)
        p = torch.softmax(raw, dim=-1)
        return -torch.sum(p * torch.log(torch.clamp(p, min=1e-30)), dim=-1)

    @annotated("policy/act")
    @torch.no_grad()
    def choose_action(self, st, obs: dict, generator: torch.Generator | None = None,
                      noise=None):
        """Masked discrete projection (reference choose_action): (B, 2)
        table actions and their log-probs (B,). ``noise``: (B, A) standard
        Gumbel noise of the categorical draw, else drawn from ``generator``.
        The categorical family returns the unmasked log-softmax at the drawn
        index."""
        return self._choose(self._raw(st.actor, st.norm, obs), st.log_std, obs["action_mask"],
                            generator, noise)

    @torch.no_grad()
    def policy_raw(self, st, obs: dict):
        """The actor's raw head (B, out) on the (normalized) observations."""
        return self._raw(st.actor, st.norm, obs)

    @torch.no_grad()
    def choose_and_score(self, st, raw, action_mask, queued,
                         generator: torch.Generator | None = None, noise=None):
        """:meth:`choose_action` and the log-prob (B,) of the queued RS
        action ``queued`` (B, 2), from one forward pass of the actor (the
        collect step's policy call): ``raw`` is :meth:`policy_raw`'s
        result, ``action_mask`` the observations' (B, A) mask."""
        action, logp = self._choose(raw, st.log_std, action_mask, generator, noise)
        return action, logp, self._logp_of(raw, st.log_std, queued)

    def _choose(self, raw, log_std, action_mask, generator, noise):
        table = self.mask_table
        if self.cfg.dist_type == "categorical":
            logp_all = torch.log_softmax(raw, dim=-1)
            w = torch.exp(logp_all) * action_mask
            p = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
            if noise is None:
                noise = gumbel(p.shape, generator, p.device)
            idx = torch.argmax(torch.log(torch.clamp(p, min=1e-30)) + noise, dim=-1)
            return table.actions_norm[idx], torch.gather(logp_all, -1, idx[:, None])[:, 0]
        mean, std = self._moments(raw, log_std)
        action, _ = mask_choose(mean, std, action_mask, table, generator, noise)
        return action, self._logp_of(raw, log_std, action)

    @annotated("policy/act")
    @torch.no_grad()
    def get_action(self, st, obs: dict, generator: torch.Generator | None = None):
        """Unmasked sample from the policy distribution and its log-prob."""
        raw = self._raw(st.actor, st.norm, obs)
        dev = raw.device
        if self.cfg.dist_type == "gaussian":
            mean, std = self._moments(raw, st.log_std)
            z = torch.randn(mean.shape, generator=generator, device=dev)
            a = torch.clamp(mean + std * z, -1.0, 1.0)
        elif self.cfg.dist_type == "beta":
            alpha, beta = _beta_params(raw)
            ga = torch._standard_gamma(alpha, generator=generator)
            gb = torch._standard_gamma(beta, generator=generator)
            a = 2.0 * (ga / (ga + gb)) - 1.0
        else:
            idx = torch.argmax(raw + gumbel(raw.shape, generator, dev), dim=-1)
            a = self.mask_table.actions_norm[idx]
        return a, self._logp_of(raw, st.log_std, a)

    @torch.no_grad()
    def log_prob(self, st, obs: dict, action):
        return self._logp_of(self._raw(st.actor, st.norm, obs), st.log_std, action)

    def observe_norm(self, st, next_obs: dict):
        if self.cfg.state_norm:
            st.norm = norm_update(st.norm, next_obs)
        return st

    # ---------------------------------------------------------------- update

    def _set_rate(self, opt: torch.optim.Adam, lr: float):
        """The schedule's rate at the Adam's count before this step, as optax
        reads it."""
        rate = lr_schedule(lr, self.cfg.lr_decay, self.cfg.max_train_steps)(adam_count(opt))
        for g in opt.param_groups:
            g["lr"] = rate

    @staticmethod
    def _clip_global_norm(params, max_norm: float = 0.5):
        """Scale the gradients of ``params`` jointly by min(1, max_norm /
        max(global norm, 1e-9)) (the reference's gradient_clip; unlike
        ``clip_grad_norm_``, no 1e-6 is added to the norm)."""
        grads = [p.grad for p in params if p.grad is not None]
        gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        torch._foreach_mul_(grads, scale)

    @torch.no_grad()
    def _values(self, net, obs: dict):
        n = next(iter(obs.values())).shape[0]
        return torch.cat([net({k: v[i:i + _VALUE_CHUNK] for k, v in obs.items()})
                          for i in range(0, n, _VALUE_CHUNK)])[:, 0]

    def update(self, st: PPOState, batch: dict, generator: torch.Generator | None = None,
               perms=None, mesh: Mesh | None = None):
        """Full-buffer PPO update, in place on ``st``.

        ``batch``: obs/*, next_obs/* (already normalized at insert), action,
        reward, done, log_prob, with leading dims (T, B): B lockstep streams
        of T steps (or (T,) for one stream). ``perms``: (mini_epoch, N) the
        permutations of the N = T * B transitions, one per epoch, else drawn
        from ``generator``.

        Once a minibatch's approximate KL exceeds ``target_kl``, that
        minibatch and every later one of the whole update leave the actor,
        the critic and both Adams (counts included) untouched; the per-epoch
        Polyak update of the target goes on. Across the ranks of ``mesh`` each
        rank is given the same ``batch`` and permutations (the module
        docstring).

        Returns the metrics of the last epoch's last minibatch as 0-d device
        tensors: actor_loss, critic_loss, approx_kl, kl_stopped (0. or 1.)."""
        cfg = self.cfg
        reward = batch["reward"]
        done = batch["done"].to(torch.float32)
        if reward.ndim == 1:
            batch = {k: v[:, None] for k, v in batch.items()}
            reward, done = reward[:, None], done[:, None]
        T, B = reward.shape
        N = T * B
        flat = {k: v.reshape((N,) + v.shape[2:]) for k, v in batch.items()}
        obs = {k[4:]: v for k, v in flat.items() if k.startswith("obs/")}
        next_obs = {k[9:]: v for k, v in flat.items() if k.startswith("next_obs/")}
        action = flat["action"]
        old_logp = flat["log_prob"][:, None]

        value = self._values(st.critic, obs).reshape(T, B)
        next_value = self._values(st.critic, next_obs).reshape(T, B)
        deltas = reward + cfg.gamma * (1 - done) * next_value - value
        if cfg.use_gae:
            adv = torch.empty_like(deltas)
            g = torch.zeros_like(deltas[0])
            for t in range(T - 1, -1, -1):
                g = deltas[t] + cfg.gamma * cfg.gae_lambda * g * (1.0 - done[t])
                adv[t] = g
        else:
            adv = deltas
        v_target = (adv + self._values(st.critic_target, obs).reshape(T, B)).reshape(N, 1)
        if cfg.adv_norm:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-5)
        adv = adv.reshape(N, 1)

        mb = cfg.mini_batch
        n_mb = N // mb
        dev = reward.device
        actor_params = [*st.actor.parameters(), st.log_std]
        critic_params = list(st.critic.parameters())
        split = mesh is not None and mesh.sharded

        def mean(x):
            # a rank's share of the whole minibatch's mean
            return torch.sum(x) / mb if split else torch.mean(x)

        stop = False
        last = None
        for e in range(cfg.mini_epoch):
            perm = (perms[e] if perms is not None else
                    torch.randperm(N, generator=generator, device=dev))
            idxs = perm[: n_mb * mb].reshape(n_mb, mb)
            for i in range(n_mb):
                final = e == cfg.mini_epoch - 1 and i == n_mb - 1
                if stop and not final:
                    continue        # frozen: only the last minibatch's metrics are read
                idx = mesh.rows(idxs[i]) if split else idxs[i]
                o = {k: v[idx] for k, v in obs.items()}
                with torch.set_grad_enabled(not stop):
                    raw = st.actor(o)
                    logp = self._logp_of(raw, st.log_std, action[idx])[:, None]
                    ratio = torch.exp(logp - old_logp[idx])
                    s1 = ratio * adv[idx]
                    s2 = torch.clamp(ratio, 1 - cfg.clip_epsilon, 1 + cfg.clip_epsilon) * adv[idx]
                    loss = -torch.minimum(s1, s2)
                    if cfg.policy_entropy:
                        loss = loss - cfg.entropy_coef * self._entropy(raw, st.log_std)[:, None]
                    la = mean(loss)
                    kl = mean(old_logp[idx] - logp).detach()
                    lc = mean((v_target[idx] - st.critic(o)) ** 2)
                if final:
                    last = (la.detach(), lc.detach(), kl)
                if split and (final or cfg.target_kl is not None):
                    # the whole minibatch's KL (and the logged losses)
                    scalars = torch.stack([la.detach(), lc.detach(), kl])
                    all_reduce_sum([scalars], mesh)
                    kl = scalars[2]
                    if final:
                        last = tuple(scalars)
                if stop:
                    continue
                if cfg.target_kl is not None:
                    # decided before the step: the overshooting minibatch is
                    # not applied
                    stop = bool(kl > cfg.target_kl)
                    if stop:
                        continue
                st.opt_actor.zero_grad(set_to_none=True)
                st.opt_critic.zero_grad(set_to_none=True)
                la.backward()
                lc.backward()
                if split:
                    all_reduce_sum([p.grad for p in actor_params + critic_params
                                    if p.grad is not None], mesh)
                if cfg.gradient_clip:
                    self._clip_global_norm(actor_params)
                    self._clip_global_norm(critic_params)
                self._set_rate(st.opt_actor, cfg.lr_actor)
                self._set_rate(st.opt_critic, cfg.lr_critic)
                st.opt_actor.step()
                st.opt_critic.step()
            # per-epoch Polyak update of the target
            with torch.no_grad():
                tp = list(st.critic_target.parameters())
                torch._foreach_mul_(tp, 1 - cfg.tau)
                torch._foreach_add_(tp, critic_params, alpha=cfg.tau)
        st.steps += 1
        la, lc, kl = last
        return {"actor_loss": la, "critic_loss": lc, "approx_kl": kl,
                "kl_stopped": torch.tensor(float(stop), device=dev)}
