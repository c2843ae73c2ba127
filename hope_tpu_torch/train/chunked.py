"""Training chunks: K lockstep env steps with auto-resets, then the SGD
updates (counterpart of ``hope_tpu/train/chunked.py``).

The JAX chunk is one jitted ``lax.scan``; here it is a Python loop of K
collect steps and then the updates, in the JAX package's order: U off-policy
updates from the replay ring for SAC, one full update of the (K, B)
on-policy buffer for PPO. Resets come from a device-resident scene pool
through a ``reset_queue`` of pool indices that the host's curriculum fills
between chunks; the chunk returns (K, B) logs of done / status / pool index /
reward, which stay on the device until :func:`summarize_logs`. No step of a
chunk waits for the device, except the PPO update's KL check on each
minibatch where ``target_kl`` is set.

Every random draw of a chunk comes from one ``torch.Generator``, or from a
:class:`ChunkDraws` / :class:`PPOChunkDraws` that a test fills with another
generator's draws.

Across the W ranks of a ``parallel.mesh.Mesh`` (``mesh``; None or one rank
is the one-process chunk) each rank steps its contiguous block of the env
batch, with the mask, raster and sweep kernels at B / W, and holds a copy of
the agent, the scene pool and the reset queue. Every rank draws each random
tensor at the whole batch's size from the same generator and takes its
rows, and runs the policy on the whole batch's observations (which it holds
for the replay anyway) and takes its rows: a matrix product's rounding may
depend on its row count, and so the collect is bitwise the one-process
collect. Two gathers a collect step give every rank the whole step: the
step's done / status / pool index / reward / action / log-prob before the
reset (the j-th env to finish in the whole batch takes
``reset_queue[(rctr + j) % R]``), and the next observations after it (the
Welford step folds in the whole batch, and the replay ring or the PPO buffer
takes the whole step), so the logs come back at the whole batch's width.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..agents import hybrid_act, hybrid_reset_done, latch, normalize, norm_update
from ..agents.replay import _decode, _encode, push_batch, sample as replay_sample
from ..envs import ParkingEnv
from ..envs.action_mask import gumbel
from ..envs.rewards import ARRIVED
from ..parallel.mesh import Mesh, gather_replicated
from ..utils.profiling import annotate


@dataclass
class ChunkDraws:
    """The random draws of one SAC chunk, injected.

    actions: (K, B, action_dim) per collect step: the uniform actions in
      [-1, 1] of a warm-up chunk, else the standard normals of the policy's
      sample.
    sample_idx: (U, sgd_batch) replay indices per update.
    update_noise: (U, 2, sgd_batch, action_dim) standard normals per update:
      [0] for the target actions, [1] for the actor loss.
    The explore_epsilon mix-in, where on, draws from the chunk's generator.
    """

    actions: torch.Tensor
    sample_idx: torch.Tensor | None = None
    update_noise: torch.Tensor | None = None


@dataclass
class PPOChunkDraws:
    """The random draws of one PPO chunk, injected.

    gumbel: (K, B, A) standard Gumbel noise of the masked action draw per
      collect step.
    perms: (mini_epoch, K * B) the update's permutation of the buffer per
      epoch.
    """

    gumbel: torch.Tensor
    perms: torch.Tensor | None = None


def _flatten_transition(obs_n, next_obs_n, action, reward, done, logp):
    tr = {f"obs/{k}": v for k, v in obs_n.items()}
    tr.update({f"next_obs/{k}": v for k, v in next_obs_n.items()})
    tr["action"] = action
    tr["reward"] = reward
    tr["done"] = done
    tr["log_prob"] = logp
    return tr


def _sharded(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.sharded


def _rows(x, mesh: Mesh | None):
    """This rank's rows of a tensor drawn at the whole batch's size."""
    return mesh.rows(x) if _sharded(mesh) else x


def _gather_obs(obs: dict, mesh: Mesh | None) -> dict:
    """Every rank's observations in the one-process layout, on every rank;
    the image travels as the replay ring stores it (uint8, exact for the
    rasterizer's colours)."""
    if not _sharded(mesh):
        return obs
    full = gather_replicated({k: _encode(k, v) for k, v in obs.items()}, mesh)
    return {k: _decode(k, v) for k, v in full.items()}


def _collect_step(env: ParkingEnv, step_ratio: float, act_fn, st, env_state, hybrid, obs,
                  pool_idx, rctr, pool, reset_queue, mesh: Mesh | None = None):
    """One env step of the chunk, shared by SAC and PPO.

    act_fn(agent_state, obs, queued) -> (action, logp, queued_logp) samples
    the RL action and scores the queued RS action ``queued`` for this
    rank's envs, from one forward pass of the actor.

    Returns (env_state, hybrid, next_obs, pool_idx, rctr, step): this rank's
    envs, hybrid state, observations and pool indices, and ``step``, the
    whole batch's done, status, pool_idx (before the reset swap), reward,
    action and log_prob."""
    policy_action, policy_logp, queued_logp = act_fn(st, obs, hybrid.queued())
    action, logp, hybrid = hybrid_act(hybrid, policy_action, policy_logp, queued_logp)

    new_env, reward, done, info = env._transition(env_state, env.rescale_action(action))
    hybrid = latch(hybrid, env._batch_rs(new_env), step_ratio)
    hybrid = hybrid_reset_done(hybrid, done)

    # the episode log BEFORE the reset swap: which pool scene just finished
    step = gather_replicated({"done": done, "status": info["status"], "pool_idx": pool_idx,
                              "reward": reward, "action": action, "log_prob": logp}, mesh)

    # queue-fed auto-reset: the j-th env of the whole batch to finish this
    # step takes reset_queue[(rctr + j) % R]
    d = step["done"].to(torch.int64)
    fresh_idx = reset_queue[(rctr + torch.cumsum(d, dim=0) - 1) % reset_queue.shape[0]]
    pool_idx = torch.where(done, _rows(fresh_idx, mesh), pool_idx)
    rctr = rctr + d.sum()
    idx = pool_idx.long()
    fresh = env._init_state(pool.map(lambda x: x[idx]))
    env_state = env.reset_where(new_env, fresh, done)

    # one observation render per step: post-step for running envs, the first
    # observation for fresh ones (a done transition's next_obs is masked out
    # of the targets by (1 - done))
    next_obs = env.observe_batch(env_state)
    return env_state, hybrid, next_obs, pool_idx, rctr, step


def _log(step: dict) -> dict:
    return {k: step[k] for k in ("done", "status", "pool_idx", "reward")}


def build_sac_chunk(env: ParkingEnv, agent, step_ratio: float, chunk_steps: int,
                    updates_per_chunk: int, sgd_batch: int, mesh: Mesh | None = None):
    """One SAC chunk: K collect steps and U updates.

    chunk(sac_state, env_state, hybrid, obs, pool_idx, replay, pool,
          reset_queue, generator, warmup, draws=None) ->
      (sac_state, env_state, hybrid, obs, pool_idx, replay,
       logs {(K, B) done / status / pool_idx / reward}, metrics)

    ``sac_state`` and ``replay`` are updated in place; ``metrics`` are the
    last update's (empty in a warm-up chunk). Across the ranks of ``mesh``
    the env arguments are this rank's block, ``replay`` is sharded over the
    ranks (``replay.create(..., mesh)``), ``draws`` stay at the whole
    batch's width and the logs come back whole."""
    K, U = chunk_steps, updates_per_chunk
    cfg = agent.cfg
    W = mesh.world if _sharded(mesh) else 1

    def chunk(st, env_state, hybrid, obs, pool_idx, replay, pool, reset_queue,
              generator: torch.Generator, warmup: bool, draws: ChunkDraws | None = None):
        dev = obs["target"].device
        B = pool_idx.shape[0] * W
        rctr = torch.zeros((), dtype=torch.int64, device=dev)
        logs = []
        obs_all = _gather_obs(obs, mesh)
        with annotate("sac_chunk/collect"):
            for k in range(K):
                def act_fn(st, o, queued, k=k, o_all=obs_all):
                    mean, std = (_rows(t, mesh) for t in agent.dist(st, o_all))
                    shape = (B, mean.shape[1])
                    if warmup:
                        a = _rows(draws.actions[k] if draws is not None else
                                  torch.rand(shape, generator=generator, device=dev) * 2.0 - 1.0,
                                  mesh)
                    else:
                        z = (draws.actions[k] if draws is not None else
                             torch.randn(shape, generator=generator, device=dev))
                        a = torch.clamp(mean + std * _rows(z, mesh), -1.0, 1.0)
                        if cfg.explore_epsilon > 0.0:
                            # epsilon-greedy mix-in of uniform actions
                            rand_a = torch.rand(shape, generator=generator, device=dev) * 2 - 1
                            take = torch.rand(B, generator=generator,
                                              device=dev) < cfg.explore_epsilon
                            a = torch.where(_rows(take, mesh)[:, None], _rows(rand_a, mesh), a)
                    return (a, torch.sum(agent._log_prob(mean, std, a), dim=-1),
                            torch.sum(agent._log_prob(mean, std, queued), dim=-1))

                env_state, hybrid, obs, pool_idx, rctr, step = _collect_step(
                    env, step_ratio, act_fn, st, env_state, hybrid, obs, pool_idx, rctr, pool,
                    reset_queue, mesh)
                next_all = _gather_obs(obs, mesh)
                # normalized push: obs with the current stats, the stats
                # updated on next_obs, next_obs with the new stats
                obs_n = normalize(obs_all, st.norm)
                st.norm = norm_update(st.norm, next_all)
                next_obs_n = normalize(next_all, st.norm)
                push_batch(replay, _flatten_transition(obs_n, next_obs_n, step["action"],
                                                       step["reward"], step["done"],
                                                       step["log_prob"]))
                obs_all = next_all
                logs.append(_log(step))
        logs = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}

        metrics = {}
        if not warmup:
            with annotate("sac_chunk/update"):
                for u in range(U):
                    idx = draws.sample_idx[u] if draws is not None else None
                    noise = draws.update_noise[u] if draws is not None else None
                    mb = replay_sample(replay, sgd_batch, generator, idx)
                    metrics = agent.update(st, mb, generator, noise, mesh)
        return st, env_state, hybrid, obs, pool_idx, replay, logs, metrics

    return chunk


def build_ppo_chunk(env: ParkingEnv, agent, step_ratio: float, chunk_steps: int,
                    mesh: Mesh | None = None):
    """One PPO chunk: K masked-action collect steps, then the full update of
    the (K, B) buffer (the reference's buffer-full trigger).

    chunk(ppo_state, env_state, hybrid, obs, pool_idx, pool, reset_queue,
          generator, draws=None) ->
      (ppo_state, env_state, hybrid, obs, pool_idx,
       logs {(K, B) done / status / pool_idx / reward}, metrics, buffer)

    ``ppo_state`` is updated in place; ``metrics`` are the update's and
    ``buffer`` the (K, B) transitions it took. Across the ranks of ``mesh``
    the env arguments are this rank's block, ``draws`` stay at the whole
    batch's width, and the logs and the buffer come back whole."""
    K = chunk_steps
    W = mesh.world if _sharded(mesh) else 1

    def chunk(st, env_state, hybrid, obs, pool_idx, pool, reset_queue,
              generator: torch.Generator, draws: PPOChunkDraws | None = None):
        dev = obs["target"].device
        B = pool_idx.shape[0] * W
        rctr = torch.zeros((), dtype=torch.int64, device=dev)
        logs, buffer = [], {}
        obs_all = _gather_obs(obs, mesh)
        with annotate("ppo_chunk/collect"):
            for k in range(K):
                def act_fn(st, o, queued, k=k, o_all=obs_all):
                    noise = (draws.gumbel[k] if draws is not None else
                             gumbel((B, o["action_mask"].shape[-1]), generator, dev))
                    return agent.choose_and_score(st, _rows(agent.policy_raw(st, o_all), mesh),
                                                  o["action_mask"], queued, generator,
                                                  _rows(noise, mesh))

                env_state, hybrid, obs, pool_idx, rctr, step = _collect_step(
                    env, step_ratio, act_fn, st, env_state, hybrid, obs, pool_idx, rctr, pool,
                    reset_queue, mesh)
                next_all = _gather_obs(obs, mesh)
                # obs normalized with the current stats, the stats updated on
                # next_obs, next_obs normalized with the new stats
                obs_n = normalize(obs_all, st.norm)
                st.norm = norm_update(st.norm, next_all)
                next_obs_n = normalize(next_all, st.norm)
                tr = _flatten_transition(obs_n, next_obs_n, step["action"], step["reward"],
                                         step["done"], step["log_prob"])
                if not buffer:          # the (K, B, ...) buffer, written step by step
                    buffer = {n: torch.empty((K,) + v.shape, dtype=v.dtype, device=dev)
                              for n, v in tr.items()}
                for n, v in tr.items():
                    buffer[n][k] = v
                obs_all = next_all
                logs.append(_log(step))
        logs = {k: torch.stack([lg[k] for lg in logs]) for k in logs[0]}
        with annotate("ppo_chunk/update"):
            metrics = agent.update(st, buffer, generator,
                                   None if draws is None else draws.perms, mesh)
        return st, env_state, hybrid, obs, pool_idx, logs, metrics, buffer

    return chunk


def summarize_logs(logs) -> dict:
    """Host-side episode bookkeeping from a chunk's (K, B) logs (the SAC
    chunk's one wait for the device).

    Returns episodes, successes, ``ends`` [(pool_idx, success), ...] in
    episode-end order (for the curriculum choosers) and the mean reward."""
    done = logs["done"].cpu().numpy()
    status = logs["status"].cpu().numpy()
    pool_idx = logs["pool_idx"].cpu().numpy()
    k, b = np.nonzero(done)
    success = status[k, b] == ARRIVED
    return {
        "episodes": int(done.sum()),
        "successes": int(success.sum()),
        "ends": list(zip(pool_idx[k, b].tolist(), success.tolist())),
        "reward_mean": float(logs["reward"].mean()),
    }
