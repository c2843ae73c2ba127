"""Batched evaluation battery (counterpart of
``hope_tpu/evaluation/evaluate.py``).

A whole battery rolls out in lockstep: finished episodes freeze in place
while the rest continue, and the per-case metrics are reduced at the end.
Includes the stuck detector (identical target obs twice -> random action)
and the RS-takeover latch.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from ..agents import HybridState, hybrid_act, latch
from ..envs import ARRIVED, ParkingEnv
from ..envs.env import select
from ..envs.rewards import COLLIDED, OUTBOUND, OUTTIME
from ..envs.scene import LEVEL_NAMES, Scene


def build_episode_runner(env: ParkingEnv, policy_act, max_steps: int = 200,
                         use_rs: bool = True):
    """policy_act(obs, generator) -> (action, logp).

    The JAX runner also scores each queued RS action under the policy; an
    evaluation discards that log-prob, so this runner does not compute it.

    Returns ``run(scenes, generator)`` -> metrics dict of (B,) tensors:
    success, steps, path_length, status, finished, rs_latched, level, case_id.
    """

    @torch.no_grad()
    def run(scenes: Scene, generator: torch.Generator):
        state, obs = env.batch_reset(scenes)
        B = obs["target"].shape[0]
        dev = obs["target"].device
        hybrid = HybridState.create(B, env.cfg.rs_queue_len, dev)
        finished = torch.zeros(B, dtype=torch.bool, device=dev)
        steps = torch.zeros(B, dtype=torch.int32, device=dev)
        path_len = torch.zeros(B, device=dev)
        status = torch.full((B,), -1, dtype=torch.int32, device=dev)
        ever_rs = torch.zeros(B, dtype=torch.bool, device=dev)
        # the first step is never "stuck" (the reference's last_obs starts empty)
        last_tgt = torch.full_like(obs["target"], torch.inf)
        for _ in range(max_steps):
            action, logp = policy_act(obs, generator)
            # stuck detector: identical target obs to the PREVIOUS step's
            # -> random action
            stuck = torch.all(torch.abs(obs["target"] - last_tgt) < 1e-12, dim=-1)
            rand_a = torch.rand(action.shape, generator=generator, device=dev) * 2.0 - 1.0
            action = torch.where(stuck[:, None], rand_a, action)
            last_tgt = obs["target"]

            action, _, hybrid = hybrid_act(hybrid, action, logp, logp)
            prev_xy = state.vehicle.pose[:, :2]
            new_state, new_obs, _, done, info = env.batch_step(
                state, env.rescale_action(action), search_rs=use_rs)
            if use_rs:
                hybrid = latch(hybrid, info["rs"], env.cfg.step_ratio)
                ever_rs = ever_rs | (info["rs"].found & ~finished)

            moved = torch.linalg.norm(new_state.vehicle.pose[:, :2] - prev_xy, dim=-1)
            active = ~finished
            steps = steps + active.to(torch.int32)
            path_len = path_len + torch.where(active, moved, 0.0)
            status = torch.where(active & done, info["status"], status)
            finished = finished | done
            # freeze finished envs
            state = select(finished, state, new_state)
            obs = select(finished, obs, new_obs)
        return {
            "success": status == ARRIVED,
            "steps": steps,
            "path_length": path_len,
            "status": status,
            "finished": finished,
            "rs_latched": ever_rs,
            "level": scenes.level,
            "case_id": scenes.case_id,
        }

    return run


def summarize(metrics: dict, max_steps: int = 200) -> dict:
    """Reference result.txt-style summary; ``max_steps`` must match the
    runner's cap (path length is reported for episodes finished within it)."""
    m_np = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in metrics.items()}
    succ = m_np["success"]
    steps = m_np["steps"]
    plen = m_np["path_length"]
    level = m_np["level"]
    status = m_np["status"]
    rs = m_np.get("rs_latched", np.zeros_like(succ))
    out = {
        "success_rate": float(succ.mean()),
        "n": int(len(succ)),
        "success_steps_mean": float(steps[succ].mean()) if succ.any() else None,
        "success_steps_std": float(steps[succ].std()) if succ.any() else None,
        "per_level": {},
    }
    for lv in np.unique(level):
        m = level == lv
        short = m & (steps < max_steps)
        out["per_level"][LEVEL_NAMES.get(int(lv), str(lv))] = {
            "n": int(m.sum()),
            "success_rate": float(succ[m].mean()),
            "steps_mean": float(steps[m].mean()),
            "path_length_mean": float(plen[short].mean()) if short.any() else None,
            "collided": float((status[m] == COLLIDED).mean()),
            "outbound": float((status[m] == OUTBOUND).mean()),
            "outtime": float((~m_np["finished"][m] | (status[m] == OUTTIME)).mean()),
            "rs_latched": float(rs[m].mean()),
        }
    return out


def write_report(path: str, summary: dict):
    with open(path, "w") as f:
        json.dump(summary, f, indent=2)
