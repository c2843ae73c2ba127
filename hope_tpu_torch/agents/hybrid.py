"""Vectorized hybrid RL + Reeds-Shepp agent state
(counterpart of ``hope_tpu/agents/hybrid.py``).

When a collision-free RS path has been latched, actions pop from its queue;
otherwise the RL policy acts. The queue is a fixed (B, Q, 2) tensor with
per-env cursors.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..planning import RSPath, build_action_queue


@dataclass
class HybridState:
    queue: torch.Tensor     # (B, Q, 2) normalized [steer, speed]
    length: torch.Tensor    # (B,) live entries
    cursor: torch.Tensor    # (B,) next entry to pop

    @staticmethod
    def create(batch: int, queue_len: int = 32, device=None) -> "HybridState":
        return HybridState(
            queue=torch.zeros((batch, queue_len, 2), device=device),
            length=torch.zeros(batch, dtype=torch.int32, device=device),
            cursor=torch.zeros(batch, dtype=torch.int32, device=device),
        )

    @property
    def executing(self):
        return self.cursor < self.length

    def queued(self):
        """(B, 2) the entry under each cursor (clamped into the queue)."""
        b = self.queue.shape[0]
        idx = torch.clamp(self.cursor, 0, self.queue.shape[1] - 1).long()
        return self.queue[torch.arange(b, device=idx.device), idx]


def latch(hs: HybridState, rs: RSPath, step_ratio: float) -> HybridState:
    """Adopt found RS paths for envs not already executing one."""
    q, n = build_action_queue(rs, step_ratio, hs.queue.shape[1])
    take = rs.found & ~hs.executing
    return HybridState(
        queue=torch.where(take[:, None, None], q, hs.queue),
        length=torch.where(take, n, hs.length),
        cursor=torch.where(take, 0, hs.cursor).to(torch.int32),
    )


def act(hs: HybridState, policy_action, policy_logp, logp_of_queue_action):
    """Merge policy actions with queued RS actions.

    Args:
      policy_action: (B, 2) the RL action (already sampled).
      policy_logp: (B,) its log-prob.
      logp_of_queue_action: (B,) log-prob of the queued action under the
        current policy.

    Returns (action, log_prob, new_state).
    """
    ex = hs.executing
    action = torch.where(ex[:, None], hs.queued(), policy_action)
    logp = torch.where(ex, logp_of_queue_action, policy_logp)
    return action, logp, replace(hs, cursor=torch.where(ex, hs.cursor + 1, hs.cursor))
