"""Checkpoints of a SAC or PPO training state (counterpart of
``hope_tpu/utils/checkpoint.py``): every network, the learned tensors
(log_std, and SAC's log_alpha), the Adams, the observation statistics and the
update count, written with ``torch.save`` to ``<path>/step_<N>/state.pt``
(the JAX package's layout of one directory per step)."""
from __future__ import annotations

import os

import torch

from ..agents.ppo import PPOState
from ..agents.sac import SACState
from ..agents.state_norm import NormState

# per state type: (modules and optimizers by state_dict, tensors by value)
_PARTS = {
    SACState: (("actor", "critic1", "critic2", "target1", "target2", "opt_actor",
                "opt_critic1", "opt_critic2", "opt_alpha"), ("log_std", "log_alpha")),
    PPOState: (("actor", "critic", "critic_target", "opt_actor", "opt_critic"), ("log_std",)),
}


def save_checkpoint(path: str, state: SACState | PPOState, step: int) -> str:
    """Write ``state`` as step ``step`` under ``path``; returns the file."""
    d = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(d, exist_ok=True)
    stateful, tensors = _PARTS[type(state)]
    blob = {n: getattr(state, n).state_dict() for n in stateful}
    blob.update({n: getattr(state, n).detach() for n in tensors})
    blob.update(norm={"mean": state.norm.mean, "S": state.norm.S, "n": state.norm.n},
                steps=state.steps)
    f = os.path.join(d, "state.pt")
    torch.save(blob, f)
    return f


def load_checkpoint(path: str, state: SACState | PPOState, step: int | None = None):
    """Load step ``step`` (the latest where None) under ``path`` into
    ``state``, in place, onto the devices ``state`` lives on; returns it."""
    path = os.path.abspath(path)
    if step is None:
        step = max(int(d.split("_")[1]) for d in os.listdir(path) if d.startswith("step_"))
    dev = state.log_std.device
    blob = torch.load(os.path.join(path, f"step_{step}", "state.pt"), map_location=dev,
                      weights_only=True)
    stateful, tensors = _PARTS[type(state)]
    for n in stateful:
        getattr(state, n).load_state_dict(blob[n])
    with torch.no_grad():
        for n in tensors:
            getattr(state, n).copy_(blob[n])
    state.norm = NormState(mean=blob["norm"]["mean"], S=blob["norm"]["S"], n=blob["norm"]["n"])
    state.steps = int(blob["steps"])
    return state
