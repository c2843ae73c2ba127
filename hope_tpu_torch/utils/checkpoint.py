"""Checkpoints of a SAC or PPO training state (counterpart of
``hope_tpu/utils/checkpoint.py``): every network, the learned tensors
(log_std, and SAC's log_alpha), the Adams, the observation statistics and the
update count, written with ``torch.save`` to ``<path>/step_<N>/state.pt``
(the JAX package's layout of one directory per step). A bare ``nn.Module``
(e.g. the BEV autoencoder) is saved by its ``state_dict``.
"""
from __future__ import annotations

import os

import torch
from torch import nn

from ..agents.ppo import PPOState
from ..agents.sac import SACState
from ..agents.state_norm import NormState

# per state type: (modules and optimizers by state_dict, tensors by value)
_PARTS = {
    SACState: (("actor", "critic1", "critic2", "target1", "target2", "opt_actor",
                "opt_critic1", "opt_critic2", "opt_alpha"), ("log_std", "log_alpha")),
    PPOState: (("actor", "critic", "critic_target", "opt_actor", "opt_critic"), ("log_std",)),
}
# what load_actor_only takes: the policy (actor, log_std, normalizer)
_ACTOR_PARTS = ("actor", "log_std", "norm")


def state_blob(state: SACState | PPOState | nn.Module) -> dict:
    """The tensors and state dicts that a checkpoint of ``state`` holds."""
    if isinstance(state, nn.Module):
        return state.state_dict()
    stateful, tensors = _PARTS[type(state)]
    blob = {n: getattr(state, n).state_dict() for n in stateful}
    blob.update({n: getattr(state, n).detach() for n in tensors})
    blob.update(norm={"mean": state.norm.mean, "S": state.norm.S, "n": state.norm.n},
                steps=state.steps)
    return blob


def load_state_blob(state, blob: dict, keep=lambda part: True):
    """Load ``blob`` (from :func:`state_blob`) into ``state`` in place, onto
    the devices ``state`` lives on: only the parts (field names, "norm",
    "steps") for which ``keep`` holds. Returns ``state``."""
    if isinstance(state, nn.Module):
        state.load_state_dict(blob)
        return state
    stateful, tensors = _PARTS[type(state)]
    for n in stateful:
        if keep(n):
            getattr(state, n).load_state_dict(blob[n])
    with torch.no_grad():
        for n in tensors:
            if keep(n):
                getattr(state, n).copy_(blob[n])
    dev = state.log_std.device
    if keep("norm"):
        state.norm = NormState(mean={k: v.to(dev) for k, v in blob["norm"]["mean"].items()},
                               S={k: v.to(dev) for k, v in blob["norm"]["S"].items()},
                               n=blob["norm"]["n"].to(dev))
    if keep("steps"):
        state.steps = int(blob["steps"])
    return state


def _device(state) -> torch.device:
    if isinstance(state, nn.Module):
        return next(state.parameters()).device
    return state.log_std.device


def latest_step(path: str) -> int:
    """The largest N of the ``step_<N>`` directories under ``path``."""
    return max(int(d.split("_")[1]) for d in os.listdir(path)
               if d.startswith("step_") and os.path.isdir(os.path.join(path, d)))


def save_checkpoint(path: str, state, step: int) -> str:
    """Write ``state`` as step ``step`` under ``path``; returns the file."""
    d = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(d, exist_ok=True)
    f = os.path.join(d, "state.pt")
    torch.save(state_blob(state), f)
    return f


def _read(path: str, state, step: int | None):
    path = os.path.abspath(path)
    step = latest_step(path) if step is None else step
    return torch.load(os.path.join(path, f"step_{step}", "state.pt"),
                      map_location=_device(state), weights_only=True)


def load_checkpoint(path: str, state, step: int | None = None):
    """Load step ``step`` (the latest where None) under ``path`` into
    ``state``, in place, onto the devices ``state`` lives on; returns it."""
    return load_state_blob(state, _read(path, state, step))


def load_params_only(path: str, state, step: int | None = None):
    """Load every part of the checkpoint except the optimizers (the
    ``opt_*`` fields): this run's Adams stay as they are."""
    return load_state_blob(state, _read(path, state, step),
                           keep=lambda n: not n.startswith("opt_"))


def load_actor_only(path: str, state, step: int | None = None):
    """Load only the policy (actor, log_std, observation normalizer) from a
    checkpoint into ``state``; critics, optimizers and counters stay."""
    return load_state_blob(state, _read(path, state, step), keep=lambda n: n in _ACTOR_PARTS)
