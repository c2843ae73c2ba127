"""Checkpoints of the whole training loop, for ``--resume`` (counterpart of
``hope_tpu/train/resume.py``).

The device side (the agent with its four Adams, env and hybrid state,
observations, pool indices, the replay ring, the pool's scenes, and the state
of every ``torch.Generator`` the loop draws from) goes through ``torch.save``
to ``<path>/step_<N>/state.pt``; the host side (the curriculum choosers with
their numpy bit-generator states, the reset queue's rng, the loop's counters)
to ``<path>/host_<N>.json`` beside it. A run resumed from one reproduces the
uninterrupted run's chunks exactly on the CPU.

Across the ranks of a ``parallel.mesh.Mesh`` the file holds the one-process
layout: the batch-sharded parts (env and hybrid state, observations, pool
indices, the replay ring's rows) gathered onto rank 0 in rank order, the
replicated ones (agent, pool, generators) as rank 0 holds them; rank 0 alone
writes. A load shards the batch-sharded parts for this rank, so a checkpoint
resumes at any number of ranks.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch

from ..agents.ppo import PPOState
from ..agents.replay import Replay
from ..agents.sac import SACState
from ..parallel.mesh import Mesh, gather_to_root, shard_batch
from ..utils.checkpoint import latest_step, load_state_blob, state_blob

# the device blob's parts that are sharded along the env batch
SHARDED = ("env", "hybrid", "obs", "pool_idx")


def device_blob(agent_state, env_state, hybrid, obs, pool_idx, replay, generator, pool_scene,
                pool_generator) -> dict:
    """The device side of the loop, as live objects (:func:`save_full`
    writes it, :func:`load_full` restores into it)."""
    return {
        "agent": agent_state,
        "env": env_state,
        "hybrid": hybrid,
        "obs": obs,
        "pool_idx": pool_idx,
        "replay": replay,
        "generator": generator,
        "pool": pool_scene,
        "pool_generator": pool_generator,
    }


def host_blob(scene_chooser, dlp_chooser, queue_rng, counters: dict) -> dict:
    """Host-side loop state: curriculum choosers, reset-queue rng, counters."""
    return {
        "scene_chooser": scene_chooser.get_state(),
        "dlp_chooser": None if dlp_chooser is None else dlp_chooser.get_state(),
        "queue_rng": queue_rng.bit_generator.state,
        "counters": counters,
    }


def to_tree(x):
    """Live objects -> the nested dicts of tensors and numbers that
    ``torch.save`` writes (and ``torch.load(weights_only=True)`` reads)."""
    if isinstance(x, (SACState, PPOState)):
        return state_blob(x)
    if isinstance(x, Replay):
        return {"data": to_tree(x.data), "cursor": x.cursor, "size": x.size,
                "capacity": x.capacity}
    if isinstance(x, torch.Generator):
        return x.get_state()
    if isinstance(x, torch.Tensor):
        return x.detach()
    if dataclasses.is_dataclass(x):
        return {f.name: to_tree(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: to_tree(v) for k, v in x.items()}
    return x


def restore(template, tree):
    """``tree`` (from :func:`to_tree`) back into objects shaped as
    ``template``: the agent, the replay ring and the generators in place, a
    tensor as a new tensor on its template's device (the values bit for bit)."""
    if isinstance(template, (SACState, PPOState)):
        return load_state_blob(template, tree)
    if isinstance(template, Replay):
        for k, v in template.data.items():
            v.copy_(tree["data"][k])
        template.cursor, template.size = int(tree["cursor"]), int(tree["size"])
        return template
    if isinstance(template, torch.Generator):
        template.set_state(tree)
        return template
    if isinstance(template, torch.Tensor):
        return tree.to(template.device)
    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: restore(getattr(template, f.name), tree[f.name])
                                 for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: restore(v, tree[k]) for k, v in template.items()}
    return tree


def save_full(path: str, step: int, device_state: dict, host_state: dict,
              mesh: Mesh | None = None) -> int | None:
    """Write step ``step`` of the loop under ``path``; returns the bytes of
    its ``state.pt`` (None on a rank other than 0, which writes nothing).
    The file is written under a temporary name and moved into place, then
    the host JSON, so a step whose JSON exists is whole. Every rank of
    ``mesh`` must call it (the module docstring)."""
    tree = to_tree(device_state)
    if mesh is not None and mesh.sharded:
        for k in SHARDED:
            tree[k] = gather_to_root(tree[k], mesh)
        tree["replay"]["data"] = gather_to_root(tree["replay"]["data"], mesh)
        if mesh.rank != 0:
            return None
    d = os.path.join(os.path.abspath(path), f"step_{step}")
    os.makedirs(d, exist_ok=True)
    f = os.path.join(d, "state.pt")
    tmp = f"{f}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, f)
    with open(os.path.join(os.path.abspath(path), f"host_{step}.json"), "w") as fh:
        json.dump(host_state, fh)
    return os.path.getsize(f)


def load_full(path: str, template: dict, step: int | None = None, mesh: Mesh | None = None):
    """Restore the latest full checkpoint under ``path`` (step ``step`` where
    given) into ``template`` (a :func:`device_blob`; across the ranks of
    ``mesh``, this rank's, which takes its block of the sharded parts).

    Returns (device_state, host_state, step); both are None where the
    directory holds an agent-only checkpoint (no ``host_<N>.json``), which
    the caller then loads with ``utils.checkpoint.load_checkpoint``.
    """
    path = os.path.abspath(path)
    step = latest_step(path) if step is None else step
    host_path = os.path.join(path, f"host_{step}.json")
    if not os.path.exists(host_path):
        return None, None, step
    tree = torch.load(os.path.join(path, f"step_{step}", "state.pt"), map_location="cpu",
                      weights_only=True)
    if mesh is not None and mesh.sharded:
        for k in SHARDED:
            tree[k] = shard_batch(tree[k], mesh)
        tree["replay"]["data"] = shard_batch(tree["replay"]["data"], mesh)
    device = restore(template, tree)
    with open(host_path) as f:
        host = json.load(f)
    return device, host, step


def restore_host(host: dict, scene_chooser, dlp_chooser, queue_rng) -> dict:
    """Put the host side back into the choosers and the rng; returns the
    counters."""
    scene_chooser.set_state(host["scene_chooser"])
    if dlp_chooser is not None and host["dlp_chooser"] is not None:
        dlp_chooser.set_state(host["dlp_chooser"])
    queue_rng.bit_generator.state = host["queue_rng"]
    return host["counters"]


__all__ = ["device_blob", "host_blob", "save_full", "load_full", "restore_host",
           "to_tree", "restore"]
