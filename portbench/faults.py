"""Faults planted under the timed path, for the tests that show each cell's
checks come out false on a broken program (``portbench/tests``) and for
the readings of the limits (``portbench.control --fault``). A run of the
benchmark plants none (``ctx.fault`` is None).

- ``unchanged``: a step that returns its state unchanged;
- ``half_batch``: half of the batch left out;
- ``altered``: an answer altered where it is produced.

One chip runs every cell, so no cell has an exchange between chips to
leave out.
"""
from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "altered")


def policy(fault: str, act):
    """A faulty ``policy_act(obs, generator)``."""

    def faulty(obs, g):
        a, logp = act(obs, g)
        a = a.clone()
        if fault == "half_batch":
            a[a.shape[0] // 2:] = 0.0
        elif fault == "altered":
            a[0] = torch.clamp(a[0] + 0.25, -1.0, 1.0) if a[0, 0] < 0.5 else a[0] - 0.25
        return a, logp

    return faulty


def env_step(fault: str, step):
    """A faulty ``ParkingEnv.batch_step`` (the ``unchanged`` fault; the others
    are the policy's)."""

    def faulty(state, actions, search_rs=True):
        new_state, obs, reward, done, info = step(state, actions, search_rs=search_rs)
        if fault == "unchanged":
            return state, obs, reward, done, info
        return new_state, obs, reward, done, info

    return faulty
