"""Welford running observation normalization
(counterpart of ``hope_tpu/agents/state_norm.py``); only lidar and target
are normalized."""
from __future__ import annotations

from dataclasses import dataclass

import torch

NORMALIZED_KEYS = ("lidar", "target")


@dataclass
class NormState:
    mean: dict
    S: dict
    n: torch.Tensor

    @staticmethod
    def create(obs_shape: dict, device=None) -> "NormState":
        keys = [k for k in obs_shape if k in NORMALIZED_KEYS]
        return NormState(
            mean={k: torch.zeros(obs_shape[k], device=device) for k in keys},
            S={k: torch.zeros(obs_shape[k], device=device) for k in keys},
            n=torch.zeros((), dtype=torch.int64, device=device),
        )


def normalize(obs: dict, st: NormState) -> dict:
    out = dict(obs)
    n = torch.clamp(st.n, min=1).to(torch.float32)
    for k in st.mean:
        std = torch.sqrt(st.S[k] / n)
        out[k] = (obs[k] - st.mean[k]) / (std + 1e-8)
    return out


def update(st: NormState, obs: dict) -> NormState:
    """Fold a batch of observations (leading dim B) into the running stats
    with a batched Welford step."""
    b = obs[next(iter(st.mean))].shape[0]
    new_n = st.n + b
    mean, S = {}, {}
    for k in st.mean:
        x = obs[k]
        batch_mean = torch.mean(x, dim=0)
        batch_S = torch.sum((x - batch_mean) ** 2, dim=0)
        delta = batch_mean - st.mean[k]
        tot = new_n.to(x.dtype)
        mean[k] = st.mean[k] + delta * (b / tot)
        S[k] = st.S[k] + batch_S + delta ** 2 * (st.n.to(x.dtype) * b / tot)
    return NormState(mean=mean, S=S, n=new_n)
