"""The port's staging precompute against the JAX package's on the committed
scenario banks (``tests/data/torch_jax_banks.npz``: ``generate_bank`` at
n = 64, keys 0, 1, 2, padded to the MPC CLI's 96 slots), at the CLI's 6 RS
words a candidate.

The 1844 parallel-parking templates go through the port's divide-free sweep
(``ops.swept_collide``); JAX sweeps them with its divided ``traj_collides``.
These tests hold the two to the same valid sets: the first 4 scenes of each
bank in full (``mc.check_staging``), and every scene of each bank (slow). JAX's outputs come from
``tests/data/torch_jax_mpc.npz`` (``tests/mpc_cases.py``).
"""
import numpy as np
import pytest
import torch

from hope_tpu_torch.config import EnvConfig, ObsConfig
from hope_tpu_torch.envs import ParkingEnv, Scene
from hope_tpu_torch.planning.staging import compute_staging

from . import mpc_cases as mc
from .torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return mc.load()


@pytest.mark.parametrize("level", mc.BANK_LEVELS)
def test_staging_matches_jax_on_banks(data, level):
    """The first 4 scenes of the level's bank, as test_staging_matches_jax:
    valid sets equal, L and poses within 1e-4 m, completions equal but for
    equally short RS words."""
    mc.check_staging(data, f"banks_{level}")
    L = data[f"staging/banks_{level}/L"]
    assert np.isfinite(L).any()


@pytest.mark.slow
@pytest.mark.parametrize("level", mc.BANK_LEVELS)
def test_staging_valid_sets_match_jax_on_whole_banks(data, level):
    """All 64 scenes of the level's bank (~7 s a scene on one CPU thread, so
    slow): valid sets equal to JAX's, the templates without exception and the
    polar candidates but where RS words tie at the 6-word cut
    (``mc.check_valid_sets``), and L within 1e-4 m."""
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        env = ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False),
                                   **mc.PROC_ENV), device="cpu")
        sc = Scene.from_numpy(mc.scenes_of(data, f"banks_{level}"), "cpu")
        st = compute_staging(env, sc, max_tries=6)
        mc.check_valid_sets(env, st, sc, data[f"banks/{level}/L"], 6)
    finally:
        torch.set_num_threads(n)
