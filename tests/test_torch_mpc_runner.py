"""The port's pure-MPC runner and CLI against the JAX package's, on the CPU.

The runner is held to JAX's outputs in ``tests/data/torch_jax_mpc.npz``
(``tests/mpc_cases.py``) on tests/test_mpc.py's open room (RS execution on
and off, and with staging), on 4 procedural Normal scenes with staging, and on
3 DLP cases; the CLI in --smoke mode writes the reference's files and keys.

The iLQR approach is chaotic in float32: in the port alone, moving a DLP
start by 1e-5 m changes an approaching env's path length by 1.8 m within 24
steps. So an env that has not latched an RS plan is held to the discrete
outcomes only; an env whose plan was executed verbatim is held to its path
length too.
"""
import json
import os

import numpy as np
import pytest
import torch

from hope_tpu_torch.config import EnvConfig, ObsConfig
from hope_tpu_torch.envs import ParkingEnv, Scene
from hope_tpu_torch.planning.ilqr import ILQRConfig
from hope_tpu_torch.planning.mpc import build_mpc_runner
from hope_tpu_torch.planning.staging import compute_staging

from . import mpc_cases as mc
from .torch_threads import one_torch_thread  # noqa: F401

DISCRETE = ("success", "steps", "status", "finished", "rs_latched", "way_latched", "level",
            "case_id")


@pytest.fixture(scope="module")
def data():
    return mc.load()


@pytest.mark.parametrize("case", list(mc.RUNNER_CASES))
def test_runner_matches_jax(data, case):
    """Discrete outcomes (success, steps, status, finished, rs_latched,
    way_latched) equal JAX's in every case. Path length within 1e-4 relative
    where the env arrived on a latched plan (measured <= 1.3e-7), and in the
    open room everywhere; the
    last replan's iLQR cost in the open room within 1e-3 relative (measured
    1.5e-5). The procedural and DLP cases run at the MPC CLI's env (12 RS
    words, 96 / 512 edge slots) with the horizon cut to 16 and 3 iLQR
    iterations; the DLP case without staging, over 24 steps."""
    sname, settings, ikw, rkw, staged = mc.RUNNER_CASES[case]
    env = ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False), **settings),
                     device="cpu")
    sc = Scene.from_numpy(mc.scenes_of(data, sname), "cpu")
    run = build_mpc_runner(env, ILQRConfig(**ikw), **rkw)
    st = compute_staging(env, sc, max_tries=6 if sname == "normal" else 4) if staged else None
    got = {k: v.numpy() for k, v in run(sc, st).items()}
    ref = {k: data[f"runner/{case}/{k}"] for k in mc.RUNNER_KEYS}
    assert set(got) == set(ref)
    for k in DISCRETE:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{case}: {k}")
    if case.startswith("room"):
        verbatim = np.ones_like(ref["success"])
        np.testing.assert_allclose(got["final_cost"], ref["final_cost"], rtol=1e-3)
    else:
        verbatim = ref["success"] & ref["rs_latched"]
    np.testing.assert_allclose(got["path_length"][verbatim], ref["path_length"][verbatim],
                               rtol=1e-4)
    if case == "normal":
        assert ref["success"].all() and ref["way_latched"].any()


def test_mpc_cli_smoke_on_cpu(data, tmp_path):
    """python -m hope_tpu_torch.planning.mpc --smoke --no-dlp --device cpu
    writes result_mpc.json and record_mpc.npz with the JAX CLI's keys (the
    port's config adds "device"), and its printed rates are positive."""
    from hope_tpu_torch.planning import mpc

    summary = mpc.main(["--smoke", "--no-dlp", "--device", "cpu", "--out", str(tmp_path)])
    with open(tmp_path / "result_mpc.json") as f:
        result = json.load(f)
    assert result == json.loads(json.dumps(summary))
    keys = mc.json_paths(result) - {"config/device"}
    assert keys == set(data["cli/result_keys"].tolist())
    with np.load(tmp_path / "record_mpc.npz") as f:
        assert sorted(f.files) == data["cli/record_keys"].tolist()
        assert f["success"].shape == (4,)
    assert result["staging"]["candidates"] == 2164
    assert result["plan_latency"]["batch"]["qp_solves_per_sec"] > 0


def test_mpc_cli_flags_and_device(tmp_path, monkeypatch):
    """Every flag of the JAX CLI parses, plus --device; the default device is
    CUDA, which raises where there is none (no silent CPU run)."""
    from hope_tpu.planning import mpc as jmpc
    from hope_tpu_torch.planning import mpc

    flags = ["--episodes", "1", "--max-steps", "8", "--replan-every", "4", "--horizon", "8",
             "--ilqr-iters", "1", "--rs-tries", "3", "--rs-points", "64", "--no-dlp",
             "--level", "Extrem", "--no-rs-exec", "--no-step-rs", "--no-staging",
             "--staging-tries", "2", "--portfolio", "--out", str(tmp_path), "--seed", "1"]
    seen = []

    def stop(self, args=None, namespace=None):
        seen.append(vars(orig(self, args, namespace)))
        raise SystemExit(0)

    import argparse
    orig = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    for m in (jmpc, mpc):
        with pytest.raises(SystemExit):
            m.main(flags)
    monkeypatch.undo()
    jax_args, port_args = seen
    assert port_args.pop("device") == "cuda"
    assert port_args == jax_args
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mpc.main(["--smoke", "--out", str(tmp_path)])


@pytest.mark.slow
def test_jax_mpc_file():
    """The committed JAX outputs are what the JAX package gives today."""
    want = mc.load()
    got = {}
    scenes = mc.jax_scenes()
    got.update({f"scenes/{n}/{f}": v for n, d in scenes.items() for f, v in d.items()})
    for name in mc.ILQR_CASES:
        got.update({f"ilqr/{name}/{k}": v for k, v in mc.jax_ilqr(name).items()})
    got.update(mc.jax_staging(scenes))
    got.update(mc.jax_runner(scenes))
    got.update(mc.jax_cli_keys())
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(want[k], v, err_msg=k)
    assert os.path.exists(mc.MPC_NPZ)
