"""The MPC cell on the CPU at a small size: 4 DLP episodes, 8 steps at
replan 4 then 2, an iLQR of horizon 8 and 2 iterations, and the staging cut
to its first 40 polar candidates and 48 templates (the whole of it takes
minutes on the CPU). A sound run is correct and a traced one reports the
program's spans and counters; each of the cell's faults
(``portbench.mpc_faults``) comes out not correct: the bfloat16 solve by
its costs, the wrong latch by its latches, and the old arc step, whose
digits go only on gentle turns, by ``cost_gap`` on such a replan."""
import math

import pytest
import torch

from portbench import mpc_faults

from . import cells

WORKLOAD = "hope_mpc.battery_dlp"
ILQR = {"horizon": 8, "n_iters": 2, "dt": 0.5, "w_terminal_pos": 300.0,
        "w_terminal_heading": 80.0, "w_running_pos": 0.05, "w_control": 0.05,
        "w_steer_rate": 0.2, "w_obstacle": 30.0, "obstacle_margin": 0.35, "reg_init": 1.0,
        "alphas": [1.0, 0.5, 0.25, 0.1, 0.03]}
SMALL = ({"episodes": 4, "max_steps": 8, "replan_every": [4, 2], "trace_replans": 1,
          "check_replans": 2, "check_steps": 3, "check_rows": 4, "check_candidates": 16},
         {"ilqr": ILQR, "staging_polar": 40})


@pytest.fixture
def small_cell(monkeypatch):
    from hope_tpu_torch.planning import staging

    cands, templates = staging.staging_candidates, staging._templates
    monkeypatch.setattr(staging, "staging_candidates",
                        lambda dest, *a, **k: cands(dest, *a, **k)[..., :40, :])
    monkeypatch.setattr(staging, "_templates", lambda *a: tuple(t[:48] for t in templates(*a)))
    monkeypatch.setitem(cells.SMALL, WORKLOAD, SMALL)
    monkeypatch.setitem(cells.SECONDS, WORKLOAD, 60.0)


def test_sound_run_is_correct(tmp_path, small_cell):
    line = cells.run_small(tmp_path, WORKLOAD)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and list(line)[-1] == "checks"


def test_traced_run_reports_the_program_spans(tmp_path, small_cell):
    """On the CPU the graphs run eagerly and no device work is traced: the
    span and counter readers and the iLQR's operations report, the device's
    do not."""
    line = cells.run_small(tmp_path, WORKLOAD, trace=1)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    for m in ("ilqr_ms.mpc", "rs_warm_ms.mpc", "waypoint_ms.mpc", "staging_ms.mpc",
              "latched_share.mpc", "mfu.mpc"):
        assert m in got and math.isfinite(got[m]["value"]), m
    assert 0 <= got["latched_share.mpc"]["value"] <= 100
    assert got["staging_ms.mpc"]["value"] > got["ilqr_ms.mpc"]["value"] > 0


@pytest.mark.parametrize("fault,check", [("bf16_solve", "cost_gap"),
                                         ("wrong_latch", "latch_mismatch")])
def test_fault_is_not_correct(tmp_path, small_cell, fault, check):
    line = cells.run_small(tmp_path, WORKLOAD, fault=fault)
    assert not line["correct"], line["checks"]
    c = line["checks"][check]
    assert c["value"] is None or c["value"] > c["limit"], line["checks"]


def test_old_arc_step_fails_cost_gap():
    """A replan on gentle turns (a warm start steering 1e-6 rad, the cell's
    weights, 16 steps, 3 iterations): with the old arc step the program's
    reported cost misses the float64 cost of its own controls by more than
    the cell's limit."""
    import json
    import os

    from hope_tpu_torch.config import VehicleConfig
    from hope_tpu_torch.planning import ilqr
    from portbench.loops.mpc_battery import replan_gaps
    from portbench.reference import ilqr as ref_ilqr

    with open(os.path.join(cells.bench.BENCH_DIR, "limits", f"{WORKLOAD}.json")) as f:
        limit = json.load(f)["cost_gap"]
    g = torch.Generator().manual_seed(3)
    B, H = 4, 16
    x0 = torch.stack([torch.rand(B, generator=g) * 4 - 6, torch.rand(B, generator=g) * 4 - 2,
                      torch.rand(B, generator=g) - 0.5], -1)
    goal = x0 + torch.tensor([8.0, 0.5, 0.1])
    edges, mask = torch.zeros(B, 4, 4), torch.zeros(B, 4, dtype=torch.bool)
    us = torch.stack([torch.full((B, H), 1e-6), torch.full((B, H), 2.0)], -1)
    v = VehicleConfig()
    cfg = ilqr.ILQRConfig(horizon=H, dt=v.dt * v.n_substep, n_iters=3,
                          **{k: x for k, x in ILQR.items()
                             if k not in ("horizon", "n_iters", "dt", "alphas")})
    sp = ref_ilqr.spec_of({"ilqr": {**ILQR, "horizon": H, "n_iters": 3}})
    with mpc_faults.planted("old_arc"):
        res = ilqr.solve_batch(x0, goal, edges, mask, us, cfg, v)
    assert replan_gaps(x0, goal, edges, mask, us, res, sp)[0] > limit
    res = ilqr.solve_batch(x0, goal, edges, mask, us, cfg, v)
    assert replan_gaps(x0, goal, edges, mask, us, res, sp)[0] <= limit


def test_card_path_loads_no_jax_and_no_jax_package():
    from .test_portbench_imports import _loaded_after

    code = "\n".join(["import portbench.run", "import portbench.loops.mpc_battery",
                      "import portbench.mpc_faults", "import portbench.ilqr_work",
                      "import hope_tpu_torch.planning.mpc"])
    assert cells.bench.loaded_forbidden(_loaded_after(code)) == []
