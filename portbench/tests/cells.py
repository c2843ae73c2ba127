"""Cells at sizes the CPU holds, for the tests: each workload's traffic and
configuration with a few numbers made small, written as new files of a
benchmark directory of their own (the harness finds them by name)."""
from __future__ import annotations

import argparse
import json
import os
import shutil

import torch

from portbench import run as bench

SMALL = {
    "hope_sac.eval_dlp1k": ({"episodes": 4, "max_steps": 6, "warm_steps": 1, "trace_steps": 2,
                             "check_steps": 3, "check_rows": 3}, {}),
}


def small_bench(tmp: str, workload: str) -> tuple:
    """A benchmark directory under ``tmp`` whose ``workload`` is small:
    (BENCHMARK.json path, data directory)."""
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    data = os.path.join(tmp, "portbench")
    for sub in ("traffic", "limits", "metrics", "configs"):
        shutil.copytree(os.path.join(bench.BENCH_DIR, sub), os.path.join(data, sub))
    cell = {w["name"]: w for w in spec["workloads"]}[workload]
    traffic_over, config_over = SMALL[workload]
    tpath = os.path.join(data, "traffic", f"{cell['config']}.{cell['traffic']}.json")
    with open(tpath) as f:
        traffic = json.load(f)
    with open(tpath, "w") as f:
        json.dump({**traffic, **traffic_over}, f)
    for c in spec["configs"]:
        cpath = os.path.join(data, "configs", os.path.basename(c["file"]))
        with open(cpath) as f:
            cfg = json.load(f)
        if c["name"] == cell["config"]:
            cfg.update(config_over)
        with open(cpath, "w") as f:
            json.dump(cfg, f)
        c["file"] = cpath
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path, data


# a CPU window long enough for a few whole units of each cell
SECONDS = {}


def run_small(tmp: str, workload: str, trace: int = 0, **kw) -> dict:
    """One small run of ``workload`` on the CPU; the result line."""
    seconds = SECONDS.get(workload, 2.0)
    path, data = small_bench(str(tmp), workload)
    args = argparse.Namespace(workload=workload, seed=2_147_483_659, seconds=seconds, trace=trace)
    return bench.run_cell(args, device=torch.device("cpu"), bench_path=path, bench_dir=data,
                          **kw)
