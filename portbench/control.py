"""Readings for the limits of the correctness checks: one cell on many seeds
in one process, with the program as it is, with the control, or with a
fault planted. Not run by the benchmark's runs.

The control is the precision below the configuration's float32 with TF32
off: the program's own TF32 path switched on (``--control tf32``).

    python3 -m portbench.control --workload <name> --seeds 1,2,3 --seconds 8 \\
        [--control tf32 | --fault unchanged|half_batch|altered] [--out f.jsonl]

Prints (and appends to ``--out``) one JSON line a seed: the checks'
numbers, ``correct`` against the limits as they stand, and the end-to-end
numbers of that short window.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import run as bench
from .faults import FAULTS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for k, v in bench.run_env().items():
        os.environ.setdefault(k, v)
    for seed in (int(s) for s in args.seeds.split(",")):
        run_args = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds,
                                      trace=0)
        line = bench.run_cell(run_args, control=args.control, fault=args.fault)
        rec = {"workload": args.workload, "seed": seed, "control": args.control,
               "fault": args.fault, "correct": line["correct"], "attempted": line["attempted"],
               "checks": {k: c["value"] for k, c in line["checks"].items()},
               "metrics": {k: m["value"] for k, m in line["metrics"].items()},
               "memory_peak_bytes": line["device"]["memory_peak_bytes"]}
        print(json.dumps(rec), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
