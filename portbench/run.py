"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything about a cell is data that this file finds by name in
``BENCHMARK.json``: the configuration ``portbench/configs/<config>.json``,
the traffic ``portbench/traffic/<config>.<traffic>.json`` (its ``loop``
names the general window loop in ``portbench/loops/`` and the rest are that
loop's parameters), the limits of the correctness check
``portbench/limits/<workload>.json``, and each per-layer metric's reader
``portbench/metrics/<metric>.py``. A cell, a traffic mix or a metric is
added by adding files and entries.

The run loads, warms up (set-up, ``setup_s``), measures for ``--seconds``,
reads the peak device memory, frees the program's state, holds what the
window produced to the plain reference under ``portbench/reference/``, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer ones), ``device`` and, traced, ``breakdown``; then ``checks``,
each number compared beside its limit, which also end standard error.
It exits non-zero with no result line where no CUDA device is there, where
the cell asks for more devices than there are, and where JAX, flax or the
JAX package is loaded after the window.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()   # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "portbench")
# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "hope_tpu")
PROGRAM = "hope_tpu_torch"


class Refused(Exception):
    """A run that must print no result (exit code 2)."""


def run_env(root: str = ROOT) -> dict:
    """The run's environment: fixed build and kernel cache directories
    inside the checkout, one host thread for PyTorch's and numpy's CPU work
    (the host's other cores stay free for the thread that drives the card),
    and no JAX behind a library's back."""
    cache = os.path.join(root, "build", "portbench_cache")
    return {"TORCH_EXTENSIONS_DIR": os.path.join(cache, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(cache, "triton"),
            "CUDA_CACHE_PATH": os.path.join(cache, "nv_compute"),
            "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1",
            "USE_FLAX": "0", "USE_JAX": "0"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench: dict):
    """The workload entry, its configuration entry, and the metric entries
    it reports: (cell, config, end_to_end, per_layer)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return cell, config, e2e, layer


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    ``FORBIDDEN`` (``hope_tpu_torch`` is not ``hope_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a window loop is given: the run's arguments, the cell's data, the
    device, and for the tests and the control runs (``portbench.control``)
    a control (``"tf32"``) or a fault (``portbench.faults``)
    to put under the timed path; a benchmark run has neither."""

    def __init__(self, args, cell: dict, config: dict, traffic: dict, limits: dict,
                 device, control: str | None = None, fault: str | None = None):
        self.workload, self.seed, self.seconds = args.workload, args.seed, args.seconds
        self.trace = bool(args.trace)
        self.cell, self.config, self.traffic, self.limits = cell, config, traffic, limits
        self.device, self.control, self.fault = device, control, fault
        self.t_process = T_PROCESS

    def module(self, name: str):
        """The program's module ``name`` (dotted, under ``hope_tpu_torch``)."""
        return importlib.import_module(f"{PROGRAM}.{name}")

    def sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)


def run_cell(args, device=None, bench_path: str | None = None, control: str | None = None,
             fault: str | None = None, bench_dir: str = BENCH_DIR):
    """Run one cell; returns the result line (a dict, ``checks`` last).
    ``device``, ``control``, ``fault`` and the data's place (``bench_path``,
    ``bench_dir``) are for the tests and the control runs: a run takes the
    first CUDA device and this checkout's data, in the precision its
    configuration states."""
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cell, cfg_entry, e2e, layer = find_cell(args.workload, bench)
    config = load_json(os.path.join(ROOT, cfg_entry["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{cell['config']}.{cell['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{cell['name']}.json"))
    if importlib.util.find_spec(PROGRAM) is None:
        raise Refused(f"the program's package {PROGRAM!r} is not in this checkout")

    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{args.workload} needs {cell['chips']} devices, "
                          f"{torch.cuda.device_count()} found")
        device = torch.device("cuda", 0)
    ctx = Context(args, cell, config, traffic, limits, device, control, fault)
    loop = importlib.import_module(f"portbench.loops.{traffic['loop']}")
    res = loop.run(ctx)

    forbidden = loaded_forbidden()
    if forbidden:
        raise Refused(f"loaded after the window: {forbidden}")

    metrics = {}
    if args.trace:
        for m in layer:
            value = load_reader(m["name"], bench_dir)(res["layer"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            value = res["setup_s"] if m["name"] == "setup_s" else res["e2e"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # a reading that is not a finite number (nothing compared, or a NaN) is
    # not correct, and goes into the line as null
    checks = {k: {"value": v if math.isfinite(v) else None, "limit": limits[k]}
              for k, v in res["checks"].items()}
    correct = bool(checks) and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    tr = res["layer"].get("trace")
    if args.trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    line["checks"] = checks
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for k, v in run_env().items():
        os.environ.setdefault(k, v)
    try:
        line = run_cell(args)
    except Refused as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        sys.path.insert(0, ROOT)
    sys.exit(main())
