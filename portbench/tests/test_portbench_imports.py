"""What the card path loads: no module whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or ``hope_tpu`` (``hope_tpu_torch`` is
allowed); and the reference imports nothing of the port."""
import ast
import json
import os
import subprocess
import sys

from portbench import run as bench

REF_DIR = os.path.join(bench.BENCH_DIR, "reference")


def test_forbidden_names_are_compared_whole():
    mods = ["hope_tpu_torch", "hope_tpu_torch.envs", "jaxtyping", "flaxen", "torch"]
    assert bench.loaded_forbidden(mods) == []
    assert bench.loaded_forbidden(mods + ["hope_tpu.ops", "jax", "jaxlib.xla", "flax"]) == [
        "flax", "hope_tpu.ops", "jax", "jaxlib.xla"]


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=bench.ROOT, capture_output=True, text=True, check=True,
                         env={**os.environ, **bench.run_env()})
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_card_path_loads_no_jax_and_no_jax_package():
    loops = ("sac_battery",)
    code = "\n".join(["import portbench.run, portbench.control"]
                     + [f"import portbench.loops.{d}" for d in loops]
                     + ["import hope_tpu_torch.evaluation.eval_mix_scene"])
    assert bench.loaded_forbidden(_loaded_after(code)) == []


def test_reference_loads_nothing_of_the_port():
    mods = []
    for dirpath, _, files in os.walk(REF_DIR):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), bench.ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    loaded = _loaded_after("\n".join(f"import {m}" for m in sorted(mods)))
    assert not [m for m in loaded if m.split(".")[0] in ("hope_tpu_torch",) + bench.FORBIDDEN]


def test_reference_sources_import_nothing_of_the_port():
    for dirpath, _, files in os.walk(REF_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])
                for n in names:
                    assert n.split(".")[0] not in ("hope_tpu_torch",) + bench.FORBIDDEN, (f, n)
