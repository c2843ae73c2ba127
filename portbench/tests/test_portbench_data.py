"""``BENCHMARK.json`` keeps to the contract's form, and a configuration, a
traffic mix and a per-layer metric are added as new files and entries only:
the harness finds them by name and runs the new cell."""
import json
import os
import re

from portbench import run as bench

from .cells import run_small, small_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    with open(os.path.join(bench.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_form():
    b = _spec()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and b["paths"] == ["portbench"]
    n = len(b["workloads"])
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 and n <= 24
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("portbench/") and os.path.isfile(
            os.path.join(bench.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["name"] not in names
        names.add(w["name"])
        for d in ("traffic", "limits"):
            f = (f"{w['config']}.{w['traffic']}" if d == "traffic" else w["name"]) + ".json"
            assert os.path.isfile(os.path.join(bench.BENCH_DIR, d, f)), f
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(bench.BENCH_DIR, "metrics", m["name"] + ".py"))
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
    for w in names:
        reported = [m for m in b["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2 and any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_a_cell_config_and_metric_added_as_files(tmp_path):
    path, data = small_bench(str(tmp_path), "hope_sac.eval_dlp1k")
    with open(path) as f:
        spec = json.load(f)
    sac = {c["name"]: c for c in spec["configs"]}["hope_sac"]
    with open(sac["file"]) as f:
        cfg = json.load(f)
    cfg["rs_tries"] = 4                                   # a new configuration
    new_cfg = os.path.join(data, "configs", "hope_sac_rs4.json")
    with open(new_cfg, "w") as f:
        json.dump(cfg, f)
    spec["configs"].append({**sac, "name": "hope_sac_rs4", "file": new_cfg})
    with open(os.path.join(data, "traffic", "hope_sac.eval_dlp1k.json")) as f:
        traffic = json.load(f)
    with open(os.path.join(data, "traffic", "hope_sac_rs4.eval_small.json"), "w") as f:
        json.dump({**traffic, "episodes": 3}, f)          # a new traffic mix
    with open(os.path.join(data, "limits", "hope_sac.eval_dlp1k.json")) as g, \
            open(os.path.join(data, "limits", "hope_sac_rs4.eval_small.json"), "w") as f:
        json.dump(json.load(g), f)
    with open(os.path.join(data, "metrics", "busy_s.eval.py"), "w") as f:
        f.write("def read(layer):\n    tr = layer.get('trace')\n"
                "    return tr.busy_s if tr is not None else None\n")  # a new per-layer metric
    spec["workloads"].append({"name": "hope_sac_rs4.eval_small", "config": "hope_sac_rs4",
                              "traffic": "eval_small", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "eval_env_steps_per_s":
            m["workloads"].append("hope_sac_rs4.eval_small")
    spec["per_layer"].append({"name": "busy_s.eval", "unit": "s", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "eval_env_steps_per_s",
                              "workloads": ["hope_sac_rs4.eval_small"]})
    with open(path, "w") as f:
        json.dump(spec, f)
    import argparse

    import torch

    for trace, metric in ((0, "eval_env_steps_per_s"), (1, "busy_s.eval")):
        args = argparse.Namespace(workload="hope_sac_rs4.eval_small", seed=7, seconds=2.0,
                                  trace=trace)
        line = bench.run_cell(args, device=torch.device("cpu"), bench_path=path, bench_dir=data)
        assert line["correct"] and metric in line["metrics"], line["checks"]


def test_traced_line_has_device_times_and_breakdown(tmp_path):
    line = run_small(tmp_path, "hope_sac.eval_dlp1k", trace=1)
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
