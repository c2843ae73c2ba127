"""Device activities (kernels, copies, sets) per program span of a
``torch.profiler`` Chrome trace: each activity is given to the innermost
program range (a name holding ``/``, as ``utils/profiling.annotate`` opens)
open on the host thread that made its launch call, matched through the
profiler's correlation ids.

    python3 tools/span_launches.py TRACE [--per N]

TRACE is a ``trace.json`` (``train_sac --profile-chunks``) or a gzipped one,
or ``chip_smoke.py``'s ``chiprun_out/battery_trace.json``. Prints one JSON
object {span: activities / N} (``none`` for launches outside any range),
largest first; ``--per`` divides by the steps the trace holds.
"""
import argparse
import gzip
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def span_launches(events: list) -> dict:
    """{innermost program range at the launch call: device activities}."""
    done = {e["args"]["correlation"] for e in events
            if e.get("cat") in DEVICE_CATS and "correlation" in e.get("args", {})}
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and "/" in e.get("name", ""):
            ranges.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    out = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        if e.get("args", {}).get("correlation") not in done:
            continue
        t = e["ts"]
        open_ = [r for r in ranges.get((e["pid"], e["tid"]), ()) if r[0] <= t < r[1]]
        name = max(open_)[2] if open_ else "none"          # the latest to open
        out[name] = out.get(name, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--per", type=float, default=1.0)
    args = ap.parse_args(argv)
    counts = span_launches(load(args.trace))
    print(json.dumps({k: v / args.per for k, v in counts.items()}))


if __name__ == "__main__":
    main()
