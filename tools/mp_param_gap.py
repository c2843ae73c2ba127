"""How far a 2-rank SAC run's parameters end from a 1-rank run's of the same
seed on one card, for sound runs and for runs with a planted fault: the data
behind ``chip_smoke.py``'s limits on that gap (``MP_ACTOR_GAP``,
``MP_ACTOR_MEAN_GAP``, ``MP_CRITIC_LOOSE``, phase ``mp_train``).

    python3 tools/mp_param_gap.py [--sound N] [--faulty N] [--one N]

Each run is ``mp_train``'s SAC run: ``train_sac`` at the defaults, 1 warm-up
and 2 update chunks (128 updates), seed 0, two ranks on ``cuda:0`` over
gloo, or one process. The planted fault leaves rank 1's half out of every
gradient sum (rank 1 zeroes its gradients before the all-reduce), so the
ranks stay equal to each other and only the comparison with one process can
see it. Each 2-rank run passes ``mp_train``'s checks of the ranks (equal
states, launches, every kernel held to its plain version). Every 2-rank run
is compared with every 1-rank run, and the 1-rank
runs with each other (the card's own run-to-run gap: cuDNN's backward is
not bitwise repeatable). One JSON line per pair with
``chip_smoke.sac_param_gaps``'s statistics, then a summary line. Needs a
CUDA device.
"""
import argparse
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank(spec: dict):
    """One rank (``--rank <spec>``): ``chip_smoke.mp_rank``, with the fault
    planted where ``spec["fault"]``."""
    import torch

    import chip_smoke as cs
    from hope_tpu_torch.agents import sac

    if spec.get("fault"):
        reduce = sac.all_reduce_sum

        def faulty(tensors, mesh, as_bytes=False):
            if mesh is not None and mesh.rank == 1:
                with torch.no_grad():
                    for t in tensors:
                        t.zero_()
            return reduce(tensors, mesh, as_bytes)

        sac.all_reduce_sum = faulty
    cs.mp_rank(spec)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sound", type=int, default=2)
    ap.add_argument("--faulty", type=int, default=1)
    ap.add_argument("--one", type=int, default=2)
    ap.add_argument("--rank", type=str, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank(json.loads(args.rank))
        return
    import torch

    import chip_smoke as cs
    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

    if not torch.cuda.is_available():
        sys.exit("mp_param_gap: needs a CUDA device")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    cs.phase_build()
    dev = torch.device("cuda", 0)
    kernels = {"mask_step_lengths": {"mod": mask_steps}, "raster_bev": {"mod": raster_bev},
               "swept_collide": {"mod": sweep_collide}}
    common = ["--no-tensorboard", "--seed", "0", "--log-every", "1",
              "--warmup-chunks", str(cs.MP_SAC_WARMUP), "--device", str(dev),
              "--max-chunks", str(cs.MP_SAC_CHUNKS)]
    entry = [sys.executable, os.path.abspath(__file__), "--rank"]
    two = []
    for i, fault in enumerate([False] * args.sound + [True] * args.faulty):
        d = cs.scratch_dir(f"gap_two_{i}")
        ranks = cs._mp_spawn(dev, "sac", common + ["--devices", str(cs.MP_WORLD),
                                                  "--log-dir", d], kernels, d, 360,
                             entry=entry, fault=fault)
        cs._check_ranks("sac", ranks, cs.TRAIN_K, cs.TRAIN_B, kernels)
        equal = ranks[0]["chunks"][-1]["state_sha"] == ranks[1]["chunks"][-1]["state_sha"]
        two.append(("faulty" if fault else "sound", i, cs.two_rank_agent(d, cs.MP_SAC_CHUNKS)[0],
                    equal))
        shutil.rmtree(d)
    ones = [cs.one_rank_sac(common, cs.scratch_dir(f"gap_one_{j}"))["state"]
            for j in range(args.one)]
    rows = []
    for kind, i, agent, equal in two:
        for j, ref in enumerate(ones):
            rows.append({"pair": f"{kind} 2-rank run {i} vs 1-rank run {j}", "kind": kind,
                         "ranks_equal": equal, **cs.sac_param_gaps(agent, ref)})
    for j in range(1, len(ones)):
        rows.append({"pair": f"1-rank run {j} vs 1-rank run 0", "kind": "one_vs_one",
                     **cs.sac_param_gaps(ones[j], ones[0])})
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {}
    for kind in ("sound", "faulty", "one_vs_one"):
        sel = [r for r in rows if r["kind"] == kind]
        if sel:
            summary[kind] = {g: {s: [min(r[g][s] for r in sel), max(r[g][s] for r in sel)]
                                 for s in ("max", "mean", "share_over_1e-6")}
                             for g in ("actor", "critics", "log_alpha")}
    print(json.dumps({"summary (min, max over pairs)": summary}), flush=True)


if __name__ == "__main__":
    main()
