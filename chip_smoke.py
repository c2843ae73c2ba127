"""Run the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per level, chunk or kernel):
  1. device  - CUDA must be available; the card's name and power limit.
  2. build   - nvcc builds the four CUDA kernels from hope_tpu_torch/csrc.
  3. kernels - each kernel at the DLP battery's shapes (B = 256 real DLP
               scenes, poses between start and goal, RS candidates from those
               poses) against its plain PyTorch version: mismatches must be 0;
               kernel and plain times from CUDA events (ms, plain_ms), the
               kernel's own time on the device from torch.profiler
               (device_ms) and its device activities per call; the bound
               from this run's inputs. render_bev_batch is the whole function
               (one launch), held to render_bev_batch_plain in both parity
               modes. Then the three kernels alone at B = 1024 (the same
               scenes tiled four times).
  4. parity  - a few steps of the whole env on the card vs on the CPU, same
               scenes and actions.
  5. battery - the 4-level evaluation battery (Extrem, dlp, Complex, Normal)
               of the committed SAC actor (hope_tpu_torch/assets/
               sac_r3b_actor.npz): 256 episodes a level, 200 steps, TF32 off;
               every kernel must launch on every level, and each level's
               success rate must be >= 0.95.
  6. kernel_procedural - the three kernels on a procedural bank's inputs
               (B = 256, 72 live edge slots of 512), recorded in the battery
               runner's first steps, held and timed as in phase 3.
  7. profile - torch.profiler over a few DLP battery steps: device busy
               share, device activities and host-to-device copies per step,
               device time by kernel (trace to chiprun_out/battery_trace.json).
  7a. graph_step - the env step's CUDA graphs (utils.graphs) on the DLP
               battery at 1024 rows: the graphed chains synchronize nothing
               (sync debug mode "error"); each graph's capture seconds; 200
               steps of the graphed env against an eager one bit for bit
               (differing values must be 0), no output overwritten by the
               next step, one launch of each kernel a step; host ms a step of
               the transition and the RS search, and wall ms a step, both
               ways; device activities and HtoD copies a step, both ways.
  8. kernel_real_step - swept_collide on the inputs the DLP battery's own
               rollout gives it at steps 1, 10, 50 and 150 (the rollout is run
               again from the battery's seed with the call recorded): what
               share of words collide and where they first hit, the times,
               and exactness against the plain version.
  9. probe   - the sweep on subsets of its words (only the colliding ones,
               only the clear ones, one word per env), for the kernel phase's
               inputs and for each recorded step; the mask kernel at B = 8
               and 64.
 10. train   - hope_tpu_torch.train.train_sac.main at the JAX CLI's default
               width for 6 chunks (3 warm-up, 3 with 64 updates each): per
               chunk wall time, env-steps/s, losses, alpha, replay size,
               episodes and kernel launches (K a chunk); peak device memory.
 11. profile_train - torch.profiler over one more update chunk: busy share,
               device activities and HtoD copies per collect step, collect
               vs update time, top device ops (chiprun_out/train_trace.json.gz).
 12. train_parity - one SAC update at full width on the card and on the CPU
               from the same fresh state, batch (from the train phase's
               replay) and noise, TF32 off: parameters, gradients and
               metrics per group within stated tolerances.
 13. ppo_battery - the 4-level battery of the committed PPO actor
               (hope_tpu_torch/assets/ppo_r5_actor.npz, masked choose_action
               + RS takeover): 256 episodes a level, 200 steps, TF32 off;
               every kernel must launch on every level, and each level's
               success must reach its floor (PPO_FLOORS).
 14. ppo_train - hope_tpu_torch.train.train_ppo.main at the JAX CLI's
               defaults (B = 64, T = 128, 10 epochs of 256 minibatches of 32)
               for 1 chunk: per chunk wall time split into collect and
               update, env-steps/s, SGD steps/s, losses, approx_kl,
               episodes, kernel launches (T a chunk) and the buffer's shape;
               peak device memory. Fails on non-finite losses, a parameter
               group that did not move, a wrong buffer shape or launch count.
 15. ppo_parity - one PPO update (2 epochs) on the card and on the CPU from
               the same fresh state and permutations, on the first 512
               transitions of ppo_train's last buffer, TF32 off: parameters,
               last gradients, Adam counts, metrics and kl_stopped per group
               within stated tolerances; then the card's update again under
               torch.profiler (device time and activities per SGD step).
 16. ppo_extrem - the r5 PPO actor's Extrem level at 256 episodes (cut
               from 1024 to keep the script's time), beside the TPU
               run's 256 (a record, not a gate).
 17. mpc_kernel - swept_collide against its plain version on what the MPC
               path gives it on 256 DLP scenes: the staging precompute's
               first polar chunk (K = 6) and first template chunk, and the
               first replan's warm start (K = 12); 0 mismatches, times, bound.
 17a. ilqr_kernel - the iLQR kernel (ops.ilqr_solve) on the first replan's
               problem at the MPC CLI's settings (256 DLP scenes, staging
               goals, RS warm starts; H = 40, 12 iterations, 512 edge slots),
               and on its first row alone: device ms and ms over 50 calls,
               its bound (portbench.ilqr_work.solve_flops at the float32
               peak) at the 512 slots and at each row's live edges, device
               activities a call (one kernel), solve_batch's ms. At B = 256
               the kernel is held to solve_batch (kernel_vs_plain) at the
               warm start and at solve_batch's iterate after each of
               iterations 1-10, for its first step and for its second (the
               nearest edges and reg it carried), beside a one-ulp witness
               of the solve's own sensitivity; the whole 12-iteration solves'
               drift apart is a record (solve_divergence), beside solve_batch
               against itself with x0 moved one ulp. Fails on a failed hold,
               a non-finite cost or another launch count.
 18. mpc_battery - hope_tpu_torch.planning.mpc.main, the CLI, on DLP,
               Normal, Complex and Extrem at its defaults with --portfolio
               (256 episodes, H = 40, 12 iLQR iterations, replan 8 then 4,
               12 RS words, 6 staging words): success (floors MPC_FLOORS, no
               collision), RS and waypoint latches, staging seconds and
               coverage, each battery's seconds, plan latency and QP
               solves/s, launches per part (no mask or raster launch; the
               iLQR kernel on every level).
 19. mpc_parity - 8 Normal scenes, staging and 2 replans of the runner on
               the card and on the CPU: staging valid sets and discrete
               outcomes equal; the first replan's warm-start controls, cost
               and derivatives within stated bounds; on the card the iLQR
               kernel's first iteration against solve_batch's
               (kernel_vs_plain: derivatives within the same bounds, the
               same line-search step but at float32 ties, the cost within
               1e-4 relative or the one-ulp witness's gap).
 20. mpc_profile - torch.profiler over 2 replan cycles of the DLP runner:
               busy share, device activities and HtoD copies per replan and
               per control step.
 21. ae_pretrain - hope_tpu_torch.train.pretrain_autoencoder.main at its
               defaults (2000 steps, batch 64): steps/s, first and last loss
               (the last below the first), 40 raster and mask launches, peak
               memory; the raster and the mask held to their plain versions
               on the first render's inputs (64 Normal scenes, 96 slots).
 22. ae_graft - train_sac.main at the defaults with --img-encoder (that
               checkpoint) --freeze-img-encoder, 4 chunks: the actor's and
               critics' encoders equal the graft bitwise after the update
               chunk, every other group moved.
 23. resume  - train_sac.main with --full-save-every 2 --max-chunks 4: the
               saved file against the live loop and the file loaded back,
               bitwise (tensors, replay ring, generator states, host JSON);
               a resume inside the warm-up chunks against the uninterrupted
               run, bitwise; a resume to chunk 7 with --profile-chunks 1
               (counters continue, the trace names both chunk ranges); save
               bytes and seconds, load seconds.
 24. stream_dlp - train_sac.main at the defaults with --stream-dlp, 4 chunks:
               launches; the prefetched batch against data/dlp.npz's rows;
               the gather time the prefetch hides; a streamed refresh against
               a resident pool's from the same ids and generator, bitwise.
 25. eval_pictures - the eval CLI on Normal with --episodes 8 --visualize 2
               --animate 1: record, CDF, PNGs and GIF written (kept in
               chiprun_out/eval_pictures/), poses (200, 8, 3).
 26. single_env - ParkingEnv.reset / step / observe at B = 1 (the kernels at
               B = 1) against the batched path's row on 8 DLP scenes, 8
               steps: equal, launches one mask and raster per observation and
               one sweep per step.
 27. mp_train - two ranks on the one card over gloo (each its own process,
               ``chip_smoke.py --mp-rank``, through the CLIs' rank_worker):
               train_sac at the defaults for 1 warm-up and 2 update chunks,
               train_ppo for 1 chunk. The ranks' states bitwise equal after
               every chunk; each kernel K times a chunk a rank at B / 2; the
               first SAC chunk against a 1-rank run of the same seed; the
               2-rank full checkpoint resumed in one process. Per-rank chunk
               and collective seconds, collective bytes, peak memory.
Every record carries "t", the seconds since the script started. Training
runs log under build/chip_smoke/ (deleted after each phase), since a full
loop checkpoint holds the 2.6 GB replay ring.
Then a {"kernels": [...]} line (the four hand-written kernels; the iLQR
kernel's launches_by_path also names the MPC phases that run it), the
nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Details (nvcc/ptxas output, every record) go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import gc
import gzip
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
EPISODES = 256
MAX_STEPS = 200
MIN_SUCCESS = 0.95
# per-level floors of the PPO battery: the JAX package's results with the same
# weights (0.996 / 0.965 / 0.910 / 0.965 on a TPU) less about 3 standard
# deviations of the difference of two independent 256-episode rates
PPO_FLOORS = {"Normal": 0.97, "Complex": 0.91, "Extrem": 0.83, "dlp": 0.91}
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 ops/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

RECORDS = []
# the iLQR kernel's launches on each path of the script, for the kernels
# line: each read from that path's own run, the count set to 0 just before
ILQR_LAUNCHES: dict = {}
T0 = time.perf_counter()     # each record's "t": seconds since the script started


def emit(rec: dict):
    rec = {**rec, "t": time.perf_counter() - T0}
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over memory rate and float32
    operations over peak rate."""
    tb, to = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, reps: int, warmup: int = 2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# the program's ranges (``utils/profiling.annotate``: ``eval/``, ``policy/``,
# ``env/``, the chunks' and the MPC runner's) and Adam's also show on the
# device's timeline, as spans over the kernels they launched: they are not
# device work
RANGE_PREFIXES = ("eval/", "policy/", "env/", "sac_chunk/", "ppo_chunk/", "mpc/",
                  "Optimizer.")


def device_work(events) -> list:
    """The device activities (kernels, copies, sets) of a profiler pass's
    events: a host range's image on the device's timeline is left out, by its
    flag, by the name of a host event and by the program's range names (as
    ``portbench/trace.py`` does)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host = {e.name for e in events if e.device_type != cuda}
    return [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host and not e.name.startswith(RANGE_PREFIXES)]


def device_ms(fn, reps: int, warmup: int = 2, kinds: dict | None = None):
    """Device time per call of ``fn`` from torch.profiler over ``reps`` calls:
    for each kind of device activity (a kernel, a copy) its mean duration
    times the number of them per call, summed. Unlike :func:`cuda_ms` it
    leaves out the gaps in which the device waits for the host to send the
    next launch. The profiler can lose the first records of a pass (2 of 50
    after an earlier pass that also traced the CPU), hence means and not the
    sum over ``reps``; a pass that lost more than a fifth is taken again, and
    after three such the result is None (the run goes on; ``ms`` is there).
    ``kinds``, where given, receives {activity name: count per call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dur = {}
        for e in device_work(prof.events()):
            dur.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if dur and all(len(d) >= 0.8 * reps for d in dur.values()):
            if kinds is not None:
                kinds.update({k[:80]: round(len(d) / reps) for k, d in dur.items()})
            return sum(sum(d) / len(d) * round(len(d) / reps) for d in dur.values()) / 1e3
    print(f"chip_smoke: torch.profiler recorded {sum(map(len, dur.values()))} device "
          f"activities over {reps} calls, three times; device_ms not measured",
          file=sys.stderr)
    return None


def phase_device():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def ptxas_summary(log: str):
    """Per kernel entry of one nvcc log (-Xptxas -v): registers and spill
    bytes."""
    entries = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", log, re.S)
    return [{"entry": e, "registers": int(r), "spill_stores": int(st), "spill_loads": int(ld)}
            for e, st, ld, r in entries]


def phase_build():
    from hope_tpu_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in report.items()},
          "ptxas": {k: ptxas_summary(v["log"]) for k, v in report.items()}})
    RECORDS.append({"phase": "build_logs", **{k: v["log"] for k, v in report.items()}})


def kernel_inputs(dev):
    """The three kernels' inputs at the battery's shapes, from real DLP scenes."""
    import torch

    from hope_tpu_torch.config import EnvConfig
    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.envs.dlp import DLPDataset
    from hope_tpu_torch.envs.lidar import lidar_observation
    from hope_tpu_torch.geometry import box_to_edges, pose_to_box
    from hope_tpu_torch.planning import reeds_shepp as rs

    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    env = ParkingEnv(cfg, device=dev)
    ds = DLPDataset(env_cfg=cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    sc = ds.batch_reset(torch.arange(EPISODES) % ds.n_cases, gen)
    a = torch.rand(EPISODES, 1, generator=gen, device=dev) * 0.6 + 0.2
    pose = sc.start * (1 - a) + sc.dest * a

    lidar = lidar_observation(pose, sc.edges, sc.edge_mask, env.angles, env.hull_base,
                              cfg.lidar)
    ext = (torch.clamp(lidar, 0.0, cfg.lidar.max_range) + env.hull_base).contiguous()
    mask_in = (ext, env.mask_table.dist_star, cfg.mask.n_iter, cfg.mask.upsample)

    vcfg = cfg.vehicle
    raster_in = tuple(t.contiguous() for t in (pose, pose_to_box(pose, env.corners),
                                               sc.dest_box, sc.edges, sc.edge_mask,
                                               sc.edge_poly)) + (cfg.obs, vcfg)

    maxc = vcfg.max_curvature
    cand = rs.candidates(pose[:, None], sc.dest[:, None], maxc)
    cand = rs.RSCandidates(*(t.squeeze(1) for t in cand))
    idx = torch.sort(cand.L, dim=1, stable=True).indices[:, :cfg.rs_max_tries]
    gi = idx[..., None].expand(-1, -1, rs.N_SEG)
    poses, live, _ = rs.sample_path(torch.gather(cand.lengths, 1, gi),
                                    torch.gather(cand.steers, 1, gi), pose[:, None],
                                    maxc, cfg.rs_max_points, cfg.rs_step_size)
    K, N = idx.shape[1], poses.shape[2]
    car = box_to_edges(pose_to_box(poses, env.corners)).reshape(EPISODES, K, N * 4, 4)
    live4 = torch.repeat_interleave(live, 4, dim=-1)
    sweep_in = (car.contiguous(), live4.contiguous(), sc.edges.contiguous(),
                sc.edge_mask.contiguous())
    return mask_in, raster_in, sweep_in


def tile4(t):
    """``t`` four times over along its first (batch) dimension."""
    return t.repeat(4, *([1] * (t.ndim - 1))).contiguous()


def raster_plain(raster_bev):
    """The module's render_bev_batch_plain; composed from its three steps in
    a tree that predates that name, so that one call can run both trees."""
    if hasattr(raster_bev, "render_bev_batch_plain"):
        return raster_bev.render_bev_batch_plain

    def plain(poses, vboxes, dboxes, edges, mask, poly, obs, vcfg, exact=None):
        import torch

        exact = obs.raster_parity == "exact" if exact is None else exact
        cx_off = (vcfg.front_hang + vcfg.wheel_base - vcfg.rear_hang) / 2.0
        params, cnt = raster_bev.ego_edge_params(poses, edges, mask, poly, cx_off,
                                                 obs.img_size, obs.img_res, exact)
        quads = torch.cat([raster_bev.quad_coeffs(poses, dboxes, cx_off),
                           raster_bev.quad_coeffs(poses, vboxes, cx_off)], dim=1)
        return raster_bev.raster_bev_plain(params, cnt, quads, obs.img_size, obs.img_res)
    return plain


def raster_work(poses, vboxes, dboxes, edges, mask, poly, obs, vcfg):
    """(bytes, float operations, data) the raster needs on these inputs, in
    exact mode. Bytes: every input read once, the image written once.
    Operations: ~30 per edge slot to move it to the ego frame and cull it;
    per kept edge ~2 log2(n) compares to find the rows it straddles; per
    straddled (edge, image row) pair ~12 (v*su + uc, J, the count of columns
    left of the crossing, and the row-word update); per pixel 8 half-planes
    of 5 and the class select. (Earlier versions charged 8 operations per (pixel, kept
    edge), the TPU kernel's formulation; crossings are needed only on the rows
    an edge straddles, fewer than 1% of those tests here.)"""
    import math

    import torch

    from hope_tpu_torch.ops import raster_bev

    n, B, E = obs.img_size, edges.shape[0], edges.shape[1]
    cx_off = (vcfg.front_hang + vcfg.wheel_base - vcfg.rear_hang) / 2.0
    params, cnt = raster_bev.ego_edge_params(poses, edges, mask, poly, cx_off, n, obs.img_res,
                                             True)
    kept = cnt[:, 0].to(torch.float64)
    v, _ = raster_bev.pixel_coords(n, obs.img_res, edges.device)
    v = v[::n]                                                           # (n,) rows
    slot = torch.arange(E, device=edges.device)[None, :] < cnt[:, :1]
    A, Bv = params[:, 0, :, None], params[:, 1, :, None]
    pairs = float((((A > v) != (Bv > v)) & slot[..., None]).sum())
    ops = (30.0 * B * E + 2.0 * math.log2(n) * float(kept.sum()) + 12.0 * pairs
           + 43.0 * B * n * n)
    nbytes = (sum(t.numel() * t.element_size() for t in (poses, vboxes, dboxes, edges, mask, poly))
              + B * n * n * 3 * 4)
    return nbytes, ops, {"kept_edges_mean": float(kept.mean()), "kept_edges_max": float(kept.max()),
                         "straddled_rows_per_kept_edge": pairs / max(float(kept.sum()), 1.0),
                         "straddled_pairs_per_env": pairs / B}


def sweep_work(car_live, scene_edges, scene_mask, seg_hit):
    """(bytes, float operations) the sweep needs on this data, from the plain
    version's per-segment hits ``seg_hit`` (B, K, S). A clear path tests
    every live (segment, edge) pair and reads all its segments' live flags; a
    colliding one stops at the first car segment that hits, so it tests and
    reads only up to and including that segment. Bytes: 16 per live segment
    tested, 1 per live flag read, the scene's edges and mask once, the
    output. Operations: ~20 per pair test (6 subs, 8 muls, 4 compares, 2
    abs)."""
    import torch

    S = car_live.shape[-1]
    hit = seg_hit.any(-1)
    first = seg_hit.to(torch.uint8).argmax(-1)
    n_edges = scene_mask.sum(dim=1).to(torch.float64)[:, None]       # (B, 1)
    segs = car_live.sum(dim=-1).to(torch.float64)                   # (B, K)
    live_before = torch.cumsum(car_live.to(torch.float64), dim=-1)  # (B, K, S)
    upto = torch.gather(live_before, -1, first[..., None]).squeeze(-1)
    segs = torch.where(hit, upto, segs)
    flags = torch.where(hit, first + 1, S).to(torch.float64)
    nbytes = (float((16.0 * segs + flags).sum()) + scene_edges.numel() * 4
              + scene_mask.numel() + hit.numel())
    return nbytes, 20.0 * float((segs * n_edges).sum())


def sweep_data(car_live, scene_mask, seg_hit):
    """What decides the sweep's cost on these inputs: live edges per env, live
    segments per word, the share of words that collide, and where along the
    path (segment index) the colliding ones first hit."""
    import torch

    hit = seg_hit.any(-1)
    first = seg_hit.to(torch.uint8).argmax(-1)[hit].float()
    stat = {k: (float(f(first)) if first.numel() else None)
            for k, f in (("median", torch.median), ("mean", torch.mean),
                         ("p90", lambda t: t.quantile(0.9)), ("max", torch.max))}
    return {"words": hit.numel(), "colliding_share": float(hit.float().mean()),
            "clear_words": int((~hit).sum()),
            "live_edges_mean": float(scene_mask.sum(1).float().mean()),
            "live_segments_mean": float(car_live.sum(-1).float().mean()),
            **{f"first_hit_segment_{k}": v for k, v in stat.items()}}


def measure_kernels(phase: str, mask_in, raster_in, sweep_in, reps: int = 50):
    """Each kernel on these inputs (those not None) against its plain version
    (0 mismatches or raise), timed (``ms``, ``device_ms``, ``plain_ms``)
    beside its bound; one record per kernel under ``phase``. Returns {name:
    record and outputs}."""
    out = {}
    if mask_in is not None:
        out["mask_step_lengths"] = _measure_mask(mask_in, reps)
    if raster_in is not None:
        out["raster_bev"] = _measure_raster(phase, raster_in, reps)
    if sweep_in is not None:
        out["swept_collide"] = _measure_sweep(sweep_in, reps)
    for name, r in out.items():
        mism = int((r["kernel_out"] != r["plain_out"]).sum())
        err = float((r["kernel_out"].float() - r["plain_out"].float()).abs().max())
        r["mismatches"], r["max_abs_err"] = mism, err
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["ops"])
        emit({"phase": phase, "name": name, "B": int(r["kernel_out"].shape[0]),
              "mismatches": mism, "max_abs_err": err, "ms": r["ms"],
              "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
              "bound_by": r["bound_by"], "bytes": r["nbytes"], "ops": r["ops"],
              **({"data": r["data"]} if "data" in r else {})})
        if mism:
            raise AssertionError(f"{phase} {name}: kernel and plain version differ in "
                                 f"{mism} places")
    return out


def _measure_mask(mask_in, reps):
    import torch

    from hope_tpu_torch.ops import mask_steps

    ext, table, n_iter, up = mask_in
    k = mask_steps.mask_step_lengths(ext, table, n_iter, up)
    p = mask_steps.mask_step_lengths_plain(ext, table, n_iter, up)
    torch.cuda.synchronize()
    B, R = ext.shape
    RU, A, I = table.shape
    nbytes = 4 * (ext.numel() + table.numel() + B * A)
    # what the function needs: one compare per (env, ray, column), since the
    # min over rays of (t > up ? k : I) is (any ray with t > up) ? k : I, and
    # the upsample's 5 operations per (env, upsampled ray)
    ops = 1.0 * B * RU * A * I + 5.0 * B * RU
    return dict(
        mod=mask_steps, kernel_out=k, plain_out=p, nbytes=nbytes, ops=ops,
        ms=cuda_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), reps),
        device_ms=device_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), reps),
        plain_ms=cuda_ms(lambda: mask_steps.mask_step_lengths_plain(ext, table, n_iter, up), 5),
        source="hope_tpu_torch/csrc/mask_steps.cu",
        replaces="hope_tpu/ops/mask_steps.py:50")


def _measure_raster(phase, raster_in, reps):
    """render_bev_batch, the whole function (exact per-polygon parity, the
    battery's mode), and the global even-odd mode held to its plain version."""
    import torch

    from hope_tpu_torch.ops import raster_bev

    render, render_plain = raster_bev.render_bev_batch, raster_plain(raster_bev)
    k = render(*raster_in)
    p = render_plain(*raster_in)
    glob = int((render(*raster_in, exact=False) != render_plain(*raster_in, exact=False)).sum())
    torch.cuda.synchronize()
    nbytes, ops, data = raster_work(*raster_in)
    acts = {}
    res = dict(
        mod=raster_bev, kernel_out=k, plain_out=p, nbytes=nbytes, ops=ops,
        ms=cuda_ms(lambda: render(*raster_in), reps),
        device_ms=device_ms(lambda: render(*raster_in), reps, kinds=acts),
        plain_ms=cuda_ms(lambda: render_plain(*raster_in), 3),
        source="hope_tpu_torch/csrc/raster_bev.cu",
        replaces="hope_tpu/ops/raster_bev.py:306",
        data=dict(data, global_mode_mismatches=glob, device_activities_per_call=acts,
                  htod_copies_per_call=sum(c for a, c in acts.items() if "HtoD" in a)))
    if glob:
        raise AssertionError(f"{phase} render_bev_batch, global parity: {glob} mismatches")
    return res


def _measure_sweep(sweep_in, reps):
    import torch

    from hope_tpu_torch.ops import sweep_collide

    car, live4, edges, emask = sweep_in
    k = sweep_collide.swept_collide(car, live4, edges, emask)
    p = sweep_collide.swept_collide_plain(car, live4, edges, emask)
    torch.cuda.synchronize()
    seg_hit = sweep_collide.swept_collide_plain(car, live4, edges, emask,
                                                per_segment=True)  # (B, K, S)
    if not torch.equal(seg_hit.any(-1), p):
        raise AssertionError("swept_collide: per-segment plain disagrees with plain")
    nbytes, ops = sweep_work(live4, edges, emask, seg_hit)
    return dict(
        mod=sweep_collide, kernel_out=k, plain_out=p, nbytes=nbytes, ops=ops,
        ms=cuda_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), reps),
        device_ms=device_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), reps),
        plain_ms=cuda_ms(lambda: sweep_collide.swept_collide_plain(car, live4, edges, emask), 3),
        source="hope_tpu_torch/csrc/sweep_collide.cu",
        replaces="hope_tpu/ops/sweep_collide.py:76",
        data=sweep_data(live4, emask, seg_hit))


def phase_kernels(dev):
    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

    mask_in, raster_in, sweep_in = kernel_inputs(dev)
    out = measure_kernels("kernel", mask_in, raster_in, sweep_in)
    ext, table, n_iter, up = mask_in
    render = raster_bev.render_bev_batch

    # the three kernels alone at a training batch: B = 1024, the same scenes
    # tiled four times; exactness against the B = 256 plain results
    ext4 = tile4(ext)
    big = tuple(tile4(t) for t in sweep_in)
    raster4 = tuple(tile4(t) for t in raster_in[:6]) + raster_in[6:]
    runs = {"mask_step_lengths": (lambda: mask_steps.mask_step_lengths(ext4, table, n_iter, up),
                                  tile4(out["mask_step_lengths"]["plain_out"])),
            "raster_bev": (lambda: render(*raster4), tile4(out["raster_bev"]["plain_out"])),
            "swept_collide": (lambda: sweep_collide.swept_collide(*big),
                              tile4(out["swept_collide"]["plain_out"]))}
    for name, (fn, want) in runs.items():
        mism = int((fn() != want).sum())
        emit({"phase": "kernel_b1024", "name": name, "B": 4 * EPISODES, "mismatches": mism,
              "ms": cuda_ms(fn, 50), "device_ms": device_ms(fn, 50)})
        if mism:
            raise AssertionError(f"{name} at B = {4 * EPISODES}: {mism} mismatches")
    return out, mask_in, sweep_in


def phase_parity(dev):
    """A few steps of the whole env on the card vs on the CPU."""
    import torch

    from hope_tpu_torch.config import EnvConfig
    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.envs.dlp import DLPDataset

    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    B = 8
    ds = DLPDataset(env_cfg=cfg, device="cpu")
    gen = torch.Generator().manual_seed(2)
    scenes = ds.batch_reset(torch.arange(B) * 31, gen)
    acts = torch.rand((6, B, 2), generator=gen) * 2 - 1
    envs = {d: ParkingEnv(cfg, device=d) for d in ("cpu", dev)}
    runs = {}
    for d, env in envs.items():
        st, obs = env.batch_reset(scenes.map(lambda t: t.to(d)))
        rec = []
        for a in acts:
            st, obs, r, done, info = env.batch_step(st, env.rescale_action(a.to(d)))
            rec.append({"reward": r, "status": info["status"], "rs_found": info["rs"].found,
                        **obs})
        runs[d] = [{k: v.cpu() for k, v in s.items()} for s in rec]
    worst = {}
    for a, b in zip(runs["cpu"], runs[dev]):
        for k in a:
            if k in ("status", "rs_found"):
                worst[k] = max(worst.get(k, 0), int((a[k] != b[k]).sum()))
            elif k == "img":
                worst[k] = max(worst.get(k, 0), float((a[k] != b[k]).any(1).float().mean()))
            else:
                worst[k] = max(worst.get(k, 0.0), float((a[k] - b[k]).abs().max()))
        if not all(torch.isfinite(v).all() for k, v in b.items() if v.is_floating_point()):
            raise AssertionError("non-finite values in the card's env step")
    emit({"phase": "parity", "steps": len(acts), "B": B, "worst": worst})
    # float32 transcendentals differ in the last place between the card and
    # the CPU; discrete outputs and the image must agree
    if worst["status"] or worst["rs_found"] or worst["img"] > 0.002:
        raise AssertionError(f"card and CPU env disagree: {worst}")
    for k in ("lidar", "target", "reward"):
        if worst[k] > 1e-3:
            raise AssertionError(f"card and CPU env disagree on {k}: {worst[k]}")


def phase_battery(dev, kernels):
    """The 4-level battery of the r3b actor, level by level in the CLI's
    order (each level draws from its own generator, so running them one at a
    time gives the battery's numbers); launch counts per level and for the
    whole battery."""
    import torch

    from hope_tpu_torch.evaluation.eval_mix_scene import LEVELS, build, run_battery

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env, agent, state = build(os.path.join(ROOT, "hope_tpu_torch", "assets",
                                           "sac_r3b_actor.npz"), dev)
    total = dict.fromkeys(kernels, 0)
    success = {}
    for level in LEVELS:
        for r in kernels.values():
            r["mod"].KERNEL.launches = 0
        res = run_battery(env, agent, state, episodes=EPISODES, max_steps=MAX_STEPS,
                          out=os.path.join(OUT_DIR, f"eval_{level}"), seed=0,
                          levels=[level])[level]
        launches = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
        wall = res["rollout_seconds"]        # the rollout alone, set-up excluded
        emit({"phase": "battery", "level": level, "episodes": EPISODES,
              "max_steps": MAX_STEPS, "success_rate": res["success_rate"],
              "per_level": res["per_level"], "success_steps_mean": res["success_steps_mean"],
              "rollout_seconds": wall, "env_steps_per_s": EPISODES * MAX_STEPS / wall,
              "launches": launches})
        success[level] = res["success_rate"]
        for name, n in launches.items():
            total[name] += n
            if n <= 0:
                raise AssertionError(f"{name}: no launch on the {level} battery's path")
    for name, n in total.items():
        kernels[name]["launches_battery"] = n
    low = {lv: v for lv, v in success.items() if v < MIN_SUCCESS}
    if low:
        raise AssertionError(f"battery success below {MIN_SUCCESS}: {low}")
    return env, agent, state


def kernel_sites() -> dict:
    """{kernel name: (module, attribute, plain version)}: where the env's
    path calls each kernel's wrapper, and the wrapper's plain version."""
    from hope_tpu_torch.envs import action_mask, env as env_mod
    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide
    from hope_tpu_torch.planning import rs_select

    return {"mask_step_lengths": (action_mask, "mask_step_lengths",
                                  mask_steps.mask_step_lengths_plain),
            "raster_bev": (env_mod, "render_bev_batch", raster_plain(raster_bev)),
            "swept_collide": (rs_select, "swept_collide", sweep_collide.swept_collide_plain)}


def record_kernel_inputs(run, at):
    """Run ``run()`` with the call sites of the kernels named in ``at``
    recorded: returns {kernel name: inputs of its ``at``-th call (from 0)}."""
    sites = {name: site[:2] for name, site in kernel_sites().items() if name in at}
    kept, inner = {}, {}
    for name, (mod, attr) in sites.items():
        inner[name] = getattr(mod, attr)

        def rec(*args, _name=name, _n=[0]):
            if _n[0] == at[_name]:
                kept[_name] = tuple(a.clone() if hasattr(a, "clone") else a for a in args)
            _n[0] += 1
            return inner[_name](*args)

        setattr(mod, attr, rec)
    try:
        run()
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, inner[name])
    if set(kept) != set(sites):
        raise AssertionError(f"recorded {sorted(kept)} of {sorted(sites)}")
    return kept


@contextlib.contextmanager
def hold_kernel_calls(every: int):
    """Within the block, the kernels' call sites on the env's path
    (:func:`kernel_sites`) held to their plain versions: at each batch size,
    calls 0, ``every``, 2 ``every``, ... are run through the plain version
    too, on the same inputs, and compared. Yields {name: {"batch": batch
    sizes called (B > 0), "calls", "held", "mismatches", "max_abs_err"}},
    filled as the block runs; the plain runs launch no kernel, so launch
    counts stay the path's."""
    sites = kernel_sites()
    held = {name: {"batch": [], "calls": 0, "held": 0, "mismatches": 0, "max_abs_err": 0.0}
            for name in sites}
    inner = {}
    for name, (mod, attr, plain) in sites.items():
        inner[name] = getattr(mod, attr)

        def hold(*args, _name=name, _plain=plain, _n={}, **kw):
            out = inner[_name](*args, **kw)
            h, B = held[_name], int(args[0].shape[0])
            h["calls"] += 1
            if B:
                h["batch"] = sorted(set(h["batch"]) | {B})
                n = _n.get(B, 0)
                _n[B] = n + 1
                if n % every == 0:
                    p = _plain(*args, **kw)
                    h["held"] += 1
                    h["mismatches"] += int((out != p).sum())
                    h["max_abs_err"] = max(h["max_abs_err"],
                                           float((out.float() - p.float()).abs().max()))
            return out

        setattr(mod, attr, hold)
    try:
        yield held
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, inner[name])


def phase_kernel_procedural(dev, env, agent, state):
    """The three kernels on a procedural bank's inputs: B = 256 scenes (86
    Normal, 85 Complex, 85 Extrem from generate_bank; 72 edge slots padded to
    512), recorded in the battery runner's first steps (the mask and the
    raster at their third call, the sweep at its second: after two control
    steps), held to the plain versions and timed beside the DLP rows."""
    import torch

    from hope_tpu_torch.envs.scenario_gen import generate_bank
    from hope_tpu_torch.evaluation.evaluate import build_episode_runner
    from hope_tpu_torch.train.scene_pool import concat_scenes, pad_scene_batch

    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    parts = [generate_bank(gen, level=lv, n=n)[0] for lv, n in
             (("Normal", 86), ("Complex", 85), ("Extrem", 85))]
    scenes = pad_scene_batch(concat_scenes(parts), env.cfg.max_edges, env.cfg.max_obstacles)
    run = build_episode_runner(env, lambda obs, g: agent.get_action(state, obs, g), 3)
    kept = record_kernel_inputs(lambda: run(scenes, gen),
                                {"mask_step_lengths": 2, "raster_bev": 2, "swept_collide": 1})
    live = scenes.edge_mask.sum(1)
    out = measure_kernels("kernel_procedural", kept["mask_step_lengths"], kept["raster_bev"],
                          kept["swept_collide"])
    emit({"phase": "kernel_procedural_data", "B": int(live.numel()),
          "edge_slots": int(scenes.edges.shape[1]),
          "live_edges_mean": float(live.float().mean()), "live_edges_max": int(live.max())})
    return out


def phase_profile(dev, env, agent, state, steps: int = 8):
    """torch.profiler over ``steps`` battery steps of the battery's own env
    and actor (after a warm-up run of the same length)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.envs.dlp import DLPDataset
    from hope_tpu_torch.evaluation.evaluate import build_episode_runner

    ds = DLPDataset(env_cfg=env.cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    scenes = ds.batch_reset(torch.arange(EPISODES) % ds.n_cases, gen)
    run = build_episode_runner(env, lambda obs, g: agent.get_action(state, obs, g), steps)
    run(scenes, gen)                                      # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(scenes, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_work(prof.events())
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    prof.export_chrome_trace(os.path.join(OUT_DIR, "battery_trace.json"))
    emit({"phase": "profile", "B": EPISODES, "steps": steps,
          "wall_ms_per_step": wall_ms / steps,
          "device_busy_ms_per_step": busy_ms / steps if kern else "not measured",
          "device_busy_share": busy_ms / wall_ms if kern else "not measured",
          "kernel_launches_per_step": len(kern) / steps,
          "htod_copies_per_step": sum("HtoD" in e.name for e in kern) / steps,
          "top_device_ms_per_step": [[name[:80], n / steps, t / steps]
                                     for name, (n, t) in top]})


def differing_values(got, want) -> int:
    """Values of two trees of tensors that differ bit for bit."""
    import torch

    from hope_tpu_torch.utils.tree import tree_leaves

    n = 0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        n += int((g != w).sum())
    return n


def timed_stages(env) -> dict:
    """Wrap ``env``'s transition and RS search (instance attributes over the
    methods) with host clocks: returns {span: [seconds, calls]}, filled as
    the env steps."""
    acc = {}
    for span, attr in (("env/transition", "_transition"), ("env/rs_search", "_batch_rs")):
        fn = getattr(env, attr)
        acc[span] = [0.0, 0]

        def timed(*args, _fn=fn, _a=acc[span], **kw):
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            _a[0] += time.perf_counter() - t0
            _a[1] += 1
            return out

        setattr(env, attr, timed)
    return acc


def phase_graph_step(dev, env, agent, state, episodes: int = 1024, steps: int = MAX_STEPS,
                     profiled: int = 8):
    """The env step's CUDA graphs on the r3b actor's DLP battery at
    ``episodes`` rows: (1) the graphed chains run eagerly under
    ``torch.cuda.set_sync_debug_mode("error")`` (no op synchronizes with the
    host, so each can be captured); (2) the first graphed call of each stage
    (warm-up, capture, first replay), synchronized, and the ops of a whole
    graphed step that synchronize (debug mode "warn"); (3) ``steps`` steps in
    lockstep, the graphed and the eager env on the same state and action, the
    runner's freeze of finished rows: differing values (must be 0), the
    previous step's outputs unchanged, one launch of each kernel a graphed
    step; (4) the battery runner on each env, graphed, eager, graphed, eager:
    host ms a step of ``env/transition`` and ``env/rs_search`` (host clocks
    around the calls) and wall ms a step; (5) ``profiled`` runner steps of
    each under torch.profiler: device activities, HtoD copies and busy ms a
    step. The eager env is the tree's code with the tables hoisted and no
    graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.envs.dlp import DLPDataset
    from hope_tpu_torch.envs.env import select
    from hope_tpu_torch.evaluation.evaluate import build_episode_runner
    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide
    from hope_tpu_torch.utils.graphs import ungraphed
    from hope_tpu_torch.utils.tree import tree_leaves

    graphed = ParkingEnv(env.cfg, dev)
    eager = ungraphed(graphed)
    ds = DLPDataset(env_cfg=graphed.cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    scenes = ds.batch_reset(torch.arange(episodes) % ds.n_cases, gen)

    def act(obs, g):
        return agent.get_action(state, obs, g)

    st0, obs0 = graphed.batch_reset(scenes)
    a = graphed.rescale_action(act(obs0, gen)[0])
    eager.batch_step(st0, a)             # the tables' one copy to the card
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = eager._transition(st0, a)[0]
        eager._batch_rs(nxt)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()

    capture_s = {}
    t0 = time.perf_counter()
    nxt = graphed._transition(st0, a)[0]
    torch.cuda.synchronize()
    capture_s["transition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphed._batch_rs(nxt)
    torch.cuda.synchronize()
    capture_s["rs_search"] = time.perf_counter() - t0

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            graphed.batch_step(st0, a)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    step_syncs = [str(w.message)[:160] for w in caught
                  if "synchronizing" in str(w.message).lower()]

    kernels = (mask_steps.KERNEL, raster_bev.KERNEL, sweep_collide.KERNEL)
    st, obs = st0, obs0
    finished = torch.zeros(episodes, dtype=torch.bool, device=dev)
    differ = aliased = bad_launch = found = 0
    prev = snap = None
    for _ in range(steps):
        a = graphed.rescale_action(act(obs, gen)[0])
        before = [k.launches for k in kernels]
        out = graphed.batch_step(st, a)
        bad_launch += [k.launches - n for k, n in zip(kernels, before)] != [1, 1, 1]
        differ += differing_values(out, eager.batch_step(st, a))
        if prev is not None:
            aliased += differing_values(prev, snap)
        prev, snap = out, [x.clone() for x in tree_leaves(out)]
        new_st, new_obs, _, done, info = out
        found += int(info["rs"].found.sum())
        finished = finished | done
        st, obs = select(finished, st, new_st), select(finished, obs, new_obs)
    del prev, snap

    runs = []
    for label, e in (("graphed", graphed), ("eager", eager)) * 2:
        acc = timed_stages(e)
        run = build_episode_runner(e, act, steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(scenes, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del e._transition, e._batch_rs
        runs.append({"env": label, "wall_ms_per_step": wall * 1e3 / steps,
                     **{f"host_ms_per_step {k}": v[0] * 1e3 / v[1] for k, v in acc.items()}})

    prof_by = {}
    for label, e in (("graphed", graphed), ("eager", eager)):
        run = build_episode_runner(e, act, profiled)
        run(scenes, gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(scenes, gen)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kern = device_work(prof.events())
        prof_by[label] = {
            "wall_ms_per_step": wall * 1e3 / profiled,
            "device_activities_per_step": len(kern) / profiled,
            "htod_copies_per_step": sum("HtoD" in k.name for k in kern) / profiled,
            "device_busy_ms_per_step": (sum(k.time_range.elapsed_us() for k in kern)
                                        / 1e3 / profiled) if kern else "not measured"}
    rec = {"phase": "graph_step", "B": episodes, "steps": steps,
           "differing_values": differ, "aliased_values": aliased,
           "steps_without_one_launch_each": bad_launch, "rs_found": found,
           "capture_s": capture_s, "syncs_in_a_graphed_step": step_syncs,
           "graphs": {"transition": len(graphed._transition_graphs._graphs),
                      "rs_prepare": len(graphed._rs_graphs._graphs)},
           "runs": runs, "profiled": prof_by,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(dev)}
    emit(rec)
    if differ or aliased or bad_launch or not found:
        raise AssertionError(f"graph_step: {differ} values differ, {aliased} aliased, "
                             f"{bad_launch} steps off one launch a kernel, {found} RS found")


def phase_real_steps(dev, env, agent, state, at=(1, 10, 50, 150)):
    """swept_collide on what the battery's rollout really gives it. The
    rollout is run again from the battery's seed (same scenes, same draws)
    with the call in ``planning.rs_select`` recorded at the control steps
    ``at`` (counted from 0). Returns {step: inputs}."""
    import torch

    from hope_tpu_torch.envs.dlp import DLPDataset
    from hope_tpu_torch.evaluation.evaluate import build_episode_runner
    from hope_tpu_torch.ops import sweep_collide
    from hope_tpu_torch.planning import rs_select

    kept, calls = {}, [0]
    inner = rs_select.swept_collide

    def record(*args):
        if calls[0] in at:
            kept[calls[0]] = tuple(t.clone() for t in args)
        calls[0] += 1
        return inner(*args)

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)                                    # run_battery's, seed 0
    ds = DLPDataset(env_cfg=env.cfg, device=dev)
    scenes = ds.batch_reset(torch.arange(EPISODES) % ds.n_cases, gen)
    run = build_episode_runner(env, lambda obs, g: agent.get_action(state, obs, g),
                               max(at) + 1)
    rs_select.swept_collide = record
    try:
        run(scenes, gen)
    finally:
        rs_select.swept_collide = inner
    if sorted(kept) != sorted(at):
        raise AssertionError(f"recorded sweeps at steps {sorted(kept)}, wanted {sorted(at)}")
    for step, inp in kept.items():
        got = sweep_collide.swept_collide(*inp)
        seg_hit = sweep_collide.swept_collide_plain(*inp, per_segment=True)
        mism = int((got != seg_hit.any(-1)).sum())
        fn = lambda inp=inp: sweep_collide.swept_collide(*inp)  # noqa: E731
        bound_ms, bound_by = bound(*sweep_work(inp[1], inp[2], inp[3], seg_hit))
        emit({"phase": "kernel_real_step", "name": "swept_collide", "step": step,
              "mismatches": mism, "ms": cuda_ms(fn, 50), "device_ms": device_ms(fn, 50),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "data": sweep_data(inp[1], inp[3], seg_hit)})
        if mism:
            raise AssertionError(f"swept_collide, battery step {step}: {mism} mismatches")
    return kept


def phase_probe(mask_in, sweep_sets, reps: int = 50):
    """The sweep on subsets of its words, for each of ``sweep_sets`` ({label:
    inputs}); the mask kernel at small batches."""
    import torch

    from hope_tpu_torch.ops import mask_steps, sweep_collide

    def timed(kind, what, fn, want, **extra):
        mism = int((fn() != want).sum())
        emit({"phase": "probe", "name": kind, "what": what, "mismatches": mism,
              "ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps), **extra})
        if mism:
            raise AssertionError(f"{kind} {what}: {mism} mismatches against the plain version")

    for label, (car, live, edges, emask) in sweep_sets.items():
        plain = sweep_collide.swept_collide_plain(car, live, edges, emask)

        def subset(sel):
            b, k = torch.nonzero(sel, as_tuple=True)
            return (car[b, k][:, None].contiguous(), live[b, k][:, None].contiguous(),
                    edges[b].contiguous(), emask[b].contiguous()), plain[b, k][:, None]

        cases = {"colliding": subset(plain), "clear": subset(~plain),
                 "one_word_per_env": ((car[:, :1].contiguous(), live[:, :1].contiguous(),
                                       edges, emask), plain[:, :1])}
        for what, (inp, want) in cases.items():
            if want.numel():
                timed("swept_collide", f"{label}: {what}",
                      lambda inp=inp: sweep_collide.swept_collide(*inp), want,
                      words=want.numel())

    ext, table, n_iter, up = mask_in
    want = mask_steps.mask_step_lengths_plain(ext, table, n_iter, up)
    for b in (8, 64):
        x = ext[:b].contiguous()
        timed("mask_step_lengths", f"B{b}",
              lambda x=x: mask_steps.mask_step_lengths(x, table, n_iter, up), want[:b])


# The training slice at the JAX CLI's default width (train_sac.py:main):
# B = 256 envs, K = 16 steps a chunk, U = 64 updates a chunk, sgd batch 256,
# a 100 000-transition ring, 256 scenes a level, 3 warm-up chunks.
TRAIN_B, TRAIN_K, TRAIN_U, TRAIN_MEMORY, TRAIN_CHUNKS, TRAIN_WARMUP = 256, 16, 64, 100_000, 6, 3


def _fingerprint(st):
    """A copy of every trained tensor of a SACState, by group."""
    import torch

    nets = {n: torch.cat([p.detach().flatten() for p in getattr(st, n).parameters()]).clone()
            for n in ("actor", "critic1", "critic2", "target1", "target2")}
    return {**nets, "log_std": st.log_std.detach().clone(),
            "log_alpha": st.log_alpha.detach().clone().reshape(1)}


def scratch_dir(name: str) -> str:
    """A fresh directory for one phase's logs and checkpoints, under build/
    (git-ignored, not brought back: a full training checkpoint holds the
    replay ring, 2.6 GB at the defaults). The phase deletes it."""
    d = os.path.join(ROOT, "build", "chip_smoke", name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def phase_train(dev, kernels):
    """hope_tpu_torch.train.train_sac.main at the defaults for 6 chunks (3
    warm-up, 3 with updates): per chunk its wall time, env-steps/s, updates/s,
    losses, alpha, replay size, episodes ended and kernel launches; then the
    peak device memory. Fails on a non-finite loss, on a group of parameters
    an update chunk left unchanged, on a replay size other than
    min(chunks * K * B, memory), or on a kernel launched other than K times a
    chunk (K + 1 for the mask and the raster in chunk 1, whose count includes
    the first reset's observation)."""
    import torch

    from hope_tpu_torch.train import train_sac

    log_dir = scratch_dir("train")
    for r in kernels.values():
        r["mod"].KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    seen = {name: 0 for name in kernels}
    prev = {}
    recs = []

    def on_chunk(record, loop):
        st, n = loop["state"], record["chunk"]
        now = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
        launches = {name: now[name] - seen[name] for name in kernels}
        seen.update(now)
        fp = _fingerprint(st)
        moved = ({g: float((fp[g] - prev[g]).abs().max()) for g in fp} if prev else None)
        prev.update(fp)
        m = {k: float(v) for k, v in loop["metrics"].items()}
        rec = {"phase": "train_chunk", **record,
               "env_steps_per_s": record["steps"] / record["seconds"],
               "updates_per_s_of_chunk": record["updates"] / record["seconds"],
               "replay_size": loop["replay"].size, "launches": launches,
               "param_max_change": moved, **m}
        emit(rec)
        recs.append(rec)
        want_size = min(n * TRAIN_K * TRAIN_B, TRAIN_MEMORY)
        if loop["replay"].size != want_size:
            raise AssertionError(f"chunk {n}: replay size {loop['replay'].size} != {want_size}")
        for name, c in launches.items():
            want = TRAIN_K + (1 if n == 1 and name != "swept_collide" else 0)
            if c != want:
                raise AssertionError(f"chunk {n}: {name} launched {c} times, want {want}")
        if not record["warmup"]:
            bad = [k for k, v in m.items() if not math.isfinite(v)]
            still = [g for g, v in (moved or {}).items() if v == 0.0]
            if bad or still or moved is None:
                raise AssertionError(f"chunk {n}: non-finite {bad}, unchanged {still}")

    t0 = time.perf_counter()
    res = train_sac.main(["--max-chunks", str(TRAIN_CHUNKS), "--no-tensorboard",
                          "--log-dir", log_dir, "--log-every", "1", "--seed", "0"],
                         on_chunk=on_chunk)
    wall = time.perf_counter() - t0
    # the agent checkpoint (tens of MB) and the full loop checkpoint (the
    # replay ring, GBs) that main writes at exit: sized, then dropped
    ckpt_bytes = os.path.getsize(os.path.join(log_dir, "ckpt", f"step_{TRAIN_CHUNKS}",
                                              "state.pt"))
    (full,) = res["loop"]["full_saves"]
    shutil.rmtree(log_dir)
    total = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    for name, n in total.items():
        kernels[name]["launches"] = n
    warm = [r["seconds"] for r in recs if r["warmup"]][1:]          # chunk 1 builds caches
    upd = [r for r in recs if not r["warmup"]]
    collect_s = sum(warm) / len(warm)
    emit({"phase": "train", "B": TRAIN_B, "K": TRAIN_K, "U": TRAIN_U, "chunks": len(recs),
          "main_seconds": wall, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "checkpoint_bytes": ckpt_bytes, "full_save_bytes": full["bytes"],
          "full_save_seconds": full["seconds"],
          "launches": total,
          "env_steps_per_s_warmup_chunks": TRAIN_B * TRAIN_K / collect_s,
          "env_steps_per_s_update_chunks": TRAIN_B * TRAIN_K * len(upd)
          / sum(r["seconds"] for r in upd),
          # an update chunk's wall less a warm-up chunk's (collect only)
          "sgd_updates_per_s_est": TRAIN_U * len(upd)
          / sum(r["seconds"] - collect_s for r in upd)})
    if len(recs) != TRAIN_CHUNKS or len(upd) != TRAIN_CHUNKS - TRAIN_WARMUP:
        raise AssertionError(f"train ran {len(recs)} chunks, {len(upd)} with updates")
    return res["loop"]


def phase_profile_train(loop):
    """torch.profiler over one more update chunk of the train phase's loop:
    device busy share, device activities and HtoD copies per collect step,
    the split of host and device time between collect and update, and the top
    device ops (trace to chiprun_out/train_trace.json.gz)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        record = loop["run_chunk"]()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if record["warmup"]:
        raise AssertionError("profile_train: the profiled chunk has no updates")
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    kern = device_work(events)
    kern_ids = {id(e) for e in kern}
    annot = [e for e in events if e.device_type == cuda and id(e) not in kern_ids]
    by_name = {}
    for e in kern:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(t for _, t in by_name.values())
    split = {}
    for part in ("collect", "update"):
        name = f"sac_chunk/{part}"
        spans = [(a.time_range.start, a.time_range.end) for a in annot if a.name == name]
        inside = [e for e in kern if any(a <= e.time_range.start <= b for a, b in spans)]
        host = [e for e in events if e.name == name and e.device_type != cuda]
        split[part] = {
            "host_ms": sum(e.time_range.elapsed_us() for e in host) / 1e3,
            "device_span_ms": sum(b - a for a, b in spans) / 1e3,
            "device_busy_ms": sum(e.time_range.elapsed_us() for e in inside) / 1e3,
            "device_activities": len(inside),
            "htod_copies": sum("HtoD" in e.name for e in inside)}
    # ~10^5 events: kept gzipped, or the output directory outgrows what comes back
    raw = os.path.join(OUT_DIR, "train_trace.json")
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(raw)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    col, upd = split["collect"], split["update"]
    emit({"phase": "profile_train", "B": TRAIN_B, "K": TRAIN_K, "U": TRAIN_U,
          "wall_ms": wall_ms, "device_busy_ms": busy_ms if kern else "not measured",
          "device_busy_share": busy_ms / wall_ms if kern else "not measured",
          "split": split,
          "device_activities_per_collect_step": col["device_activities"] / TRAIN_K,
          "htod_copies_per_collect_step": col["htod_copies"] / TRAIN_K,
          "device_activities_per_update": upd["device_activities"] / TRAIN_U,
          "device_busy_ms_per_update": upd["device_busy_ms"] / TRAIN_U,
          "htod_copies_chunk": sum("HtoD" in e.name for e in kern),
          "top_device_ms": [[name[:80], n, t] for name, (n, t) in top]})


# one SAC update at full width, card vs CPU: the same fresh state (seed 0),
# the same batch and noise. With fresh Adams a step moves each parameter by
# lr * g / (|g| + eps), less than lr, so the two devices' parameters differ by
# under 2 lr wherever their gradients differ at all (a gradient at rounding
# level can flip sign); 1e-6 more covers float32 rounding of parameters up to
# ~8. Gradients differ only by the rounding of reductions (matmul, conv and
# sums over the batch in other orders): ~1e-6 of the group's largest
# gradient; held to 1e-3 of it. Losses of the same forward pass (critic loss,
# entropy): 1e-4 relative; the actor loss uses critics already stepped, which
# differ by up to 2 lr: 1e-3 relative (or 1e-5 absolute near 0).
PARITY_GRAD_REL = 1e-3


def phase_train_parity(dev, loop):
    import torch

    from hope_tpu_torch.agents import SACAgent, replay
    from hope_tpu_torch.models import MultiObsEmbedding

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_agent = loop["agent"]
    g = torch.Generator().manual_seed(5)
    ring = loop["replay"]
    idx = torch.randint(0, ring.size, (train_agent.cfg.batch_size,), generator=g)
    batch = {k: v.cpu() for k, v in replay.sample(ring, len(idx), idx=idx.to(dev)).items()}
    noise = [torch.randn((len(idx), 2), generator=g) for _ in range(2)]
    shape = loop["env"].observation_shape
    runs = {}
    for d in ("cpu", dev):
        agent = SACAgent(MultiObsEmbedding(train_agent.actor.cfg).to(d), train_agent.cfg,
                         train_agent.critic_cfg)
        st = agent.init(shape, torch.Generator().manual_seed(0))
        m = agent.update(st, {k: v.to(d) for k, v in batch.items()},
                         noise=[z.to(d) for z in noise])
        runs[d] = (st, {k: float(v) for k, v in m.items()})
    (cs, cm), (gs, gm) = runs["cpu"], runs[dev]
    lr = {"actor": train_agent.cfg.lr_actor, "log_std": train_agent.cfg.lr_actor,
          "critic1": train_agent.cfg.lr_critic, "critic2": train_agent.cfg.lr_critic,
          "target1": train_agent.cfg.lr_critic, "target2": train_agent.cfg.lr_critic,
          "log_alpha": train_agent.cfg.lr_alpha}
    cf, gf = _fingerprint(cs), _fingerprint(gs)
    params = {}
    for grp in cf:
        d = (gf[grp].cpu() - cf[grp]).abs()
        params[grp] = {"max_abs": float(d.max()),
                       "max_rel": float((d / cf[grp].abs().clamp(min=1e-12)).max()),
                       "bound": 2 * lr[grp] + 1e-6}
    def grad(st, grp):
        """The group's last gradients, flat on the CPU (0 for a parameter the
        loss does not reach, e.g. the image encoder's unused std head)."""
        ps = [getattr(st, grp)] if grp in ("log_std", "log_alpha") else \
            list(getattr(st, grp).parameters())
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .flatten().cpu() for p in ps])

    grads = {}
    for grp in ("actor", "log_std", "critic1", "critic2", "log_alpha"):
        gc, gg = grad(cs, grp), grad(gs, grp)
        grads[grp] = {"max_abs": float((gg - gc).abs().max()),
                      "rel_to_max": float((gg - gc).abs().max() / gc.abs().max())}
    metrics = {k: {"cpu": cm[k], "card": gm[k], "abs": abs(gm[k] - cm[k]),
                   "rel": abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)} for k in cm}
    emit({"phase": "train_parity", "batch": len(idx), "tf32": False, "params": params,
          "grads": grads, "metrics": metrics, "grad_rel_tol": PARITY_GRAD_REL})
    bad = [g for g, r in params.items() if r["max_abs"] > r["bound"]]
    bad += [f"grad {g}" for g, r in grads.items() if r["rel_to_max"] > PARITY_GRAD_REL]
    for k, r in metrics.items():
        if not (math.isfinite(r["cpu"]) and math.isfinite(r["card"])):
            bad.append(f"{k} not finite")
        tol = 1e-3 if k == "actor_loss" else 1e-4
        if r["rel"] > tol and r["abs"] > 1e-5:
            bad.append(k)
    if bad:
        raise AssertionError(f"train_parity: card and CPU disagree on {bad}")


# The PPO training path at the JAX CLI's defaults (train_ppo.py:main): B = 64
# envs, T = 128 steps a chunk, 10 epochs of 8192 // 32 = 256 minibatches.
# one chunk (cut from two to keep the script's time)
PPO_B, PPO_T, PPO_EPOCHS, PPO_MB, PPO_CHUNKS = 64, 128, 10, 32, 1


def phase_ppo_battery(dev, kernels):
    """The 4-level battery of the r5 PPO actor, level by level in the CLI's
    order, with launch counts per level."""
    import torch

    from hope_tpu_torch.evaluation.eval_mix_scene import LEVELS, build, run_battery

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env, agent, state = build(os.path.join(ROOT, "hope_tpu_torch", "assets",
                                           "ppo_r5_actor.npz"), dev, "ppo")
    total = dict.fromkeys(kernels, 0)
    success = {}
    for level in LEVELS:
        for r in kernels.values():
            r["mod"].KERNEL.launches = 0
        res = run_battery(env, agent, state, "ppo", episodes=EPISODES, max_steps=MAX_STEPS,
                          out=os.path.join(OUT_DIR, f"eval_ppo_{level}"), seed=0,
                          levels=[level])[level]
        launches = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
        wall = res["rollout_seconds"]
        emit({"phase": "ppo_battery", "level": level, "episodes": EPISODES,
              "max_steps": MAX_STEPS, "success_rate": res["success_rate"],
              "floor": PPO_FLOORS[level], "per_level": res["per_level"],
              "success_steps_mean": res["success_steps_mean"], "rollout_seconds": wall,
              "env_steps_per_s": EPISODES * MAX_STEPS / wall, "launches": launches})
        success[level] = res["success_rate"]
        for name, n in launches.items():
            total[name] += n
            if n <= 0:
                raise AssertionError(f"{name}: no launch on the {level} PPO battery's path")
    for name, n in total.items():
        kernels[name]["launches_ppo_battery"] = n
    low = {lv: v for lv, v in success.items() if v < PPO_FLOORS[lv]}
    if low:
        raise AssertionError(f"PPO battery success below its floors {PPO_FLOORS}: {low}")


def _ppo_fingerprint(st):
    """A copy of every trained tensor of a PPOState, by group."""
    import torch

    nets = {n: torch.cat([p.detach().flatten() for p in getattr(st, n).parameters()]).clone()
            for n in ("actor", "critic", "critic_target")}
    return {**nets, "log_std": st.log_std.detach().flatten().clone()}


def phase_ppo_train(dev, kernels):
    """hope_tpu_torch.train.train_ppo.main at the defaults for 1 chunk: per
    chunk its wall time split into the update (PPOAgent.update, timed here
    with the device synchronized at each end) and the rest (the collect, the
    reset queue's fill and the host's episode bookkeeping), env-steps/s of the
    collect, SGD steps/s of the update, losses,
    approx_kl, episodes, launches and the buffer's shape; then the peak
    device memory. Fails on a non-finite loss, a group of parameters a chunk
    left unchanged, a buffer of another shape than (T, B), or a kernel
    launched other than T times a chunk (T + 1 for the mask and the raster in
    chunk 1: the first reset's observation)."""
    import torch

    from hope_tpu_torch.agents import PPOAgent
    from hope_tpu_torch.train import train_ppo

    update_seconds = []
    plain_update = PPOAgent.update

    def timed_update(self, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = plain_update(self, *args, **kwargs)
        torch.cuda.synchronize()
        update_seconds.append(time.perf_counter() - t)
        return out

    log_dir = os.path.join(OUT_DIR, "ppo_train")
    for r in kernels.values():
        r["mod"].KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    seen = {name: 0 for name in kernels}
    prev = {}
    recs = []

    def on_chunk(record, loop):
        st, n = loop["state"], record["chunk"]
        now = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
        launches = {name: now[name] - seen[name] for name in kernels}
        seen.update(now)
        fp = _ppo_fingerprint(st)
        base = prev or initial
        moved = {g: float((fp[g] - base[g]).abs().max()) for g in fp}
        prev.update(fp)
        m = {k: float(v) for k, v in loop["metrics"].items()}
        shapes = {k: list(v.shape) for k, v in loop["buffer"].items()}
        upd = update_seconds[-1]
        rec = {"phase": "ppo_train_chunk", **record, "update_seconds": upd,
               "collect_seconds": record["seconds"] - upd,
               "env_steps_per_s_collect": record["steps"] / (record["seconds"] - upd),
               "sgd_steps_per_s": record["sgd_steps"] / upd,
               "launches": launches, "param_max_change": moved, "buffer_shapes": shapes, **m}
        emit(rec)
        recs.append(rec)
        for name, c in launches.items():
            want = PPO_T + (1 if n == 1 and name != "swept_collide" else 0)
            if c != want:
                raise AssertionError(f"PPO chunk {n}: {name} launched {c} times, want {want}")
        bad_shape = [k for k, v in shapes.items() if v[:2] != [PPO_T, PPO_B]]
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        still = [g for g, v in moved.items() if v == 0.0]
        if bad or still or bad_shape:
            raise AssertionError(f"PPO chunk {n}: non-finite {bad}, unchanged {still}, "
                                 f"buffer shapes {bad_shape}")

    # the fresh state's parameters, as main builds them (seed 0 on the CPU)
    from hope_tpu_torch.config import ObsConfig, PPOConfig, actor_net_config, critic_net_config

    obs_cfg = ObsConfig()
    fresh = PPOAgent(actor_net_config(obs_cfg), critic_net_config(obs_cfg), PPOConfig()).init(
        {"lidar": (120,), "action_mask": (42,), "img": (3, 64, 64), "target": (5,)},
        torch.Generator().manual_seed(0))
    initial = {k: v.to(dev) for k, v in _ppo_fingerprint(fresh).items()}

    t0 = time.perf_counter()
    PPOAgent.update = timed_update
    try:
        res = train_ppo.main(["--max-chunks", str(PPO_CHUNKS), "--no-tensorboard",
                              "--log-dir", log_dir, "--seed", "0"], on_chunk=on_chunk)
    finally:
        PPOAgent.update = plain_update
    wall = time.perf_counter() - t0
    ckpt = os.path.join(log_dir, "ckpt")
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, f"step_{PPO_CHUNKS}", "state.pt"))
    shutil.rmtree(ckpt)
    total = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    for name, n in total.items():
        kernels[name]["launches_ppo_train"] = n
    emit({"phase": "ppo_train", "B": PPO_B, "T": PPO_T, "epochs": PPO_EPOCHS,
          "minibatch": PPO_MB, "chunks": len(recs), "main_seconds": wall,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "checkpoint_bytes": ckpt_bytes, "launches": total,
          "collect_seconds": [r["collect_seconds"] for r in recs],
          "update_seconds": [r["update_seconds"] for r in recs],
          "sgd_steps_per_s": [r["sgd_steps_per_s"] for r in recs]})
    if len(recs) != PPO_CHUNKS or any(r["sgd_steps"] != PPO_EPOCHS * PPO_B * PPO_T // PPO_MB
                                      for r in recs):
        raise AssertionError(f"ppo_train ran {len(recs)} chunks of "
                             f"{[r['sgd_steps'] for r in recs]} SGD steps")
    return res["loop"]


# one PPO update (2 epochs of 16 minibatches of 32) at full width, card vs CPU:
# the same fresh state (seed 0), transitions and permutations. An Adam step
# moves a parameter by at most about lr, so the two runs differ by under
# 2 * steps * lr (+1e-6 of float32 rounding) where gradients at rounding level
# take other signs; elsewhere the steps differ by the gradients' reduction
# order (~1e-6 relative of a step of ~lr): held to 1e-6, with at most 1 entry
# in 10^4 looser. The last minibatch's gradients: 1e-3 of the group's largest
# (as train_parity). Metrics: 1e-3 relative or 1e-5 absolute; Adam counts and
# kl_stopped equal.
PPO_PARITY_N, PPO_PARITY_EPOCHS = 512, 2


def phase_ppo_parity(dev, loop):
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.agents.ppo import adam_count

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_agent = loop["agent"]
    buf = loop["buffer"]
    t = PPO_PARITY_N // buf["reward"].shape[1]
    batch = {k: v[:t].cpu() for k, v in buf.items()}            # the first 512, time-major
    agent = type(train_agent)(train_agent.actor_cfg, train_agent.critic_cfg,
                              dataclasses.replace(train_agent.cfg,
                                                  mini_epoch=PPO_PARITY_EPOCHS),
                              train_agent.mask_table)
    g = torch.Generator().manual_seed(6)
    perms = torch.stack([torch.randperm(PPO_PARITY_N, generator=g)
                         for _ in range(PPO_PARITY_EPOCHS)])
    shape = loop["env"].observation_shape
    runs = {}
    for d in ("cpu", dev):
        st = agent.init(shape, torch.Generator().manual_seed(0), d)
        m = agent.update(st, {k: v.to(d) for k, v in batch.items()}, perms=perms.to(d))
        runs[d] = (st, {k: float(v) for k, v in m.items()})
    (cs, cm), (gs, gm) = runs["cpu"], runs[dev]
    steps = adam_count(cs.opt_actor)
    cfg = agent.cfg
    lr = {"actor": cfg.lr_actor, "log_std": cfg.lr_actor, "critic": cfg.lr_critic,
          "critic_target": cfg.lr_critic}
    cf, gf = _ppo_fingerprint(cs), _ppo_fingerprint(gs)
    params = {}
    for grp in cf:
        d = (gf[grp].cpu() - cf[grp]).abs()
        params[grp] = {"max_abs": float(d.max()), "beyond_1e-6": int((d > 1e-6).sum()),
                       "entries": d.numel(), "bound": 2 * steps * lr[grp] + 1e-6}

    def grad(st, grp):
        ps = [st.log_std] if grp == "log_std" else list(getattr(st, grp).parameters())
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                          .flatten().cpu() for p in ps])

    grads = {}
    for grp in ("actor", "log_std", "critic"):
        g_cpu, g_card = grad(cs, grp), grad(gs, grp)
        d = float((g_card - g_cpu).abs().max())
        grads[grp] = {"max_abs": d, "rel_to_max": d / float(g_cpu.abs().max())}
    metrics = {k: {"cpu": cm[k], "card": gm[k], "abs": abs(gm[k] - cm[k]),
                   "rel": abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-30)} for k in cm}
    counts = {"cpu": [adam_count(cs.opt_actor), adam_count(cs.opt_critic)],
              "card": [adam_count(gs.opt_actor), adam_count(gs.opt_critic)]}

    # the card's update again under the profiler: device time per SGD step
    st = agent.init(shape, torch.Generator().manual_seed(0), dev)
    card_batch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.update(st, card_batch, perms=perms.to(dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = device_work(prof.events())
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    emit({"phase": "ppo_parity", "transitions": PPO_PARITY_N, "epochs": PPO_PARITY_EPOCHS,
          "sgd_steps": steps, "tf32": False, "params": params, "grads": grads,
          "metrics": metrics, "adam_counts": counts, "grad_rel_tol": PARITY_GRAD_REL,
          "profiled_update": {"wall_ms": wall_ms,
                              "device_busy_ms": busy_ms if kern else "not measured",
                              "device_busy_share": busy_ms / wall_ms if kern else "not measured",
                              "device_activities_per_sgd_step": len(kern) / steps,
                              "wall_ms_per_sgd_step": wall_ms / steps}})
    bad = [g for g, r in params.items()
           if r["max_abs"] > r["bound"] or r["beyond_1e-6"] > 1e-4 * r["entries"]]
    bad += [f"grad {g}" for g, r in grads.items() if r["rel_to_max"] > PARITY_GRAD_REL]
    for k, r in metrics.items():
        if not (math.isfinite(r["cpu"]) and math.isfinite(r["card"])):
            bad.append(f"{k} not finite")
        if r["rel"] > 1e-3 and r["abs"] > 1e-5:
            bad.append(k)
    if counts["cpu"] != counts["card"] or steps != PPO_PARITY_EPOCHS * PPO_PARITY_N // PPO_MB:
        bad.append(f"adam counts {counts}")
    if bad:
        raise AssertionError(f"ppo_parity: card and CPU disagree on {bad}")


# The pure-MPC path at the MPC CLI's settings (hope_tpu_torch/planning/mpc.py:
# main): B = 256 a level, H = 40, 12 iLQR iterations, replan every 8, 12 RS
# words, 6 staging words, --portfolio (a second run at replan 4, the union
# taken). Floors: the JAX package's results with the same configuration
# (DLP 1.000, Normal 0.992, Complex 0.980, Extrem 0.926 on a TPU) less about 3
# standard deviations of the difference of two independent 256-episode rates;
# the JAX runs had no collision on any level.
MPC_LEVELS = ("dlp", "Normal", "Complex", "Extrem")
MPC_FLOORS = {"dlp": 0.98, "Normal": 0.97, "Complex": 0.94, "Extrem": 0.85}
MPC_H, MPC_ITERS, MPC_REPLAN = 40, 12, 8


def _mpc_setup(dev, level: str, episodes: int = EPISODES, seed: int = 0):
    """(env, iLQR config, scenes) of the MPC CLI for one battery level."""
    import torch

    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.planning import mpc

    env_cfg = mpc.mpc_env_config(no_dlp=level != "dlp")
    env = ParkingEnv(env_cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scenes = mpc.battery_scenes(env_cfg, level, episodes, gen, dev)
    return env, mpc.mpc_ilqr_config(env_cfg, MPC_H, MPC_ITERS), scenes


def phase_mpc_kernel(dev):
    """swept_collide against swept_collide_plain on the inputs the MPC path
    gives it on 256 DLP scenes: the staging precompute's first polar chunk
    (K = 6 words) and first template chunk (templates as words), and the
    first replan's warm start (K = 12), recorded at the kernel's call sites."""
    import torch

    from hope_tpu_torch.ops import sweep_collide
    from hope_tpu_torch.planning import mpc, rs_select, staging

    env, icfg, scenes = _mpc_setup(dev, "dlp")
    kept = {}

    def recorder(mod, label):
        inner = mod.swept_collide

        def rec(*args):
            kept.setdefault(label(), tuple(a.clone() for a in args))
            return inner(*args)
        return inner, rec

    phase = ["staging polar"]
    sites = [(rs_select, lambda: phase[0]), (staging, lambda: "staging templates")]
    inners = []
    for mod, label in sites:
        inner, rec = recorder(mod, label)
        inners.append((mod, inner))
        mod.swept_collide = rec
    try:
        st = staging.compute_staging(env, scenes, max_tries=6)
        phase[0] = "warm start"
        mpc.build_mpc_runner(env, icfg, MPC_REPLAN, MPC_REPLAN)(scenes, st)
    finally:
        for mod, inner in inners:
            mod.swept_collide = inner
    out = {}
    for label, inp in kept.items():
        # the plain version's temporaries are (B, K, chunk, E): the polar
        # chunk's B is 256 x ~50 candidates, so it takes fewer car segments
        # at a time
        B, K, _, _ = inp[0].shape
        seg_chunk = max(1, min(64, int(1e8 // (B * K * inp[2].shape[1]))))
        plain = lambda *a, **kw: sweep_collide.swept_collide_plain(  # noqa: E731
            *a, chunk=seg_chunk, **kw)
        k = sweep_collide.swept_collide(*inp)
        seg_hit = plain(*inp, per_segment=True)
        p = seg_hit.any(-1)
        mism = int((k != p).sum())
        nbytes, ops = sweep_work(inp[1], inp[2], inp[3], seg_hit)
        bms, bby = bound(nbytes, ops)
        fn = lambda inp=inp: sweep_collide.swept_collide(*inp)  # noqa: E731
        rec = {"phase": "mpc_kernel", "name": "swept_collide", "what": label,
               "shape": list(inp[0].shape), "edge_slots": int(inp[2].shape[1]),
               "mismatches": mism, "max_abs_err": float((k.float() - p.float()).abs().max()),
               "ms": cuda_ms(fn, 20), "device_ms": device_ms(fn, 20),
               "plain_ms": cuda_ms(lambda inp=inp: plain(*inp), 2, 1),
               "plain_segments_per_chunk": seg_chunk,
               "bound_ms": bms, "bound_by": bby, "data": sweep_data(inp[1], inp[3], seg_hit)}
        emit(rec)
        out[label] = rec
        if mism:
            raise AssertionError(f"mpc_kernel {label}: {mism} mismatches against the plain version")
    if set(out) != {"staging polar", "staging templates", "warm start"}:
        raise AssertionError(f"mpc_kernel recorded {sorted(out)}")
    return out


def phase_mpc_battery(dev, kernels, extra_args=()):
    """hope_tpu_torch.planning.mpc.main, the CLI itself, on each level at its
    defaults with --portfolio (256 episodes, TF32 off). The script wraps the
    CLI's staging and runner calls to time them (device synchronized) and to
    count the kernels' launches in each; the rest of main's launches are the
    plan-latency measurement's. Fails on a level below its floor, on any
    collision, on a mask or raster launch (this path has neither), or on a
    level that never launched the iLQR kernel (the runner's solve)."""
    import torch

    from hope_tpu_torch.ops import ilqr_solve
    from hope_tpu_torch.planning import mpc, staging

    torch.backends.cuda.matmul.allow_tf32 = False
    plain_runner, plain_staging = mpc.build_mpc_runner, staging.compute_staging
    parts = []
    mods = {**{name: r["mod"] for name, r in kernels.items()}, "ilqr_solve": ilqr_solve}

    def counts():
        return {name: m.KERNEL.launches for name, m in mods.items()}

    def timed(label, fn, *args, **kw):
        torch.cuda.synchronize()
        before, t0 = counts(), time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        parts.append({"part": label, "seconds": time.perf_counter() - t0,
                      "launches": {k: v - before[k] for k, v in counts().items()}})
        return out

    def runner(env, icfg, replan_every, *a, **kw):
        run = plain_runner(env, icfg, replan_every, *a, **kw)
        return lambda *args: timed(f"battery replan {replan_every}", run, *args)

    total = dict.fromkeys(mods, 0)
    results = {}
    mpc.build_mpc_runner = runner
    staging.compute_staging = lambda *a, **kw: timed("staging", plain_staging, *a, **kw)
    try:
        for level in MPC_LEVELS:
            parts.clear()
            for m in mods.values():
                m.KERNEL.launches = 0
            argv = ["--portfolio", "--seed", "0", "--out", os.path.join(OUT_DIR, f"mpc_{level}")]
            argv += [] if level == "dlp" else ["--no-dlp", "--level", level]
            argv += list(extra_args)
            t0 = time.perf_counter()
            summary = mpc.main(argv)
            wall = time.perf_counter() - t0
            launches = counts()
            # DLP cases carry their map's level (Normal / Complex / Extrem)
            per = summary["per_level"].values()
            share = {k: sum(v["n"] * v[k] for v in per) / summary["n"] for k in
                     ("collided", "outbound", "outtime", "rs_latched", "way_latched",
                      "steps_mean")}
            rec = {"phase": "mpc_battery", "level": level, "episodes": summary["n"],
                   "success_rate": summary["success_rate"], "floor": MPC_FLOORS[level], **share,
                   "per_level": summary["per_level"],
                   "success_steps_mean": summary["success_steps_mean"],
                   "staging": summary["staging"], "parts": list(parts),
                   "episode_batch_seconds": summary["episode_batch_seconds"],
                   "main_seconds": wall, "plan_latency": summary["plan_latency"],
                   "launches": launches}
            emit(rec)
            results[level] = rec
            for name, n in launches.items():
                total[name] += n
    finally:
        mpc.build_mpc_runner, staging.compute_staging = plain_runner, plain_staging
    for name in kernels:
        kernels[name]["launches_mpc_battery"] = total[name]
    ILQR_LAUNCHES["mpc_battery"] = total["ilqr_solve"]
    bad = {lv: r["success_rate"] for lv, r in results.items() if r["success_rate"] < MPC_FLOORS[lv]}
    bad.update({f"{lv} collided": r["collided"] for lv, r in results.items() if r["collided"] > 0})
    bad.update({f"{lv} iLQR kernel launches": 0 for lv, r in results.items()
                if not r["launches"]["ilqr_solve"]})
    if total["mask_step_lengths"] or total["raster_bev"] or not total["swept_collide"]:
        bad["launches"] = total
    if bad:
        raise AssertionError(f"mpc_battery: {bad} (floors {MPC_FLOORS}, no collision)")
    return results


# card vs CPU: 8 Normal scenes at the MPC CLI's settings. The staging
# precompute on each device: valid sets equal, L within 1e-3 m (float32 sin /
# cos of two libraries). The first replan's iLQR problem: the RS warm start
# from the start poses on each device (found flags equal, controls within
# 1e-4), then on the CPU's warm start the cost within 1e-4 relative, and the
# derivatives the backward pass takes within the bounds tests/test_torch_mpc.py
# holds JAX and the port to (lx, lxx, Vx, Vxx within 2e-5 of each point's
# largest entry, fx and fu within 1e-4 + 1e-7 / dth^2 at a step turning by
# dth). On the card the iLQR kernel's first iteration is held to
# solve_batch's from the same warm start (kernel_vs_plain): its derivatives
# within the same bounds at its own rollout, the same line-search step on
# every row but at a float32 tie, and there the cost within 1e-4 relative
# (or the one-ulp witness's gap, where larger). Then 2 replans (16 control steps) of the runner on each device:
# discrete outcomes equal. The solve itself is not held card vs CPU: it is
# chaotic at these weights (on the CPU alone, moving the iterate by 1e-6
# changes the line search's candidate costs by up to ~100x within a few
# iterations).
MPC_PARITY_B, MPC_PARITY_STEPS = 8, 16
# phase ilqr_kernel: the least share of the 256 rows on which the kernel's
# step and solve_batch's agree, from each iterate of a solve, and the least
# share of rows on which solve_batch's step is well conditioned (those held)
ILQR_AGREE_FLOOR, ILQR_HELD_FLOOR = 0.9, 0.25


def _derivative_gaps(cpu, card, us, vcfg, dt):
    """Per quadraticize output: the largest card-vs-CPU gap over its bound
    (<= 1 passes)."""
    import torch

    names = ("lx", "lu", "lxx", "luu", "fx", "fu", "Vx", "Vxx")
    u = torch.stack([us[..., 0].clamp(-vcfg.max_steer, vcfg.max_steer),
                     us[..., 1].clamp(-vcfg.max_speed, vcfg.max_speed)], -1)
    dth = (u[..., 1] * torch.tan(u[..., 0]) / vcfg.wheel_base * dt).abs()
    out = {}
    for name, c, g in zip(names, cpu, card):
        d = (g.cpu() - c).abs()
        if name in ("fx", "fu"):
            tol = (1e-4 + 1e-7 / dth.clamp(min=1e-9) ** 2)[..., None, None]
        elif name in ("lu", "luu"):
            tol = 1e-6 * c.abs().max() + 1e-7
        else:
            k = 1 if name in ("lx", "Vx") else 2
            tol = 2e-5 * c.abs().amax(dim=tuple(range(c.ndim - k, c.ndim)), keepdim=True) + 1e-6
        out[name] = float((d / tol).max())
    return out


def phase_mpc_parity(dev):
    import torch

    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.planning import ilqr, mpc, staging

    torch.backends.cuda.matmul.allow_tf32 = False
    env_cfg = mpc.mpc_env_config(no_dlp=True)
    vcfg = env_cfg.vehicle
    icfg = mpc.mpc_ilqr_config(env_cfg, MPC_H, MPC_ITERS)
    gen = torch.Generator().manual_seed(17)
    scenes = mpc.battery_scenes(env_cfg, "Normal", MPC_PARITY_B, gen, "cpu")
    runs, first, found = {}, {}, {}
    for d in ("cpu", dev):
        env = ParkingEnv(env_cfg, device=d)
        sc = scenes.map(lambda t: t.to(d))
        st = staging.compute_staging(env, sc, max_tries=6)
        us, rs = mpc.rs_warm_start(env, sc.start, sc, MPC_H)
        goal = staging.pick_goal(st, sc.start, sc.dest)[0]
        first[d] = (sc.start, goal, sc.edges, sc.edge_mask,
                    torch.where(rs.found[:, None, None], us, 0.0))
        found[d] = rs.found.cpu()
        with torch.no_grad():
            m = mpc.build_mpc_runner(env, icfg, MPC_REPLAN, MPC_PARITY_STEPS)(sc, st)
        runs[d] = {"L": st.L.cpu(), **{k: v.cpu() for k, v in m.items()}}
    cpu_args = first["cpu"]
    warm_found = int((found["cpu"] != found[dev]).sum())
    warm_us = float((first[dev][4].cpu() - cpu_args[4]).abs().max())
    card_args = [a.to(dev) for a in cpu_args]
    # the warm start's rollout, cost and derivatives on both devices
    zero = icfg._replace(n_iters=0)
    start = {d: ilqr.solve_batch(*a, zero, vcfg) for d, a in (("cpu", cpu_args), (dev, card_args))}
    c0c, c0g = start["cpu"].cost, start[dev].cost.cpu()
    warm_cost_rel = float(((c0g - c0c).abs() / c0c.abs()).max())
    quad = {d: ilqr.quadraticize(start[d].xs, a[4], a[1], a[2], a[3], icfg, vcfg)
            for d, a in (("cpu", cpu_args), (dev, card_args))}
    gaps = _derivative_gaps(quad["cpu"], quad[dev], cpu_args[4], vcfg, icfg.dt)
    kernel = kernel_vs_plain(card_args, icfg, vcfg)
    c, g = runs["cpu"], runs[dev]
    valid = torch.isfinite(c["L"])
    rec = {"phase": "mpc_parity", "B": MPC_PARITY_B, "steps": MPC_PARITY_STEPS,
           "staging_valid_mismatches": int((valid != torch.isfinite(g["L"])).sum()),
           "staging_L_max_abs": float((c["L"][valid] - g["L"][valid]).abs().max()),
           "warm_start_found_mismatches": warm_found, "warm_start_us_max_abs": warm_us,
           "warm_start_cost_max_rel": warm_cost_rel, "derivative_gap_over_bound": gaps,
           "kernel_vs_plain": kernel,
           "path_length_max_abs": float((c["path_length"] - g["path_length"]).abs().max()),
           "discrete_mismatches": {k: int((c[k] != g[k]).sum()) for k in
                                   ("success", "steps", "status", "finished", "rs_latched",
                                    "way_latched")},
           "success": [int(c["success"].sum()), int(g["success"].sum())]}
    emit(rec)
    bad = [k for k, v in rec["discrete_mismatches"].items() if v]
    if rec["staging_valid_mismatches"] or rec["staging_L_max_abs"] > 1e-3:
        bad.append("staging")
    if warm_found or warm_us > 1e-4:
        bad.append("warm start controls")
    if warm_cost_rel > 1e-4:
        bad.append("warm start cost")
    bad += [f"derivative {k}" for k, v in gaps.items() if v > 1.0]
    bad += [f"kernel {k}" for k in kernel["bad"]]
    if bad:
        raise AssertionError(f"mpc_parity: card and CPU disagree on {bad}")


def _rows_where(rows, a, b):
    """A named tuple of tensors with leading dim B: ``b``'s rows where
    ``rows``, ``a``'s elsewhere."""
    import torch

    return type(a)(*(torch.where(rows.view(-1, *[1] * (x.ndim - 1)), y, x) for x, y in zip(a, b)))


def kernel_vs_plain(args, icfg, vcfg, step: int = 1, agree_floor: float = 0.0,
                    every_row: bool = True, held_floor: float = 0.0) -> dict:
    """The iLQR kernel's ``step``-th iteration (1 or 2) on the card against
    one iteration of solve_batch from the same controls: for the first, the
    warm start ``args``; for the second, the kernel's own iterate after its
    first step, with the regularization solve_batch's rule gives after that
    step (the kernel carries its nearest edges and its reg into the second
    step; solve_batch starts afresh from the controls).

    On every row the derivatives the kernel formed in that iteration are
    held to ``quadraticize`` at the kernel's own iterate (its rollout: a
    pose one ulp off moves the terminal gradient by 600 ulps) by
    ``_derivative_gaps``' bounds, and at least ``agree_floor`` of the rows
    must take solve_batch's line-search step.

    With ``every_row`` the step is held on every row: solve_batch's step
    but at a float32 tie (the two picks' candidate costs within 1e-5
    relative), and where it is, the cost within 1e-4 relative, poses and
    controls within 1e-2, and (first step) ``converged`` equal where the
    cost ratio lies more than 2e-4 from its 1e-3 threshold.

    Without it (deep in the clearance cost, where one ulp of x0 moves a
    single step's poses by metres) the step is held on the rows where
    solve_batch's is well conditioned: two witnesses, its same step from
    x0 moved one ulp up and one ulp down, take its pick and land within
    1e-5 relative in cost and 1e-3 in poses and controls; at least
    ``held_floor`` of the rows must be so. There a tie also covers two
    candidate costs that lie within the sum of their drifts under the
    witnesses, at most 1% of the rows may take another step off a tie (one
    ulp of x0 flips solve_batch's own pick on up to 1.6% of the rows; the
    kernel's float32 rounding differs in every operation), and the cost
    must lie within 1e-3 relative (the kernel read up to ~1e-4 on such
    rows, against 1e-2 to 1e-1 with its reg rule planted wrong). ``bad``
    names what fails, also a second step whose first differs from the
    first-step call's."""
    import numpy as np
    import torch

    from hope_tpu_torch.ops import ilqr_solve as kmod
    from hope_tpu_torch.planning import ilqr

    f32 = np.float32
    with torch.no_grad():
        # the kernel's iterate before the held step, then the held step
        xs0, prev, _, _, p0, _ = kmod.ilqr_solve(*args, icfg._replace(n_iters=step - 1), vcfg,
                                                 record=True)
        xs, us, cost, conv, picks, q = kmod.ilqr_solve(*args, icfg._replace(n_iters=step), vcfg,
                                                       record=True)
        regs, repeat = {icfg.reg_init: None}, True
        if step == 2:
            repeat = torch.equal(p0[:, 0], picks[:, 0])
            took = p0[:, 0] > 0
            regs = {float(max(f32(icfg.reg_init) * f32(0.7), f32(1e-6))): took,
                    float(f32(icfg.reg_init) * f32(4.0)): ~took}
        want = ilqr.quadraticize(xs0, prev, args[1], args[2], args[3], icfg, vcfg)
        up = lambda t: torch.nextafter(t, torch.full_like(t, torch.inf))  # noqa: E731
        down = lambda t: torch.nextafter(t, torch.full_like(t, -torch.inf))  # noqa: E731
        runs = None
        for reg, rows in regs.items():
            c = icfg._replace(n_iters=1, reg_init=reg)
            now = [ilqr.solve_batch(x, *args[1:4], prev, c, vcfg, history=True)
                   for x in (args[0], up(args[0]), down(args[0]))]
            runs = now if runs is None else [
                (_rows_where(rows, a[0], b[0]), _rows_where(rows, a[1], b[1]))
                for a, b in zip(runs, now)]
    (res, hist), witnesses = runs[0], runs[1:]
    got = tuple(q[k] if k in q else w for k, w in
                zip(("lx", "lu", "lxx", "luu", "fx", "fu", "Vx", "Vxx"), want))
    gaps = _derivative_gaps([w.cpu() for w in want], got, prev.cpu(), vcfg, icfg.dt)

    def near(r, h, cost_tol, pose_tol):
        """Rows where (r, h) took solve_batch's pick and landed within the
        tolerances of its step."""
        return ((h.pick[:, 0] == hist.pick[:, 0])
                & ((r.cost - res.cost).abs() <= cost_tol * res.cost.abs())
                & ((r.xs - res.xs).abs().amax((1, 2)) <= pose_tol)
                & ((r.us - res.us).abs().amax((1, 2)) <= pose_tol))

    held = torch.ones_like(res.converged)
    cand = hist.candidates[:, 0]
    p_got, p_want = picks[:, step - 1].long(), hist.pick[:, 0]
    c_got, c_want = cand.gather(1, p_got[:, None])[:, 0], cand.gather(1, p_want[:, None])[:, 0]
    tie = 1e-5 * c_want.abs()
    cost_bar, untied_allowed = 1e-4, 0
    if not every_row:
        drift = torch.zeros_like(cand)
        for r, h in witnesses:
            held &= near(r, h, 1e-5, 1e-3)
            drift = torch.maximum(drift, torch.nan_to_num((h.candidates[:, 0] - cand).abs(),
                                                          nan=0.0))
        tie = torch.maximum(tie, drift.gather(1, p_got[:, None])[:, 0]
                            + drift.gather(1, p_want[:, None])[:, 0])
        cost_bar, untied_allowed = 1e-3, int(0.01 * len(cand))
    differ = p_got != p_want
    untied = held & differ & ((c_got - c_want).abs() > tie)
    same = held & ~differ
    rel = ((cost - res.cost).abs() / res.cost.abs())[same]
    out = {"step": step, "rows": int(p_got.numel()), "derivative_gap_over_bound": gaps,
           "rows_held": int(held.sum()), "held_share": float(held.float().mean()),
           "pick_rows_differ": int(differ.sum()), "pick_rows_differ_untied": int(untied.sum()),
           "pick_rows_agree_share": float((~differ).float().mean()),
           "steps_taken": int((p_want > 0).sum()),
           "cost_max_rel": float(rel.max()) if rel.numel() else 0.0,
           "xs_max_abs": float((xs - res.xs).abs()[same].max()) if same.any() else 0.0,
           "us_max_abs": float((us - res.us).abs()[same].max()) if same.any() else 0.0,
           "witness_rows_off": [int((~near(r, h, 1e-5, 1e-3)).sum()) for r, h in witnesses],
           "untied_rows": untied.nonzero()[:, 0].tolist()[:8]}
    if step == 1:
        c0 = cand[:, 0]
        ratio = (c0 - res.cost) / c0.clamp(min=1e-9)
        clear = same & ((ratio - 1e-3).abs() > 2e-4)
        out["converged_rows_differ"] = int((clear & (conv != res.converged)).sum())
    out["bad"] = [f"derivative {k}" for k, v in gaps.items() if v > 1.0]
    if out["pick_rows_differ_untied"] > untied_allowed:
        out["bad"].append("line-search step")
    if out["cost_max_rel"] > cost_bar:
        out["bad"].append("cost")
    if out["xs_max_abs"] > 1e-2 or out["us_max_abs"] > 1e-2:
        out["bad"].append("poses or controls")
    if out.get("converged_rows_differ"):
        out["bad"].append("converged")
    if out["pick_rows_agree_share"] < agree_floor:
        out["bad"].append(f"agreeing rows below {agree_floor}")
    if out["held_share"] < held_floor:
        out["bad"].append(f"well-conditioned rows below {held_floor}")
    if not repeat:
        out["bad"].append("first step not repeated")
    return out


def kernel_along_the_solve(args, icfg, vcfg, agree_floor: float = 0.0,
                           held_floor: float = 0.0) -> dict:
    """``kernel_vs_plain`` at every iterate of a whole solve: from
    solve_batch's own iterate after k = 0 .. n_iters - 2 iterations (its
    controls as the warm start, the configuration's reg_init), the kernel's
    first and second steps, the step held on its well-conditioned rows.
    So every iteration's derivatives, picks and
    costs are held from an iterate both sides share, the second step from
    the nearest edges and reg the kernel carried. Returns {"steps": [...],
    "bad": [...]}."""
    import torch

    from hope_tpu_torch.planning import ilqr

    steps, bad = [], []
    for k in range(icfg.n_iters - 1):
        with torch.no_grad():
            us_k = ilqr.solve_batch(*args, icfg._replace(n_iters=k), vcfg).us if k else args[4]
        a = (*args[:4], us_k.contiguous())
        for step in (1, 2):
            r = kernel_vs_plain(a, icfg, vcfg, step, agree_floor, every_row=False,
                                held_floor=held_floor)
            steps.append({"from_iteration": k, **r})
            bad += [f"from iteration {k}, step {step}: {b}" for b in r["bad"]]
    return {"steps": steps, "bad": bad}


def solve_divergence(args, icfg, vcfg) -> dict:
    """A record of how far two float32 solves drift apart over all
    iterations: the kernel against solve_batch, and beside it (the witness
    of the solve's own sensitivity) solve_batch against solve_batch with x0
    moved by one ulp toward +inf. For each pair: the share of rows whose
    picks agree at every iteration, the relative cost gap over all rows and
    over those rows, and rows whose ``converged`` differs."""
    import torch

    from hope_tpu_torch.ops import ilqr_solve as kmod
    from hope_tpu_torch.planning import ilqr

    with torch.no_grad():
        xs, us, cost, conv, picks, _ = kmod.ilqr_solve(*args, icfg, vcfg, record=True)
        res, hist = ilqr.solve_batch(*args, icfg, vcfg, history=True)
        x1 = torch.nextafter(args[0], torch.full_like(args[0], torch.inf))
        ulp, uhist = ilqr.solve_batch(x1, *args[1:], icfg, vcfg, history=True)

    def pair(p_a, c_a, conv_a):
        agree = (p_a == hist.pick).all(1)
        rel = ((c_a - res.cost).abs() / res.cost.abs()).cpu()
        on = rel[agree.cpu()]
        stat = lambda t: ({"median": float(t.median()), "max": float(t.max())}  # noqa: E731
                          if t.numel() else None)
        return {"picks_agree_share": float(agree.float().mean()), "cost_rel_gap": stat(rel),
                "cost_rel_gap_where_picks_agree": stat(on),
                "converged_rows_differ": int((conv_a != res.converged).sum())}

    return {"kernel_vs_plain": pair(picks.long(), cost, conv),
            "plain_vs_plain_one_ulp": pair(uhist.pick, ulp.cost, ulp.converged)}


def phase_ilqr_kernel(dev, reps: int = 50):
    """The iLQR kernel on the first replan's problem of the DLP battery at
    the MPC CLI's settings, at B = 256 and on its first row (see the
    module docstring, phase 17a)."""
    import torch

    from hope_tpu_torch.ops import ilqr_solve as kmod
    from hope_tpu_torch.planning import ilqr, mpc, staging
    from portbench import ilqr_work

    env, icfg, scenes = _mpc_setup(dev, "dlp")
    vcfg = env.cfg.vehicle
    st = staging.compute_staging(env, scenes, max_tries=6)
    with torch.no_grad():
        us, rs = mpc.rs_warm_start(env, scenes.start, scenes, MPC_H)
        goal = staging.pick_goal(st, scenes.start, scenes.dest)[0]
    us0 = torch.where(rs.found[:, None, None], us, 0.0)
    full = (scenes.start, goal, scenes.edges, scenes.edge_mask, us0)
    solver = ilqr.ILQRSolver(icfg, vcfg)
    out = {}
    for B in (EPISODES, 1):
        args = [t[:B].contiguous() for t in full]
        E = int(args[2].shape[1])
        live = args[3].sum(1).tolist()
        kinds = {}
        with torch.no_grad():
            before = kmod.KERNEL.launches
            res = solver(*args)
            launched = kmod.KERNEL.launches - before
            plain = ilqr.solve_batch(*args, icfg, vcfg)
            fn = lambda args=args: solver(*args)  # noqa: E731
            rec = {"phase": "ilqr_kernel", "B": B, "N": MPC_H, "E": E,
                   "live_edges_mean": sum(live) / B,
                   "iters": icfg.n_iters, "alphas": len(icfg.alphas),
                   "ms": cuda_ms(fn, reps), "device_ms": device_ms(fn, reps, kinds=kinds),
                   "activities_per_call": kinds,
                   "plain_ms": cuda_ms(lambda args=args: ilqr.solve_batch(*args, icfg, vcfg), 3, 1)}
        # the bound at E slots (portbench's frozen count, which prices a dead
        # slot as a live one) and at each row's live edges, all that the
        # kernel walks and the solve needs (a dead slot is +inf, never the
        # minimum)
        A = len(icfg.alphas)
        flops = ilqr_work.solve_flops(B, MPC_H, E, icfg.n_iters, A)
        flops_live = sum(ilqr_work.solve_flops(1, MPC_H, n, icfg.n_iters, A) for n in live)
        rec["bound_ms"], rec["bound_by"] = bound(0.0, flops)
        rec["bound_ms_live"], _ = bound(0.0, flops_live)
        rec["flops"], rec["flops_live"] = flops, flops_live
        if rec["device_ms"]:
            rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
            rec["bound_share_live"] = rec["bound_ms_live"] / rec["device_ms"]
        rel = ((res.cost - plain.cost).abs() / plain.cost.abs().clamp(min=1.0)).cpu()
        rec.update({"launches_per_call": launched,
                    "cost_rel_gap_median": float(rel.median()), "cost_rel_gap_max": float(rel.max()),
                    "cost_kernel_mean": float(res.cost.mean()),
                    "cost_plain_mean": float(plain.cost.mean()),
                    "converged": int(res.converged.sum())})
        bad = []
        if B == EPISODES:
            first = kernel_vs_plain(args, icfg, vcfg, agree_floor=ILQR_AGREE_FLOOR,
                                    every_row=False, held_floor=ILQR_HELD_FLOOR)
            along = kernel_along_the_solve(args, icfg, vcfg, ILQR_AGREE_FLOOR, ILQR_HELD_FLOOR)
            rec.update({"kernel_vs_plain": first, "along_the_solve": along,
                        "divergence": solve_divergence(args, icfg, vcfg)})
            bad = first["bad"] + along["bad"]
        emit(rec)
        out[B] = rec
        if launched != 1 or not bool(torch.isfinite(res.cost).all()) or bad:
            raise AssertionError(f"ilqr_kernel at B = {B}: {launched} launches, costs "
                                 f"finite {bool(torch.isfinite(res.cost).all())}, {bad}")
    return out


def phase_mpc_profile(dev, replans: int = 2):
    """torch.profiler over ``replans`` replan cycles of the DLP runner at the
    CLI's settings (after a warm-up run of the same runner): device busy share, and device
    activities and HtoD copies per replan and per control step, split by the
    runner's ``mpc/replan`` and ``mpc/step`` ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.planning import mpc, staging

    env, icfg, scenes = _mpc_setup(dev, "dlp", seed=3)
    st = staging.compute_staging(env, scenes, max_tries=6)
    run = mpc.build_mpc_runner(env, icfg, MPC_REPLAN, MPC_REPLAN * replans)
    run(scenes, st)                      # warm-up: the kernels built, the allocator warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(scenes, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kern = device_work(events)
    kern_ids = {id(e) for e in kern}
    annot = [e for e in events if e.device_type == cuda and id(e) not in kern_ids]
    split = {}
    for part, n in (("replan", replans), ("step", replans * MPC_REPLAN)):
        spans = [(a.time_range.start, a.time_range.end) for a in annot if a.name == f"mpc/{part}"]
        inside = [e for e in kern if any(a <= e.time_range.start <= b for a, b in spans)]
        host = [e for e in events if e.name == f"mpc/{part}" and e.device_type != cuda]
        split[part] = {"host_ms_each": sum(e.time_range.elapsed_us() for e in host) / 1e3 / n,
                       "device_busy_ms_each": sum(e.time_range.elapsed_us() for e in inside)
                       / 1e3 / n,
                       "device_activities_each": len(inside) / n,
                       "htod_copies_each": sum("HtoD" in e.name for e in inside) / n}
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        k, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (k + 1, t + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    emit({"phase": "mpc_profile", "B": EPISODES, "replans": replans, "wall_ms": wall_ms,
          "device_busy_ms": busy if kern else "not measured",
          "device_busy_share": busy / wall_ms if kern else "not measured",
          "split": split, "htod_copies": sum("HtoD" in e.name for e in kern),
          "top_device_ms": [[name[:80], k, t] for name, (k, t) in top]})


def phase_ppo_extrem(dev):
    """The r5 PPO actor's Extrem level at 256 episodes (a record, not a
    gate; cut from 1024 episodes to keep the script's time), beside the TPU
    run's results/eval_ppo_r5/result_Extrem.json (256 episodes: success
    0.91015625, success steps 47.18454935622318, mean steps 60.9140625, RS
    latched 0.58984375)."""
    import torch

    from hope_tpu_torch.evaluation.eval_mix_scene import build, run_battery

    torch.backends.cuda.matmul.allow_tf32 = False
    env, agent, state = build(os.path.join(ROOT, "hope_tpu_torch", "assets", "ppo_r5_actor.npz"),
                              dev, "ppo")
    res = run_battery(env, agent, state, "ppo", episodes=EPISODES, max_steps=MAX_STEPS,
                      out=None, seed=0, levels=["Extrem"])["Extrem"]
    lv = res["per_level"]["Extrem"]
    n, p = EPISODES, res["success_rate"]
    tpu = 0.91015625
    se = math.sqrt(p * (1 - p) / n + tpu * (1 - tpu) / EPISODES)
    emit({"phase": "ppo_extrem", "episodes": n, "success_rate": p,
          "success_steps_mean": res["success_steps_mean"], "steps_mean": lv["steps_mean"],
          "rs_latched": lv["rs_latched"], "collided": lv["collided"],
          "rollout_seconds": res["rollout_seconds"],
          "tpu_256": {"success_rate": tpu, "success_steps_mean": 47.18454935622318,
                      "steps_mean": 60.9140625, "rs_latched": 0.58984375},
          "difference_in_standard_errors": (p - tpu) / se})


# ---------------------------------------------------------------- PR 7 paths

# pretrain_autoencoder.main's defaults: 2000 Adam steps on batches of 64
# Normal scenes, a fresh batch rendered every 50 steps
AE_STEPS, AE_BATCH, AE_RENDERS = 2000, 64, 40


def _flat(tree, prefix=""):
    """{"/a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _tree_diff(got, want) -> list:
    """The leaves (by path) in which two trees from resume.to_tree differ,
    compared bitwise (tensors moved to the CPU)."""
    import torch

    fg, fw = _flat(got), _flat(want)
    bad = sorted(set(fg) ^ set(fw))
    for k in set(fg) & set(fw):
        a, b = fg[k], fw[k]
        if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
            same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                    and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.cpu(), b.cpu()))
        else:
            same = a == b
        if not same:
            bad.append(k)
    return bad


def _clone_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def phase_ae_pretrain(dev, kernels):
    """hope_tpu_torch.train.pretrain_autoencoder.main at its defaults (2000
    steps, batch 64, lr 1e-4): steps/s, the first and last loss (the last
    must be below the first), raster and mask launches (one each per render:
    40), peak memory; then the raster and the mask held to their plain
    versions on the first render's recorded inputs (64 Normal scenes, 96
    edge slots). Returns (checkpoint directory, the two kernels' records)."""
    import torch

    from hope_tpu_torch.train import pretrain_autoencoder

    log_dir = scratch_dir("ae")
    for r in kernels.values():
        r["mod"].KERNEL.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = {}
    t0 = time.perf_counter()
    kept = record_kernel_inputs(
        lambda: out.update(pretrain_autoencoder.main(["--log-dir", log_dir])),
        {"mask_step_lengths": 0, "raster_bev": 0})
    wall = time.perf_counter() - t0
    launches = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    for name, n in launches.items():
        kernels[name]["launches_ae_pretrain"] = n
    losses = out["losses"]
    rec = {"phase": "ae_pretrain", "steps": len(losses), "batch": AE_BATCH,
           "main_seconds": wall, "train_seconds": out["seconds"],
           "steps_per_s": len(losses) / out["seconds"], "loss_first": losses[0],
           "loss_last": losses[-1], "loss_min": min(losses), "launches": launches,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "checkpoint_bytes": os.path.getsize(out["checkpoint"])}
    emit(rec)
    held = measure_kernels("ae_pretrain_kernel", kept["mask_step_lengths"], kept["raster_bev"],
                           None)
    want = {"mask_step_lengths": AE_RENDERS, "raster_bev": AE_RENDERS, "swept_collide": 0}
    bad = [f"{k} launched {launches[k]}, want {v}" for k, v in want.items() if launches[k] != v]
    if len(losses) != AE_STEPS or not all(map(math.isfinite, losses)):
        bad.append("losses")
    if not losses[-1] < losses[0]:
        bad.append(f"last loss {losses[-1]} not below the first {losses[0]}")
    if bad:
        raise AssertionError(f"ae_pretrain: {bad}")
    return os.path.join(log_dir, "ckpt"), held


def phase_ae_graft(dev, kernels, ae_ckpt):
    """train_sac.main at the defaults with --img-encoder (the ae_pretrain
    checkpoint) --freeze-img-encoder for 4 chunks (3 warm-up, 1 update
    chunk of 64 updates): after the update chunk every embed_img tensor of
    the actor and both critics equals the graft bitwise, and every other
    group moved; the targets' encoders (soft-updated from unmoving critics)
    are recorded, not gated."""
    import torch

    from hope_tpu_torch.config import ObsConfig, actor_net_config
    from hope_tpu_torch.models.autoencoder import AEConv
    from hope_tpu_torch.train import train_sac
    from hope_tpu_torch.utils.checkpoint import load_checkpoint

    log_dir = scratch_dir("ae_graft")
    enc = load_checkpoint(ae_ckpt, AEConv(actor_net_config(ObsConfig())).to(dev)).encoder
    enc = {k: v.clone() for k, v in enc.state_dict().items()}
    before = {}

    def groups(st):
        """{group: [(name, tensor)]}: the encoders and the rest of each net."""
        out = {}
        for n in ("actor", "critic1", "critic2", "target1", "target2"):
            for k, p in getattr(st, n).named_parameters():
                g = f"{n}/{'embed_img' if '.embed_img.' in f'.{k}' else 'rest'}"
                out.setdefault(g, []).append((k, p.detach()))
        out["log_std"] = [("log_std", st.log_std.detach())]
        return out

    def on_chunk(record, loop):
        if record["chunk"] == TRAIN_WARMUP:
            before.update({g: [(k, v.clone()) for k, v in ps]
                           for g, ps in groups(loop["state"]).items()})

    t0 = time.perf_counter()
    res = train_sac.main(["--max-chunks", str(TRAIN_WARMUP + 1), "--no-tensorboard",
                          "--log-dir", log_dir, "--seed", "0", "--img-encoder", ae_ckpt,
                          "--freeze-img-encoder"], on_chunk=on_chunk)
    wall = time.perf_counter() - t0
    st = res["loop"]["state"]
    shutil.rmtree(log_dir)
    after = groups(st)
    graft_diff, moved = {}, {}
    for g, ps in after.items():
        if g.endswith("embed_img"):
            graft_diff[g] = max(float((v - enc[k.split("embed_img.", 1)[1]]).abs().max())
                                for k, v in ps)
        else:
            moved[g] = max(float((v - w).abs().max()) for (_, v), (_, w) in zip(ps, before[g]))
    emit({"phase": "ae_graft", "chunks": len(res["chunks"]), "main_seconds": wall,
          "sgd_steps": st.steps, "encoder_max_abs_from_graft": graft_diff,
          "rest_max_change_in_update_chunk": moved,
          "full_save": res["loop"]["full_saves"][-1]})
    bad = [g for g, d in graft_diff.items() if not g.startswith("target") and d != 0.0]
    bad += [f"{g} unmoved" for g, d in moved.items() if d == 0.0]
    if bad or st.steps != TRAIN_U:
        raise AssertionError(f"ae_graft: {bad}, {st.steps} updates")


def phase_resume(dev, kernels):
    """Full-loop checkpoints at the defaults: train_sac.main with
    --full-save-every 2 --max-chunks 4 (run A); the file at step 4 against
    A's live loop, bitwise (every tensor, the replay ring, every generator
    state, the host JSON); the file loaded back into A's objects after they
    were overwritten, bitwise; a resume from step 2 (inside the warm-up
    chunks, which only collect) to chunk 3 against A's chunk 3, bitwise; a
    resume from A's last checkpoint to chunk 7 with --profile-chunks 1:
    counters continue, the trace names both chunk ranges. An update chunk
    resumed on the card is not compared with an uninterrupted one: cuDNN's
    backward is not bitwise repeatable here (PERF.md §7)."""
    import torch

    from hope_tpu_torch.train import resume, train_sac

    # at the default --log-every 5 no run logs (or passes the best-checkpoint
    # gate) before chunk 5, so run B's host state is A's at its chunk 3
    base = ["--no-tensorboard", "--seed", "0"]
    d_a, d_b, d_c = (scratch_dir(n) for n in ("resume_a", "resume_b", "resume_c"))
    snap = {}

    def on_chunk(record, loop):
        if record["chunk"] == TRAIN_WARMUP:
            dev_blob, host = loop["full_state"]()
            snap["device"] = _clone_tree(resume.to_tree(dev_blob))
            snap["host"] = json.loads(json.dumps(host))

    t0 = time.perf_counter()
    a = train_sac.main(base + ["--log-dir", d_a, "--full-save-every", "2", "--max-chunks", "4"],
                       on_chunk=on_chunk)["loop"]
    a_wall = time.perf_counter() - t0
    a_saves = [{k: r[k] for k in ("step", "bytes", "seconds")} for r in a["full_saves"]]
    ck = os.path.join(d_a, "ckpt_full")
    live_dev, live_host = a["full_state"]()
    t0 = time.perf_counter()
    saved = torch.load(os.path.join(ck, "step_4", "state.pt"), map_location="cpu",
                       weights_only=True)
    read_s = time.perf_counter() - t0
    with open(os.path.join(ck, "host_4.json")) as f:
        saved_host = json.load(f)
    save_bad = _tree_diff(resume.to_tree(live_dev), saved)
    host_equal = saved_host == json.loads(json.dumps(live_host))

    # overwrite A's live objects, then restore them from the file
    with torch.no_grad():
        for v in a["replay"].data.values():
            v.zero_()
        for p in a["state"].critic1.parameters():
            p.add_(1.0)
    for g in (a["generator"], a["pool"].generator):
        torch.rand(7, generator=g, device=g.device)
    t0 = time.perf_counter()
    restored, host, step = resume.load_full(ck, live_dev)
    load_s = time.perf_counter() - t0
    load_bad = _tree_diff(resume.to_tree(restored), saved)
    del live_dev, restored, saved, a
    gc.collect()

    # a resume inside the warm-up chunks, against run A's chunk 3
    os.makedirs(os.path.join(d_b, "src"))
    shutil.copytree(os.path.join(ck, "step_2"), os.path.join(d_b, "src", "step_2"))
    shutil.copy(os.path.join(ck, "host_2.json"), os.path.join(d_b, "src"))
    b = train_sac.main(base + ["--log-dir", os.path.join(d_b, "run"), "--max-chunks", "3",
                               "--resume", os.path.join(d_b, "src")])["loop"]
    b_dev, b_host = b["full_state"]()
    warm_bad = _tree_diff(resume.to_tree(b_dev), snap["device"])
    warm_host = json.loads(json.dumps(b_host)) == snap["host"]
    del b, b_dev, snap
    gc.collect()

    # a resume from step 4 to chunk 7, tracing chunk 5
    t0 = time.perf_counter()
    c = train_sac.main(base + ["--log-dir", d_c, "--max-chunks", "7", "--resume", ck,
                               "--profile-chunks", "1"])
    c_wall = time.perf_counter() - t0
    trace = os.path.join(d_c, "trace", "trace.json")
    with open(trace) as f:
        text = f.read()
    names = {n for n in ("sac_chunk/collect", "sac_chunk/update") if f'"{n}"' in text}
    del text
    c_loop = c["loop"]
    saves = [{k: r[k] for k in ("step", "bytes", "seconds")} for r in c_loop["full_saves"]]
    rec = {"phase": "resume", "run_a_seconds": a_wall, "run_c_seconds": c_wall,
           "save_diff_leaves": save_bad, "host_json_equal": host_equal,
           "load_full_seconds": load_s, "file_read_seconds": read_s,
           "load_diff_leaves": load_bad, "load_step": step,
           "warmup_resume_diff_leaves": warm_bad, "warmup_resume_host_equal": warm_host,
           "resumed": c_loop["resumed"], "chunks_after_resume": [r["chunk"] for r in c["chunks"]],
           "trace_bytes": os.path.getsize(trace), "trace_has_ranges": sorted(names),
           "full_saves_a": a_saves, "full_saves_c": saves}
    emit(rec)
    del c, c_loop
    gc.collect()
    for d in (d_a, d_b, d_c):
        shutil.rmtree(d)
    bad = []
    if save_bad or not host_equal:
        bad.append(f"save differs from the live loop in {save_bad[:5]} (host {host_equal})")
    if load_bad or step != 4 or host != saved_host:
        bad.append(f"load differs from the file in {load_bad[:5]}")
    if warm_bad or not warm_host:
        bad.append(f"warm-up resume differs in {warm_bad[:5]} (host {warm_host})")
    if rec["chunks_after_resume"] != [5, 6, 7] or rec["resumed"]["chunk"] != 4:
        bad.append(f"counters: {rec['chunks_after_resume']}, {rec['resumed']}")
    if not {"sac_chunk/collect", "sac_chunk/update"} <= names:
        bad.append("trace lacks the chunk ranges")
    if bad:
        raise AssertionError(f"resume: {bad}")


def phase_stream_dlp(dev, kernels):
    """train_sac.main at the defaults with --stream-dlp for 4 chunks (launch
    counts: K a chunk, +1 for the mask and raster in chunk 1); then the
    prefetch in flight: its batch against the rows of data/dlp.npz and the
    numpy plain gather, the time a synchronous gather of it takes against
    the wait for the prefetched one (the gather time the prefetch hides);
    and one more refresh of the pool against a resident pool's from the same
    ids and generator state, every field bitwise."""
    import numpy as np
    import torch

    from hope_tpu_torch import native
    from hope_tpu_torch.train import train_sac
    from hope_tpu_torch.train.scene_pool import ScenePool

    log_dir = scratch_dir("stream_dlp")
    for r in kernels.values():
        r["mod"].KERNEL.launches = 0
    seen = {name: 0 for name in kernels}
    per_chunk = []

    def on_chunk(record, loop):
        now = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
        per_chunk.append({name: now[name] - seen[name] for name in kernels})
        seen.update(now)

    t0 = time.perf_counter()
    res = train_sac.main(["--max-chunks", str(TRAIN_WARMUP + 1), "--no-tensorboard",
                          "--log-dir", log_dir, "--seed", "0", "--stream-dlp"],
                         on_chunk=on_chunk)
    wall = time.perf_counter() - t0
    launches = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    for name, n in launches.items():
        kernels[name]["launches_stream_dlp_train"] = n
    loop = res["loop"]
    pool = loop["pool"]
    shutil.rmtree(log_dir)
    stream = pool.stream
    ids = stream.pending_ids.copy()
    t0 = time.perf_counter()
    waited = stream.bank.take()
    wait_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sync = stream.bank.gather(ids)
    gather_s = time.perf_counter() - t0
    plain = native.gather_plain(stream.bank.path, ids)
    with np.load(os.path.join(ROOT, "data", "dlp.npz")) as d:
        rows = {k: d[k][ids] for k in ("edges", "edge_mask", "edge_poly", "n_polys", "dest",
                                       "starts", "n_starts", "levels")}
    gather_bad = [k for k in rows if not (np.array_equal(waited[k], rows[k])
                                          and np.array_equal(sync[k], rows[k])
                                          and np.array_equal(plain[k], rows[k]))]
    stream.prefetch(ids)                   # as it was
    state = pool.generator.get_state()
    t0 = time.perf_counter()
    pool.refresh(dlp_case_ids=np.arange(pool.per_level))
    refresh_s = time.perf_counter() - t0
    resident = ScenePool(pool.env_cfg, per_level=pool.per_level, seed=1, device=dev)
    resident.generator.set_state(state)
    resident.refresh(dlp_case_ids=ids)
    pool_bad = [f for f in pool.pool.__dataclass_fields__
                if not torch.equal(getattr(pool.pool, f), getattr(resident.pool, f))]
    emit({"phase": "stream_dlp", "chunks": len(res["chunks"]), "main_seconds": wall,
          "chunk_seconds": [r["seconds"] for r in res["chunks"]],
          "launches": launches, "launches_per_chunk": per_chunk,
          "batch_cases": len(ids), "batch_bytes": int(sum(v.nbytes for v in sync.values())),
          "sync_gather_s": gather_s, "prefetched_wait_s": wait_s,
          "hidden_gather_s": gather_s - wait_s, "refresh_s": refresh_s,
          "gather_diff_fields": gather_bad, "pool_diff_fields": pool_bad,
          "full_save": loop["full_saves"][-1]})
    stream.close()
    del res, loop, pool, resident
    gc.collect()
    bad = list(gather_bad) + [f"pool {f}" for f in pool_bad]
    for n, c in enumerate(per_chunk, 1):
        for name, k in c.items():
            want = TRAIN_K + (1 if n == 1 and name != "swept_collide" else 0)
            if k != want:
                bad.append(f"chunk {n}: {name} launched {k}, want {want}")
    if bad:
        raise AssertionError(f"stream_dlp: {bad}")


def phase_eval_pictures(dev):
    """The eval CLI (the r3b actor) on Normal with --episodes 8 --visualize
    2 --animate 1: the record (no poses), the success CDF, 2 PNGs and a GIF
    exist; the runner's recorded poses are (T, 8, 3). The pictures are kept
    in chiprun_out/eval_pictures/."""
    import numpy as np

    from hope_tpu_torch.evaluation import eval_mix_scene

    out = os.path.join(OUT_DIR, "eval_pictures")
    shutil.rmtree(out, ignore_errors=True)
    inner = eval_mix_scene.build_episode_runner
    seen = []

    def runner(*a, **kw):
        run = inner(*a, **kw)

        def wrapped(*ra, **rkw):
            m = run(*ra, **rkw)
            seen.append(tuple(m["poses"].shape) if "poses" in m else None)
            return m
        return wrapped

    eval_mix_scene.build_episode_runner = runner
    try:
        t0 = time.perf_counter()
        res = eval_mix_scene.main([os.path.join(ROOT, "hope_tpu_torch", "assets",
                                                "sac_r3b_actor.npz"),
                                   "--levels", "Normal", "--episodes", "8", "--visualize", "2",
                                   "--animate", "1", "--out", out])
        wall = time.perf_counter() - t0
    finally:
        eval_mix_scene.build_episode_runner = inner
    files = {f: os.path.getsize(os.path.join(out, f)) for f in sorted(os.listdir(out))}
    with np.load(os.path.join(out, "record_Normal.npz")) as rec:
        rec_keys = sorted(rec.files)
    emit({"phase": "eval_pictures", "seconds": wall, "success_rate": res["Normal"]["success_rate"],
          "poses_shapes": seen, "files": files, "record_keys": rec_keys})
    want = ["episode_Normal_0.gif", "episode_Normal_0.png", "episode_Normal_1.png",
            "record_Normal.npz", "success_cdf_Normal.png"]
    if (seen != [(MAX_STEPS, 8, 3)] or "poses" in rec_keys
            or any(files.get(f, 0) < 1000 for f in want)):
        raise AssertionError(f"eval_pictures: poses {seen}, files {files}")


# ------------------------------------------------- data-parallel training

# two ranks on the one card over gloo (the pool gives one card, so NCCL across
# cards is not what this measures): SAC at the defaults with 1 warm-up chunk
# and 2 update chunks, PPO at the defaults for 1 chunk
MP_WORLD, MP_SAC_CHUNKS, MP_SAC_WARMUP, MP_PPO_CHUNKS = 2, 3, 1, 1
# the card's updates are not bitwise repeatable (cuDNN's backward), and a
# 2-rank gradient is the sum of two halves: an Adam step moves an entry by at
# most about lr (5e-6), so after U steps the runs differ by under 2 U lr where
# gradients at rounding level take other signs (ppo_parity's reasoning)
MP_SAC_LR = 5e-6
# the actor's largest and mean gap after the 2 update chunks, 2 ranks against
# 1, and the share of the critics' entries more than 1e-6 apart: limits set
# between sound runs (7.8e-5, 5.9e-6, 0.619 at most) and runs with rank 1's
# half left out of every gradient sum (2.15e-4, 2.46e-5, 0.913 at least),
# near the geometric mean of the two (tools/mp_param_gap.py on an H100,
# PERF.md section 6)
MP_ACTOR_GAP, MP_ACTOR_MEAN_GAP, MP_CRITIC_LOOSE = 1.3e-4, 1.2e-5, 0.75
# a rank holds every 16th call of each kernel to its plain version: once a
# SAC chunk (K = 16 steps), 8 times in a PPO chunk (T = 128)
MP_HOLD_EVERY = 16
# the first chunk's rewards and ring rows, 2 ranks against 1: the policy runs
# on the whole batch on every rank, so the collect is bitwise on the CPU
# (tests/test_torch_parallel.py); on the card the env's reductions at B / 2
# rows may round otherwise: 1e-5 (normalized values are O(1))
MP_ROW_ATOL = 1e-5


def sac_param_gaps(got: dict, ref: dict) -> dict:
    """|got - ref| over SAC's parameters, two flat {key: tensor} of
    ``state_blob``: per group (the actor with log_std, the critics with
    their targets, log_alpha) the largest and the mean gap and the share of
    entries more than 1e-6 apart."""
    import torch

    groups = {"actor": ("actor", "log_std"),
              "critics": ("critic1", "critic2", "target1", "target2"),
              "log_alpha": ("log_alpha",)}
    out = {}
    for g, nets in groups.items():
        d = torch.cat([(got[k].double() - v.double()).abs().reshape(-1)
                       for k, v in ref.items() if k.split("/")[1] in nets])
        out[g] = {"max": float(d.max()), "mean": float(d.mean()),
                  "share_over_1e-6": float((d > 1e-6).double().mean())}
    return out


def one_rank_sac(argv: list, d: str) -> dict:
    """train_sac.main(argv) in this process, logging to ``d`` (deleted
    after): the first chunk's logs and ring rows, and the state's tensors
    after the last chunk."""
    import torch

    from hope_tpu_torch.train import train_sac
    from hope_tpu_torch.utils.checkpoint import state_blob

    ref = {}

    def on_chunk(record, loop):
        if record["chunk"] == 1:
            ref["logs"] = {k: v.cpu() for k, v in loop["logs"].items()}
            n = loop["replay"].cursor
            ref["ring"] = {k: v[:n].cpu() for k, v in loop["replay"].data.items()}
        ref["state"] = {k: v.detach().cpu().clone() for k, v in
                        _flat(state_blob(loop["state"])).items() if isinstance(v, torch.Tensor)}

    t0 = time.perf_counter()
    train_sac.main(argv + ["--log-dir", d], on_chunk=on_chunk)
    ref["seconds"] = time.perf_counter() - t0
    shutil.rmtree(d)
    return ref


def two_rank_agent(log_dir: str, step: int) -> tuple:
    """The agent's tensors in the full checkpoint that a 2-rank run wrote
    (gathered to rank 0) at ``step``."""
    import torch

    blob = torch.load(os.path.join(log_dir, "ckpt_full", f"step_{step}", "state.pt"),
                      map_location="cpu", mmap=True, weights_only=True)
    return ({k: v.clone() for k, v in _flat(blob["agent"]).items()
             if isinstance(v, torch.Tensor)}, blob["replay"]["data"]["action"].shape[0])


def _state_sha(st) -> str:
    """sha256 of every tensor of a SAC or PPO state (networks, Adams,
    normalizer, count), in key order, as its checkpoint holds them."""
    import hashlib

    import torch

    from hope_tpu_torch.utils.checkpoint import state_blob

    h = hashlib.sha256()
    for k, v in sorted(_flat(state_blob(st)).items()):
        h.update(k.encode())
        h.update(v.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
                 if isinstance(v, torch.Tensor) else repr(v).encode())
    return h.hexdigest()


def mp_rank(spec: dict):
    """One rank of phase mp_train, in a process of its own (``chip_smoke.py
    --mp-rank <json>``): the CLI's rank worker on the phase's card over gloo,
    its kernel calls held to the plain versions (:func:`hold_kernel_calls`,
    every MP_HOLD_EVERY-th call at each batch size), with per-chunk records
    (seconds, collectives, launches, the batch sizes each kernel was called
    at, the holds so far, the state's sha256, peak memory) written to
    ``spec["out"]``; rank 0 also keeps chunk 1's logs and, for SAC, the
    ring's rows of chunk 1."""
    import importlib

    import torch

    from hope_tpu_torch.train import train_ppo, train_sac

    cli = train_sac if spec["kind"] == "sac" else train_ppo
    args = cli.parse_args(spec["argv"])
    args.coordinator = spec["coordinator"]
    rank = spec["rank"]
    # the ranks share the host's cores: an even share of torch's threads each
    torch.set_num_threads(max(1, (os.cpu_count() or MP_WORLD) // MP_WORLD))
    from hope_tpu_torch.ops import ilqr_solve

    mods = {name: importlib.import_module(m) for name, m in spec["kernels"].items()}
    for mod in (*mods.values(), ilqr_solve):
        mod.KERNEL.launches = 0
    seen = {name: 0 for name in mods}
    chunks = []
    held = {}

    def on_chunk(record, loop):
        now = {name: m.KERNEL.launches for name, m in mods.items()}
        rec = {**record, "launches": {n: now[n] - seen[n] for n in mods},
               "kernel_batch": {n: list(held[n]["batch"]) for n in mods},
               "held": {n: {k: v for k, v in held[n].items() if k != "batch"} for n in mods},
               "state_sha": _state_sha(loop["state"]),
               "metrics": {k: float(v) for k, v in loop["metrics"].items()}}
        seen.update(now)
        chunks.append(rec)
        if record["chunk"] == 1 and rank == 0:
            keep = {"logs": {k: v.cpu() for k, v in loop["logs"].items()}}
            if "replay" in loop:
                n = loop["replay"].cursor
                keep["ring"] = {k: v[:n].cpu() for k, v in loop["replay"].data.items()}
            torch.save(keep, spec["out"] + ".chunk1.pt")

    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)                 # CUDA up before its memory counters
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with hold_kernel_calls(MP_HOLD_EVERY) as h:
        held.update(h)
        res = cli.rank_worker(args, rank, MP_WORLD, dev, "gloo", on_chunk)
    out = {"rank": rank, "main_seconds": time.perf_counter() - t0, "chunks": chunks,
           "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                                 else None),
           "full_saves": res["loop"].get("full_saves"),
           "ilqr_launches": ilqr_solve.KERNEL.launches}
    with open(spec["out"], "w") as f:
        json.dump(out, f)


def _mp_spawn(dev, kind: str, argv: list, kernels: dict, d: str, timeout: int,
              entry: list | None = None, **spec_extra) -> list:
    """Start the 2 rank processes of ``kind`` at once (``entry`` + [spec
    JSON], by default ``chip_smoke.py --mp-rank``) and wait for both; their
    output goes to mp_<kind>_rank<r>.log under OUT_DIR. Returns each rank's
    results."""
    import socket

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        coord = f"localhost:{sk.getsockname()[1]}"
    procs, outs = [], []
    for r in range(MP_WORLD):
        spec = {"kind": kind, "argv": argv, "rank": r, "coordinator": coord, "device": str(dev),
                "kernels": {n: k["mod"].__name__ for n, k in kernels.items()},
                "out": os.path.join(d, f"rank{r}.json"), **spec_extra}
        log = open(os.path.join(OUT_DIR, f"mp_{kind}_rank{r}.log"), "w")
        cmd = entry or [sys.executable, os.path.abspath(__file__), "--mp-rank"]
        procs.append((subprocess.Popen(cmd + [json.dumps(spec)], cwd=ROOT, stdout=log,
                                       stderr=subprocess.STDOUT), log))
        outs.append(spec["out"])
    try:
        for r, (p, log) in enumerate(procs):
            code = p.wait(timeout=timeout)
            log.close()
            if code != 0:
                raise AssertionError(f"mp_train {kind}: rank {r} exited {code} ("
                                     f"{os.path.join(OUT_DIR, f'mp_{kind}_rank{r}.log')})")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def _check_ranks(kind: str, ranks: list, K: int, B: int, kernels: dict):
    """Both ranks' chunks: the state's sha256 equal after every chunk, the
    same episodes, each kernel launched K times a chunk (K + 1 for the mask
    and the raster in chunk 1, the first reset) and called at B / 2 envs
    only, held to its plain version in every chunk with 0 mismatches,
    finite metrics."""
    bad = []
    for c0, c1 in zip(ranks[0]["chunks"], ranks[1]["chunks"]):
        if c0["state_sha"] != c1["state_sha"]:
            bad.append(f"chunk {c0['chunk']}: the ranks' states differ")
        if c0["episodes"] != c1["episodes"]:
            bad.append(f"chunk {c0['chunk']}: episodes {c0['episodes']} != {c1['episodes']}")
    for r in ranks:
        for c in r["chunks"]:
            for name, n in c["launches"].items():
                want = K + (1 if c["chunk"] == 1 and name != "swept_collide" else 0)
                if n != want:
                    bad.append(f"rank {r['rank']} chunk {c['chunk']}: {name} {n} launches, "
                               f"want {want}")
            for name, b in c["kernel_batch"].items():
                if b != [B // MP_WORLD]:
                    bad.append(f"rank {r['rank']}: {name} called at batch {b}")
            bad += [f"rank {r['rank']} chunk {c['chunk']}: {k} = {v}"
                    for k, v in c["metrics"].items() if not math.isfinite(v)]
        for name in kernels:
            held = [c["held"][name]["held"] for c in r["chunks"]]
            if sorted(set(held)) != held or 0 in held:
                bad.append(f"rank {r['rank']}: {name} not held in every chunk ({held})")
            if r["chunks"] and r["chunks"][-1]["held"][name]["mismatches"]:
                bad.append(f"rank {r['rank']}: {name} {r['chunks'][-1]['held'][name]} "
                           "against its plain version")
    if len(ranks[0]["chunks"]) != len(ranks[1]["chunks"]):
        bad.append("the ranks ran different numbers of chunks")
    if bad:
        raise AssertionError(f"mp_train {kind}: {bad}")


def phase_mp_train(dev, kernels):
    """Two ranks on cuda:0 over gloo through the CLIs' rank worker
    (train_sac / train_ppo ``rank_worker``), at the defaults: SAC 1 warm-up
    and 2 update chunks, PPO 1 chunk. Checks: both ranks finish with the
    same episodes; their parameters, Adam states and normalizer bitwise
    equal after every chunk (sha256); each kernel launched K times a chunk
    on each rank, at B / 2, and held to its plain version in every chunk
    (:func:`mp_rank`); SAC's first chunk against a 1-rank run of the same
    seed: logs (done, status, pool index) equal, rewards and the ring's
    rows within MP_ROW_ATOL, and after chunk 3 the actor within
    MP_ACTOR_GAP (largest) and MP_ACTOR_MEAN_GAP (mean), the critics and
    log_alpha within 2 U lr (MP_SAC_LR) with at most MP_CRITIC_LOOSE of
    the critics' entries more than 1e-6 apart;
    the 2-rank full checkpoint (written at exit, gathered to rank 0) holds
    the whole ring and resumes in one process, where the counters and the
    ring go on. Records per-rank chunk seconds, collective seconds and
    bytes, and peak memory."""
    import torch

    from hope_tpu_torch.train import train_sac

    # --- SAC, 2 ranks
    d2 = scratch_dir("mp_sac2")
    common = ["--no-tensorboard", "--seed", "0", "--log-every", "1",
              "--warmup-chunks", str(MP_SAC_WARMUP), "--device", str(dev)]
    t0 = time.perf_counter()
    ranks = _mp_spawn(dev, "sac", common + ["--devices", str(MP_WORLD), "--max-chunks",
                                            str(MP_SAC_CHUNKS), "--log-dir", d2],
                      kernels, d2, 360)
    sac_wall = time.perf_counter() - t0
    _check_ranks("sac", ranks, TRAIN_K, TRAIN_B, kernels)
    for r in ranks:
        emit({"phase": "mp_train_rank", "kind": "sac", "rank": r["rank"],
              "main_seconds": r["main_seconds"], "peak_memory_bytes": r["peak_memory_bytes"],
              "chunks": [{k: c[k] for k in ("chunk", "warmup", "seconds", "episodes",
                                            "collective_calls", "collective_bytes",
                                            "collective_seconds", "launches", "kernel_batch",
                                            "held", "metrics")} for c in r["chunks"]],
              "full_saves": r["full_saves"]})
    mp_launches = {name: sum(c["launches"][name] for c in ranks[0]["chunks"])
                   for name in kernels}
    for name, n in mp_launches.items():
        kernels[name]["launches_mp_train"] = n
    ILQR_LAUNCHES["mp_train_rank0"] = ranks[0]["ilqr_launches"]
    if [c["chunk"] for c in ranks[0]["chunks"]] != list(range(1, MP_SAC_CHUNKS + 1)):
        raise AssertionError(f"mp_train sac: chunks {ranks[0]['chunks']}")

    # --- the same seed on 1 rank: the first chunk's collect, the parameters
    # after the last chunk
    ref = one_rank_sac(common + ["--max-chunks", str(MP_SAC_CHUNKS)], scratch_dir("mp_sac1"))
    one_wall = ref["seconds"]
    mine = torch.load(os.path.join(d2, "rank0.json.chunk1.pt"), weights_only=True)
    diffs, bad = {}, []
    for k in ("done", "status", "pool_idx"):
        if not torch.equal(mine["logs"][k], ref["logs"][k]):
            bad.append(f"chunk 1 {k} differs from the 1-rank run")
    diffs["reward"] = float((mine["logs"]["reward"] - ref["logs"]["reward"]).abs().max())
    for k, v in ref["ring"].items():
        g = mine["ring"][k]
        diffs[f"ring/{k}"] = (float((g.double() - v.double()).abs().max()) if g.shape == v.shape
                              else math.inf)
    bad += [k for k, v in diffs.items() if not v <= MP_ROW_ATOL]
    # the full checkpoint rank 0 wrote at exit: its agent against the
    # 1-rank run's after the same chunks
    ckpt = os.path.join(d2, "ckpt_full")
    agent, ring_rows = two_rank_agent(d2, MP_SAC_CHUNKS)
    gaps = sac_param_gaps(agent, ref["state"])
    updates = (MP_SAC_CHUNKS - MP_SAC_WARMUP) * TRAIN_U
    if not (gaps["actor"]["max"] <= MP_ACTOR_GAP and gaps["actor"]["mean"] <= MP_ACTOR_MEAN_GAP
            and gaps["critics"]["max"] <= 2 * updates * MP_SAC_LR + 1e-6
            and gaps["critics"]["share_over_1e-6"] <= MP_CRITIC_LOOSE
            and gaps["log_alpha"]["max"] <= 2 * updates * MP_SAC_LR + 1e-6):
        bad.append(f"parameters from the 1-rank run's: {gaps}")
    del agent, ref

    # --- that checkpoint resumed in one process, one more chunk
    d3 = scratch_dir("mp_sac_resume")
    resumed = {}

    def on_resumed(record, loop):
        resumed.update(record=record, size=loop["replay"].size, resumed=loop["resumed"])

    t0 = time.perf_counter()
    train_sac.main(common + ["--max-chunks", str(MP_SAC_CHUNKS + 1), "--log-dir", d3,
                             "--resume", ckpt], on_chunk=on_resumed)
    resume_wall = time.perf_counter() - t0
    shutil.rmtree(d3)
    want_size = min((MP_SAC_CHUNKS + 1) * TRAIN_K * TRAIN_B, TRAIN_MEMORY)
    rr = resumed.get("resumed") or {}
    if (rr.get("mode") != "full" or rr.get("chunk") != MP_SAC_CHUNKS
            or resumed["size"] != want_size or ring_rows != TRAIN_MEMORY):
        bad.append(f"resume: {rr}, ring {resumed.get('size')} rows of {ring_rows}")
    full_bytes = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(ckpt)
                     for f in fs)
    shutil.rmtree(d2)
    emit({"phase": "mp_train_sac", "world": MP_WORLD, "backend": "gloo (one card)",
          "B": TRAIN_B, "K": TRAIN_K, "U": TRAIN_U, "chunks": MP_SAC_CHUNKS,
          "two_rank_seconds": sac_wall, "one_rank_seconds": one_wall,
          "resume_seconds": resume_wall, "launches_rank0": mp_launches,
          "vs_one_rank": diffs, "params_from_one_rank": gaps,
          "actor_gap_limits": [MP_ACTOR_GAP, MP_ACTOR_MEAN_GAP],
          "critic_bound": 2 * updates * MP_SAC_LR + 1e-6, "critic_loose_limit": MP_CRITIC_LOOSE,
          "full_checkpoint_bytes": full_bytes,
          "resumed": rr, "resumed_ring_size": resumed.get("size")})
    if bad:
        raise AssertionError(f"mp_train sac: {bad}")

    # --- PPO, 2 ranks, 1 chunk
    dp = scratch_dir("mp_ppo")
    t0 = time.perf_counter()
    pranks = _mp_spawn(dev, "ppo", ["--no-tensorboard", "--seed", "0", "--devices",
                                    str(MP_WORLD), "--device", str(dev), "--max-chunks",
                                    str(MP_PPO_CHUNKS), "--log-dir", dp], kernels, dp, 400)
    ppo_wall = time.perf_counter() - t0
    shutil.rmtree(dp)
    _check_ranks("ppo", pranks, PPO_T, PPO_B, kernels)
    for r in pranks:
        emit({"phase": "mp_train_rank", "kind": "ppo", "rank": r["rank"],
              "main_seconds": r["main_seconds"], "peak_memory_bytes": r["peak_memory_bytes"],
              "chunks": [{k: c[k] for k in ("chunk", "seconds", "episodes", "sgd_steps",
                                            "collective_calls", "collective_bytes",
                                            "collective_seconds", "launches", "kernel_batch",
                                            "held", "metrics")} for c in r["chunks"]]})
    emit({"phase": "mp_train_ppo", "world": MP_WORLD, "backend": "gloo (one card)",
          "B": PPO_B, "T": PPO_T, "chunks": MP_PPO_CHUNKS, "two_rank_seconds": ppo_wall})



def phase_single_env(dev, kernels):
    """ParkingEnv.reset / step / observe at B = 1 on the card against the
    batched path's row, on 8 DLP scenes at the defaults (512 edges, the
    image on): the first observation, then 8 steps of fixed actions, scene 3
    alone against the batch. Observations (the kernels' outputs) and
    statuses equal, rewards and poses to 1e-5; each single-env observation
    launches the mask and the raster once, each step the sweep once; every
    kernel call, at B = 1 and at B = 8, held to its plain version on the
    same inputs (0 mismatches)."""
    import torch

    from hope_tpu_torch.config import EnvConfig
    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.envs.dlp import DLPDataset

    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    env = ParkingEnv(cfg, device=dev)
    ds = DLPDataset(env_cfg=cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scenes = ds.batch_reset(torch.arange(8, device=dev) * 31, gen)
    i = 3
    with hold_kernel_calls(1) as held:
        bs, bo = env.batch_reset(scenes)
        launches = {name: 0 for name in kernels}

        def single(fn, *args):
            """``fn(*args)``, counting the launches it makes."""
            for r in kernels.values():
                r["mod"].KERNEL.launches = 0
            out = fn(*args)
            for name, r in kernels.items():
                launches[name] += r["mod"].KERNEL.launches
            return out

        ss, so = single(env.reset, scenes.map(lambda x: x[i]))
        gaps, bad = {"obs": 0.0, "reward": 0.0, "pose": 0.0}, []

        def obs_gap(single, batch):
            return max(float((single[k].float() - batch[k][i].float()).abs().max()) for k in single)

        gaps["obs"] = obs_gap(so, bo)
        actions = torch.tensor([[0.3, 1.5], [0.3, 1.5], [-0.5, 2.0], [0.0, -1.0], [0.6, 2.5],
                                [-0.2, 1.0], [0.0, 2.0], [0.4, -2.0]], device=dev)
        steps = 0
        for a in actions:
            bs, bo, br, bd, bi = env.batch_step(bs, a.expand(8, 2).contiguous())
            ss, so, sr, sd, si = single(env.step, ss, a)
            steps += 1
            gaps["obs"] = max(gaps["obs"], obs_gap(so, bo))
            gaps["reward"] = max(gaps["reward"], float((sr - br[i]).abs()))
            gaps["pose"] = max(gaps["pose"], float((ss.vehicle.pose - bs.vehicle.pose[i])
                                                  .abs().max()))
            if int(si["status"]) != int(bi["status"][i]) or bool(si["rs"].found) != bool(
                    bi["rs"].found[i]):
                bad.append(f"step {steps}: status or RS found differs")
            if bool(sd):
                break
    torch.cuda.synchronize()
    want = {name: (steps if name == "swept_collide" else steps + 1) for name in kernels}
    emit({"phase": "single_env", "steps": steps, "max_abs": gaps, "launches": launches,
          "held": held})
    bad += [f"{name} {h}" for name, h in held.items()
            if h["mismatches"] or h["held"] != h["calls"] or h["batch"] != [1, 8]]
    if bad or launches != want or not all(v <= 1e-5 for v in gaps.values()):
        raise AssertionError(f"single_env: {bad}, launches {launches} want {want}, {gaps}")


def on_path(path: str, fn, *args, **kw):
    """``fn(*args, **kw)``, the iLQR kernel's launch count set to 0 just
    before it and kept after it as ILQR_LAUNCHES[path]."""
    from hope_tpu_torch.ops import ilqr_solve

    ilqr_solve.KERNEL.launches = 0
    out = fn(*args, **kw)
    ILQR_LAUNCHES[path] = ilqr_solve.KERNEL.launches
    return out


def ilqr_kernel_line(rec: dict) -> dict:
    """The iLQR kernel's entry of the kernels line, from phase ilqr_kernel's
    B = 256 record and ILQR_LAUNCHES. It is held to solve_batch within
    stated bounds, not bit for bit, so max_abs_err is None and ``held``
    gives the first iteration's gaps."""
    first = rec["kernel_vs_plain"]
    return {"name": "ilqr_solve", "route": "cuda", "source": "hope_tpu_torch/csrc/ilqr_solve.cu",
            "replaces": "hope_tpu_torch/planning/ilqr.py solve_batch (no Pallas kernel)",
            "launches": ILQR_LAUNCHES["train"], "max_abs_err": None, "ms": rec["ms"],
            "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_ms_live": rec["bound_ms_live"],
            "bound_by": rec["bound_by"], "library_ms": None,
            "launches_by_path": dict(ILQR_LAUNCHES),
            "held": {k: first[k] for k in ("pick_rows_differ", "pick_rows_differ_untied",
                                           "cost_max_rel", "xs_max_abs", "us_max_abs")}}


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--mp-rank"]:               # one rank of phase mp_train
        mp_rank(json.loads(sys.argv[2]))
        return
    smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    kernels, mask_in, sweep_in = phase_kernels(dev)
    phase_parity(dev)
    env, agent, state = on_path("battery", phase_battery, dev, kernels)
    procedural = phase_kernel_procedural(dev, env, agent, state)
    phase_profile(dev, env, agent, state)
    phase_graph_step(dev, env, agent, state)
    real = phase_real_steps(dev, env, agent, state)
    phase_probe(mask_in, {"kernel phase": sweep_in,
                          **{f"battery step {k}": v for k, v in real.items()}})
    loop = on_path("train", phase_train, dev, kernels)
    phase_profile_train(loop)
    phase_train_parity(dev, loop)
    # free the SAC run (its replay ring is 2.6 GB; the loop's closures hold
    # it in a reference cycle) before the PPO phases measure peak memory
    del loop
    gc.collect()
    on_path("ppo_battery", phase_ppo_battery, dev, kernels)
    ppo_loop = on_path("ppo_train", phase_ppo_train, dev, kernels)
    phase_ppo_parity(dev, ppo_loop)
    del ppo_loop
    gc.collect()
    phase_ppo_extrem(dev)
    mpc_kern = phase_mpc_kernel(dev)
    ilqr_rec = on_path("ilqr_kernel", phase_ilqr_kernel, dev)
    phase_mpc_battery(dev, kernels)
    on_path("mpc_parity", phase_mpc_parity, dev)
    on_path("mpc_profile", phase_mpc_profile, dev)
    ae_ckpt, ae_held = on_path("ae_pretrain", phase_ae_pretrain, dev, kernels)
    phase_ae_graft(dev, kernels, ae_ckpt)
    shutil.rmtree(os.path.dirname(ae_ckpt))
    phase_resume(dev, kernels)
    on_path("stream_dlp_train", phase_stream_dlp, dev, kernels)
    phase_eval_pictures(dev)
    phase_single_env(dev, kernels)
    phase_mp_train(dev, kernels)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None,
         "launches_by_path": {"train": r["launches"], "battery": r["launches_battery"],
                              "ppo_train": r["launches_ppo_train"],
                              "ppo_battery": r["launches_ppo_battery"],
                              "mpc_battery": r["launches_mpc_battery"],
                              "ae_pretrain": r["launches_ae_pretrain"],
                              "stream_dlp_train": r["launches_stream_dlp_train"],
                              "mp_train_rank0": r["launches_mp_train"]},
         "procedural": {k: procedural[name][k] for k in
                        ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}}
        for name, r in kernels.items()] + [ilqr_kernel_line(ilqr_rec[EPISODES])]}
    for k in line["kernels"]:
        if k["name"] in ae_held:
            k["ae_pretrain"] = {f: ae_held[k["name"]][f] for f in
                                ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by")}
    sweep = next(k for k in line["kernels"] if k["name"] == "swept_collide")
    sweep["mpc"] = {k: {f: v[f] for f in ("shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by")} for k, v in mpc_kern.items()}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"records": RECORDS, "kernels": line["kernels"], "nvidia_smi": smi}, f,
                  indent=1, default=str)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
