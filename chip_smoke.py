"""Run the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per level, chunk or kernel):
  1. device  - CUDA must be available; the card's name and power limit.
  2. build   - nvcc builds the three CUDA kernels from hope_tpu_torch/csrc.
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
               for 2 chunks: per chunk wall time split into collect and
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
 16. ppo_extrem - the r5 PPO actor's Extrem level at 1024 episodes, beside
               the TPU run's 256 (a record, not a gate).
 17. mpc_kernel - swept_collide against its plain version on what the MPC
               path gives it on 256 DLP scenes: the staging precompute's
               first polar chunk (K = 6) and first template chunk, and the
               first replan's warm start (K = 12); 0 mismatches, times, bound.
 18. mpc_battery - hope_tpu_torch.planning.mpc.main, the CLI, on DLP,
               Normal, Complex and Extrem at its defaults with --portfolio
               (256 episodes, H = 40, 12 iLQR iterations, replan 8 then 4,
               12 RS words, 6 staging words): success (floors MPC_FLOORS, no
               collision), RS and waypoint latches, staging seconds and
               coverage, each battery's seconds, plan latency and QP
               solves/s, launches per part (no mask or raster launch).
 19. mpc_parity - 8 Normal scenes, staging and 2 replans of the runner on
               the card and on the CPU: staging valid sets and discrete
               outcomes equal; the first replan's warm-start controls, cost
               and derivatives within stated bounds; the CUDA-graph solve
               equal to the eager one.
 20. mpc_profile - torch.profiler over 2 replan cycles of the DLP runner:
               busy share, device activities and HtoD copies per replan and
               per control step.
Then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Details (nvcc/ptxas output, every record) go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

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


def emit(rec: dict):
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
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
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
    """Each kernel on these inputs against its plain version (0 mismatches or
    raise), timed (``ms``, ``device_ms``, ``plain_ms``) beside its bound; one
    record per kernel under ``phase``. Returns {name: record and outputs}."""
    import torch

    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

    out = {}

    # --- mask_step_lengths
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
    out["mask_step_lengths"] = dict(
        mod=mask_steps, kernel_out=k, plain_out=p, nbytes=nbytes, ops=ops,
        ms=cuda_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), reps),
        device_ms=device_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), reps),
        plain_ms=cuda_ms(lambda: mask_steps.mask_step_lengths_plain(ext, table, n_iter, up), 5),
        source="hope_tpu_torch/csrc/mask_steps.cu",
        replaces="hope_tpu/ops/mask_steps.py:50")

    # --- render_bev_batch, the whole function (exact per-polygon parity, the
    # battery's mode), and the global even-odd mode held to its plain version
    render, render_plain = raster_bev.render_bev_batch, raster_plain(raster_bev)
    k = render(*raster_in)
    p = render_plain(*raster_in)
    glob = int((render(*raster_in, exact=False) != render_plain(*raster_in, exact=False)).sum())
    torch.cuda.synchronize()
    nbytes, ops, data = raster_work(*raster_in)
    acts = {}
    out["raster_bev"] = dict(
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

    # --- swept_collide
    car, live4, edges, emask = sweep_in
    k = sweep_collide.swept_collide(car, live4, edges, emask)
    p = sweep_collide.swept_collide_plain(car, live4, edges, emask)
    torch.cuda.synchronize()
    seg_hit = sweep_collide.swept_collide_plain(car, live4, edges, emask,
                                                per_segment=True)  # (B, K, S)
    if not torch.equal(seg_hit.any(-1), p):
        raise AssertionError("swept_collide: per-segment plain disagrees with plain")
    nbytes, ops = sweep_work(live4, edges, emask, seg_hit)
    out["swept_collide"] = dict(
        mod=sweep_collide, kernel_out=k, plain_out=p, nbytes=nbytes, ops=ops,
        ms=cuda_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), reps),
        device_ms=device_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), reps),
        plain_ms=cuda_ms(lambda: sweep_collide.swept_collide_plain(car, live4, edges, emask), 3),
        source="hope_tpu_torch/csrc/sweep_collide.cu",
        replaces="hope_tpu/ops/sweep_collide.py:76",
        data=sweep_data(live4, emask, seg_hit))

    for name, r in out.items():
        mism = int((r["kernel_out"] != r["plain_out"]).sum())
        err = float((r["kernel_out"].float() - r["plain_out"].float()).abs().max())
        r["mismatches"], r["max_abs_err"] = mism, err
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["ops"])
        emit({"phase": phase, "name": name, "B": int(ext.shape[0]), "mismatches": mism,
              "max_abs_err": err, "ms": r["ms"], "device_ms": r["device_ms"],
              "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
              "bound_by": r["bound_by"], "bytes": r["nbytes"], "ops": r["ops"],
              **({"data": r["data"]} if "data" in r else {})})
        if mism:
            raise AssertionError(f"{phase} {name}: kernel and plain version differ in "
                                 f"{mism} places")
    return out


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


def record_kernel_inputs(run, at):
    """Run ``run()`` with the three kernels' call sites recorded: returns
    {kernel name: inputs of its ``at``-th call (from 0)}."""
    from hope_tpu_torch.envs import action_mask, env as env_mod
    from hope_tpu_torch.planning import rs_select

    sites = {"mask_step_lengths": (action_mask, "mask_step_lengths"),
             "raster_bev": (env_mod, "render_bev_batch"),
             "swept_collide": (rs_select, "swept_collide")}
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
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
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

    log_dir = os.path.join(OUT_DIR, "train")
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
    # the agent checkpoint main writes at exit (tens of MB): checked, then
    # dropped so that the output directory stays small
    ckpt = os.path.join(log_dir, "ckpt")
    ckpt_bytes = os.path.getsize(os.path.join(ckpt, f"step_{TRAIN_CHUNKS}", "state.pt"))
    shutil.rmtree(ckpt)
    total = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    for name, n in total.items():
        kernels[name]["launches"] = n
    warm = [r["seconds"] for r in recs if r["warmup"]][1:]          # chunk 1 builds caches
    upd = [r for r in recs if not r["warmup"]]
    collect_s = sum(warm) / len(warm)
    emit({"phase": "train", "B": TRAIN_B, "K": TRAIN_K, "U": TRAIN_U, "chunks": len(recs),
          "main_seconds": wall, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "checkpoint_bytes": ckpt_bytes,
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
    # record_function ranges (the chunk's own and Adam's) also show on the
    # device's timeline, as spans over the kernels they launched: they are
    # not device work
    annot = [e for e in events if e.device_type == cuda and (
        getattr(e, "is_user_annotation", False)
        or e.name.startswith(("sac_chunk/", "Optimizer.")))]
    annot_ids = {id(e) for e in annot}
    kern = [e for e in events if e.device_type == cuda and id(e) not in annot_ids]
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
PPO_B, PPO_T, PPO_EPOCHS, PPO_MB, PPO_CHUNKS = 64, 128, 10, 32, 2


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
    """hope_tpu_torch.train.train_ppo.main at the defaults for 2 chunks: per
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
    cuda = torch.autograd.DeviceType.CUDA
    kern = [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(("ppo_chunk/", "Optimizer."))]
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
    collision, or on a mask or raster launch (this path has neither)."""
    import torch

    from hope_tpu_torch.planning import mpc, staging

    torch.backends.cuda.matmul.allow_tf32 = False
    plain_runner, plain_staging = mpc.build_mpc_runner, staging.compute_staging
    parts = []

    def counts():
        return {name: r["mod"].KERNEL.launches for name, r in kernels.items()}

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

    total = dict.fromkeys(kernels, 0)
    results = {}
    mpc.build_mpc_runner = runner
    staging.compute_staging = lambda *a, **kw: timed("staging", plain_staging, *a, **kw)
    try:
        for level in MPC_LEVELS:
            parts.clear()
            for r in kernels.values():
                r["mod"].KERNEL.launches = 0
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
    for name, n in total.items():
        kernels[name]["launches_mpc_battery"] = n
    bad = {lv: r["success_rate"] for lv, r in results.items() if r["success_rate"] < MPC_FLOORS[lv]}
    bad.update({f"{lv} collided": r["collided"] for lv, r in results.items() if r["collided"] > 0})
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
# dth). On the card the runner's CUDA-graph solve must equal the eager solve
# exactly. Then 2 replans (16 control steps) of the runner on each device:
# discrete outcomes equal. The solve itself is not held card vs CPU: it is
# chaotic at these weights (on the CPU alone, moving the iterate by 1e-6
# changes the line search's candidate costs by up to ~100x within a few
# iterations).
MPC_PARITY_B, MPC_PARITY_STEPS = 8, 16


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
    with torch.no_grad():
        eager = ilqr.solve_batch(*card_args, icfg, vcfg)
        graphed = ilqr.ILQRSolver(icfg, vcfg)(*card_args)
    graph_equal = all(torch.equal(a, b) for a, b in zip(eager, graphed))
    c, g = runs["cpu"], runs[dev]
    valid = torch.isfinite(c["L"])
    rec = {"phase": "mpc_parity", "B": MPC_PARITY_B, "steps": MPC_PARITY_STEPS,
           "staging_valid_mismatches": int((valid != torch.isfinite(g["L"])).sum()),
           "staging_L_max_abs": float((c["L"][valid] - g["L"][valid]).abs().max()),
           "warm_start_found_mismatches": warm_found, "warm_start_us_max_abs": warm_us,
           "warm_start_cost_max_rel": warm_cost_rel, "derivative_gap_over_bound": gaps,
           "graph_equals_eager": graph_equal,
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
    if not graph_equal:
        bad.append("graphed solve")
    if bad:
        raise AssertionError(f"mpc_parity: card and CPU disagree on {bad}")


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
    run(scenes, st)                      # warm-up, and the iLQR solve's graph capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(scenes, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    annot = [e for e in events if e.device_type == cuda and (
        getattr(e, "is_user_annotation", False) or e.name.startswith("mpc/"))]
    annot_ids = {id(e) for e in annot}
    kern = [e for e in events if e.device_type == cuda and id(e) not in annot_ids]
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
    """The r5 PPO actor's Extrem level at 1024 episodes (a record, not a
    gate), beside the TPU run's results/eval_ppo_r5/result_Extrem.json
    (256 episodes: success 0.91015625, success steps 47.18454935622318, mean
    steps 60.9140625, RS latched 0.58984375)."""
    import torch

    from hope_tpu_torch.evaluation.eval_mix_scene import build, run_battery

    torch.backends.cuda.matmul.allow_tf32 = False
    env, agent, state = build(os.path.join(ROOT, "hope_tpu_torch", "assets", "ppo_r5_actor.npz"),
                              dev, "ppo")
    res = run_battery(env, agent, state, "ppo", episodes=4 * EPISODES, max_steps=MAX_STEPS,
                      out=None, seed=0, levels=["Extrem"])["Extrem"]
    lv = res["per_level"]["Extrem"]
    n, p = 4 * EPISODES, res["success_rate"]
    tpu = 0.91015625
    se = math.sqrt(p * (1 - p) / n + tpu * (1 - tpu) / EPISODES)
    emit({"phase": "ppo_extrem", "episodes": n, "success_rate": p,
          "success_steps_mean": res["success_steps_mean"], "steps_mean": lv["steps_mean"],
          "rs_latched": lv["rs_latched"], "collided": lv["collided"],
          "rollout_seconds": res["rollout_seconds"],
          "tpu_256": {"success_rate": tpu, "success_steps_mean": 47.18454935622318,
                      "steps_mean": 60.9140625, "rs_latched": 0.58984375},
          "difference_in_standard_errors": (p - tpu) / se})


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    sys.path.insert(0, ROOT)
    smi = phase_device()
    import torch

    dev = torch.device("cuda", 0)
    phase_build()
    kernels, mask_in, sweep_in = phase_kernels(dev)
    phase_parity(dev)
    env, agent, state = phase_battery(dev, kernels)
    procedural = phase_kernel_procedural(dev, env, agent, state)
    phase_profile(dev, env, agent, state)
    real = phase_real_steps(dev, env, agent, state)
    phase_probe(mask_in, {"kernel phase": sweep_in,
                          **{f"battery step {k}": v for k, v in real.items()}})
    loop = phase_train(dev, kernels)
    phase_profile_train(loop)
    phase_train_parity(dev, loop)
    # free the SAC run (its replay ring is 2.6 GB; the loop's closures hold
    # it in a reference cycle) before the PPO phases measure peak memory
    del loop
    gc.collect()
    phase_ppo_battery(dev, kernels)
    ppo_loop = phase_ppo_train(dev, kernels)
    phase_ppo_parity(dev, ppo_loop)
    del ppo_loop
    gc.collect()
    phase_ppo_extrem(dev)
    mpc_kern = phase_mpc_kernel(dev)
    phase_mpc_battery(dev, kernels)
    phase_mpc_parity(dev)
    phase_mpc_profile(dev)
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": None,
         "launches_by_path": {"train": r["launches"], "battery": r["launches_battery"],
                              "ppo_train": r["launches_ppo_train"],
                              "ppo_battery": r["launches_ppo_battery"],
                              "mpc_battery": r["launches_mpc_battery"]},
         "procedural": {k: procedural[name][k] for k in
                        ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}}
        for name, r in kernels.items()]}
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
