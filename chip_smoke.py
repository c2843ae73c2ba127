"""Run the PyTorch port once on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each printing one JSON line:
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
  5. battery - the DLP evaluation battery of the committed SAC actor
               (hope_tpu_torch/assets/sac_r3b_actor.npz): 256 episodes, 200
               steps, TF32 off; every kernel must have launched, and the
               success rate must be >= 0.95.
  6. profile - torch.profiler over a few battery steps: device busy share,
               device activities and host-to-device copies per step, device
               time by kernel (trace to chiprun_out/battery_trace.json).
  7. kernel_real_step - swept_collide on the inputs the battery's own
               rollout gives it at steps 1, 10, 50 and 150 (the rollout is run
               again from the battery's seed with the call recorded): what
               share of words collide and where they first hit, the times,
               and exactness against the plain version.
  8. probe   - the sweep on subsets of its words (only the colliding ones,
               only the clear ones, one word per env), for the kernel phase's
               inputs and for each recorded step; the mask kernel at B = 8
               and 64.
Then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failure raises and exits non-zero.
Details (nvcc/ptxas output, every record) go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
EPISODES = 256
MAX_STEPS = 200
MIN_SUCCESS = 0.95
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


def phase_kernels(dev):
    import torch

    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

    mask_in, raster_in, sweep_in = kernel_inputs(dev)
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
        ms=cuda_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), 50),
        device_ms=device_ms(lambda: mask_steps.mask_step_lengths(ext, table, n_iter, up), 50),
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
        ms=cuda_ms(lambda: render(*raster_in), 50),
        device_ms=device_ms(lambda: render(*raster_in), 50, kinds=acts),
        plain_ms=cuda_ms(lambda: render_plain(*raster_in), 3),
        source="hope_tpu_torch/csrc/raster_bev.cu",
        replaces="hope_tpu/ops/raster_bev.py:306",
        data=dict(data, global_mode_mismatches=glob, device_activities_per_call=acts,
                  htod_copies_per_call=sum(c for a, c in acts.items() if "HtoD" in a)))
    if glob:
        raise AssertionError(f"render_bev_batch, global parity: {glob} mismatches")

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
        ms=cuda_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), 50),
        device_ms=device_ms(lambda: sweep_collide.swept_collide(car, live4, edges, emask), 50),
        plain_ms=cuda_ms(lambda: sweep_collide.swept_collide_plain(car, live4, edges, emask), 3),
        source="hope_tpu_torch/csrc/sweep_collide.cu",
        replaces="hope_tpu/ops/sweep_collide.py:76",
        data=sweep_data(live4, emask, seg_hit))

    for name, r in out.items():
        mism = int((r["kernel_out"] != r["plain_out"]).sum())
        err = float((r["kernel_out"].float() - r["plain_out"].float()).abs().max())
        r["mismatches"], r["max_abs_err"] = mism, err
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["ops"])
        emit({"phase": "kernel", "name": name, "mismatches": mism, "max_abs_err": err,
              "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
              "bound_ms": r["bound_ms"],
              "bound_by": r["bound_by"], "bytes": r["nbytes"], "ops": r["ops"],
              **({"data": r["data"]} if "data" in r else {})})
        if mism:
            raise AssertionError(f"{name}: kernel and plain version differ in {mism} places")

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
    import torch

    from hope_tpu_torch.evaluation.eval_mix_scene import build, run_battery

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env, agent, state = build(os.path.join(ROOT, "hope_tpu_torch", "assets",
                                           "sac_r3b_actor.npz"), dev)
    for r in kernels.values():
        r["mod"].KERNEL.launches = 0
    res = run_battery(env, agent, state, episodes=EPISODES, max_steps=MAX_STEPS,
                      out=os.path.join(OUT_DIR, "eval_dlp"), seed=0)["dlp"]
    launches = {name: r["mod"].KERNEL.launches for name, r in kernels.items()}
    wall = res["rollout_seconds"]        # the rollout alone, set-up excluded
    emit({"phase": "battery", "level": "dlp", "episodes": EPISODES, "max_steps": MAX_STEPS,
          "success_rate": res["success_rate"], "per_level": res["per_level"],
          "success_steps_mean": res["success_steps_mean"], "rollout_seconds": wall,
          "env_steps_per_s": EPISODES * MAX_STEPS / wall, "launches": launches})
    for name, n in launches.items():
        kernels[name]["launches"] = n
        if n <= 0:
            raise AssertionError(f"{name}: no launch on the battery's path")
    if res["success_rate"] < MIN_SUCCESS:
        raise AssertionError(f"DLP success {res['success_rate']} < {MIN_SUCCESS}")
    return env, agent, state


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
    phase_profile(dev, env, agent, state)
    real = phase_real_steps(dev, env, agent, state)
    phase_probe(mask_in, {"kernel phase": sweep_in,
                          **{f"battery step {k}": v for k, v in real.items()}})
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": r["source"], "replaces": r["replaces"],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "device_ms": r["device_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"],
         "library_ms": None}
        for name, r in kernels.items()]}
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
