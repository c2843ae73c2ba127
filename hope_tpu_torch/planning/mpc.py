"""Pure-MPC parking evaluation: Reeds-Shepp warm start + batched iLQR
receding-horizon refinement, rolled out in the real environment
(counterpart of ``hope_tpu/planning/mpc.py``).

Every ``replan_every`` control steps the runner searches an RS path from each
env's pose (the warm start, through the sweep kernel), refines the plan with
``ilqr.solve_batch`` toward a staging pose (``staging.pick_goal``) and
executes its first controls. A found RS plan is latched and executed as it
stands through the endgame, and each replan also tries a two-segment latch
through a staging pose (``staging.waypoint_latch``); the RS endgame search
runs again after every control step. Finished envs freeze in place.

Where the reference jits a pair of nested scans, this runner is a Python loop
over replans and steps on (B, ·) tensors, with no read of a device value in
the loop; on the card the iLQR solve replays as a CUDA graph
(``ilqr.ILQRSolver``).

Reported metrics: the success rate of the battery (arrival = 95% slot
overlap); QP solves/s (one iLQR iteration is one horizon-long Riccati QP
solve per scenario, so a ``solve_batch`` call performs B x n_iters of them);
p50 / p99 plan latency, the wall time of one replan cycle (RS search + iLQR
solve) for the whole batch and for one scenario.

Usage: python -m hope_tpu_torch.planning.mpc --episodes 256 --out log/mpc
       python -m hope_tpu_torch.planning.mpc --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..agents.hybrid import HybridState, latch
from ..config import EnvConfig, ObsConfig
from ..device import resolve_device
from ..envs import ParkingEnv
from ..envs.env import select
from ..envs.rewards import ARRIVED, CONTINUE
from ..utils.profiling import annotate
from .ilqr import ILQRConfig, ILQRSolver
from .rs_select import build_action_queue, find_path_batch
from .staging import pick_goal, waypoint_latch


def rs_warm_start(env: ParkingEnv, poses, scenes, horizon: int):
    """Batched RS plan from the current poses -> (us (B, H, 2) physical
    controls, rs: RSPath). Envs without a collision-free RS path get zero
    controls (the iLQR then plans from scratch)."""
    cfg = env.cfg
    rs = find_path_batch(poses, scenes.dest, cfg.vehicle.max_curvature, env.corners,
                         scenes.edges, scenes.edge_mask, scenes.bounds,
                         n_points=cfg.rs_max_points, step_m=cfg.rs_step_size,
                         max_tries=cfg.rs_max_tries)
    q, _ = build_action_queue(rs, cfg.step_ratio, horizon)
    return q * env._scale, rs


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_mpc_runner(env: ParkingEnv, ilqr_cfg: ILQRConfig, replan_every: int = 8,
                     max_steps: int = 200, rs_exec: bool = True, step_rs: bool = True,
                     use_staging: bool = True):
    """Receding-horizon episode runner over a scene batch:
    ``run(scenes, staging=None)`` -> metrics dict of (B,) tensors.

    Every ``replan_every`` control steps: batched RS search -> ``solve_batch``
    warm-started from the RS plan (or the shifted previous plan). With
    ``rs_exec`` a found RS plan is latched and executed verbatim through the
    endgame; the iLQR drives the approach. ``step_rs`` runs the RS endgame
    search after every control step, not only at replans. ``use_staging``
    (with a StagingSet given) aims the iLQR at the best staging pose instead
    of the slot and tries a two-segment latch each replan, sliding its window
    of candidates down the ranking on odd replans.
    """
    H = ilqr_cfg.horizon
    M = replan_every
    n_outer = max(1, max_steps // M)
    q_len = max(64, H)
    step_ratio = env.cfg.step_ratio
    solve = ILQRSolver(ilqr_cfg, env.cfg.vehicle)

    @torch.no_grad()
    def run(scenes, staging=None):
        dev = scenes.dest.device
        B = scenes.dest.shape[0]
        c = {"state": env._init_state(scenes),
             "hybrid": HybridState.create(B, q_len, dev),
             "finished": torch.zeros(B, dtype=torch.bool, device=dev),
             "steps": torch.zeros(B, dtype=torch.int32, device=dev),
             "path_len": torch.zeros(B, device=dev),
             "status": torch.full((B,), CONTINUE, dtype=torch.int32, device=dev),
             "ever_rs": torch.zeros(B, dtype=torch.bool, device=dev),
             "ever_way": torch.zeros(B, dtype=torch.bool, device=dev)}
        us_prev = torch.zeros((B, H, 2), device=dev)
        staged = use_staging and staging is not None
        res = None
        for t in range(n_outer):
            with annotate("mpc/replan"):
                pose = c["state"].vehicle.pose
                us_rs, rs = rs_warm_start(env, pose, scenes, H)
                found = rs.found & ~c["finished"]
                c["ever_rs"] = c["ever_rs"] | found
                if rs_exec:
                    c["hybrid"] = latch(c["hybrid"], rs._replace(found=found), step_ratio)
                if rs_exec and staged:
                    # even replans try the 4 cheapest valid staging
                    # candidates; odd replans slide the window deeper
                    # (offsets 4..20), so a stuck env cycles through the 24
                    # cheapest
                    off = 0 if t % 2 == 0 else 4 * (((t // 2) % 5) + 1)
                    c["hybrid"], wl = waypoint_latch(env, staging, pose, scenes, c["hybrid"],
                                                     ~c["finished"], step_ratio, offset=off)
                    c["ever_way"] = c["ever_way"] | wl
                us_shift = torch.cat([us_prev[:, M:], torch.zeros((B, M, 2), device=dev)], dim=1)
                us_init = torch.where(found[:, None, None], us_rs, us_shift)
                goal = pick_goal(staging, pose, scenes.dest)[0] if staged else scenes.dest
                res = solve(pose, goal, scenes.edges, scenes.edge_mask, us_init)
            for i in range(M):
                with annotate("mpc/step"):
                    step(c, res.us[:, i])
            us_prev = res.us
        s = c["status"]
        return {"success": s == ARRIVED, "steps": c["steps"], "path_length": c["path_len"],
                "status": s, "finished": c["finished"], "rs_latched": c["ever_rs"],
                "way_latched": c["ever_way"], "level": scenes.level,
                "case_id": scenes.case_id, "final_cost": res.cost}

    def step(c, u_t):
        """One control step of the batch, in place on the carry ``c``: the
        latched plan's control where one is executing, else the iLQR's."""
        hybrid = c["hybrid"]
        if rs_exec:
            ex = hybrid.executing
            u_t = torch.where(ex[:, None], hybrid.queued() * env._scale, u_t)
            hybrid = replace(hybrid, cursor=torch.where(ex, hybrid.cursor + 1, hybrid.cursor))
        state = c["state"]
        new_state, _, done, info = env._transition(state, u_t)
        moved = torch.linalg.norm(new_state.vehicle.pose[:, :2] - state.vehicle.pose[:, :2],
                                  dim=-1)
        active = ~c["finished"]
        c["steps"] = c["steps"] + active.to(torch.int32)
        c["path_len"] = c["path_len"] + torch.where(active, moved, 0.0)
        c["status"] = torch.where(active & done, info["status"], c["status"])
        finished = c["finished"] | done
        if rs_exec and step_rs:
            # the endgame search after every control step
            srs = env._batch_rs(new_state)
            sfound = srs.found & ~finished
            c["ever_rs"] = c["ever_rs"] | sfound
            hybrid = latch(hybrid, srs._replace(found=sfound), step_ratio)
        # an env that finished (this step too) keeps its state
        c["state"] = select(finished, state, new_state)
        c["finished"], c["hybrid"] = finished, hybrid

    return run


def _plan_cycle_fn(env: ParkingEnv, ilqr_cfg: ILQRConfig):
    """One warm replan cycle (RS search + iLQR refinement): the unit whose
    latency the p50 / p99 metrics measure."""
    solve = ILQRSolver(ilqr_cfg, env.cfg.vehicle)

    @torch.no_grad()
    def cycle(poses, scenes):
        us, rs = rs_warm_start(env, poses, scenes, ilqr_cfg.horizon)
        res = solve(poses, scenes.dest, scenes.edges, scenes.edge_mask, us)
        return res.us, res.cost, rs

    return cycle


def measure_plan_latency(env, ilqr_cfg, scenes, n_calls: int = 20):
    """p50 / p99 wall latency of a warm plan cycle, and the QP-solve rate it
    gives (the device synchronized at each end of every call)."""
    cycle = _plan_cycle_fn(env, ilqr_cfg)
    poses = scenes.start
    dev = poses.device
    cycle(poses, scenes)                                  # warm-up
    _sync(dev)
    times = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        cycle(poses, scenes)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    B = int(scenes.dest.shape[0])
    return {
        "batch": B,
        "p50_s": float(np.percentile(times, 50)),
        "p99_s": float(np.percentile(times, 99)),
        "qp_solves_per_sec": B * ilqr_cfg.n_iters / float(np.median(times)),
    }


def mpc_env_config(no_dlp: bool = False, rs_tries: int | None = None,
                   rs_points: int | None = None) -> EnvConfig:
    """The CLI's env: no image, no action mask, 96 edges / 32 polygons on
    procedural scenes or 512 / 128 on DLP, and 12 RS words tried (the CLI's
    wider endgame search) unless ``rs_tries`` says otherwise."""
    overrides = {"rs_max_tries": 12 if rs_tries is None else rs_tries}
    if rs_points is not None:
        overrides["rs_max_points"] = rs_points
    return EnvConfig(obs=ObsConfig(use_img=False, use_action_mask=False),
                     max_edges=96 if no_dlp else 512, max_obstacles=32 if no_dlp else 128,
                     **overrides)


def mpc_ilqr_config(env_cfg: EnvConfig, horizon: int = 40, n_iters: int = 12) -> ILQRConfig:
    """The CLI's parking-tuned iLQR weights: arrival needs 95% slot overlap,
    so terminal precision dominates and running / control costs stay small."""
    return ILQRConfig(horizon=horizon, dt=env_cfg.vehicle.dt * env_cfg.vehicle.n_substep,
                      n_iters=n_iters, w_terminal_pos=300.0, w_terminal_heading=80.0,
                      w_running_pos=0.05, w_control=0.05, w_steer_rate=0.2)


def battery_scenes(env_cfg: EnvConfig, level: str, episodes: int, generator: torch.Generator,
                   device):
    """The CLI's scenes: a procedural bank of ``level`` (or DLP cases
    ``arange(episodes) % n_cases`` where level is "dlp"), padded to the env's
    edge budget."""
    from ..envs.dlp import DLPDataset
    from ..envs.scenario_gen import generate_bank
    from ..train.scene_pool import pad_scene_batch

    if level == "dlp":
        ds = DLPDataset(env_cfg=env_cfg, device=device)
        scenes = ds.batch_reset(torch.arange(episodes) % ds.n_cases, generator)
    else:
        scenes, _ = generate_bank(generator, level=level, n=episodes)
    return pad_scene_batch(scenes, env_cfg.max_edges, env_cfg.max_obstacles)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--replan-every", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=40)
    ap.add_argument("--ilqr-iters", type=int, default=12)
    ap.add_argument("--rs-tries", type=int, default=None,
                    help="override rs_max_tries (candidate RS words collision-checked per "
                         "endgame search; the CLI's default is 12)")
    ap.add_argument("--rs-points", type=int, default=None,
                    help="override rs_max_points (discretization budget per candidate; caps "
                         "the validatable path length at rs_points * rs_step_size metres)")
    ap.add_argument("--no-dlp", action="store_true",
                    help="procedural battery instead of DLP mixed")
    ap.add_argument("--level", type=str, default="Normal",
                    choices=["Normal", "Complex", "Extrem"],
                    help="procedural battery difficulty (with --no-dlp)")
    ap.add_argument("--no-rs-exec", action="store_true",
                    help="ablation: refine and execute iLQR controls everywhere instead of "
                         "executing latched RS plans verbatim")
    ap.add_argument("--no-step-rs", action="store_true",
                    help="ablation: search the RS endgame only at replan boundaries instead "
                         "of every control step")
    ap.add_argument("--no-staging", action="store_true",
                    help="ablation: iLQR targets the slot pose directly instead of the best "
                         "staging pose with a verified completion")
    ap.add_argument("--staging-tries", type=int, default=6,
                    help="RS words collision-checked per staging candidate")
    ap.add_argument("--portfolio", action="store_true",
                    help="after the main battery, re-run it at half the replan cadence and "
                         "take the per-scene union")
    ap.add_argument("--out", type=str, default="log/mpc")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.episodes, args.max_steps, args.horizon = 4, 24, 16
        args.replan_every, args.ilqr_iters = 8, 3

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # float32 products in full precision, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
    env_cfg = mpc_env_config(args.no_dlp, args.rs_tries, args.rs_points)
    env = ParkingEnv(env_cfg, device=dev)
    ilqr_cfg = mpc_ilqr_config(env_cfg, args.horizon, args.ilqr_iters)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    battery = args.level if args.no_dlp else "dlp"
    scenes = battery_scenes(env_cfg, battery, args.episodes, gen, dev)

    os.makedirs(args.out, exist_ok=True)
    use_staging = not args.no_staging
    staging = None
    t_stag = 0.0
    if use_staging:
        from .staging import compute_staging

        _sync(dev)
        t0 = time.perf_counter()
        staging = compute_staging(env, scenes, max_tries=args.staging_tries)
        _sync(dev)
        t_stag = time.perf_counter() - t0

    def run_battery(replan_every):
        run = build_mpc_runner(env, ilqr_cfg, replan_every, args.max_steps,
                               rs_exec=not args.no_rs_exec, step_rs=not args.no_step_rs,
                               use_staging=use_staging)
        return {k: v.cpu().numpy() for k, v in run(scenes, staging).items()}

    t0 = time.perf_counter()
    metrics = run_battery(args.replan_every)
    if args.portfolio:
        alt = run_battery(max(1, args.replan_every // 2))
        newly = alt["success"] & ~metrics["success"]
        for k in ("success", "steps", "path_length", "status", "finished", "rs_latched",
                  "way_latched"):
            metrics[k] = np.where(newly, alt[k], metrics[k])
    t_ep = time.perf_counter() - t0

    from ..evaluation.evaluate import summarize, write_report
    from ..evaluation.render import save_record

    save_record(os.path.join(args.out, "record_mpc.npz"), metrics)
    summary = summarize(metrics, max_steps=args.max_steps)
    summary["episode_batch_seconds"] = round(t_ep, 3)
    summary["config"] = {"replan_every": args.replan_every, "horizon": args.horizon,
                         "ilqr_iters": args.ilqr_iters, "rs_tries": env_cfg.rs_max_tries,
                         "rs_points": env_cfg.rs_max_points, "step_rs": not args.no_step_rs,
                         "staging": use_staging, "portfolio": args.portfolio,
                         "battery": battery, "device": str(dev)}
    if use_staging:
        n_valid = torch.isfinite(staging.L).sum(1).cpu().numpy()
        summary["staging"] = {
            "precompute_seconds": round(t_stag, 3),
            "candidates": int(staging.L.shape[1]),
            "scenes_with_valid_staging": float((n_valid > 0).mean()),
            "mean_valid_candidates": float(n_valid.mean()),
        }

    n_calls = 3 if args.smoke else 20
    lat = measure_plan_latency(env, ilqr_cfg, scenes, n_calls=n_calls)
    one = scenes.map(lambda x: x[:1])
    lat1 = measure_plan_latency(env, ilqr_cfg, one, n_calls=n_calls)
    summary["plan_latency"] = {"batch": lat, "single": lat1}

    write_report(os.path.join(args.out, "result_mpc.json"), summary)
    print(json.dumps({"metric": "mpc_success_rate", "value": summary["success_rate"],
                      "unit": f"fraction ({args.episodes} "
                              f"{args.level if args.no_dlp else 'DLP'} "
                              f"episodes, RS warm start + iLQR)",
                      "qp_solves_per_sec": round(lat["qp_solves_per_sec"], 1),
                      "plan_p50_ms": round(lat["p50_s"] * 1e3, 2),
                      "plan_p50_ms_single": round(lat1["p50_s"] * 1e3, 2)}), flush=True)
    return summary


if __name__ == "__main__":
    main()
