"""PPO training entry point (counterpart of ``hope_tpu/train/train_ppo.py``):
each chunk collects T lockstep steps of B envs with the masked discrete
action projection and the hybrid RS takeover, then runs the full update of
the (T, B) buffer (``chunked.build_ppo_chunk``).

The flags, defaults, JSON log lines, ``config.json`` and best-checkpoint
gate are the JAX CLI's. ``--device`` picks the device (CUDA unless named).
``--resume`` restores the agent (networks, Adams, normalizer, update count)
from a checkpoint directory, as the JAX CLI does.

``--devices N`` trains on N data-parallel ranks, as ``train_sac`` does
(``parallel/launch.py``): each rank collects B / N envs, every rank holds the
whole (T, B) buffer, and the update's gradients are summed over the ranks
(``agents/ppo.py``). Rank 0 alone writes the log directory and runs
``--final-eval``.

Usage: python -m hope_tpu_torch.train.train_ppo --episodes 2000 --batch-envs 64
       python -m hope_tpu_torch.train.train_ppo --smoke --device cpu
       python -m hope_tpu_torch.train.train_ppo --smoke --device cpu --devices 2
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..agents import HybridState, PPOAgent
from ..config import EnvConfig, ObsConfig, PPOConfig, actor_net_config, critic_net_config
from ..envs import ParkingEnv
from ..parallel.launch import add_flags, check_flags, rank_group, run_ranks
from ..parallel.mesh import agree, barrier, shard_batch, shutdown
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.profiling import MetricsWriter, StepTimer
from .chunked import build_ppo_chunk, summarize_logs
from .curriculum import LEVELS, TARGET_SUCCESS, DlpCaseChoose, SceneChoose
from .scene_pool import ScenePool
from .train_sac import ResetQueueSampler


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=100000)
    ap.add_argument("--batch-envs", type=int, default=64)
    ap.add_argument("--buffer-steps", type=int, default=128,
                    help="T steps per update chunk (buffer = T x B)")
    ap.add_argument("--pool-per-level", type=int, default=256)
    ap.add_argument("--pool-refresh", type=int, default=10,
                    help="refresh the scene pool every N chunks")
    ap.add_argument("--no-img", action="store_true")
    ap.add_argument("--no-dlp", action="store_true")
    add_flags(ap)
    ap.add_argument("--lr-decay", type=str, default=None, choices=["linear", "exp"],
                    help="lr schedule over the Adams' step counts")
    ap.add_argument("--max-train-steps", type=int, default=1_000_000,
                    help="schedule horizon for --lr-decay (SGD steps)")
    ap.add_argument("--gradient-clip", action="store_true",
                    help="global-norm 0.5 clip of each network's gradients")
    ap.add_argument("--target-kl", type=float, default=None,
                    help="KL early-stop guard per buffer pass (e.g. 0.03)")
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--log-dir", type=str, default="log/ppo")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="stop after this much wall-clock time (0 = never)")
    ap.add_argument("--max-chunks", type=int, default=0,
                    help="stop after N chunks (0 = episode count only)")
    ap.add_argument("--resume", type=str, default=None,
                    help="agent checkpoint directory (<log-dir>/ckpt) to go on from")
    ap.add_argument("--final-eval", type=int, default=0,
                    help="run the 4-level eval battery with N episodes per level after "
                         "training; 0 disables")
    ap.add_argument("--no-tensorboard", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.argv = sys.argv[1:] if argv is None else list(argv)

    if args.smoke:
        args.episodes = 6
        args.batch_envs = max(4, 2 * args.devices)
        args.buffer_steps = 8
        args.pool_per_level = 4
        args.no_img = True
        args.no_dlp = True
    check_flags(ap, args, {"--batch-envs": args.batch_envs})
    return args


def main(argv=None, on_chunk=None):
    """Train; returns {"chunks": [per-chunk record], "loop": live objects}
    (None where the ranks were spawned processes).

    ``on_chunk(record, loop)``, where given, is called after each chunk with
    its record (chunk, seconds, episodes, steps, sgd_steps; across ranks the
    chunk's collectives too) and the loop's live objects (agent, state, env,
    pool, chunk_fn, metrics, logs, buffer, mesh, run_chunk); ``loop["buffer"]``
    and ``loop["logs"]`` are the last chunk's (T, B) buffer and logs.
    ``loop["run_chunk"]()`` runs one more chunk."""
    return run_ranks(parse_args(argv), rank_worker, on_chunk)


def rank_worker(args, rank: int, world: int, device, backend: str | None, on_chunk=None):
    """One rank of ``world`` (``rank_group``), training on ``device``: the
    whole run where ``world`` is 1. Returns as :func:`main`."""
    with rank_group(args.coordinator, rank, world, device, backend) as mesh:
        return _train(args, mesh, on_chunk)


def _train(args, mesh, on_chunk):
    dev = mesh.device
    root = mesh.rank == 0
    if dev.type == "cuda":
        # float32 products and convolutions in full precision, as on the CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    obs_cfg = ObsConfig(use_img=not args.no_img)
    env_cfg = EnvConfig(obs=obs_cfg, max_edges=96 if args.no_dlp else 512,
                        max_obstacles=32 if args.no_dlp else 128)
    env = ParkingEnv(env_cfg, device=dev)
    ppo_cfg = PPOConfig(mini_batch=32 if not args.smoke else 8,
                        mini_epoch=10 if not args.smoke else 2,
                        lr_decay=args.lr_decay, max_train_steps=args.max_train_steps,
                        gradient_clip=args.gradient_clip, target_kl=args.target_kl)
    agent = PPOAgent(actor_net_config(obs_cfg), critic_net_config(obs_cfg), ppo_cfg,
                     env.mask_table)
    ppo_state = agent.init(env.observation_shape, torch.Generator().manual_seed(args.seed), dev)
    if args.resume:
        load_checkpoint(args.resume, ppo_state)
        if root:
            print(json.dumps({"resumed": args.resume, "sgd_steps": ppo_state.steps}), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)

    pool = ScenePool(env_cfg, per_level=args.pool_per_level, include_dlp=not args.no_dlp,
                     seed=args.seed, device=dev)
    scene_chooser = SceneChoose(rng=np.random.default_rng(args.seed))
    dlp_chooser = None if args.no_dlp else DlpCaseChoose(rng=np.random.default_rng(args.seed + 1))
    queue_sampler = ResetQueueSampler(scene_chooser, pool, np.random.default_rng(args.seed + 2),
                                      dlp_chooser=dlp_chooser)

    B, T = args.batch_envs, args.buffer_steps
    R = B * T  # worst-case resets per chunk
    sgd_steps = ppo_cfg.mini_epoch * (R // ppo_cfg.mini_batch)

    # this rank's block of the envs; pool, agent and queue are replicated
    pool_idx = shard_batch(torch.as_tensor(queue_sampler.sample(B), device=dev), mesh)
    env_state, obs = env.batch_reset(pool.gather(pool_idx))
    hybrid = HybridState.create(B // mesh.world, env_cfg.rs_queue_len, dev)
    chunk_fn = build_ppo_chunk(env, agent, env_cfg.step_ratio, T, mesh)

    writer = None
    if root:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "config.json"), "w") as f:
            json.dump({"argv": args.argv,
                       "args": {k: v for k, v in vars(args).items() if k != "argv"},
                       "env": dataclasses.asdict(env_cfg), "ppo": dataclasses.asdict(ppo_cfg)},
                      f, indent=2, default=str)
        writer = MetricsWriter(args.log_dir, tensorboard=not args.no_tensorboard)
    timer = StepTimer(unit="env-steps")

    live = {"n_chunk": 0, "episodes_done": 0, "total_steps": 0, "env_state": env_state,
            "hybrid": hybrid, "obs": obs, "pool_idx": pool_idx, "best_score": (-1.0, -1.0)}
    reward_hist: list[float] = []
    records = []
    loop = {"agent": agent, "state": ppo_state, "env": env, "pool": pool,
            "chunk_fn": chunk_fn, "metrics": {}, "buffer": None, "mesh": mesh}

    def run_chunk():
        """One chunk: fill the reset queue, collect and update, then the
        host's episode bookkeeping. Returns the chunk's record and summary."""
        live["n_chunk"] += 1
        mesh.reset_stats()
        t0 = time.perf_counter()
        reset_queue = torch.as_tensor(queue_sampler.sample(R), device=dev)
        loop["buffer"] = None               # freed before the next buffer fills
        (_, live["env_state"], live["hybrid"], live["obs"], live["pool_idx"], logs,
         metrics, loop["buffer"]) = chunk_fn(ppo_state, live["env_state"], live["hybrid"],
                                             live["obs"], live["pool_idx"], pool.pool,
                                             reset_queue, gen)
        summary = summarize_logs(logs)
        seconds = time.perf_counter() - t0
        live["total_steps"] += R
        timer.tick(R)
        queue_sampler.record_ends(summary["ends"])
        live["episodes_done"] += summary["episodes"]
        reward_hist.append(summary["reward_mean"])
        loop["metrics"], loop["logs"] = metrics, logs
        record = {"chunk": live["n_chunk"], "seconds": seconds,
                  "episodes": summary["episodes"], "steps": R, "sgd_steps": sgd_steps}
        if mesh.sharded:
            record.update({f"collective_{k}": v for k, v in mesh.stats.items()})
        records.append(record)
        return record, summary

    loop["run_chunk"] = lambda: run_chunk()[0]

    def log_and_save(n_chunk):
        """Rank 0's log line, metrics and checkpoints after a chunk."""
        sr = scene_chooser.recent_success()
        metrics = loop["metrics"]
        line = {
            "chunk": n_chunk, "episodes": live["episodes_done"],
            "steps": live["total_steps"],
            "reward": float(np.mean(reward_hist[-10:])),
            "success": {LEVELS[i]: round(float(sr[i]), 3) for i in range(4)},
            "actor_loss": round(float(metrics["actor_loss"]), 4),
            "critic_loss": round(float(metrics["critic_loss"]), 4),
            "elapsed": round(time.time() - t_start, 1),
            "approx_kl": round(float(metrics["approx_kl"]), 5),
            "kl_stopped": float(metrics["kl_stopped"]),
        }
        rate = timer.report()
        if rate and rate["unit_per_sec"]:
            line["env_steps_per_sec"] = round(rate["unit_per_sec"], 1)
        print(json.dumps(line), flush=True)
        flat = {k: v for k, v in line.items() if isinstance(v, (int, float))}
        flat.update({f"success/{k}": v for k, v in line["success"].items()})
        writer.write(n_chunk, flat)

        # best-checkpoint gate: lexicographic (capped mean, raw mean) over the
        # recent per-level success window, with enough episodes per level
        capped = np.minimum(sr, TARGET_SUCCESS)
        score = (round(float(capped.mean()), 9), round(float(sr.mean()), 9))
        if (live["episodes_done"] > 100 and score > live["best_score"]
                and scene_chooser.window_counts().min() >= 50):
            live["best_score"] = score
            save_checkpoint(os.path.join(args.log_dir, "ckpt_best"), ppo_state, n_chunk)

        if args.save_every and n_chunk % args.save_every == 0:
            save_checkpoint(os.path.join(args.log_dir, "ckpt"), ppo_state, n_chunk)

    # every rank set up before the first collective
    barrier(mesh)
    t_start = time.time()
    while live["episodes_done"] < args.episodes:
        # a stop on the host's clock is taken by every rank at once
        if agree(bool(args.max_seconds and time.time() - t_start > args.max_seconds), mesh):
            break
        record, _ = run_chunk()
        n_chunk = record["chunk"]
        if on_chunk is not None:
            on_chunk(record, loop)

        if n_chunk % args.pool_refresh == 0:
            queue_sampler.refresh_pool()
        if root:
            log_and_save(n_chunk)
        if args.max_chunks and n_chunk >= args.max_chunks:
            break

    if root:
        save_checkpoint(os.path.join(args.log_dir, "ckpt"), ppo_state, live["n_chunk"])
        writer.close()
    print(json.dumps({"final_episodes": live["episodes_done"],
                      "steps_per_sec": live["total_steps"] / (time.time() - t_start)}),
          flush=True)

    # every collective is behind: leave the group, so that the other ranks
    # exit while rank 0 runs the eval (its barrier would time out on a long
    # one)
    shutdown(mesh)
    if args.final_eval and root:
        from ..evaluation.eval_mix_scene import LEVELS as EVAL_LEVELS, run_battery

        results = run_battery(env, agent, ppo_state, "ppo", episodes=args.final_eval,
                              out=os.path.join(args.log_dir, "final_eval"), seed=args.seed,
                              levels=[lv for lv in EVAL_LEVELS
                                      if not (args.no_dlp and lv == "dlp")])
        print(json.dumps({"final_eval": {lv: round(r["success_rate"], 4)
                                         for lv, r in results.items()}}), flush=True)
    return {"chunks": records, "loop": loop}


if __name__ == "__main__":
    main()
