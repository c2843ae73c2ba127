"""SAC training entry point (counterpart of ``hope_tpu/train/train_sac.py``):
chunks of lockstep batched rollouts with the hybrid RS takeover and the
curriculum, then the SGD updates.

B envs step in lockstep, and each chunk runs K steps and then
U = K x updates_per_step updates (``chunked.py``). The flags, defaults, JSON
log lines, ``config.json`` and best-checkpoint gate are the JAX CLI's.
``--device`` picks the device (CUDA unless named).

``--devices N`` trains on N data-parallel ranks, one per device
(``parallel/launch.py``: spawned here, or ``--devices / --num-processes``
per launched process with ``--coordinator`` and ``--process-id``): each rank
steps its B / N envs and holds its N-th of the replay ring, the agent is
replicated and the gradients are summed over the ranks (``chunked.py``,
``agents/sac.py``). Rank 0 alone writes the log directory (config, metrics,
checkpoints) and runs ``--final-eval``; a full checkpoint holds the
one-process layout, so ``--resume`` takes it at any number of ranks.

Checkpoints: the agent under ``<log-dir>/ckpt`` every ``--save-every``
chunks (with ``reward_curve.png``) and at exit; the whole loop under
``<log-dir>/ckpt_full`` every ``--full-save-every`` chunks and always at exit
(``resume.py``; with the image on at the defaults the replay ring alone is
~2.6 GB). ``--resume`` takes either directory: a full one restores the loop
and continues its chunk count, an agent-only one the agent.

Usage: python -m hope_tpu_torch.train.train_sac --episodes 20000 --batch-envs 256
       python -m hope_tpu_torch.train.train_sac --smoke --device cpu
       python -m hope_tpu_torch.train.train_sac --resume log/sac/ckpt_full
       python -m hope_tpu_torch.train.train_sac --devices 2 --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from ..agents import HybridState, SACAgent, replay_create
from ..config import EnvConfig, ObsConfig, SACConfig, actor_net_config, critic_net_config
from ..envs import ParkingEnv
from ..evaluation.render import save_reward_curve
from ..models import MultiObsEmbedding
from ..parallel.launch import add_flags, check_flags, rank_group, run_ranks
from ..parallel.mesh import agree, barrier, shard_batch, shutdown
from ..utils.checkpoint import load_checkpoint, load_params_only, save_checkpoint
from ..utils.profiling import MetricsWriter, StepTimer, trace
from . import resume
from .chunked import build_sac_chunk, summarize_logs
from .curriculum import LEVELS, TARGET_SUCCESS, DlpCaseChoose, SceneChoose
from .scene_pool import ScenePool

# the chunk at which --profile-chunks starts its trace
PROFILE_FROM = 5


class ResetQueueSampler:
    """Fills each chunk's reset queue from the curriculum choosers, which
    learn from the episodes that end (:meth:`record_ends`).

    With a ``dlp_chooser``, DLP resets pick their pool slot by the per-case
    failure-rate weights instead of uniformly; the weights refresh every
    queue fill, one chunk behind the episode statistics.
    """

    def __init__(self, scene_chooser: SceneChoose, pool: ScenePool, rng,
                 fill: int = 128, dlp_chooser: DlpCaseChoose | None = None):
        self.scene_chooser = scene_chooser
        self.pool = pool
        self.rng = rng
        self.fill = fill
        self.dlp_chooser = dlp_chooser

    def sample(self, size: int) -> np.ndarray:
        m = min(self.fill, size)
        levels = self.scene_chooser.sample_levels(m) % self.pool.n_levels
        slots = self.rng.integers(0, self.pool.per_level, m)
        if self.dlp_chooser is not None and self.pool.dlp_case_ids is not None:
            is_dlp = levels == LEVELS.index("dlp")
            if is_dlp.any():
                w = self.dlp_chooser.slot_weights(self.pool.dlp_case_ids)
                slots[is_dlp] = self.rng.choice(self.pool.per_level, size=int(is_dlp.sum()), p=w)
        flat = self.pool.flat_index(levels, slots)
        reps = int(np.ceil(size / m))
        return np.tile(flat, reps)[:size].astype(np.int32)

    def record_ends(self, ends):
        """Fold a chunk's ended episodes [(flat pool index, success), ...]
        into the choosers' statistics."""
        per_level = self.pool.per_level
        for flat_idx, success in ends:
            level = flat_idx // per_level
            self.scene_chooser.record_episode(level, success)
            if (LEVELS[level] == "dlp" and self.dlp_chooser is not None
                    and self.pool.dlp_case_ids is not None):
                slot = flat_idx % per_level
                self.dlp_chooser.update_success_record(success,
                                                       int(self.pool.dlp_case_ids[slot]))

    def refresh_pool(self):
        """Draw the pool's scenes anew (its DLP cases by the DLP chooser)."""
        dlp_ids = None if self.dlp_chooser is None else np.array(
            [self.dlp_chooser.choose_case() for _ in range(self.pool.per_level)])
        self.pool.refresh(dlp_case_ids=dlp_ids)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=100000)
    ap.add_argument("--batch-envs", type=int, default=256)
    ap.add_argument("--chunk-steps", type=int, default=16, help="env steps per chunk")
    ap.add_argument("--warmup-chunks", type=int, default=3,
                    help="random-action chunks before updates start")
    ap.add_argument("--updates-per-step", type=int, default=4)
    ap.add_argument("--sgd-batch", type=int, default=256)
    ap.add_argument("--memory", type=int, default=100_000)
    ap.add_argument("--pool-per-level", type=int, default=256)
    ap.add_argument("--pool-refresh", type=int, default=50,
                    help="refresh the scene pool every N chunks")
    ap.add_argument("--no-img", action="store_true")
    ap.add_argument("--no-dlp", action="store_true")
    ap.add_argument("--stream-dlp", action="store_true",
                    help="stream DLP case batches from the native memory-mapped bank, "
                         "prefetched while the device works, instead of holding the bank "
                         "on the device")
    add_flags(ap)
    ap.add_argument("--resume", type=str, default=None,
                    help="checkpoint directory to go on from: a full one (<log-dir>/ckpt_full) "
                         "restores the whole loop (agent and Adams, replay ring, env and "
                         "hybrid state, pool, generators, curriculum, counters); an "
                         "agent-only one (<log-dir>/ckpt) the agent")
    ap.add_argument("--max-chunks", type=int, default=0,
                    help="stop after N chunks (0 = never)")
    ap.add_argument("--init-params", type=str, default=None,
                    help="agent checkpoint directory: take its networks, log_std, "
                         "temperature, normalizer and update count, keep fresh Adams")
    ap.add_argument("--img-encoder", type=str, default=None,
                    help="autoencoder checkpoint directory (pretrain_autoencoder): graft its "
                         "encoder into the actor's and critics' image towers at init")
    ap.add_argument("--freeze-img-encoder", action="store_true",
                    help="no update moves the image encoders")
    ap.add_argument("--save-every", type=int, default=200,
                    help="agent checkpoint and reward curve every N chunks")
    ap.add_argument("--full-save-every", type=int, default=0,
                    help="full loop checkpoint (the replay ring included) every N chunks; "
                         "0 = only at exit. Resume from <log-dir>/ckpt_full")
    ap.add_argument("--log-dir", type=str, default="log/sac")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="stop after this much wall-clock time (0 = never)")
    ap.add_argument("--profile-chunks", type=int, default=0,
                    help="trace chunks 5 to 5+N-1 with torch.profiler into <log-dir>/trace")
    ap.add_argument("--final-eval", type=int, default=0,
                    help="run the 4-level eval battery with N episodes per level after "
                         "training; 0 disables")
    ap.add_argument("--no-tensorboard", action="store_true")
    ap.add_argument("--log-every", type=int, default=5,
                    help="print/write metrics every N chunks")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    args.argv = sys.argv[1:] if argv is None else list(argv)

    if args.smoke:
        args.episodes = 8
        args.batch_envs = max(4, 2 * args.devices)
        args.chunk_steps = 4
        args.warmup_chunks = 1
        args.updates_per_step = 1
        args.sgd_batch = 8
        args.memory = 512
        args.pool_per_level = 4
        args.no_img = True
        args.no_dlp = True
    check_flags(ap, args, {"--batch-envs": args.batch_envs, "--memory": args.memory})
    return args


def main(argv=None, on_chunk=None):
    """Train; returns {"chunks": [per-chunk record], "loop": live objects}
    (None where the ranks were spawned processes).

    ``on_chunk(record, loop)``, where given, is called after each chunk with
    its record (chunk, warmup, seconds, episodes, steps; across ranks the
    chunk's collectives too) and the loop's live objects (agent, state,
    replay, env, pool, generator, metrics, logs (the chunk's, whole), mesh,
    run_chunk, full_state, full_saves, resumed), e.g. to check what a chunk
    changed.
    ``loop["run_chunk"]()`` runs one more chunk; ``loop["full_state"]()``
    gives the (device, host) blobs that a full checkpoint would write now;
    ``loop["full_saves"]`` lists the full saves made (step, bytes, seconds);
    ``loop["resumed"]`` is the record of the ``--resume`` (None without)."""
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
    sac_cfg = SACConfig(memory_size=args.memory, batch_size=args.sgd_batch,
                        freeze_img_encoder=args.freeze_img_encoder)
    init_gen = torch.Generator().manual_seed(args.seed)
    agent = SACAgent(MultiObsEmbedding(actor_net_config(obs_cfg)).to(dev), sac_cfg,
                     critic_net_config(obs_cfg, action_input=True))
    sac_state = agent.init(env.observation_shape, init_gen)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 3)

    if args.init_params:
        load_params_only(args.init_params, sac_state)
        if root:
            print(json.dumps({"init_params": args.init_params}), flush=True)

    if args.img_encoder:
        # a pretrained autoencoder's encoder into every image tower: the
        # actor's, both critics' and both targets'
        if args.no_img:
            raise SystemExit("--img-encoder requires the image modality")
        from ..models.autoencoder import AEConv, graft_encoder_params

        ae = load_checkpoint(args.img_encoder, AEConv(actor_net_config(obs_cfg)).to(dev))
        for net in (sac_state.actor, sac_state.critic1, sac_state.critic2, sac_state.target1,
                    sac_state.target2):
            graft_encoder_params(net, ae)
        if root:
            print(json.dumps({"img_encoder": args.img_encoder,
                              "frozen": args.freeze_img_encoder}), flush=True)

    pool = ScenePool(env_cfg, per_level=args.pool_per_level, include_dlp=not args.no_dlp,
                     stream_dlp=args.stream_dlp, seed=args.seed, device=dev)
    scene_chooser = SceneChoose(rng=np.random.default_rng(args.seed))
    dlp_chooser = None if args.no_dlp else DlpCaseChoose(rng=np.random.default_rng(args.seed + 1))
    queue_sampler = ResetQueueSampler(scene_chooser, pool, np.random.default_rng(args.seed + 2),
                                      dlp_chooser=dlp_chooser)

    B, K = args.batch_envs, args.chunk_steps
    R = B * K  # worst-case resets per chunk

    # this rank's block of the envs; pool, agent and queue are replicated
    pool_idx = shard_batch(torch.as_tensor(queue_sampler.sample(B), device=dev), mesh)
    env_state, obs = env.batch_reset(pool.gather(pool_idx))
    hybrid = HybridState.create(B // mesh.world, env_cfg.rs_queue_len, dev)

    example = {}
    for k, v in obs.items():
        example[f"obs/{k}"] = v[0]
        example[f"next_obs/{k}"] = v[0]
    example["action"] = torch.zeros(2, device=dev)
    example["reward"] = torch.zeros((), device=dev)
    example["done"] = torch.zeros((), dtype=torch.bool, device=dev)
    example["log_prob"] = torch.zeros((), device=dev)
    replay = replay_create(args.memory, example, mesh)

    live = {"n_chunk": 0, "episodes_done": 0, "total_steps": 0, "env_state": env_state,
            "hybrid": hybrid, "obs": obs, "pool_idx": pool_idx, "metrics": {},
            "best_score": (-1.0, -1.0), "reward_hist": []}

    def device_blob():
        return resume.device_blob(sac_state, live["env_state"], live["hybrid"], live["obs"],
                                  live["pool_idx"], replay, gen, pool.pool, pool.generator)

    resumed = None
    if args.resume:
        t0 = time.perf_counter()
        restored, host, step = resume.load_full(args.resume, device_blob(), mesh=mesh)
        if restored is None:
            load_checkpoint(args.resume, sac_state)
            resumed = {"resumed": args.resume, "mode": "agent-only",
                       "sgd_steps": sac_state.steps}
        else:
            live.update(env_state=restored["env"], hybrid=restored["hybrid"],
                        obs=restored["obs"], pool_idx=restored["pool_idx"])
            pool.pool = restored["pool"]
            counters = resume.restore_host(host, scene_chooser, dlp_chooser, queue_sampler.rng)
            if counters["dlp_case_ids"] is not None:
                pool.dlp_case_ids = np.asarray(counters["dlp_case_ids"])
            pool.resume_stream(counters["dlp_pending_ids"])
            for k in ("n_chunk", "episodes_done", "total_steps"):
                live[k] = int(counters[k])
            live["best_score"] = tuple(counters["best_score"])
            live["reward_hist"] = list(counters["reward_hist"])
            resumed = {"resumed": args.resume, "mode": "full", "chunk": live["n_chunk"],
                       "episodes": live["episodes_done"],
                       "load_seconds": time.perf_counter() - t0}
        if root:
            print(json.dumps(resumed), flush=True)

    chunk_fn = build_sac_chunk(env, agent, env_cfg.step_ratio, K, K * args.updates_per_step,
                               args.sgd_batch, mesh)

    writer = None
    if root:
        os.makedirs(args.log_dir, exist_ok=True)
        with open(os.path.join(args.log_dir, "config.json"), "w") as f:
            json.dump({"argv": args.argv,
                       "args": {k: v for k, v in vars(args).items() if k != "argv"},
                       "env": dataclasses.asdict(env_cfg), "sac": dataclasses.asdict(sac_cfg)},
                      f, indent=2, default=str)
        writer = MetricsWriter(args.log_dir, tensorboard=not args.no_tensorboard)
    timer = StepTimer(unit="env-steps")

    reward_hist = live["reward_hist"]
    records = []
    full_saves = []
    loop = {"agent": agent, "state": sac_state, "replay": replay, "env": env, "pool": pool,
            "generator": gen, "mesh": mesh, "full_saves": full_saves, "resumed": resumed}

    def full_state():
        """The (device, host) blobs of the loop as it stands."""
        host = resume.host_blob(scene_chooser, dlp_chooser, queue_sampler.rng, {
            "episodes_done": live["episodes_done"], "total_steps": live["total_steps"],
            "n_chunk": live["n_chunk"], "best_score": list(live["best_score"]),
            "reward_hist": reward_hist[-1000:],
            "dlp_case_ids": None if pool.dlp_case_ids is None else pool.dlp_case_ids.tolist(),
            "dlp_pending_ids": None if pool.pending_ids is None else pool.pending_ids.tolist(),
        })
        return device_blob(), host

    def save_full():
        """The whole loop under <log-dir>/ckpt_full (every rank gathers,
        rank 0 writes)."""
        t0 = time.perf_counter()
        nbytes = resume.save_full(os.path.join(args.log_dir, "ckpt_full"), live["n_chunk"],
                                  *full_state(), mesh=mesh)
        rec = {"full_save": os.path.join(args.log_dir, "ckpt_full"), "step": live["n_chunk"],
               "bytes": nbytes, "seconds": time.perf_counter() - t0}
        full_saves.append(rec)
        if root:
            print(json.dumps(rec), flush=True)

    loop["full_state"] = full_state

    def run_chunk():
        """One chunk: fill the reset queue, collect and update, then the
        host's episode bookkeeping. Returns the chunk's record and summary."""
        live["n_chunk"] += 1
        n_chunk = live["n_chunk"]
        warmup = n_chunk <= args.warmup_chunks
        mesh.reset_stats()
        t0 = time.perf_counter()
        reset_queue = torch.as_tensor(queue_sampler.sample(R), device=dev)
        (_, live["env_state"], live["hybrid"], live["obs"], live["pool_idx"], _, logs,
         live["metrics"]) = chunk_fn(sac_state, live["env_state"], live["hybrid"], live["obs"],
                                     live["pool_idx"], replay, pool.pool, reset_queue, gen,
                                     warmup=warmup)
        summary = summarize_logs(logs)
        seconds = time.perf_counter() - t0
        live["total_steps"] += B * K
        timer.tick(B * K)
        queue_sampler.record_ends(summary["ends"])
        live["episodes_done"] += summary["episodes"]
        reward_hist.append(summary["reward_mean"])
        loop["metrics"], loop["logs"] = live["metrics"], logs
        record = {"chunk": n_chunk, "warmup": warmup, "seconds": seconds,
                  "episodes": summary["episodes"], "steps": B * K,
                  "updates": 0 if warmup else K * args.updates_per_step}
        if mesh.sharded:
            record.update({f"collective_{k}": v for k, v in mesh.stats.items()})
        records.append(record)
        return record, summary

    loop["run_chunk"] = lambda: run_chunk()[0]

    if mesh.sharded:
        # every rank set up: the first collective follows
        barrier(mesh)
        print(json.dumps({"multihost": "barrier passed", "rank": mesh.rank,
                          "t": round(time.time(), 1)}), flush=True)
    t_start = time.time()
    tracing = contextlib.ExitStack()
    with tracing:
        while live["episodes_done"] < args.episodes:
            # a stop on the host's clock is taken by every rank at once
            if agree(bool(args.max_seconds and time.time() - t_start > args.max_seconds),
                     mesh):
                break
            if args.profile_chunks and root:
                if live["n_chunk"] + 1 == PROFILE_FROM:
                    tracing.enter_context(trace(os.path.join(args.log_dir, "trace")))
                elif live["n_chunk"] + 1 == PROFILE_FROM + args.profile_chunks:
                    tracing.close()
            record, _ = run_chunk()
            n_chunk = record["chunk"]
            if on_chunk is not None:
                on_chunk(record, loop)

            if n_chunk % args.pool_refresh == 0:
                queue_sampler.refresh_pool()

            if root and (n_chunk % args.log_every == 0
                         or live["episodes_done"] >= args.episodes):
                sr = scene_chooser.recent_success()
                line = {
                    "chunk": n_chunk, "episodes": live["episodes_done"],
                    "steps": live["total_steps"],
                    "reward": float(np.mean(reward_hist[-20:])),
                    "success": {LEVELS[i]: round(float(sr[i]), 3) for i in range(4)},
                    "alpha": round(float(torch.exp(sac_state.log_alpha.detach())), 5),
                    "elapsed": round(time.time() - t_start, 1),
                }
                metrics = live["metrics"]
                if metrics:
                    line["actor_loss"] = round(float(metrics["actor_loss"]), 4)
                    line["critic_loss"] = round(float(metrics["critic_loss"]), 4)
                rate = timer.report()
                if rate and rate["unit_per_sec"]:
                    line["env_steps_per_sec"] = round(rate["unit_per_sec"], 1)
                print(json.dumps(line), flush=True)
                flat = {k: v for k, v in line.items() if isinstance(v, (int, float))}
                flat.update({f"success/{k}": v for k, v in line["success"].items()})
                writer.write(n_chunk, flat)

                # best-checkpoint gate: lexicographic (capped mean, raw mean)
                # over the recent per-level success window, with enough
                # episodes per level in the window
                capped = np.minimum(sr, TARGET_SUCCESS)
                score = (round(float(capped.mean()), 9), round(float(sr.mean()), 9))
                if (live["episodes_done"] > 100 and score > live["best_score"]
                        and scene_chooser.window_counts().min() >= 50):
                    live["best_score"] = score
                    save_checkpoint(os.path.join(args.log_dir, "ckpt_best"), sac_state,
                                    n_chunk)

            if root and args.save_every and n_chunk % args.save_every == 0:
                save_checkpoint(os.path.join(args.log_dir, "ckpt"), sac_state, n_chunk)
                save_reward_curve(os.path.join(args.log_dir, "reward_curve.png"), reward_hist)
            if args.full_save_every and n_chunk % args.full_save_every == 0:
                save_full()

            if args.max_chunks and n_chunk >= args.max_chunks:
                break

    # the whole loop, always (what --resume continues from; unless this
    # chunk's periodic save wrote it), and the agent alone (what the eval
    # CLI scores)
    if not (full_saves and full_saves[-1]["step"] == live["n_chunk"]):
        save_full()
    if root:
        save_checkpoint(os.path.join(args.log_dir, "ckpt"), sac_state, live["n_chunk"])
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

        results = run_battery(env, agent, sac_state, episodes=args.final_eval,
                              out=os.path.join(args.log_dir, "final_eval"), seed=args.seed,
                              levels=[lv for lv in EVAL_LEVELS
                                      if not (args.no_dlp and lv == "dlp")])
        print(json.dumps({"final_eval": {lv: round(r["success_rate"], 4)
                                         for lv, r in results.items()}}), flush=True)
    return {"chunks": records, "loop": loop}


if __name__ == "__main__":
    main()
