"""Mixed-scene evaluation CLI (counterpart of
``hope_tpu/evaluation/eval_mix_scene.py``): the 4-level battery, Extrem ->
dlp -> Complex -> Normal.

Usage: python -m hope_tpu_torch.evaluation.eval_mix_scene \\
           hope_tpu_torch/assets/sac_r3b_actor.npz --episodes 256
       python -m hope_tpu_torch.evaluation.eval_mix_scene log/sac/ckpt --no-img
       python -m hope_tpu_torch.evaluation.eval_mix_scene random --episodes 64
The agent is an actor ``.npz`` (by its suffix), a checkpoint directory that
the port's ``train_sac`` / ``train_ppo`` wrote (the agent's config rebuilt
from the run's ``config.json`` beside it), or ``random``: fresh weights from
``--seed``. ``--agent`` defaults to ppo where the path says "ppo", else sac.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..agents import PPOAgent, SACAgent
from ..config import EnvConfig, ObsConfig, PPOConfig, SACConfig, actor_net_config, critic_net_config
from ..device import resolve_device
from ..envs import ParkingEnv
from ..envs.dlp import DLPDataset
from ..envs.scenario_gen import generate_bank
from ..models import MultiObsEmbedding
from ..models.convert import load_actor_npz, load_ppo_actor_npz
from ..train.scene_pool import pad_scene_batch
from ..utils.checkpoint import load_checkpoint
from .evaluate import build_episode_runner, summarize, write_report

LEVELS = ("Extrem", "dlp", "Complex", "Normal")
# each procedural level draws its bank and its rollout from its own generator,
# seeded seed + 7 + LEVEL_SEED[level]; the DLP level keeps seed + 7
LEVEL_SEED = {"dlp": 0, "Normal": 1000, "Complex": 2000, "Extrem": 3000}


def run_battery(env: ParkingEnv, agent, state, agent_type: str = "sac", episodes: int = 256,
                max_steps: int = 200, out: str | None = "log/eval", seed: int = 0,
                levels=LEVELS):
    """Evaluate an in-memory actor over the battery's levels, in the order of
    ``levels``, with the RS takeover: a PPO agent (``agent_type`` "ppo") acts
    through the masked ``choose_action``, a SAC agent through the raw
    ``get_action`` (the reference's eval semantics for each).

    Procedural levels run on ``generate_bank`` scenes padded to the env's
    edge budget, DLP on cases ``arange(episodes) % n_cases``. Each level draws
    its scenes and rollout noise from a generator of its own, so a level's
    numbers do not depend on which levels ran before it.

    Returns {level: summary}; each summary's ``rollout_seconds`` is the wall
    time of the rollout alone (no scene generation or reporting). Writes
    ``result_<level>.json`` and ``result_all.json`` under ``out`` unless it is
    None.
    """
    act = agent.choose_action if agent_type == "ppo" else agent.get_action
    run = build_episode_runner(env, lambda obs, g: act(state, obs, g), max_steps)
    cfg = env.cfg
    results = {}
    for level in levels:
        gen = torch.Generator(device=env.device)
        gen.manual_seed(seed + 7 + LEVEL_SEED[level])
        if level == "dlp":
            ds = DLPDataset(env_cfg=cfg, device=env.device)
            scenes = ds.batch_reset(torch.arange(episodes) % ds.n_cases, gen)
        else:
            scenes, _ = generate_bank(gen, level=level, n=episodes)
        scenes = pad_scene_batch(scenes, cfg.max_edges, cfg.max_obstacles)
        _sync(env.device)
        t0 = time.perf_counter()
        metrics = run(scenes, gen)
        _sync(env.device)
        results[level] = {**summarize(metrics, max_steps=max_steps),
                          "rollout_seconds": time.perf_counter() - t0}
        if out is not None:
            os.makedirs(out, exist_ok=True)
            write_report(os.path.join(out, f"result_{level}.json"), results[level])
        print(json.dumps({level: results[level]["success_rate"],
                          "steps": results[level]["success_steps_mean"]}), flush=True)
    if out is not None:
        write_report(os.path.join(out, "result_all.json"), results)
    return results


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def agent_type_of(path: str) -> str:
    """The agent a file holds, by its path (as the JAX CLI infers it)."""
    return "ppo" if "ppo" in path.lower() else "sac"


def cfg_from_run(ckpt: str, cls, key: str):
    """The agent config ``cls`` of the run that wrote the checkpoint directory
    ``ckpt``, from the ``config.json`` beside it (its ``key`` entry), or the
    default where there is none."""
    path = os.path.join(os.path.dirname(os.path.abspath(ckpt.rstrip("/"))), "config.json")
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f).get(key)
        if d:
            fields = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in d.items() if k in fields})
    return cls()


def build(source: str, device=None, agent_type: str | None = None, no_img: bool = False,
          no_dlp: bool = False, rs_tries: int | None = None, seed: int = 0):
    """(env, agent, agent state) for the battery: the full observation unless
    ``no_img``, 512-edge / 128-polygon scenes (96 / 32 with ``no_dlp``), and
    ``rs_tries`` RS words where given. ``source`` is an actor ``.npz`` (a SAC
    actor, or a gaussian PPO actor with the env's action-mask table), a
    checkpoint directory, or "random" (fresh weights from ``seed``); the agent
    is ``agent_type``'s, else the one the path names."""
    dev = resolve_device(device)
    obs_cfg = ObsConfig(use_img=not no_img)
    env = ParkingEnv(EnvConfig(obs=obs_cfg, max_edges=96 if no_dlp else 512,
                               max_obstacles=32 if no_dlp else 128,
                               **({} if rs_tries is None else {"rs_max_tries": rs_tries})),
                     device=dev)
    agent_type = agent_type or agent_type_of(source)
    if source.endswith(".npz"):
        if agent_type == "ppo":
            agent = PPOAgent(actor_net_config(obs_cfg), critic_net_config(obs_cfg), PPOConfig(),
                             env.mask_table)
            return env, agent, load_ppo_actor_npz(source, agent, dev)
        actor, state = load_actor_npz(source, actor_net_config(obs_cfg), dev)
        return env, SACAgent(actor, SACConfig()), state
    gen = torch.Generator().manual_seed(seed)
    if agent_type == "ppo":
        agent = PPOAgent(actor_net_config(obs_cfg), critic_net_config(obs_cfg),
                         cfg_from_run(source, PPOConfig, "ppo"), env.mask_table)
        state = agent.init(env.observation_shape, gen, dev)
    else:
        agent = SACAgent(MultiObsEmbedding(actor_net_config(obs_cfg)).to(dev),
                         cfg_from_run(source, SACConfig, "sac"),
                         critic_net_config(obs_cfg, action_input=True))
        state = agent.init(env.observation_shape, gen)
    if source != "random":
        state = load_checkpoint(source, state)
    return env, agent, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt", type=str,
                    help="an actor .npz (models/convert.py format), a checkpoint directory "
                         "(<log>/ckpt), or 'random'")
    ap.add_argument("--episodes", type=int, default=256, help="episodes per level")
    ap.add_argument("--agent", choices=["sac", "ppo"], default=None,
                    help="the agent (default: ppo where the path says ppo)")
    ap.add_argument("--no-img", action="store_true")
    ap.add_argument("--no-dlp", action="store_true",
                    help="procedural levels only, on 96-edge / 32-polygon scenes")
    ap.add_argument("--levels", type=str, default=",".join(LEVELS),
                    help="comma-separated battery levels, in the order to run")
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--rs-tries", type=int, default=None,
                    help="override rs_max_tries (candidate RS words collision-checked per "
                         "endgame search)")
    ap.add_argument("--out", type=str, default="log/eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    levels = [lv for lv in args.levels.split(",") if not (args.no_dlp and lv == "dlp")]
    unknown = set(levels) - set(LEVELS)
    if unknown:
        ap.error(f"--levels: unknown {sorted(unknown)}; choose from {list(LEVELS)}")
    agent_type = args.agent or agent_type_of(args.ckpt)
    env, agent, state = build(args.ckpt, args.device, agent_type, no_img=args.no_img,
                              no_dlp=args.no_dlp, rs_tries=args.rs_tries, seed=args.seed)
    return run_battery(env, agent, state, agent_type, episodes=args.episodes,
                       max_steps=args.max_steps, out=args.out, seed=args.seed, levels=levels)


if __name__ == "__main__":
    main()
