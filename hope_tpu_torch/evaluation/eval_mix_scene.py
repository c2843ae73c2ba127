"""Mixed-scene evaluation CLI (counterpart of
``hope_tpu/evaluation/eval_mix_scene.py``), DLP battery.

Usage: python -m hope_tpu_torch.evaluation.eval_mix_scene \\
           hope_tpu_torch/assets/sac_r3b_actor.npz --episodes 256

The procedural levels (Normal / Complex / Extrem) need the scenario
generator, which the port does not have yet (ROADMAP.md, "Modules to port",
item 13); asking for one exits with an error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..agents import SACAgent
from ..config import EnvConfig, ObsConfig, SACConfig, actor_net_config
from ..device import resolve_device
from ..envs import ParkingEnv
from ..envs.dlp import DLPDataset
from ..models.convert import load_actor_npz
from .evaluate import build_episode_runner, summarize, write_report

NOT_PORTED = ("the procedural levels (Extrem, Complex, Normal) need "
              "envs/scenario_gen.py, not yet ported (ROADMAP.md, 'Modules to "
              "port', item 13)")


def run_battery(env: ParkingEnv, agent: SACAgent, state, episodes: int = 256,
                max_steps: int = 200, out: str | None = "log/eval", seed: int = 0):
    """Evaluate an in-memory SAC actor over the DLP battery (raw
    ``get_action`` + RS takeover, the reference's SAC eval semantics).

    Returns {"dlp": summary}; the summary's ``rollout_seconds`` is the wall
    time of the rollout alone (no data loading or reporting). Writes
    ``result_dlp.json`` and ``result_all.json`` under ``out`` unless it is
    None.
    """
    run = build_episode_runner(
        env, lambda obs, g: agent.get_action(state, obs, g), max_steps)
    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 7)
    ds = DLPDataset(env_cfg=env.cfg, device=env.device)
    scenes = ds.batch_reset(torch.arange(episodes) % ds.n_cases, gen)
    _sync(env.device)
    t0 = time.perf_counter()
    metrics = run(scenes, gen)
    _sync(env.device)
    rollout_s = time.perf_counter() - t0
    results = {"dlp": {**summarize(metrics, max_steps=max_steps),
                       "rollout_seconds": rollout_s}}
    if out is not None:
        os.makedirs(out, exist_ok=True)
        write_report(os.path.join(out, "result_dlp.json"), results["dlp"])
        write_report(os.path.join(out, "result_all.json"), results)
    print(json.dumps({"dlp": results["dlp"]["success_rate"],
                      "steps": results["dlp"]["success_steps_mean"]}), flush=True)
    return results


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(actor_path: str, device=None):
    """(env, agent, actor state) for the battery's configuration: full
    observation, 512-edge / 128-polygon scenes."""
    dev = resolve_device(device)
    obs_cfg = ObsConfig()
    env = ParkingEnv(EnvConfig(obs=obs_cfg, max_edges=512, max_obstacles=128), device=dev)
    actor, state = load_actor_npz(actor_path, actor_net_config(obs_cfg), dev)
    return env, SACAgent(actor, SACConfig()), state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("actor", type=str, help="actor .npz (models/convert.py format)")
    ap.add_argument("--episodes", type=int, default=256, help="episodes per level")
    ap.add_argument("--levels", type=str, default="dlp",
                    help="comma-separated battery levels (only 'dlp' is ported)")
    ap.add_argument("--max-steps", type=int, default=200)
    ap.add_argument("--out", type=str, default="log/eval")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    if args.levels != "dlp":
        sys.exit(f"eval_mix_scene: --levels {args.levels}: only 'dlp' runs; {NOT_PORTED}")
    env, agent, state = build(args.actor, args.device)
    return run_battery(env, agent, state, episodes=args.episodes,
                       max_steps=args.max_steps, out=args.out, seed=args.seed)


if __name__ == "__main__":
    main()
