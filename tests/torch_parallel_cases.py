"""The port's one-chunk SAC and PPO cases for the multi-rank tests
(``tests/test_torch_parallel.py``): the scene, agent and inputs of
``tests/chunk_fixture.py`` (B = 16 envs in one room, 2 collect steps, for
SAC 2 updates of 8 from a ring of 64), built in the port alone, so that a
rank process imports no JAX. Unlike that fixture, the envs start at
different poses, and ``ON_DEST`` start on the destination: they arrive at
the first step and take resets from a queue of distinct pool indices, two
on each of 2 ranks, so the whole batch's done order decides which.

A rank runs as its own process:

    python -m tests.torch_parallel_cases {sac|ppo|collectives} <coordinator> <rank> <world> <out.pt>

and writes its chunk's outputs with ``torch.save``; ``run(case, mesh)`` is
the same in one process. ``train_sac`` / ``train_ppo`` run the CLI's rank
worker at ``--smoke`` (2 chunks) on a given device over gloo, e.g. two ranks
sharing one card (``tests/test_torch_card.py``):

    python -m tests.torch_parallel_cases train_sac <coordinator> <rank> <world> <out.pt> cuda:0

``final_eval_sac`` / ``final_eval_ppo`` run one ``--smoke`` chunk with
``--final-eval 1``, rank 0's battery held until rank 1's worker has
returned.
"""
import copy
import os
import sys
import time

import numpy as np
import torch

from hope_tpu_torch.agents import HybridState, PPOAgent, SACAgent, replay_create
from hope_tpu_torch.config import (EnvConfig, ObsConfig, PPOConfig, SACConfig, actor_net_config,
                                   critic_net_config)
from hope_tpu_torch.envs import ParkingEnv, make_scene, stack_scenes
from hope_tpu_torch.geometry import pose_to_box
from hope_tpu_torch.models import MultiObsEmbedding
from hope_tpu_torch.parallel.launch import rank_group
from hope_tpu_torch.parallel.mesh import (Mesh, agree, all_reduce_sum, barrier, gather_replicated,
                                          gather_to_root, shard_batch)
from hope_tpu_torch.train.chunked import PPOChunkDraws, build_ppo_chunk, build_sac_chunk

B, K, U, SGD, MEM = 16, 2, 2, 8, 64
PPO_MB, PPO_EPOCHS = 8, 2
ON_DEST = (1, 6, 9, 14)


def setup(kind: str):
    """(env, agent, agent state, scenes) of the fixture, on the CPU."""
    obs_cfg = ObsConfig(use_img=False)
    env_cfg = EnvConfig(obs=obs_cfg, max_edges=32, max_obstacles=4, rs_max_points=64,
                        rs_max_tries=2)
    env = ParkingEnv(env_cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if kind == "sac":
        agent = SACAgent(MultiObsEmbedding(actor_net_config(obs_cfg)), SACConfig(),
                         critic_net_config(obs_cfg, action_input=True))
        st = agent.init(env.observation_shape, gen)
    else:
        agent = PPOAgent(actor_net_config(obs_cfg), critic_net_config(obs_cfg),
                         PPOConfig(mini_batch=PPO_MB, mini_epoch=PPO_EPOCHS), env.mask_table)
        st = agent.init(env.observation_shape, gen)
    corners = torch.as_tensor(env_cfg.vehicle.box_corners(), dtype=torch.float32)
    room = np.array([[-8.0, -8], [8, -8], [8, 8], [-8, 8]])
    dest = [3.0, 0.0, 0.0]
    dest_box = pose_to_box(torch.tensor(dest), corners).numpy()
    starts = [dest if i in ON_DEST else [-2.0 + 0.25 * i, 0.5 * (i % 3), 0.1 * (i % 4)]
              for i in range(B)]
    scenes = [make_scene([room], start, dest, [-10, 10, -10, 10], 0, 0, dest_box, max_edges=32,
                         max_polys=4, device="cpu") for start in starts]
    return env, agent, st, stack_scenes(scenes)


def ppo_draws(n_actions: int) -> PPOChunkDraws:
    """The PPO chunk's Gumbel noise and permutations, from a numpy seed."""
    rng = np.random.default_rng(3)
    u = rng.uniform(np.finfo(np.float32).tiny, 1.0, (K, B, n_actions)).astype(np.float32)
    perms = np.stack([rng.permutation(K * B) for _ in range(PPO_EPOCHS)])
    return PPOChunkDraws(gumbel=torch.as_tensor(-np.log(-np.log(u))),
                         perms=torch.as_tensor(perms))


def _state_dicts(st, names):
    return {n: copy.deepcopy(getattr(st, n).state_dict()) for n in names}


def run(kind: str, mesh: Mesh) -> dict:
    """One chunk of the fixture on this rank's block (the whole batch for
    one rank); returns what the tests compare, on the CPU."""
    env, agent, st, scenes = setup(kind)
    pool_idx = shard_batch(torch.arange(B, dtype=torch.int32), mesh)
    env_state, obs = env.batch_reset(shard_batch(scenes, mesh))
    hybrid = HybridState.create(pool_idx.shape[0], env.cfg.rs_queue_len, "cpu")
    reset_queue = (torch.arange(2 * B, dtype=torch.int32) * 5 + 3) % B
    gen = torch.Generator().manual_seed(1)
    out = {}
    if kind == "sac":
        ex = {**{f"{p}/{k}": v[0] for p in ("obs", "next_obs") for k, v in obs.items()},
              "action": torch.zeros(2), "reward": torch.zeros(()),
              "done": torch.zeros((), dtype=torch.bool), "log_prob": torch.zeros(())}
        ring = replay_create(MEM, ex, mesh)
        chunk = build_sac_chunk(env, agent, env.cfg.step_ratio, K, U, SGD, mesh)
        (st, env_state, hybrid, obs, pool_idx, ring, logs, metrics) = chunk(
            st, env_state, hybrid, obs, pool_idx, ring, scenes, reset_queue, gen, warmup=False)
        out["ring"] = {"data": ring.data, "cursor": ring.cursor, "size": ring.size}
        nets = ("actor", "critic1", "critic2", "target1", "target2", "opt_actor",
                "opt_critic1", "opt_critic2", "opt_alpha")
        out["tensors"] = {"log_std": st.log_std.detach(), "log_alpha": st.log_alpha.detach()}
    else:
        chunk = build_ppo_chunk(env, agent, env.cfg.step_ratio, K, mesh)
        (st, env_state, hybrid, obs, pool_idx, logs, metrics, buffer) = chunk(
            st, env_state, hybrid, obs, pool_idx, scenes, reset_queue, gen,
            ppo_draws(env.cfg.mask.n_actions))
        out["buffer"] = buffer
        nets = ("actor", "critic", "critic_target", "opt_actor", "opt_critic")
        out["tensors"] = {"log_std": st.log_std.detach()}
    out.update(logs=logs, metrics={k: v.detach() for k, v in metrics.items()},
               nets=_state_dicts(st, nets), steps=st.steps,
               norm={"mean": st.norm.mean, "S": st.norm.S, "n": st.norm.n},
               pose=env_state.vehicle.pose, obs=obs, pool_idx=pool_idx,
               hybrid={"queue": hybrid.queue, "length": hybrid.length,
                       "cursor": hybrid.cursor},
               generator=gen.get_state())
    return out


def collective_tree() -> dict:
    """A tree of 8 rows with a leaf of each dtype the loop sends; x[0, 0] is
    -0.0."""
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3) - 5.0
    x[0, 0] = -0.0
    return {"x": x, "i": torch.arange(8, dtype=torch.int32) * 7,
            "b": torch.arange(8) % 3 == 0, "u": torch.arange(8, dtype=torch.uint8) + 200}


def rank_values(rank: int) -> torch.Tensor:
    return torch.tensor([1.5, -2.0, 0.25]) * (rank + 1)


def collectives(mesh: Mesh) -> dict:
    """Each collective of ``parallel.mesh`` once, on this rank's block of
    :func:`collective_tree`."""
    tree = collective_tree()
    block = shard_batch(tree, mesh)
    gathered = gather_replicated(block, mesh)
    root = gather_to_root(block, mesh)
    lo, hi = mesh.bounds(8)
    own = (torch.arange(8) >= lo) & (torch.arange(8) < hi)
    owned = {k: torch.where(own.reshape((-1,) + (1,) * (v.ndim - 1)), v, torch.zeros_like(v))
             for k, v in tree.items()}
    all_reduce_sum(list(owned.values()), mesh, as_bytes=True)
    float_sum = rank_values(mesh.rank)
    all_reduce_sum([float_sum], mesh)
    barrier(mesh)
    agreed = [agree(mesh.rank == 1, mesh), agree(False, mesh)]
    return {"gathered": gathered, "root": root, "owned_sum": owned, "float_sum": float_sum,
            "agree": agreed, "stats": dict(mesh.stats)}


def train(kind: str, coordinator: str, rank: int, world: int, device: str, log_dir: str) -> dict:
    """Two --smoke chunks of the CLI's rank worker on ``device`` over gloo:
    the state's parameters and Adam states, the episode count and each
    kernel's launches in this rank."""
    from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide
    from hope_tpu_torch.train import train_ppo, train_sac

    cli = train_sac if kind == "train_sac" else train_ppo
    args = cli.parse_args(["--smoke", "--devices", str(world), "--max-chunks", "2",
                           "--no-tensorboard", "--save-every", "0", "--log-dir", log_dir])
    args.coordinator = coordinator
    res = cli.rank_worker(args, rank, world, device, "gloo")
    st = res["loop"]["state"]
    nets = [n for n in ("actor", "critic1", "critic2", "target1", "target2", "critic",
                        "critic_target", "opt_actor", "opt_critic1", "opt_critic2", "opt_alpha",
                        "opt_critic") if hasattr(st, n)]
    return {"nets": {n: _to_cpu(copy.deepcopy(getattr(st, n).state_dict())) for n in nets},
            "chunks": res["chunks"],
            "launches": {m.__name__.split(".")[-1]: m.KERNEL.launches
                         for m in (mask_steps, raster_bev, sweep_collide)}}


def final_eval(kind: str, coordinator: str, rank: int, world: int, path: str) -> dict:
    """One --smoke chunk with --final-eval 1 through the CLI's rank worker.
    Rank 1 leaves a marker file once its worker has returned; rank 0's
    battery starts only when the marker is there (at most ``wait`` s): a
    rank that stayed in the process group until rank 0's eval ended would
    hold rank 0 up to the wait's timeout. Returns whether rank 0 ran the
    battery, its success rates and the seconds it waited."""
    from hope_tpu_torch.evaluation import eval_mix_scene
    from hope_tpu_torch.train import train_ppo, train_sac

    cli = train_sac if kind == "final_eval_sac" else train_ppo
    args = cli.parse_args(["--smoke", "--devices", str(world), "--max-chunks", "1",
                           "--no-tensorboard", "--save-every", "0", "--final-eval", "1",
                           "--log-dir", path + ".log"])
    args.coordinator = coordinator
    marker = os.path.join(os.path.dirname(path), f"{kind}_rank1_returned")
    out, wait, battery = {"battery": None, "waited_s": None}, 60.0, eval_mix_scene.run_battery

    def held_battery(*a, **kw):
        t0 = time.monotonic()
        while not os.path.exists(marker):
            if time.monotonic() - t0 > wait:
                raise TimeoutError(f"rank 1 still in its worker {wait} s into rank 0's eval")
            time.sleep(0.02)
        out["waited_s"] = time.monotonic() - t0
        res = battery(*a, **kw)
        out["battery"] = {lv: r["success_rate"] for lv, r in res.items()}
        return res

    eval_mix_scene.run_battery = held_battery
    cli.rank_worker(args, rank, world, "cpu", "gloo")
    if rank == 1:
        open(marker, "w").close()
    return out


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def main(argv):
    kind, coordinator, rank, world, path, *device = argv
    torch.set_num_threads(1)
    if kind.startswith("final_eval_"):
        out = final_eval(kind, coordinator, int(rank), int(world), path)
    elif kind.startswith("train_"):
        out = train(kind, coordinator, int(rank), int(world), (device or ["cpu"])[0],
                    path + ".log")
    else:
        with rank_group(coordinator, int(rank), int(world), "cpu", "gloo") as mesh:
            out = collectives(mesh) if kind == "collectives" else run(kind, mesh)
    torch.save(out, path)


if __name__ == "__main__":
    main(sys.argv[1:])
