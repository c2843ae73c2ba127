"""The port's data-parallel ranks (``hope_tpu_torch.parallel``) on the CPU.

- ``shard_batch`` / ``replicate`` / the gather against the JAX package's
  ``NamedSharding`` shards on the 8-device CPU mesh of ``tests/conftest.py``:
  exact.
- The collectives across 2 gloo ranks (separate processes, as a multi-device
  run has them): the gathers, the sums (of bytes, exact), the barrier and the
  agreed stop.
- One SAC chunk and one PPO chunk of ``tests/torch_parallel_cases.py`` (the
  fixture of ``tests/chunk_fixture.py``) on 2 gloo ranks against the same
  chunk in one process. The ranks are bitwise equal to each other
  (parameters, Adam states, normalizer, metrics, logs, generator). Against
  one process the collect is bitwise (logs, rewards, env and hybrid state,
  the replay ring or the PPO buffer, the normalizer: every rank runs the
  policy on the whole batch and the Welford step on the gathered one, and
  the env's own ops do not depend on the batch size); the updates are held
  to the JAX package's tolerances for its sharded chunk
  (``tests/test_parallel.py:126-128``, actor parameters rtol 2e-4 / atol
  1e-6), since each gradient is the sum of the ranks' halves and rounds
  otherwise than the one-process one.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hope_tpu.parallel.mesh import gather_replicated as jgather
from hope_tpu.parallel.mesh import make_mesh as jmake_mesh
from hope_tpu.parallel.mesh import replicate as jreplicate
from hope_tpu.parallel.mesh import shard_batch as jshard
from hope_tpu_torch.parallel.launch import free_port
from hope_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch

from . import torch_parallel_cases as cases
from .torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2


def spawn_ranks(kind: str, out_dir, world: int = WORLD, timeout: int = 300) -> list:
    """Run ``tests.torch_parallel_cases`` as ``world`` gloo rank processes;
    returns each rank's outputs."""
    coord = f"localhost:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    paths = [os.path.join(out_dir, f"{kind}_{r}.pt") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_cases", kind, coord,
                               str(r), str(world), paths[r]], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return [torch.load(p, weights_only=False) for p in paths]


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def assert_bitwise(a, b, err=""):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys(), err
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), f"{err}{k}"
        else:
            assert fa[k] == fb[k], f"{err}{k}"


def whole(ranks, key):
    """The ranks' blocks of ``key`` concatenated in rank order."""
    return torch.cat([r[key] for r in ranks])


# ------------------------------------------------------------- sharding

@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_])
def test_sharding_matches_named_sharding(dtype):
    """Rank r's block is the JAX array's shard on device r of the 8-device
    mesh, a replicated leaf is whole on every rank, and the blocks in rank
    order are JAX's gathered array: exact."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, 3)) * 10
    x = (x > 0) if dtype is np.bool_ else x.astype(dtype)
    mesh = jmake_mesh()
    world = len(mesh.devices.ravel())
    assert world == 8
    sharded = jshard(jnp.asarray(x), mesh)
    by_start = {s.index[0].start or 0: np.asarray(s.data) for s in sharded.addressable_shards}
    blocks = []
    for r in range(world):
        got = shard_batch({"x": torch.as_tensor(x)}, Mesh(world=world, rank=r))["x"]
        lo, _ = Mesh(world=world, rank=r).bounds(16)
        np.testing.assert_array_equal(got.numpy(), by_start[lo])
        blocks.append(got)
        rep = replicate(torch.as_tensor(x), Mesh(world=world, rank=r))
        for s in jreplicate(jnp.asarray(x), mesh).addressable_shards:
            np.testing.assert_array_equal(rep.numpy(), np.asarray(s.data))
    np.testing.assert_array_equal(torch.cat(blocks).numpy(),
                                  np.asarray(jax.device_get(jgather(sharded, mesh))))


def test_collectives_across_two_ranks(tmp_path):
    """gather_replicated (a tree of float, int, bool and uint8 leaves),
    gather_to_root, the byte sum of rows each rank owns (-0.0 kept) and the
    float sum, the barrier and the agreed stop, on 2 gloo ranks."""
    ranks = spawn_ranks("collectives", tmp_path)
    want = cases.collective_tree()
    for r, got in enumerate(ranks):
        assert_bitwise(got["gathered"], want, f"rank {r} gather ")
        assert_bitwise(got["owned_sum"], want, f"rank {r} byte sum ")
        assert torch.equal(got["float_sum"], sum(cases.rank_values(q) for q in range(WORLD)))
        assert got["agree"] == [True, False]
        assert got["stats"]["calls"] >= 5 and got["stats"]["bytes"] > 0
    assert_bitwise(ranks[0]["root"], want, "root ")
    assert ranks[1]["root"] is None
    assert torch.signbit(ranks[1]["owned_sum"]["x"][0, 0])      # -0.0 survived the sum


# ------------------------------------------------------------ SAC chunk

@pytest.fixture(scope="module")
def sac(tmp_path_factory):
    ranks = spawn_ranks("sac", tmp_path_factory.mktemp("sac"))
    return cases.run("sac", Mesh()), ranks


SHARED = ("nets", "tensors", "norm", "metrics", "logs", "steps", "generator")


def test_sac_ranks_bitwise_equal(sac):
    _, ranks = sac
    for r in ranks[1:]:
        assert_bitwise({k: ranks[0][k] for k in SHARED}, {k: r[k] for k in SHARED})
    assert ranks[0]["steps"] == cases.U
    assert ranks[0]["ring"]["size"] == cases.B * cases.K


def assert_collect_equal(one, ranks):
    """The whole batch's logs, the ranks' env and hybrid state in rank order
    and the normalizer: bitwise the one-process chunk's."""
    assert_bitwise(ranks[0]["logs"], one["logs"], "logs ")
    for k in ("pool_idx", "pose"):
        assert torch.equal(whole(ranks, k), one[k]), k
    for k, v in one["hybrid"].items():
        assert torch.equal(torch.cat([r["hybrid"][k] for r in ranks]), v), k
    for k, v in one["obs"].items():
        assert torch.equal(torch.cat([r["obs"][k] for r in ranks]), v), k
    assert_bitwise(ranks[0]["norm"], one["norm"], "norm ")
    assert int(one["norm"]["n"]) == cases.B * cases.K
    # the queue-fed reset ran on both ranks: envs on their destination
    # arrived at the first step, on each rank, and took the queue's entries
    # in the whole batch's order
    done = one["logs"]["done"][0].nonzero().flatten().tolist()
    assert set(done) <= set(cases.ON_DEST) and min(done) < cases.B // 2 <= max(done)
    queue = [(5 * j + 3) % cases.B for j in range(len(done))]
    assert one["logs"]["pool_idx"][1][done].tolist() == queue


def test_sac_collect_matches_one_process(sac):
    one, ranks = sac
    assert_collect_equal(one, ranks)


def test_sac_ring_matches_one_process(sac):
    """The ring's blocks in rank order are the one-process ring, bitwise,
    with the same cursor and size."""
    one, ranks = sac
    assert (ranks[0]["ring"]["cursor"], ranks[0]["ring"]["size"]) == \
        (one["ring"]["cursor"], one["ring"]["size"])
    for k, v in one["ring"]["data"].items():
        assert torch.equal(torch.cat([r["ring"]["data"][k] for r in ranks]), v), k


def test_sac_parameters_match_one_process(sac):
    """The actor to JAX's rtol 2e-4 / atol 1e-6; the critics and targets
    within 2 U lr_critic (test_torch_train's ADAM_NOISE reasoning: an Adam
    step is lr g / (|g| + eps), so an entry whose gradient is at rounding
    level may move by up to lr either way each update), with at most 1
    entry in 10^3 above 1e-6; metrics to rtol 1e-4."""
    one, ranks = sac
    got, want = ranks[0]["nets"], one["nets"]
    for k, v in want["actor"].items():
        np.testing.assert_allclose(got["actor"][k].numpy(), v.numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    lr = cases.SACConfig().lr_critic
    n = loose = 0
    for net in ("critic1", "critic2", "target1", "target2"):
        for k, v in want[net].items():
            d = (got[net][k] - v).abs()
            assert float(d.max()) <= max(1e-6, 2 * cases.U * lr), (net, k)
            n, loose = n + d.numel(), loose + int((d > 1e-6).sum())
    assert loose <= 1e-3 * n, (loose, n)
    for k, v in one["metrics"].items():
        assert float(ranks[0]["metrics"][k]) == pytest.approx(float(v), rel=1e-4, abs=1e-6), k


# ------------------------------------------------------------ PPO chunk

@pytest.fixture(scope="module")
def ppo(tmp_path_factory):
    ranks = spawn_ranks("ppo", tmp_path_factory.mktemp("ppo"))
    return cases.run("ppo", Mesh()), ranks


def test_ppo_ranks_bitwise_equal(ppo):
    _, ranks = ppo
    for r in ranks[1:]:
        assert_bitwise({k: ranks[0][k] for k in SHARED}, {k: r[k] for k in SHARED})
        assert_bitwise(ranks[0]["buffer"], r["buffer"])
    assert ranks[0]["steps"] == 1


def test_ppo_collect_and_buffer_match_one_process(ppo):
    """The collect and the whole (K, B) buffer that every rank holds:
    bitwise the one-process chunk's."""
    one, ranks = ppo
    assert_collect_equal(one, ranks)
    assert_bitwise(ranks[0]["buffer"], one["buffer"], "buffer ")


def test_ppo_parameters_match_one_process(ppo):
    """Actor and critic to JAX's rtol 2e-4 / atol 1e-6 (the buffer is the
    same, so only the split of each minibatch's gradient rounds otherwise);
    the metrics to 1e-6."""
    one, ranks = ppo
    for net in ("actor", "critic", "critic_target"):
        for k, v in one["nets"][net].items():
            np.testing.assert_allclose(ranks[0]["nets"][net][k].numpy(), v.numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=f"{net} {k}")
    for k, v in one["metrics"].items():
        assert float(ranks[0]["metrics"][k]) == pytest.approx(float(v), abs=1e-6), k
