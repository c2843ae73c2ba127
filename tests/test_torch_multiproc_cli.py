"""The training CLIs across ranks on the CPU (gloo), in the style of
``tests/test_multihost.py``: ``--devices 2`` with the ranks spawned by the
CLI, and ``--coordinator / --num-processes 2 / --process-id`` with two
launched processes. Both ranks finish with the same ``final_episodes``;
rank 0 alone writes the log directory.

A full checkpoint across 2 ranks holds the one-process layout: at the end of
the warm-up chunk (collect only) it is bitwise the 1-process run's at the
same chunk, and resumed in one process it reproduces the uninterrupted
1-process run bitwise (as ``tests/test_torch_resume.py`` holds a resume to).
A 1-process checkpoint resumes on 2 ranks (resharded). No tolerance: every
comparison is exact.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hope_tpu_torch.parallel.launch import free_port
from hope_tpu_torch.train import train_ppo, train_sac

from .test_torch_resume import flat, host, metrics
from .torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PPO_COMMON = ["--smoke", "--device", "cpu", "--no-tensorboard", "--save-every", "0", "--seed", "7"]
COMMON = PPO_COMMON + ["--log-every", "1"]


def cli(module: str, argv_per_proc: list, timeout: int = 300) -> list:
    """Run ``python -m <module>`` once per argv list, all at once; returns
    each process's output (asserting exit code 0)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for argv in argv_per_proc]
    outs = []
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=timeout)
        assert p.returncode == 0, f"process {i}:\n{out[-4000:]}"
        outs.append(out)
    return outs


def finals(out: str) -> list:
    return [json.loads(ln)["final_episodes"] for ln in out.splitlines()
            if ln.startswith("{") and "final_episodes" in ln]


def state(log_dir, step):
    return torch.load(os.path.join(log_dir, "ckpt_full", f"step_{step}", "state.pt"),
                      weights_only=True)


def assert_states_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def only_step(src_log, step, dst):
    """A checkpoint directory holding step ``step`` of ``src_log``'s alone."""
    src = os.path.join(src_log, "ckpt_full")
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, f"step_{step}"), os.path.join(dst, f"step_{step}"))
    shutil.copy(os.path.join(src, f"host_{step}.json"), dst)
    return dst


@pytest.fixture(scope="module")
def sac_runs(tmp_path_factory):
    """3 chunks (1 warm-up) with a full checkpoint every chunk: in one
    process (a), on 2 spawned ranks (b); then (c) a's run from b's chunk 1
    in one process, (e) on 2 ranks from a's chunk 1 to chunk 2."""
    root = tmp_path_factory.mktemp("mp_sac")
    d = {k: str(root / k) for k in "abce"}
    run = COMMON + ["--full-save-every", "1"]
    train_sac.main(run + ["--max-chunks", "3", "--log-dir", d["a"]])
    (out_b,) = cli("hope_tpu_torch.train.train_sac",
                   [run + ["--max-chunks", "3", "--devices", "2", "--log-dir", d["b"]]])
    train_sac.main(run + ["--max-chunks", "3", "--log-dir", d["c"], "--resume",
                          only_step(d["b"], 1, str(root / "b1"))])
    (out_e,) = cli("hope_tpu_torch.train.train_sac",
                   [run + ["--max-chunks", "2", "--devices", "2", "--log-dir", d["e"],
                           "--resume", only_step(d["a"], 1, str(root / "a1"))]])
    return d, out_b, out_e


def test_train_sac_two_spawned_ranks(sac_runs):
    """Both ranks finish with the same episode count; rank 0 wrote the log
    (one line per chunk), the agent checkpoint and the full ones."""
    d, out, _ = sac_runs
    f = finals(out)
    assert len(f) == 2 and f[0] == f[1]
    assert out.count('"multihost": "barrier passed"') == 2
    assert sorted(metrics(d["b"])) == [1, 2, 3]
    assert os.path.isdir(os.path.join(d["b"], "ckpt", "step_3"))
    assert all(os.path.exists(os.path.join(d["b"], "ckpt_full", f"host_{s}.json"))
               for s in (1, 2, 3))


def test_two_rank_full_checkpoint_is_the_one_process_one(sac_runs):
    """After the warm-up chunk the 2-rank file (env and hybrid state,
    observations, pool indices and the replay ring gathered in rank order;
    agent, pool and generators from rank 0) equals the 1-process file
    tensor for tensor, and the host JSON too."""
    d, _, _ = sac_runs
    assert_states_equal(state(d["b"], 1), state(d["a"], 1))
    assert host(d["b"], 1) == host(d["a"], 1)
    ring = state(d["b"], 3)["replay"]
    assert ring["data"]["action"].shape[0] == ring["capacity"] == 512
    assert ring["size"] == ring["cursor"] == 3 * 4 * 4          # 3 chunks of K = 4, B = 4


def test_two_rank_checkpoint_resumes_in_one_process(sac_runs):
    """b's chunk-1 checkpoint resumed in one process reproduces a's chunks 2
    and 3: metrics, host state and the full checkpoint, bitwise."""
    d, _, _ = sac_runs
    ma, mc = metrics(d["a"]), metrics(d["c"])
    assert sorted(mc) == [2, 3]
    for s in (2, 3):
        assert {k: v for k, v in mc[s].items() if k != "elapsed" and "per_sec" not in k} == \
            {k: v for k, v in ma[s].items() if k != "elapsed" and "per_sec" not in k}
    assert host(d["c"], 3) == host(d["a"], 3)
    assert_states_equal(state(d["c"], 3), state(d["a"], 3))


def test_one_process_checkpoint_resumes_on_two_ranks(sac_runs):
    """a's chunk-1 checkpoint resharded onto 2 ranks: the counters go on from
    chunk 1, the ring holds two chunks, the gathered checkpoint has the
    one-process shapes."""
    d, _, out = sac_runs
    assert '"mode": "full", "chunk": 1' in out
    assert sorted(metrics(d["e"])) == [2]
    st, st_a = state(d["e"], 2), state(d["a"], 2)
    assert st["replay"]["size"] == st_a["replay"]["size"] == 2 * 4 * 4
    assert torch.equal(st["pool_idx"], st_a["pool_idx"])
    for k, v in st_a["replay"]["data"].items():
        assert st["replay"]["data"][k].shape == v.shape, k
    assert (host(d["e"], 2)["counters"]["total_steps"]
            == host(d["a"], 2)["counters"]["total_steps"])


def test_train_sac_launched_processes(tmp_path):
    """--coordinator / --num-processes 2 / --process-id: two launched
    processes of one rank each agree on the episode stream; only process 0
    writes (its log directory has the checkpoints, process 1's nothing)."""
    coord = f"localhost:{free_port()}"
    argv = [COMMON + ["--devices", "2", "--coordinator", coord, "--num-processes", "2",
                      "--process-id", str(i), "--max-chunks", "2",
                      "--log-dir", str(tmp_path / f"proc{i}")] for i in range(2)]
    outs = cli("hope_tpu_torch.train.train_sac", argv)
    (f0,), (f1,) = finals(outs[0]), finals(outs[1])
    assert f0 == f1
    assert (tmp_path / "proc0" / "ckpt").exists() and (tmp_path / "proc0" / "ckpt_full").exists()
    assert not (tmp_path / "proc1").exists()


def test_train_ppo_spawned_and_launched(tmp_path):
    """train_ppo on 2 spawned ranks, and as two launched processes: both
    ranks finish with equal episode counts, rank 0 alone writes the agent
    checkpoint; the spawned run's checkpoint equals the launched one's
    (the same ranks, started otherwise)."""
    run = PPO_COMMON + ["--max-chunks", "2"]
    (out,) = cli("hope_tpu_torch.train.train_ppo",
                 [run + ["--devices", "2", "--log-dir", str(tmp_path / "spawned")]])
    f = finals(out)
    assert len(f) == 2 and f[0] == f[1]
    coord = f"localhost:{free_port()}"
    outs = cli("hope_tpu_torch.train.train_ppo",
               [run + ["--devices", "2", "--coordinator", coord, "--num-processes", "2",
                       "--process-id", str(i), "--log-dir", str(tmp_path / f"proc{i}")]
                for i in range(2)])
    assert finals(outs[0]) == finals(outs[1]) == f[:1]
    assert (tmp_path / "proc0" / "ckpt").exists() and not (tmp_path / "proc1").exists()
    load = lambda d: torch.load(os.path.join(d, "ckpt", "step_2", "state.pt"),  # noqa: E731
                                weights_only=True)
    assert_states_equal(load(tmp_path / "spawned"), load(tmp_path / "proc0"))


@pytest.mark.parametrize("kind", ["final_eval_sac", "final_eval_ppo"])
def test_final_eval_on_two_ranks(tmp_path, kind):
    """--final-eval 1 on 2 ranks: rank 0 alone runs the battery, and rank 1
    has left its worker before the battery starts (rank 0 waits for it), so
    no rank waits out rank 0's eval in a barrier."""
    coord = f"localhost:{free_port()}"
    cli("tests.torch_parallel_cases",
        [[kind, coord, str(r), "2", str(tmp_path / f"{kind}_{r}.pt")] for r in range(2)])
    r0, r1 = (torch.load(tmp_path / f"{kind}_{r}.pt", weights_only=False) for r in range(2))
    assert r1["battery"] is None and r0["waited_s"] is not None
    assert sorted(r0["battery"]) == ["Complex", "Extrem", "Normal"]
    assert all(0.0 <= v <= 1.0 for v in r0["battery"].values())


def test_smoke_batch_follows_devices():
    """--smoke takes max(4, 2 * devices) envs, as the JAX CLIs do."""
    assert train_sac.parse_args(["--smoke", "--devices", "4"]).batch_envs == 8
    assert train_sac.parse_args(["--smoke"]).batch_envs == 4
    assert train_ppo.parse_args(["--smoke", "--devices", "3"]).batch_envs == 6
