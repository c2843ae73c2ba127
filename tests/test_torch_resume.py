"""Full-loop checkpoints and resume in the port, on the CPU: a run killed at
chunk 3 and resumed reproduces the uninterrupted run's metrics and host
state bitwise (as ``tests/test_resume.py`` holds the JAX package to), the
full checkpoint round-trips every tensor and generator state, a streamed
pool keeps its one-refresh lag across a resume, and the agent-only paths
(``--resume`` of an agent checkpoint, ``--init-params``, ``train_ppo
--resume``) and ``--profile-chunks`` work. No tolerance: every comparison
is exact.
"""
import json
import os

import pytest
import torch

from hope_tpu_torch.train import resume, train_ppo, train_sac
from hope_tpu_torch.utils.checkpoint import load_actor_only, save_checkpoint

from .torch_threads import one_torch_thread  # noqa: F401

COMMON = ["--smoke", "--device", "cpu", "--no-tensorboard", "--save-every", "0", "--seed", "7",
          "--log-every", "1"]
# a streamed DLP pool at a small size, refreshed every chunk
STREAM = ["--device", "cpu", "--no-tensorboard", "--save-every", "0", "--seed", "5",
          "--log-every", "1", "--batch-envs", "4", "--chunk-steps", "2", "--warmup-chunks", "1",
          "--updates-per-step", "1", "--sgd-batch", "8", "--memory", "64", "--pool-per-level",
          "2", "--no-img", "--pool-refresh", "1", "--stream-dlp"]


def metrics(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return {d["step"]: d for d in map(json.loads, f)}


def host(log_dir, step):
    with open(os.path.join(log_dir, "ckpt_full", f"host_{step}.json")) as f:
        return json.load(f)


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """An uninterrupted 6-chunk run; one killed at chunk 3; its resume to
    chunk 6, tracing chunk 5."""
    root = tmp_path_factory.mktemp("resume")
    d = {k: str(root / k) for k in ("a", "b", "b2")}
    out = {"a": train_sac.main(COMMON + ["--max-chunks", "6", "--log-dir", d["a"]]),
           "b": train_sac.main(COMMON + ["--max-chunks", "3", "--log-dir", d["b"]]),
           "b2": train_sac.main(COMMON + ["--max-chunks", "6", "--log-dir", d["b2"], "--resume",
                                          os.path.join(d["b"], "ckpt_full"),
                                          "--profile-chunks", "1"])}
    return d, out


def test_kill_and_resume_reproduces_run(runs):
    d, out = runs
    assert [r["chunk"] for r in out["b2"]["chunks"]] == [4, 5, 6]
    ma, mb = metrics(d["a"]), metrics(d["b2"])
    assert sorted(mb) == [4, 5, 6]
    for step in (4, 5, 6):
        for k, v in ma[step].items():
            if k not in ("elapsed", "env_steps_per_sec"):
                assert mb[step][k] == v, (step, k)
    ha, hb = host(d["a"], 6), host(d["b2"], 6)
    assert ha == hb                      # counters, chooser tails and rng states, queue rng
    assert ha["counters"]["n_chunk"] == 6 and ha["counters"]["total_steps"] == 6 * 16
    sa, sb = out["a"]["loop"]["state"], out["b2"]["loop"]["state"]
    for n in ("actor", "critic1", "critic2", "target1", "target2"):
        for (k, x), y in zip(getattr(sa, n).state_dict().items(),
                             getattr(sb, n).state_dict().values()):
            assert torch.equal(x, y), (n, k)


def test_full_checkpoint_round_trips(runs):
    """The file holds exactly the live loop at exit; loading it into
    another loop's objects restores every tensor and generator state."""
    d, out = runs
    live_a = resume.to_tree(out["a"]["loop"]["full_state"]()[0])
    saved = torch.load(os.path.join(d["a"], "ckpt_full", "step_6", "state.pt"), weights_only=True)
    fa, fs = flat(live_a), flat(saved)
    assert set(fa) == set(fs) and any("/generator" in k for k in fa)
    for k, v in fa.items():
        assert torch.equal(v, fs[k]) if isinstance(v, torch.Tensor) else v == fs[k], k
    assert fs["/replay/size"] == 6 * 16 and fs["/replay/cursor"] == 6 * 16 % 512
    # into the loop of the killed run (at chunk 3): every leaf becomes run a's
    template = out["b"]["loop"]["full_state"]()[0]
    dev, h, step = resume.load_full(os.path.join(d["a"], "ckpt_full"), template)
    assert step == 6 and h == host(d["a"], 6)
    for k, v in flat(resume.to_tree(dev)).items():
        assert torch.equal(v, fs[k]) if isinstance(v, torch.Tensor) else v == fs[k], k
    assert dev["agent"] is out["b"]["loop"]["state"]          # restored in place
    assert dev["replay"] is out["b"]["loop"]["replay"]


def test_profile_chunks_writes_trace(runs):
    d, _ = runs
    with open(os.path.join(d["b2"], "trace", "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"sac_chunk/collect", "sac_chunk/update"} <= names


def test_streamed_resume_keeps_the_lag(tmp_path):
    """A streamed DLP pool refreshed every chunk, killed at chunk 2 and
    resumed: the pool's case ids and the prefetch in flight carry over, so
    chunk 3 and the host state equal the uninterrupted run's."""
    a, b, b2 = (str(tmp_path / k) for k in ("a", "b", "b2"))
    ra = train_sac.main(STREAM + ["--max-chunks", "3", "--log-dir", a])
    train_sac.main(STREAM + ["--max-chunks", "2", "--log-dir", b])
    rb = train_sac.main(STREAM + ["--max-chunks", "3", "--log-dir", b2, "--resume",
                                  os.path.join(b, "ckpt_full")])
    ha, hb = host(a, 3), host(b2, 3)
    assert ha == hb and ha["counters"]["dlp_pending_ids"] is not None
    # the lag: the ids in flight are the ones the last refresh asked for,
    # which differ from those it put in the pool
    assert ha["counters"]["dlp_pending_ids"] != ha["counters"]["dlp_case_ids"]
    ma, mb = metrics(a), metrics(b2)
    assert {k: v for k, v in ma[3].items() if k not in ("elapsed", "env_steps_per_sec")} \
        == {k: v for k, v in mb[3].items() if k not in ("elapsed", "env_steps_per_sec")}
    pa, pb = ra["loop"]["pool"], rb["loop"]["pool"]
    for f in ("edges", "start", "dest", "case_id"):
        assert torch.equal(getattr(pa.pool, f), getattr(pb.pool, f)), f


def test_agent_only_resume_and_init_params(tmp_path, capsys):
    """--resume of an agent checkpoint loads the agent; --init-params loads
    everything but the Adams. The one chunk each runs is a warm-up chunk,
    which moves no parameter."""
    src = train_sac.main(COMMON + ["--max-chunks", "2", "--log-dir", str(tmp_path / "src")])
    st = src["loop"]["state"]
    capsys.readouterr()
    for flag in ("--resume", "--init-params"):
        res = train_sac.main(COMMON + ["--max-chunks", "1", "--log-dir", str(tmp_path / flag[2:]),
                                       "--seed", "8", flag, str(tmp_path / "src" / "ckpt")])
        lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
        new = res["loop"]["state"]
        for n in ("actor", "critic1", "target2"):
            for x, y in zip(getattr(st, n).parameters(), getattr(new, n).parameters()):
                assert torch.equal(x, y), (flag, n)
        assert torch.equal(st.log_std, new.log_std) and new.steps == st.steps == 4
        if flag == "--resume":
            assert {"resumed": str(tmp_path / "src" / "ckpt"), "mode": "agent-only",
                    "sgd_steps": 4} in lines
            assert len(new.opt_critic1.state) == len(st.opt_critic1.state) > 0
        else:
            assert {"init_params": str(tmp_path / "src" / "ckpt")} in lines
            assert len(new.opt_critic1.state) == 0                 # fresh Adam


def test_load_actor_only(tmp_path):
    """The policy (actor, log_std, normalizer) and nothing else."""
    src = train_sac.main(COMMON + ["--max-chunks", "2", "--log-dir", str(tmp_path / "a")])["loop"]
    dst = train_sac.main(COMMON + ["--max-chunks", "1", "--seed", "9",
                                   "--log-dir", str(tmp_path / "b")])["loop"]
    save_checkpoint(str(tmp_path / "ck"), src["state"], 2)
    critic = [p.clone() for p in dst["state"].critic1.parameters()]
    load_actor_only(str(tmp_path / "ck"), dst["state"])
    s, t = src["state"], dst["state"]
    for x, y in zip(s.actor.parameters(), t.actor.parameters()):
        assert torch.equal(x, y)
    assert torch.equal(s.log_std, t.log_std) and int(s.norm.n) == int(t.norm.n)
    assert all(torch.equal(x, y) for x, y in zip(critic, t.critic1.parameters()))
    assert t.steps == 0


def test_train_ppo_resume(tmp_path, capsys):
    """train_ppo --resume: the agent checkpoint's networks, Adams and update
    count, and training goes on from them."""
    a = train_ppo.main(["--smoke", "--device", "cpu", "--no-tensorboard", "--max-chunks", "1",
                        "--log-dir", str(tmp_path / "a")])
    steps = a["loop"]["state"].steps
    capsys.readouterr()
    b = train_ppo.main(["--smoke", "--device", "cpu", "--no-tensorboard", "--max-chunks", "1",
                        "--seed", "3", "--log-dir", str(tmp_path / "b"), "--resume",
                        str(tmp_path / "a" / "ckpt")])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert {"resumed": str(tmp_path / "a" / "ckpt"), "sgd_steps": steps} in lines
    assert b["loop"]["state"].steps == 2 * steps > 0
