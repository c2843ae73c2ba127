"""The port's ranges and counters (``hope_tpu_torch.utils.profiling``) and
the benchmark's readers of them, on the CPU at a small batch.

With no profiler recording, a range is a shared null context and a counter
keeps nothing: no op is dispatched, nothing is synchronized and
``record_function`` is never entered. Under ``torch.profiler`` the control
step's ranges nest as the layers do, and the RS search counts the rows it
searched and the rows whose answer can be used.
"""
import contextlib
import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from hope_tpu_torch.envs.dlp import DLPDataset
from hope_tpu_torch.envs.rewards import CONTINUE
from hope_tpu_torch.evaluation import eval_mix_scene
from hope_tpu_torch.evaluation.evaluate import build_episode_runner
from hope_tpu_torch.utils import profiling
from portbench.run import load_reader
from portbench.trace import TraceSummary

from .torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(ROOT, "hope_tpu_torch", "assets", "sac_r3b_actor.npz")
B = 4
SPANS = ("eval/step", "policy/act", "env/step", "env/transition", "env/rs_search",
         "env/observe", "env/lidar", "env/reset")
# (inner, outer, n): n of the ``inner`` ranges of ``traced`` lie inside an
# ``outer`` one (the reset observes once, outside any step; the second
# ``batch_step`` runs outside the runner)
NESTING = (("env/lidar", "env/observe", 3), ("env/observe", "env/step", 2),
           ("env/step", "eval/step", 1), ("policy/act", "eval/step", 1),
           ("env/transition", "env/step", 2), ("env/rs_search", "env/step", 2),
           ("env/observe", "env/reset", 1))


class Dispatched(TorchDispatchMode):
    """Records every op dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def battery():
    """The benchmark's SAC actor and full observation on B DLP scenes, half
    of them started 4 m from their slot (within ``rs_max_dist``)."""
    env, agent, st = eval_mix_scene.build(NPZ, device="cpu")
    ds = DLPDataset(env_cfg=env.cfg, device="cpu")
    scenes = ds.batch_reset(torch.arange(B) * 37, generator=torch.Generator().manual_seed(0))
    near = scenes.dest.clone()
    near[:, 0] += 4.0 * torch.cos(near[:, 2])
    near[:, 1] += 4.0 * torch.sin(near[:, 2])
    start = torch.where((torch.arange(B) % 2 == 0)[:, None], near, scenes.start)
    return env, (lambda obs, g: agent.get_action(st, obs, g)), dataclasses.replace(
        scenes, start=start)


@pytest.fixture(scope="module")
def traced(battery):
    """Ranges of one runner step and of one ``batch_step``, profiled."""
    env, act, scenes = battery
    state, obs = env.batch_reset(scenes)
    run = build_episode_runner(env, act, 1)
    with cpu_profile() as prof:
        run(scenes, torch.Generator().manual_seed(1))
        env.batch_step(state, torch.zeros(B, 2))
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name in SPANS]


def test_annotate_off_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    a = profiling.annotate("env/step")
    assert isinstance(a, contextlib.nullcontext) and a is profiling.annotate("eval/step")


def test_off_enters_no_range_and_counts_nothing(battery, monkeypatch):
    """No profiler: a runner step and a ``batch_step`` never enter
    ``record_function``, and the counters stay empty; a range and a count
    dispatch no op (so launch nothing and synchronize nothing)."""
    env, act, scenes = battery

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    profiling.reset_counters()
    state, _ = env.batch_reset(scenes)
    build_episode_runner(env, act, 1)(scenes, torch.Generator().manual_seed(1))
    env.batch_step(state, torch.zeros(B, 2))
    assert profiling.counters() == {}
    want = torch.ones(B, dtype=torch.bool)
    with Dispatched() as mode:
        with profiling.annotate("env/step"):
            profiling.count("env/rs_rows_wanted", want)
            profiling.count("env/rs_rows_searched", B)
        profiling.annotated("env/observe")(lambda: None)()
    assert mode.ops == [] and profiling.counters() == {}


def test_count_on_keeps_the_tensor_and_dispatches_nothing():
    profiling.reset_counters()
    want = torch.tensor([True, False, True])
    with cpu_profile(), Dispatched() as mode:
        profiling.count("c", want)
        profiling.count("c", 4)
    assert mode.ops == []
    assert profiling.counters() == {"c": 6} and profiling.counters() == {"c": 6}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_count_stays_bounded_and_never_reads_back():
    """Over a long profiled run a counter holds fewer than ``_FOLD`` values:
    the pending tensors are added up on their device, never read back."""
    profiling.reset_counters()
    want = torch.tensor([True, False, True])
    n = 3 * profiling._FOLD + 5
    with cpu_profile(), Dispatched() as mode:
        for _ in range(n):
            profiling.count("c", want)
            profiling.count("c", 1)
            assert len(profiling._counts["c"]) < profiling._FOLD
    assert mode.ops and "aten._local_scalar_dense.default" not in mode.ops
    assert profiling.counters() == {"c": 3 * n}
    profiling.reset_counters()


def test_each_span_is_recorded(traced):
    names = [n for n, _, _ in traced]
    # one runner step and one batch_step: two control steps, one reset
    assert {n: names.count(n) for n in SPANS} == {
        "eval/step": 1, "policy/act": 1, "env/step": 2, "env/transition": 2,
        "env/rs_search": 2, "env/observe": 3, "env/lidar": 3, "env/reset": 1}


@pytest.mark.parametrize("inner,outer,n", NESTING,
                         ids=[f"{a}-in-{b}" for a, b, _ in NESTING])
def test_spans_nest(traced, inner, outer, n):
    outers = [(s, t) for name, s, t in traced if name == outer]
    inside = [any(s0 <= s and t <= t0 for s0, t0 in outers)
              for name, s, t in traced if name == inner]
    assert sum(inside) == n


def test_rs_counters_match_the_state(battery):
    """``env/rs_rows_searched`` is B a step; ``env/rs_rows_wanted`` equals
    the rows past their first step, running and within ``rs_max_dist`` of
    their slot, recomputed from each step's state in float64."""
    env, _, scenes = battery
    state, _ = env.batch_reset(scenes)
    steps, wanted = 3, 0
    profiling.reset_counters()
    with cpu_profile():
        for k in range(steps):
            state = env.batch_step(state, torch.full((B, 2), 0.1 * (k + 1)))[0]
            p, d = state.vehicle.pose.double(), state.scene.dest.double()
            dist = torch.hypot(p[:, 0] - d[:, 0], p[:, 1] - d[:, 1])
            wanted += int(((state.t > 1) & (state.status == CONTINUE)
                           & (dist < env.cfg.rs_max_dist)).sum())
    counts = profiling.counters()
    assert counts == {"env/rs_rows_searched": B * steps, "env/rs_rows_wanted": wanted}
    assert 0 < wanted < B * steps


def test_trace_resets_and_writes_counters(tmp_path):
    with cpu_profile():
        profiling.count("env/rs_rows_searched", 100)     # before: not the trace's
    with profiling.trace(str(tmp_path)):
        profiling.count("env/rs_rows_searched", 4)
        profiling.count("env/rs_rows_wanted", torch.tensor([True, False, True, False]))
    with open(tmp_path / "counters.json") as f:
        assert json.load(f) == {"env/rs_rows_searched": 4, "env/rs_rows_wanted": 2}
    assert (tmp_path / "trace.json").exists()
    profiling.reset_counters()


def test_chip_smoke_leaves_range_images_out_of_device_work():
    """``chip_smoke.device_work`` keeps kernels and copies and drops a host
    range's image on the device's timeline: by its flag, by the name of a
    host event, or by a program range's name."""
    import sys
    sys.path.insert(0, ROOT)
    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev=cuda, annot=False):
        return SimpleNamespace(name=name, device_type=dev, is_user_annotation=annot)

    events = [ev("eval/step", cpu), ev("eval/step"), ev("env/lidar", annot=True),
              ev("policy/act"), ev("portbench/policy", cpu), ev("portbench/policy"),
              ev("Optimizer.step#Adam.step"), ev("aten::add", cpu),
              ev("void at::native::elementwise_kernel<128, 2>"),
              ev("Memcpy HtoD (Pageable -> Device)"), ev("raster_bev_kernel")]
    assert [e.name for e in chip_smoke.device_work(events)] == [
        "void at::native::elementwise_kernel<128, 2>", "Memcpy HtoD (Pageable -> Device)",
        "raster_bev_kernel"]


def test_span_launches_gives_each_activity_to_the_innermost_range(tmp_path):
    """``tools/span_launches.py`` on a hand-built Chrome trace: a launch call
    counts for the innermost range open on its own thread, and only where a
    device activity carries its correlation id."""
    import gzip
    import sys
    sys.path.insert(0, ROOT)
    from tools import span_launches

    def x(cat, name, ts, dur, corr=None, tid=1):
        e = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("user_annotation", "eval/step", 0, 100), x("user_annotation", "env/step", 10, 60),
              x("user_annotation", "env/rs_search", 20, 20),
              x("user_annotation", "env/lidar", 0, 100, tid=2),       # another thread's
              x("gpu_user_annotation", "env/step", 12, 70),
              x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=1),    # eval/step
              x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),   # env/rs_search
              x("cuda_runtime", "cudaMemcpyAsync", 30, 1, corr=3),    # env/rs_search
              x("cuda_runtime", "cudaLaunchKernel", 50, 1, corr=4),   # env/step
              x("cuda_runtime", "cudaStreamSynchronize", 60, 1, corr=5),   # no activity
              x("cuda_runtime", "cudaLaunchKernel", 200, 1, corr=6),  # outside any range
              x("kernel", "k1", 6, 1, 1), x("kernel", "k2", 26, 1, 2),
              x("gpu_memcpy", "Memcpy HtoD", 31, 1, 3), x("kernel", "k3", 51, 1, 4),
              x("gpu_memset", "Memset", 201, 1, 6)]
    want = {"env/rs_search": 2, "eval/step": 1, "env/step": 1, "none": 1}
    assert span_launches.span_launches(events) == want
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    assert span_launches.span_launches(span_launches.load(str(path))) == want


# ---------------------------------------------------- the benchmark's readers

def summary(spans=None, kernels=None, units=4):
    return TraceSummary(window_s=1.0, busy_s=0.2, units=units, kernels=kernels or {},
                        spans=spans or {})


SPAN_READERS = (("env_step_ms.eval", "env/step"), ("transition_ms.eval", "env/transition"),
                ("rs_search_ms.eval", "env/rs_search"), ("observe_ms.eval", "env/observe"),
                ("lidar_ms.eval", "env/lidar"))


@pytest.mark.parametrize("metric,span", SPAN_READERS, ids=[m for m, _ in SPAN_READERS])
def test_span_reader_per_step(metric, span):
    read = load_reader(metric)
    assert read({"trace": summary({span: (5, 0.02)})}) == pytest.approx(5.0)   # 20 ms / 4
    assert read({"trace": summary({"other/x": (5, 0.02)})}) is None
    assert read({"trace": None}) is None


def test_policy_act_reader_per_call():
    read = load_reader("policy_act_ms.eval")
    assert read({"trace": summary({"policy/act": (8, 0.04)})}) == pytest.approx(5.0)
    assert read({"trace": summary({"portbench/policy": (8, 0.04)})}) is None
    assert read({"trace": None}) is None


def test_runner_self_reader():
    read = load_reader("runner_self_ms.eval")
    spans = {"eval/step": (4, 0.1), "policy/act": (4, 0.03), "env/step": (4, 0.05),
             "env/transition": (4, 0.01)}
    assert read({"trace": summary(spans)}) == pytest.approx(5.0)    # (100 - 30 - 50) / 4
    assert read({"trace": summary({"portbench/policy": (4, 0.03)})}) is None
    assert read({"trace": None}) is None


def test_launches_per_step_reader():
    read = load_reader("launches_per_step.eval")
    kernels = {"raster_bev_kernel": (4, 0.01), "Memcpy HtoD": (8, 0.001),
               "elementwise_kernel": (28, 0.02)}
    assert read({"trace": summary(kernels=kernels)}) == pytest.approx(10.0)
    assert read({"trace": summary()}) == 0.0
    assert read({"trace": None}) is None


def test_rs_wanted_share_reader():
    read = load_reader("rs_wanted_share.eval")
    profiling.reset_counters()
    assert read({"trace": summary()}) is None                       # nothing searched
    with cpu_profile():
        profiling.count("env/rs_rows_searched", 8)
        profiling.count("env/rs_rows_wanted", torch.tensor([True, False, False, True]))
    assert read({"trace": summary()}) == pytest.approx(25.0)
    assert read({"trace": None}) is None
    profiling.reset_counters()


def test_ilqr_kernel_share_reader():
    """Kernel solves over kernel plus plain solves of the iLQR; nothing to
    read without a trace or where no solve was counted."""
    read = load_reader("ilqr_kernel_share.mpc")
    profiling.reset_counters()
    assert read({"trace": summary()}) is None
    with cpu_profile():
        profiling.count("ilqr/plain_solves", 1)
        for _ in range(3):
            profiling.count("ilqr/kernel_solves", 1)
    assert read({"trace": summary()}) == pytest.approx(75.0)
    assert read({"trace": None}) is None
    profiling.reset_counters()
    with cpu_profile():
        profiling.count("ilqr/kernel_solves", 2)
    assert read({"trace": summary()}) == 100.0
    profiling.reset_counters()


def test_graph_replay_share_reader():
    """Replays over replays plus eager runs of the env step's graphed
    stages; nothing to read where no stage ran on a CUDA device (the CPU)."""
    read = load_reader("graph_replay_share.eval")
    profiling.reset_counters()
    assert read({"trace": summary()}) is None
    with cpu_profile():
        profiling.count("env/graph_eager", 2)
        for _ in range(6):
            profiling.count("env/graph_replays", 1)
    assert read({"trace": summary()}) == pytest.approx(75.0)
    assert read({"trace": None}) is None
    profiling.reset_counters()
    with cpu_profile():
        profiling.count("env/graph_eager", 1)
    assert read({"trace": summary()}) == 0.0
    profiling.reset_counters()
