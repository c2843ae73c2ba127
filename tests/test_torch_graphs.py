"""The env step's graphed chains on the CPU: the RS word tables, the reward
weights and the action mask's edge penalty copied to the device once,
``find_path_batch`` as three stages, and
``utils.graphs.ShapeGraphs``, which on the CPU calls its function as it is.

The tables are held bit for bit to the way they were built before (a copy
from the host on every call), and the staged search to the search as one
function (``_find_path_batch_before``, its body before the split). The
graphs themselves run on the card only (``tests/test_torch_card.py``).
"""
import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hope_tpu_torch.config import ActionMaskConfig, EnvConfig, RewardConfig, VehicleConfig
from hope_tpu_torch.envs import ParkingEnv
from hope_tpu_torch.envs import action_mask, rewards
from hope_tpu_torch.envs.dlp import DLPDataset
from hope_tpu_torch.geometry import box_to_edges, pose_to_box
from hope_tpu_torch.ops.sweep_collide import swept_collide
from hope_tpu_torch.planning import RSPath, find_path_batch
from hope_tpu_torch.planning import reeds_shepp as rs
from hope_tpu_torch.planning.rs_select import (_outbound, prepare_sweep, select_path,
                                               sweep_words)
from hope_tpu_torch.utils import profiling
from hope_tpu_torch.utils.graphs import ShapeGraphs, ungraphed
from hope_tpu_torch.utils.tree import tree_leaves

from .torch_threads import one_torch_thread  # noqa: F401

VCFG = VehicleConfig()
MAXC = VCFG.max_curvature
CORNERS = torch.as_tensor(VCFG.box_corners(), dtype=torch.float32)
B = 24


def _all_words_before(x, y, phi):
    """``rs.all_words`` with its tables copied from the host on each call."""
    c, s = torch.cos(phi), torch.sin(phi)
    bxy = (x * c + y * s, x * s - y * c)
    valids, tuvs = [], []
    for fn, idx in rs._GROUPS.items():
        ins = [[], [], []]
        for i in idx:
            sx, sy, sphi, backwards = rs._TABLE[i][1]
            bx, by = bxy if backwards else (x, y)
            ins[0].append(sx * bx)
            ins[1].append(sy * by)
            ins[2].append(sphi * phi)
        ok, t, u, v = fn(*(torch.stack(a, dim=-1) for a in ins))
        valids.append(ok)
        tuvs.append(torch.stack([t, u, v], dim=-1))
    dev = x.device
    row = torch.as_tensor(rs._ROW, device=dev)
    valid = torch.cat(valids, dim=-1)[..., row]
    tuv = torch.cat(tuvs, dim=-2)[..., row, :]
    src = torch.cat([tuv, torch.full_like(tuv[..., :1], -0.5 * rs.PI),
                     torch.zeros_like(tuv[..., :1])], dim=-1)
    idx = torch.as_tensor(rs._SEG_SRC, device=dev).expand(src.shape)
    lengths = torch.as_tensor(rs._SEG_SIGN, device=dev) * torch.gather(src, -1, idx)
    Ltot = torch.sum(torch.abs(lengths), dim=-1)
    valid = valid & (Ltot >= 0.001) & (Ltot < rs.MAX_LENGTH)
    lengths = torch.where(valid[..., None], lengths, 0.0)
    steers = torch.as_tensor(rs._STEERS, device=dev).expand(lengths.shape)
    return rs.RSCandidates(lengths, steers, valid, torch.where(valid, Ltot, torch.inf))


def _find_path_batch_before(starts, goals, maxc, corners, edges, edge_masks, bounds,
                            n_points=288, step_m=0.1, max_tries=6):
    """``find_path_batch`` as one function, before its split into stages."""
    K = max_tries
    cand = rs.candidates(starts[:, None, :], goals[:, None, :], maxc)
    cand = rs.RSCandidates(*(t.squeeze(1) for t in cand))
    L_m = cand.L / maxc
    Ls, idxs = torch.sort(L_m, dim=1, stable=True)
    Ls, idxs = Ls[:, :K], idxs[:, :K]
    gi = idxs[:, :, None].expand(-1, -1, rs.N_SEG)
    lengths = torch.gather(cand.lengths, 1, gi)
    steers = torch.gather(cand.steers, 1, gi)
    poses, mask, _ = rs.sample_path(lengths, steers, starts[:, None, :], maxc, n_points, step_m)
    outbound = _outbound(poses, mask, bounds[:, None, :])
    B, _, N = poses.shape[:3]
    car_edges = box_to_edges(pose_to_box(poses, corners)).reshape(B, K, N * 4, 4)
    live4 = torch.repeat_interleave(mask, 4, dim=-1)
    collide = swept_collide(car_edges.contiguous(), live4.contiguous(),
                            edges.contiguous(), edge_masks.contiguous()) | outbound
    rank = torch.arange(K, device=starts.device)[None, :]
    sweepable = Ls <= n_points * step_m
    eligible = sweepable & torch.isfinite(Ls) & ((rank < 2) | (Ls <= 1.6 * Ls[:, :1]))
    ok = eligible & ~collide
    found = torch.any(ok, dim=1)
    pick = torch.argmax(ok.to(torch.uint8), dim=1)
    rows = torch.arange(B, device=starts.device)
    f = found[:, None]
    return RSPath(found=found, lengths=torch.where(f, lengths[rows, pick] / maxc, 0.0),
                  steers=torch.where(f, steers[rows, pick], 0.0),
                  L=torch.where(found, Ls[rows, pick], torch.inf))


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.fixture(scope="module")
def dlp():
    """B DLP scenes and poses a third and two thirds of the way in."""
    ds = DLPDataset(env_cfg=EnvConfig(), device="cpu")
    sc = ds.batch_reset(torch.arange(B) * 10, generator=torch.Generator().manual_seed(3))
    a = torch.where(torch.arange(B) % 2 == 0, 1 / 3, 2 / 3)[:, None]
    return sc, sc.start * (1 - a) + sc.dest * a


@pytest.mark.parametrize("shape", [(7,), (3, 46), (2, 5, 4)])
def test_word_tables_once_per_device_bit_identical(shape):
    g = torch.Generator().manual_seed(len(shape))
    x, y = (torch.randn(shape, generator=g) * 6 for _ in range(2))
    phi = (torch.rand(shape, generator=g) * 2 - 1) * np.pi
    x.view(-1)[0], y.view(-1)[0] = 4.0, 0.0          # a straight goal: words tie
    assert_same(rs.all_words(x, y, phi), _all_words_before(x, y, phi))
    start = torch.stack([x, y, phi], dim=-1)
    goal = start.flip(-1)
    assert_same(rs.candidates(start, goal, MAXC),
                _all_words_before(*rs.goal_to_local(start, goal, MAXC)))
    tables = rs._device_tables(torch.device("cpu"))
    assert tables is rs._device_tables(x.device)        # built once
    assert [t.dtype for t in tables] == [torch.int64, torch.int64, torch.float32, torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reward_weights_once_bit_identical(dtype):
    g = torch.Generator().manual_seed(1)
    terms = torch.randn((40, 5), generator=g).to(dtype)
    status = torch.arange(40, dtype=torch.int32) % 5
    for cfg in (EnvConfig(), EnvConfig(reward=RewardConfig(w_rs_dist=0.7, w_time=0.3))):
        rc = cfg.reward
        w = torch.tensor([rc.w_time, rc.w_rs_dist, rc.w_dist, rc.w_angle, rc.w_box_union],
                         dtype=terms.dtype, device=terms.device)
        want = torch.sum(w * terms, dim=-1)
        for code, value in ((rewards.OUTTIME, rc.r_outtime), (rewards.OUTBOUND, rc.r_outbound),
                            (rewards.COLLIDED, rc.r_collided), (rewards.ARRIVED, rc.r_arrived)):
            want = torch.where(status == code, value, want)
        got = rewards.shaped_reward(terms, status, cfg)
        assert got.dtype == dtype and torch.equal(got, want * rc.ratio)


@pytest.mark.parametrize("precision", [10, 3])
def test_mask_edge_penalty_once_bit_identical(precision):
    cfg = ActionMaskConfig(precision=precision)
    g = torch.Generator().manual_seed(precision)
    steps = torch.randint(0, cfg.n_iter + 1, (9, cfg.n_actions), generator=g).float()
    steps[0] = 0.0                                   # the all-blocked floor
    half = cfg.n_actions // 2
    edge = torch.zeros(half)
    edge[0] = 1.0
    edge[half - 1] = 1.0
    fwd = action_mask._min_filter5_reflect(steps[:, :half] - edge)
    bwd = action_mask._min_filter5_reflect(steps[:, half:] - edge)
    mask = torch.clamp(torch.cat([fwd, bwd], dim=-1), 0.0, cfg.n_iter) / cfg.n_iter
    want = torch.where(torch.sum(mask, dim=-1, keepdim=True) == 0.0,
                       torch.clamp(mask, 0.01, 1.0), mask)
    assert torch.equal(action_mask.postprocess(steps, cfg), want)
    assert action_mask._edge_penalty(half, torch.float32, steps.device) is \
        action_mask._edge_penalty(half, torch.float32, steps.device)


def test_find_path_batch_stages_compose_to_the_search(dlp):
    """The three stages, composed by hand, by ``find_path_batch`` and by the
    env's graph helper on the CPU, give the search as one function gave it."""
    sc, pose = dlp
    args = (pose, sc.dest, MAXC, CORNERS, sc.edges, sc.edge_mask, sc.bounds)
    want = _find_path_batch_before(*args)
    assert want.found.any() and not want.found.all()
    assert_same(find_path_batch(*args), want)
    for K in (6, 12):
        stage = ShapeGraphs(functools.partial(prepare_sweep, maxc=MAXC, corners=CORNERS,
                                              max_tries=K), "env")
        prep = stage(pose, sc.dest, sc.bounds)
        assert prep.car_edges.shape == (B, K, 288 * 4, 4) and prep.live4.shape == (B, K, 288 * 4)
        got = select_path(prep, sweep_words(prep, sc.edges, sc.edge_mask), MAXC)
        assert_same(got, _find_path_batch_before(*args, max_tries=K))


def test_shape_graphs_on_the_cpu_call_the_function():
    """On the CPU the helper returns the function's own outputs, captures
    nothing and counts nothing, with or without a profiler; the env's steps
    leave its helpers empty."""
    calls = []

    def fn(a, b):
        calls.append((a, b))
        return a + b, a * b

    helper = ShapeGraphs(fn, "test")
    a, b = torch.arange(4.0), torch.full((4,), 2.0)
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = helper(a, b)
        again = helper(a, b)
    assert len(calls) == 2 and calls[0][0] is a and calls[1][1] is b
    assert torch.equal(out[0], a + b) and torch.equal(again[1], a * b)
    assert helper._graphs == {} and profiling.counters() == {}

    env = ParkingEnv(EnvConfig(), device="cpu")
    ds = DLPDataset(env_cfg=env.cfg, device="cpu")
    state, _ = env.batch_reset(ds.batch_reset(torch.arange(2),
                                              generator=torch.Generator().manual_seed(0)))
    new_state, _, _, _, info = env.batch_step(state, torch.full((2, 2), 0.2))
    assert new_state.scene is state.scene and isinstance(info["rs"], RSPath)
    assert all(g._graphs == {} for g in (env._transition_graphs, env._rs_graphs))


def test_ungraphed_runs_every_graphed_stage_plainly():
    """``ungraphed`` gives a copy whose every ShapeGraphs attribute is its
    plain function, leaves the original's helpers in place, and its steps
    equal the original's on the CPU."""
    env = ParkingEnv(EnvConfig(), device="cpu")
    eager = ungraphed(env)
    graphed = {k for k, v in vars(env).items() if isinstance(v, ShapeGraphs)}
    assert graphed == {"_transition_graphs", "_rs_graphs"}
    assert not any(isinstance(v, ShapeGraphs) for v in vars(eager).values())
    assert all(getattr(eager, k) is getattr(env, k).fn for k in graphed)
    assert eager.corners is env.corners
    ds = DLPDataset(env_cfg=env.cfg, device="cpu")
    state, _ = env.batch_reset(ds.batch_reset(torch.arange(3),
                                              generator=torch.Generator().manual_seed(1)))
    a = torch.full((3, 2), -0.3)
    for x, w in zip(tree_leaves(env.batch_step(state, a)), tree_leaves(eager.batch_step(state, a))):
        assert torch.equal(x, w)
