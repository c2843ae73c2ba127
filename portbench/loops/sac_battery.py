"""The SAC actor's DLP battery, as ``eval_mix_scene.run_battery`` runs it:
``build`` (the full observation, 512 edges / 128 polygons, 6 RS words, the
committed actor ``.npz``), then ``build_episode_runner`` with the agent's
``get_action``, batteries of ``episodes`` lockstep episodes of ``max_steps``
control steps, back to back until the deadline.

Battery b's cases are ``arange(episodes) % 248``; the harness draws their
starts from the run's seed and b, and the program's ``DLPDataset`` builds
the scenes from those draws inside the window, as a battery does. The
runner steps every episode to ``max_steps``, so the work of a step is fixed.

End to end: ``eval_env_steps_per_s``, episodes x the control steps enqueued
before the deadline (the policy call of the first step after it raises and
ends the battery), over the time until a synchronize after them returns.

The checks hold the window's first battery to the plain reference
(``portbench.reference``), which works from the raw DLP bank, the actor
``.npz`` and the published constants. Its scenes against the reference's
own from the same draws. At steps drawn from the seed (the first among
them), from the program's state at that step: the actor's action and
log-probability under the same Gaussian draw; the control step (pose,
time, slot overlap, status, reward) and the next observation (lidar,
target, mask, image); every RS path found after the step. Over every step,
for rows drawn from the seed: the hybrid RS takeover, replayed from the
program's policy actions and RS finds.
"""
from __future__ import annotations

import os
import sys
import time
from types import SimpleNamespace

import torch
from torch.profiler import record_function

from .. import faults, roofline, stats
from ..reference import compare, env_step, kernels
from ..reference import scenes as ref_scenes
from ..reference.actor import Actor
from ..reference.spec import CONTINUE, ENV, OBS, VEHICLE
from ..trace import Tracer
from .common import (ROOT, memory_peak, reference_precision, release, sample, set_precision,
                     sub_seed)


class WindowClosed(Exception):
    """Raised from the policy call of the first step after the deadline."""


class Recorder:
    """Wraps the policy call and ``env.batch_step``. Keeps references (no
    copy, no launch) to the small per-step tensors of battery 0, and to the
    whole inputs and outputs of battery 0's sampled steps; raises
    :class:`WindowClosed` at the first policy call after ``deadline``."""

    def __init__(self, act, env_step_fn, sampled: set, deadline: float):
        self.act, self.env_step = act, env_step_fn
        self.sampled, self.deadline = sampled, deadline
        self.battery, self.j, self.steps = 0, 0, 0
        self.per_step, self.full = [], {}
        self.on = False

    def new_battery(self, b: int):
        self.battery, self.j = b, 0

    def policy(self, obs, g):
        if self.on and time.perf_counter() > self.deadline:
            raise WindowClosed
        rec = self.battery == 0 and self.on
        if rec and self.j in self.sampled:
            self.full[self.j] = {"gen": g.get_state(), "obs": obs}
        with record_function("portbench/policy"):
            a, logp = self.act(obs, g)
        if rec:
            self.per_step.append({"action": a, "target": obs["target"]})
            if self.j in self.full:
                self.full[self.j].update(action=a, logp=logp)
        return a, logp

    def batch_step(self, state, actions, search_rs=True):
        out = self.env_step(state, actions, search_rs=search_rs)
        if self.battery == 0 and self.on:
            self.per_step[-1].update(applied=actions, rs=out[4]["rs"])
            if self.j in self.full:
                self.full[self.j].update(state=state, actions=actions, out=out)
        if self.on:
            self.steps += 1
        self.j += 1
        return out


class KernelInputs:
    """While on, wraps the program's three kernel entry points where its
    modules call them and keeps the inputs of every call (for the roofline
    arithmetic of a traced run)."""

    SITES = (("envs.env", "render_bev_batch", "raster"),
             ("envs.action_mask", "mask_step_lengths", "mask"),
             ("planning.rs_select", "swept_collide", "sweep"))

    def __init__(self, ctx):
        self.ctx, self.saved = ctx, []
        self.args = {key: [] for _, _, key in self.SITES}

    def __enter__(self):
        for mod, name, key in self.SITES:
            m = self.ctx.module(mod)
            fn = getattr(m, name)
            self.saved.append((m, name, fn))
            setattr(m, name, self._wrap(fn, key))
        return self

    def _wrap(self, fn, key):
        def wrapped(*args):
            self.args[key].append(args)
            return fn(*args)
        return wrapped

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def run(ctx):
    tr, cf, dev = ctx.traffic, ctx.config, ctx.device
    E, T = tr["episodes"], tr["max_steps"]
    set_precision(ctx)
    ems = ctx.module("evaluation.eval_mix_scene")
    evaluate = ctx.module("evaluation.evaluate")
    Draws = ctx.module("envs.dlp").DLPDraws
    actor = os.path.join(ROOT, cf["actor"])
    env, agent, state = ems.build(actor, device=dev, rs_tries=cf["rs_tries"])
    ds = ctx.module("envs.dlp").DLPDataset(env_cfg=env.cfg, device=dev)
    bank = ref_scenes.Bank(dev)
    ids = torch.arange(E, device=dev) % bank.n_cases

    def battery(b: int):
        """Battery b's scenes (the program's, from the harness's draws), its
        draws, and the runner's generator."""
        dg = torch.Generator(device=dev)
        dg.manual_seed(sub_seed(ctx.seed, 4, b))
        d = ref_scenes.draw(bank, ids, dg)
        scenes = ds.batch_reset(ids, draws=Draws(d.start_idx, d.jitter, d.flip_dest,
                                                 d.flip_start))
        g = torch.Generator(device=dev)
        g.manual_seed(sub_seed(ctx.seed, 3, b))
        return scenes, d, g

    sampled = set(sample(ctx.seed, T - 1, tr["check_steps"] - 1, tag=1))
    sampled = {0} | {j + 1 for j in sampled}
    act, step_fn = (lambda obs, g: agent.get_action(state, obs, g)), env.batch_step
    if ctx.fault == "unchanged":
        step_fn = faults.env_step(ctx.fault, step_fn)
    elif ctx.fault:
        act = faults.policy(ctx.fault, act)
    rec = Recorder(act, step_fn, sampled, float("inf"))
    env.batch_step = rec.batch_step

    # warm-up: the shapes of every step, on a battery the window does not use
    warm = evaluate.build_episode_runner(env, rec.policy, tr["warm_steps"])
    scenes, _, g = battery(-1)
    warm(scenes, g)
    del warm
    runner = evaluate.build_episode_runner(env, rec.policy, T)
    ctx.sync()

    tracer = Tracer(ctx.trace, ctx.device)
    kin = KernelInputs(ctx)
    if ctx.trace:
        # the traced part, before the window: the first trace_steps steps of
        # a battery the window does not use
        short = evaluate.build_episode_runner(env, rec.policy, tr["trace_steps"])
        short_scenes, _, sg = battery(-2)
        tracer.start()
        with kin:
            short(short_scenes, sg)
        tracer.stop(tr["trace_steps"])
        del short, short_scenes
    t_start = time.perf_counter()
    rec.deadline, rec.on = t_start + ctx.seconds, True
    first = None
    b = 0
    try:
        while True:
            rec.new_battery(b)
            scenes, d, g = battery(b)
            if b == 0:
                first = (scenes, d)
            runner(scenes, g)
            b += 1
    except WindowClosed:
        pass
    ctx.sync()
    t_end = time.perf_counter()
    steps = rec.steps
    peak = memory_peak(ctx)
    del env.batch_step, runner, env, agent, state, ds
    release()

    checks, layer = check(ctx, rec, tr, actor, bank, ids, first, kin.args)
    layer["trace"] = tracer.summary
    return {"setup_s": t_start - ctx.t_process,
            "e2e": {"eval_env_steps_per_s": stats.synced_rate(t_start, t_end, steps, E)},
            "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
            "checks": checks, "layer": layer}


def _want_rs(st):
    """(want, unsure): the rows whose RS search was due after a step (past the
    first step, running, within ``rs_max_dist`` of the slot)."""
    p, dest = st.vehicle.pose.double(), st.scene.dest.double()
    dist = torch.hypot(p[:, 0] - dest[:, 0], p[:, 1] - dest[:, 1])
    want = (st.t > 1) & (st.status == CONTINUE) & (dist < ENV["rs_max_dist"])
    return want, (dist - ENV["rs_max_dist"]).abs() < env_step.EPS


def check(ctx, rec: Recorder, tr: dict, actor_path: str, bank, ids, first, kargs):
    """The reference's readings of the recorded steps (module docstring),
    and in a traced run the kernels' mean bound over their traced calls'
    inputs and the actor's FLOPs a step."""
    reference_precision(ctx)
    dev = ctx.device
    actor = Actor(actor_path, dev)
    table = kernels.mask_table(dev)
    scenes, d = first
    ref = ref_scenes.build(bank, ids, d)
    scene_bad = ref_scenes.scene_differs(scenes, ref)
    actor_gap, values, rows_bad, rs_bad, unsure = 0.0, 0, 0, 0, 0
    flops = None
    judged = [j for j in sorted(rec.full) if "out" in rec.full[j]]
    if not judged or not rec.per_step:   # nothing reached in the window: nothing was checked
        return {k: float("inf") for k in ctx.limits}, {}
    for j in judged:
        r = rec.full[j]
        g = torch.Generator(device=dev)
        g.set_state(r["gen"])
        noise = torch.randn(r["action"].shape, generator=g, device=dev)
        with torch.no_grad():
            a, logp = actor.act(r["obs"], noise)
        actor_gap = max(actor_gap, compare.max_abs(r["action"], a),
                        compare.max_rel(r["logp"], logp))
        st = r["state"]
        if j == 0:
            values += env_step.observation_differs(r["obs"], st.vehicle.pose, ref, table)
            if ctx.trace:
                from torch.utils.flop_counter import FlopCounterMode

                with torch.no_grad(), FlopCounterMode(display=False) as counter:
                    actor.mean_std(r["obs"])
                flops = float(counter.get_total_flops())
        ps, pobs, prew, pdone, pinfo = r["out"]
        with torch.no_grad():
            nxt = env_step.transition(st.vehicle.pose, st.t, st.accum_arrive, r["actions"], ref)
        sure = ~nxt["unsure"]
        unsure += int(nxt["unsure"].sum())
        # the reward and accumulator of rows on the slot carry the overlap's
        # float32 rounding (``AREA_TOL``)
        plain, ov = sure & ~nxt["overlap"], sure & nxt["overlap"]
        values += compare.values_differ(ps.vehicle.pose[sure], nxt["pose"][sure])
        for rows, tol in ((plain, compare.ROUNDING), (ov, env_step.AREA_TOL)):
            values += (compare.values_differ(prew[rows], nxt["reward"][rows], tol)
                       + compare.values_differ(ps.accum_arrive[rows], nxt["accum"][rows], tol))
        rows_bad += int(compare.rows_differ((pdone[sure], nxt["status"][sure] != CONTINUE),
                                            (pinfo["status"][sure], nxt["status"][sure]),
                                            (ps.t[sure], nxt["t"][sure])).sum())
        values += env_step.observation_differs(pobs, ps.vehicle.pose, ref, table)
        want, near = _want_rs(ps)
        rs = pinfo["rs"]
        rs_bad += env_step.rs_invalid(ps.vehicle.pose, rs.found, rs.lengths, rs.steers, rs.L,
                                      ref["dest"], ref["edges"], ref["edge_mask"], ref["bounds"],
                                      want=want | near, unsure=near)
    rows = torch.tensor(sample(ctx.seed, tr["episodes"], tr["check_rows"], tag=2), device=dev)
    scale = (VEHICLE["max_steer"], VEHICLE["max_speed"])
    takeover = env_step.takeover_mismatch(rec.per_step, rows, scale)
    print(f"rows a margin left unjudged: {unsure}", file=sys.stderr)
    layer = {"policy_calls": tr["trace_steps"]}
    if ctx.trace and all(kargs.values()):
        layer["bounds_ms"] = {k: sum(map(BOUNDS[k], calls)) / len(calls)
                              for k, calls in kargs.items()}
        if flops is not None:
            layer["flops"] = flops * tr["trace_steps"]
    return {"scene_differs": scene_bad, "actor_gap": actor_gap, "step_values_differ": values,
            "step_rows_differ": rows_bad, "rs_invalid": rs_bad,
            "takeover_mismatch": takeover}, layer


def _mask_bound(args) -> float:
    ext, dist_star = args[:2]
    return roofline.bound(*roofline.mask_work(ext.shape[0], ext.shape[1],
                                              tuple(dist_star.shape)))[0]


def _raster_bound(args) -> float:
    pose, vbox, dbox, edges, emask, poly = args[:6]
    obs = SimpleNamespace(img_size=OBS["img_size"], img_res=OBS["img_res"])
    vcfg = SimpleNamespace(**{k: VEHICLE[k] for k in ("front_hang", "wheel_base", "rear_hang")})
    return roofline.bound(*roofline.raster_work(pose, vbox, dbox, edges, emask,
                                                poly.to(torch.int32), obs, vcfg))[0]


def _sweep_bound(args) -> float:
    car, live4, edges, emask = args
    seg_hit = kernels.swept_collide_plain(car, live4, edges, emask, per_segment=True)
    return roofline.bound(*roofline.sweep_work(live4, edges, emask, seg_hit))[0]


# bound in ms of one kernel call on the inputs it was given
BOUNDS = {"mask": _mask_bound, "raster": _raster_bound, "sweep": _sweep_bound}
