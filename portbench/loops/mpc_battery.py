"""Pure MPC's DLP battery, as ``planning.mpc.main --portfolio`` runs it:
the CLI's env (``mpc_env_config``: no image, no mask, 512 edges / 128
polygons, ``rs_tries`` RS words) and iLQR (``mpc_ilqr_config``), then
batteries of ``episodes`` lockstep episodes back to back until the deadline.
A battery builds its scenes, computes the staging poses
(``compute_staging``, ``staging_tries`` words a candidate) and runs
``build_mpc_runner`` for ``max_steps`` control steps at each cadence of
``replan_every`` in turn (8, then 4). The two runners are built once, so
their iLQR graphs are captured in the warm-up.

Battery b's cases are ``arange(episodes) % 248``; the harness draws their
starts from the run's seed and b, and the program's ``DLPDataset`` builds
the scenes from those draws inside the window, as a battery does.

End to end: ``eval_env_steps_per_s``, episodes x the control steps enqueued
before the deadline (the first control step after it raises and ends the
window), over the time until a synchronize after them returns.

The runner hands its own tensors to an observer (``observe``), which keeps
references to battery 0's and checks the deadline; no copy, no sync. The
checks hold battery 0 to the plain reference (``portbench.reference``):
its scenes; at replans drawn from the seed, the program's reported iLQR
cost against the float64 cost of its own controls (``cost_gap``) and that
float64 cost against the float64 iLQR's from the same warm start
(``cost_excess``, on the mean of the rows); at every step, for rows drawn
from the seed, the runner's control rule and latches replayed
(``control_mismatch``, ``latch_mismatch``); at drawn steps the env step
(``step_values_differ``, ``step_rows_differ``); the RS paths found at those
replans and steps (``rs_invalid``); staging candidates drawn from the seed
(``staging_invalid``).

A program whose runner takes no observer cannot run this cell: the loop
stops before its set-up with an error.
"""
from __future__ import annotations

import inspect
import sys
import time

import torch

from .. import ilqr_work, mpc_faults, roofline, stats
from ..reference import compare, env_step
from ..reference import ilqr as ref_ilqr
from ..reference import mpc as ref_mpc
from ..reference import scenes as ref_scenes
from ..reference.spec import CONTINUE
from ..trace import Tracer
from .common import memory_peak, reference_precision, release, sample, set_precision, sub_seed
from .sac_battery import KernelInputs, WindowClosed, _want_rs


class Enough(Exception):
    """Raised after the replans a short run (warm-up, traced pass) wants."""


class Recorder:
    """The runner's observer: keeps references to battery 0's records, counts
    the control steps of the window and raises :class:`WindowClosed` at the
    first control step after ``deadline``, or :class:`Enough` after the last
    step of the ``limit``-th replan of a short run."""

    def __init__(self):
        self.deadline, self.on = float("inf"), False
        self.steps = 0
        self.runs = []          # battery 0's runs: [(cadence, [(kind, record)])]
        self.keep = False
        self.limit = None
        self.every = self.i = self.replans = 0
        self.staging = None

    def new_run(self, battery: int, every: int, limit=None):
        self.keep = self.on and battery == 0
        self.every, self.limit, self.replans = every, limit, 0
        if self.keep:
            self.runs.append((every, []))

    def __call__(self, kind: str, **rec):
        if kind == "replan":
            self.replans += 1
        elif kind == "step":
            if self.on and time.perf_counter() > self.deadline:
                raise WindowClosed
            self.i = rec["i"]
            if self.on:
                self.steps += 1
        if self.keep:
            self.runs[-1][1].append((kind, rec))
        if (kind == "stepped" and self.limit is not None and self.replans >= self.limit
                and self.i == self.every - 1):
            raise Enough


class SweepInputs(KernelInputs):
    """The sweep kernel's inputs at both of its call sites on the MPC path."""

    SITES = (("planning.rs_select", "swept_collide", "sweep"),
             ("planning.staging", "swept_collide", "sweep"))


def run(ctx):
    mpc = ctx.module("planning.mpc")
    if "observe" not in inspect.signature(mpc.build_mpc_runner).parameters:
        raise RuntimeError("the program's build_mpc_runner takes no observer: this cell "
                           "cannot read its controls and latches")
    tr, cf, dev = ctx.traffic, ctx.config, ctx.device
    E, T = tr["episodes"], tr["max_steps"]
    cadences = tr["replan_every"]
    set_precision(ctx)
    env_cfg = mpc.mpc_env_config(no_dlp=False, rs_tries=cf["rs_tries"])
    env = ctx.module("envs").ParkingEnv(env_cfg, device=dev)
    icfg = mpc.mpc_ilqr_config(env_cfg, cf["ilqr"]["horizon"], cf["ilqr"]["n_iters"])
    staging_mod = ctx.module("planning.staging")
    dlp = ctx.module("envs.dlp")
    ds = dlp.DLPDataset(env_cfg=env.cfg, device=dev)
    bank = ref_scenes.Bank(dev)
    ids = torch.arange(E, device=dev) % bank.n_cases
    rec = Recorder()
    with mpc_faults.planted(ctx.fault):
        runners = {every: mpc.build_mpc_runner(env, icfg, every, T, observe=rec)
                   for every in cadences}

        def scenes_of(b: int):
            g = torch.Generator(device=dev)
            g.manual_seed(sub_seed(ctx.seed, 4, b))
            d = ref_scenes.draw(bank, ids, g)
            return ds.batch_reset(ids, draws=dlp.DLPDraws(d.start_idx, d.jitter, d.flip_dest,
                                                          d.flip_start)), d

        def battery(b: int, scenes, limit=None):
            st = staging_mod.compute_staging(env, scenes, max_tries=cf["staging_tries"])
            if b == 0 and rec.on:
                rec.staging = st
            for every in cadences:
                rec.new_run(b, every, limit)
                try:
                    runners[every](scenes, st)
                except Enough:
                    pass

        # warm-up: every shape of a battery (and each runner's graph), on
        # scenes the window does not use
        battery(-1, scenes_of(-1)[0], limit=1)
        ctx.sync()
        tracer = Tracer(ctx.trace, dev)
        layer = {}
        if ctx.trace:
            # the traced part, before the window: one staging and
            # ``trace_replans`` replans at each cadence
            scenes = scenes_of(-2)[0]
            kin = SweepInputs(ctx)
            tracer.start()
            with kin:
                battery(-2, scenes, limit=tr["trace_replans"])
            tracer.stop(tr["trace_replans"] * len(cadences))
            layer = traced_layer(kin.args["sweep"], tracer.summary, icfg, scenes, len(cadences),
                                 tr["trace_replans"])
            del kin, scenes
        t_start = time.perf_counter()
        rec.deadline, rec.on = t_start + ctx.seconds, True
        first = None
        b = 0
        try:
            while True:
                scenes, d = scenes_of(b)
                if b == 0:
                    first = (scenes, d)
                battery(b, scenes)
                b += 1
        except WindowClosed:
            pass
        ctx.sync()
        t_end = time.perf_counter()
    steps = rec.steps
    peak = memory_peak(ctx)
    del runners, env, ds
    release()

    checks = check(ctx, rec, tr, cf, bank, ids, first)
    layer["trace"] = tracer.summary
    return {"setup_s": t_start - ctx.t_process,
            "e2e": {"eval_env_steps_per_s": stats.synced_rate(t_start, t_end, steps, E)},
            "attempted": steps, "failed": 0, "memory_peak_bytes": peak,
            "checks": checks, "layer": layer}


def traced_layer(sweep_calls: list, summary, icfg, scenes, runs: int, replans: int) -> dict:
    """What the readers need beside the trace: the sweep's mean bound per
    traced call (``roofline.sweep_work`` on each call's inputs) and the
    iLQR's operations over the traced solves (``ilqr_work``)."""
    layer = {}
    if summary is None:
        return layer
    if sweep_calls:
        nbytes = ops = 0.0
        for args in sweep_calls:
            b, o = sweep_work(*args)
            nbytes, ops = nbytes + b, ops + o
        layer["bounds_ms"] = {"sweep": roofline.bound(nbytes, ops)[0] / len(sweep_calls)}
    B, E = scenes.edges.shape[:2]
    layer["ilqr_flops"] = runs * replans * ilqr_work.solve_flops(
        B, icfg.horizon, E, icfg.n_iters, len(icfg.alphas))
    return layer


def sweep_work(car, live4, edges, emask, pairs: float = 2e7) -> tuple:
    """``roofline.sweep_work`` of one sweep call, row chunk by row chunk
    (each row's work is its own) so that the plain sweep's temporaries stay
    small: (bytes, operations)."""
    from ..reference.kernels import swept_collide_plain

    B, K, S = live4.shape
    rows = max(1, int(pairs // (K * 64 * edges.shape[1])))
    nbytes = ops = 0.0
    for r0 in range(0, B, rows):
        sl = slice(r0, r0 + rows)
        hit = swept_collide_plain(car[sl], live4[sl], edges[sl], emask[sl], per_segment=True)
        b, o = roofline.sweep_work(live4[sl], edges[sl], emask[sl], hit)
        nbytes, ops = nbytes + b, ops + o
    return nbytes, ops


def _replans(rec: Recorder) -> list:
    """Battery 0's replan records, both runs."""
    return [r for _, events in rec.runs for kind, r in events if kind == "replan"]


def check(ctx, rec: Recorder, tr: dict, cf: dict, bank, ids, first) -> dict:
    reference_precision(ctx)
    replans = _replans(rec)
    if first is None or not replans:       # nothing reached in the window: nothing was checked
        return {k: float("inf") for k in ctx.limits}
    dev = ctx.device
    scenes, d = first
    ref = ref_scenes.build(bank, ids, d)
    out = {"scene_differs": ref_scenes.scene_differs(scenes, ref)}
    sp = ref_ilqr.spec_of(cf)
    edges, emask = scenes.edges, scenes.edge_mask
    keep = emask.any(0)                    # slots dead in every row never matter
    edges, emask = edges[:, keep], emask[:, keep]
    gap = excess = 0.0
    rs_bad = 0
    for j in sample(ctx.seed, len(replans), tr["check_replans"], tag=5):
        r = replans[j]
        g, e = replan_gaps(r["pose"], r["goal"], edges, emask, r["us_init"], r["res"], sp)
        gap, excess = max(gap, g), max(excess, e)
        rs_bad += _paths_invalid(r, ref, rec.staging)
    out["cost_gap"], out["cost_excess"] = gap, excess

    rows = torch.tensor(sample(ctx.seed, tr["episodes"], tr["check_rows"], tag=2), device=dev)
    control = latch = 0
    for every, events in rec.runs:
        rp = ref_mpc.Replay(rows, cf["ilqr"]["horizon"], every, cf["queue_len"], rec.staging)
        before = None
        for kind, r in events:
            if kind == "replan":
                rp.replan(r["t"], r["pose"], r["goal"], r["us_init"], r["rs"], r["way"],
                          r["finished"], scenes.dest, r["res"].us)
            elif kind == "step":
                pose = r["state"].vehicle.pose
                if before is not None:
                    control += rp.frozen(before[0], pose, before[1])
                before, i = (pose, r["finished"]), r["i"]
            else:
                rp.step(i, r["applied"], r["executing"], r["hybrid"], r["srs"], r["finished"])
        control, latch = control + rp.control_bad, latch + rp.latch_bad
    out["control_mismatch"], out["latch_mismatch"] = control, latch

    values, rows_bad, unsure = _steps(ctx, rec, tr, ref)
    out["step_values_differ"], out["step_rows_differ"] = values, rows_bad
    out["rs_invalid"] = rs_bad + _step_paths_invalid(ctx, rec, tr, ref)
    out["staging_invalid"] = _staging_invalid(ctx, rec.staging, tr, ref, cf)
    print(f"rows a margin left unjudged: {unsure}", file=sys.stderr)
    return out


def replan_gaps(x0, goal, edges, emask, us_init, res, sp) -> tuple:
    """(cost_gap, cost_excess) of one replan's solve ``res``. ``cost_gap``:
    the program's reported cost against the float64 cost of its own
    controls, relative to the latter, worst row. ``cost_excess``: how far
    that float64 cost lies above the float64 iLQR's from the same warm start,
    relative to the warm start's float64 cost, on the mean of the rows. Not
    the worst row: rows deep in the clearance cost end in minima that differ
    by tens of per cent of their descent between any two precisions (the
    reference's own float64 solve moves so when the start moves by 1e-6 m),
    and a solver that only takes descending steps can read up to 1 on such
    a row; on the mean a few such rows stay small, while a solve that fails
    on every row (bfloat16) or takes no step reads large."""
    own = ref_ilqr.plan_cost(x0, res.us, goal, edges, emask, sp)
    start = ref_ilqr.plan_cost(x0, us_init, goal, edges, emask, sp)
    plan = ref_ilqr.solve(x0, goal, edges, emask, us_init, sp)
    gap = _nan_inf((res.cost.to(own.dtype) - own).abs() / own.abs().clamp(min=1.0))
    excess = _nan_inf((own - plan.cost) / start.abs().clamp(min=1.0))
    print(f"cost excess over the rows: mean {float(excess.mean()):.6g}, "
          f"largest {float(excess.max()):.6g}; cost gap largest {float(gap.max()):.6g}",
          file=sys.stderr)
    return float(gap.max()), float(excess.mean())


def _nan_inf(rel):
    """``rel`` with inf where a value is not a number."""
    return torch.nan_to_num(rel, nan=torch.inf)


def _paths_invalid(r: dict, ref: dict, staging) -> int:
    """The RS paths found at a replan: the warm start's to the slot, and the
    first segment of each two-segment latch to its staging pose."""
    rs = r["rs"]
    bad = env_step.rs_invalid(r["pose"], rs.found, rs.lengths, rs.steers, rs.L, ref["dest"],
                              ref["edges"], ref["edge_mask"], ref["bounds"])
    if r["way"] is not None:
        _, rs1, idx = r["way"]
        goal = staging.poses[torch.arange(idx.shape[0], device=idx.device), idx]
        bad += env_step.rs_invalid(r["pose"], rs1.found, rs1.lengths, rs1.steers, rs1.L, goal,
                                   ref["edges"], ref["edge_mask"], ref["bounds"])
    return bad


def _stepped(rec: Recorder) -> list:
    """Battery 0's control steps: (the state before, the step's record)."""
    out = []
    for _, events in rec.runs:
        before = None
        for kind, r in events:
            if kind == "step":
                before = r["state"]
            elif kind == "stepped":
                out.append((before, r))
    return out


def _drawn_steps(ctx, rec: Recorder, tr: dict) -> list:
    steps = _stepped(rec)
    return [steps[j] for j in sample(ctx.seed, len(steps), tr["check_steps"], tag=1)]


def _steps(ctx, rec: Recorder, tr: dict, ref: dict):
    """The env step at drawn steps against ``env_step.transition``, as the
    battery cell of the SAC actor judges it."""
    values = rows_bad = unsure = 0
    for st, r in _drawn_steps(ctx, rec, tr):
        with torch.no_grad():
            nxt = env_step.transition(st.vehicle.pose, st.t, st.accum_arrive, r["applied"], ref)
        ps = r["state"]
        sure = ~nxt["unsure"]
        unsure += int(nxt["unsure"].sum())
        plain, ov = sure & ~nxt["overlap"], sure & nxt["overlap"]
        values += compare.values_differ(ps.vehicle.pose[sure], nxt["pose"][sure])
        for rows, tol in ((plain, compare.ROUNDING), (ov, env_step.AREA_TOL)):
            values += (compare.values_differ(r["reward"][rows], nxt["reward"][rows], tol)
                       + compare.values_differ(ps.accum_arrive[rows], nxt["accum"][rows], tol))
        rows_bad += int(compare.rows_differ(
            (r["done"][sure], nxt["status"][sure] != CONTINUE),
            (r["status"][sure], nxt["status"][sure]), (ps.t[sure], nxt["t"][sure])).sum())
    return values, rows_bad, unsure


def _step_paths_invalid(ctx, rec: Recorder, tr: dict, ref: dict) -> int:
    """The endgame search's paths found after the drawn steps."""
    bad = 0
    for _, r in _drawn_steps(ctx, rec, tr):
        srs = r["srs"]
        if srs is None:
            continue
        ps = r["state"]
        want, near = _want_rs(ps)
        bad += env_step.rs_invalid(ps.vehicle.pose, srs.found, srs.lengths, srs.steers, srs.L,
                                   ref["dest"], ref["edges"], ref["edge_mask"], ref["bounds"],
                                   want=want | near, unsure=near)
    return bad


def _staging_invalid(ctx, st, tr: dict, ref: dict, cf: dict) -> int:
    """Valid staging candidates drawn from the seed, half of the polar grid
    and half templates, held to what a valid one must be."""
    if st is None:
        return 0
    n_polar = cf["staging_polar"]
    valid = torch.isfinite(st.L)
    picks = []
    for tag, lo, hi in ((6, 0, n_polar), (7, n_polar, valid.shape[1])):
        idx = torch.nonzero(valid[:, lo:hi]) + torch.tensor([0, lo], device=valid.device)
        for j in sample(ctx.seed, idx.shape[0], tr["check_candidates"] // 2, tag=tag):
            picks.append(idx[j])
    if not picks:
        return 0
    return ref_mpc.staging_invalid(st, torch.stack(picks), ref["dest"], ref["edges"],
                                   ref["edge_mask"], ref["bounds"], cf["staging_wiggle_m"],
                                   n_polar)


__all__ = ["Recorder", "check", "run"]
