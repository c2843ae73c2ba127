"""The pure-MPC runner's control rule and its latches, replayed row by row,
and its staging poses held to what a valid one must be.

The runner (HOPE's hybrid agent with an iLQR in place of the policy)
replans every ``replan_every`` control steps and between replans applies,
to each row, the next control of a latched plan where one is executing and
else the iLQR's control for that step. A plan is latched only where none is
executing:
- at a replan, the Reeds-Shepp path found from the pose to the slot (the
  warm start), then a two-segment plan: a path to a staging pose, followed by
  that staging pose's completion to the slot;
- after every control step, the path found by the endgame search.
A latched plan is its segments in whole control steps at full speed and a
last part step, ``queue_len`` controls at most. A row that has finished
stays where it is. The warm start of the iLQR is the warm-start path's
controls where one was found, else the last plan shifted by
``replan_every`` steps with zeros behind; its goal is the staging pose of
least distance plus completion length, or the slot where none is valid.

What is replayed comes from the program's own records: the paths it found
(held to what a found path must be by ``env_step.rs_invalid``), its iLQR
controls, the staging index it picked and its step outcomes (held to
``env_step.transition`` at drawn steps). Nothing is read from the program's
code.
"""
from __future__ import annotations

import torch

from .env_step import queue, rs_invalid
from .spec import ENV, VEHICLE

F64 = torch.float64
# a cost within this of the least is a tie a float32 sum may decide either way
TIE = 1e-4


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= 1e-5 * max(1.0, abs(b))


def _near(a, b) -> int:
    """How many values of ``a`` are farther from ``b`` than rounding."""
    a, b = a.to(F64), b.to(F64)
    return int(((a - b).abs() > 1e-5 * b.abs().clamp(min=1.0)).sum())


def _plan(lengths, steers, found, size: int) -> list:
    return queue(lengths, steers, found, ENV["step_ratio"], size)


class Replay:
    """One run of the runner on the rows ``rows``, fed its records in order
    (``replan``, then ``step`` for each control step); counts control and
    latch mismatches."""

    def __init__(self, rows, horizon: int, replan_every: int, queue_len: int, staging):
        self.rows = rows
        self.rl = rows.tolist()
        self.H, self.M, self.Q = horizon, replan_every, queue_len
        self.staging = staging
        self.q = {r: [] for r in self.rl}
        self.cur = {r: 0 for r in self.rl}
        self.us_prev = None
        self.us = None
        self.control_bad = 0
        self.latch_bad = 0
        self.scale = (VEHICLE["max_steer"], VEHICLE["max_speed"])

    def running(self, r) -> bool:
        return self.cur[r] < len(self.q[r])

    def _latch(self, r, plan):
        if plan and not self.running(r):
            self.q[r], self.cur[r] = plan[:self.Q], 0
            return True
        return False

    def replan(self, t: int, pose, goal, us_init, rs, way, finished, dest, res_us):
        rows = self.rows
        found = rs.found[rows].cpu()
        lengths, steers = rs.lengths[rows].cpu(), rs.steers[rows].cpu()
        warm = _plan(lengths, steers, found, self.Q)
        for k, r in enumerate(self.rl):
            self._latch(r, warm[k])
        if way is not None:
            took, rs1, idx = way
            took, idx = took[rows].cpu(), idx[rows].cpu()
            f1 = rs1.found[rows].cpu()
            first = _plan(rs1.lengths[rows].cpu(), rs1.steers[rows].cpu(), f1, self.Q)
            st = self.staging
            comp = _plan(st.lengths[rows, idx].cpu(), st.steers[rows, idx].cpu(), f1, self.Q)
            fin = finished[rows].cpu()
            offset = 0 if t % 2 == 0 else 4 * (((t // 2) % 5) + 1)
            self.latch_bad += self._window_misses(pose, rows, idx, f1, offset)
            for k, r in enumerate(self.rl):
                want = bool(f1[k]) and not bool(fin[k]) and not self.running(r)
                if want != bool(took[k]):
                    self.latch_bad += 1
                if want:
                    self.q[r], self.cur[r] = (first[k] + comp[k])[:self.Q], 0
        # the iLQR's warm start and goal
        want_us = torch.zeros(len(self.rl), self.H, 2, dtype=F64)
        for k in range(len(self.rl)):
            if bool(found[k]):
                for i, (s, v) in enumerate(warm[k][:self.H]):
                    want_us[k, i] = torch.tensor([s * self.scale[0], v * self.scale[1]])
            elif self.us_prev is not None:
                want_us[k, :self.H - self.M] = self.us_prev[k, self.M:]
        self.control_bad += _near(us_init[rows].cpu(), want_us)
        self.control_bad += self._goal_misses(pose, goal, dest, rows)
        self.us = res_us[rows].cpu().to(F64)
        self.us_prev = self.us

    def step(self, i: int, applied, executing, hybrid, srs, finished):
        rows = self.rows
        applied = applied[rows].cpu().to(F64)
        ex = executing[rows].cpu()
        fin = finished[rows].cpu()
        for k, r in enumerate(self.rl):
            run = self.running(r)
            if run:
                s, v = self.q[r][self.cur[r]]
                want = (s * self.scale[0], v * self.scale[1])
                self.cur[r] += 1
            else:
                want = tuple(self.us[k, i].tolist())
            if bool(ex[k]) != run:
                self.latch_bad += 1
            if not all(_close(float(g), w) for g, w in zip(applied[k], want)):
                self.control_bad += 1
        if srs is not None:
            sf = srs.found[rows].cpu()
            new = _plan(srs.lengths[rows].cpu(), srs.steers[rows].cpu(), sf, self.Q)
            for k, r in enumerate(self.rl):
                if bool(fin[k]) and bool(sf[k]):
                    self.latch_bad += 1            # a path found for a finished row
                self._latch(r, new[k])
        length, cursor = hybrid.length[rows].cpu(), hybrid.cursor[rows].cpu()
        for k, r in enumerate(self.rl):
            if self.running(r) != bool(cursor[k] < length[k]):
                self.latch_bad += 1
            elif self.running(r) and (int(length[k]) != len(self.q[r])
                                      or int(cursor[k]) != self.cur[r]):
                self.latch_bad += 1

    def frozen(self, before, after, finished_before) -> int:
        """Rows that had finished and moved."""
        rows = self.rows
        fin = finished_before[rows]
        moved = (before[rows] != after[rows]).any(-1)
        return int((fin & moved).sum())

    def _costs(self, pose, rows):
        st = self.staging
        d = (pose[rows, None, :2].to(F64) - st.poses[rows, :, :2].to(F64)).norm(dim=-1)
        return d + st.L[rows].to(F64)

    def _window_misses(self, pose, rows, idx, found, offset: int, k_best: int = 4) -> int:
        """Rows whose picked staging candidate is not valid, or not among the
        ``k_best`` of least cost from rank ``offset`` (ties either way)."""
        cost = self._costs(pose, rows)
        S = cost.shape[1]
        start = min(max(offset, 0), S - k_best)
        mine = cost[torch.arange(len(self.rl), device=cost.device), idx.to(cost.device)]
        lo = (cost < (mine - TIE)[:, None]).sum(1).cpu()
        hi = (cost <= (mine + TIE)[:, None]).sum(1).cpu() - 1
        ok = torch.isfinite(mine).cpu() & (hi >= start) & (lo < start + k_best)
        return int((found & ~ok).sum())

    def _goal_misses(self, pose, goal, dest, rows) -> int:
        """Rows whose iLQR goal is not a staging pose of least cost (ties
        either way), or not the slot where none is valid."""
        if self.staging is None:
            return _near(goal[rows].cpu(), dest[rows].cpu())
        cost = self._costs(pose, rows)
        best = cost.amin(1)
        bad = 0
        g = goal[rows]
        for k in range(len(self.rl)):
            if not torch.isfinite(best[k]):
                bad += _near(g[k].cpu(), dest[rows][k].cpu()) > 0
                continue
            same = (self.staging.poses[rows[k]] == g[k]).all(-1)
            bad += not bool((cost[k][same] <= best[k] + TIE).any())
        return bad


def staging_invalid(staging, picks, dest, edges, emask, bounds, wiggle_penalty: float,
                    n_polar: int) -> int:
    """How many of the staging candidates ``picks`` ((row, candidate) pairs)
    are not what a valid one must be: where its length is finite, its
    completion (a Reeds-Shepp path for the polar grid, a parallel-parking
    wiggle for the templates after ``n_polar``) ends on the slot, crosses no
    live edge or bound, and is ``L`` long (less ``wiggle_penalty`` for a
    template). Judged by ``env_step.rs_invalid``."""
    if not len(picks):
        return 0
    r, s = picks[:, 0], picks[:, 1]
    L = staging.L[r, s].to(F64)
    L = torch.where(s >= n_polar, L - wiggle_penalty, L)
    found = torch.isfinite(L)
    return rs_invalid(staging.poses[r, s], found, staging.lengths[r, s], staging.steers[r, s],
                      torch.where(found, L, 0.0), dest[r], edges[r], emask[r], bounds[r])
