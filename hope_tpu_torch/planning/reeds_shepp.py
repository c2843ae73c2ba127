"""Branch-free Reeds-Shepp curve expansion over a batch
(counterpart of ``hope_tpu/planning/reeds_shepp.py``).

All 46 word variants are evaluated at once as masked fixed-shape tensors.
Each base word formula runs once on the stacked inputs of all its variants, so
a batch costs 9 formula evaluations, not 46.

Candidate layout: ``lengths (..., 46, 5)`` signed segment lengths
(curvature-normalized), ``steers (..., 46, 5)`` in {-1 (R), 0 (S), +1 (L)},
``valid (..., 46)``. Segments beyond a word's arity are zero-length with
steer 0.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

PI = math.pi
MAX_LENGTH = 1000.0
N_WORDS = 46
N_SEG = 5


def wrap_pi(theta):
    """Regulate angle to (-pi, pi]."""
    phi = torch.remainder(theta, 2.0 * PI)
    return torch.where(phi > PI, phi - 2.0 * PI, phi)


def _polar(x, y):
    return torch.hypot(x, y), torch.atan2(y, x)


def _sq(x):
    return x * x


# base word formulas — each returns (valid, t, u, v)


def _lsl(x, y, phi):
    u, t = _polar(x - torch.sin(phi), y - 1.0 + torch.cos(phi))
    v = wrap_pi(phi - t)
    return (t >= 0.0) & (v >= 0.0), t, u, v


def _lsr(x, y, phi):
    u1, t1 = _polar(x + torch.sin(phi), y - 1.0 - torch.cos(phi))
    u1sq = u1 * u1
    ok = u1sq >= 4.0
    u = torch.sqrt(torch.clamp(u1sq - 4.0, min=0.0))
    theta = torch.atan2(torch.full_like(u, 2.0), torch.where(u == 0.0, 1e-30, u))
    t = wrap_pi(t1 + theta)
    v = wrap_pi(t - phi)
    return ok & (t >= 0.0) & (v >= 0.0), t, u, v


def _lrl(x, y, phi):
    u1, t1 = _polar(x - torch.sin(phi), y - 1.0 + torch.cos(phi))
    ok = u1 <= 4.0
    u = -2.0 * torch.arcsin(torch.clamp(0.25 * u1, -1.0, 1.0))
    t = wrap_pi(t1 + 0.5 * u + PI)
    v = wrap_pi(phi - t + u)
    return ok & (t >= 0.0) & (u <= 0.0), t, u, v


def _sls(x, y, phi):
    phi = wrap_pi(phi)
    ok_ang = (phi > 0.0) & (phi < PI * 0.99)
    tan_phi = torch.tan(torch.where(ok_ang, phi, 0.5))
    xd = -y / tan_phi + x
    t = xd - torch.tan(phi / 2.0)
    u = phi
    r = torch.sqrt(_sq(x - xd) + _sq(y))
    v_pos = r - torch.tan(phi / 2.0)
    v_neg = -r - torch.tan(phi / 2.0)
    v = torch.where(y > 0.0, v_pos, v_neg)
    return ok_ang & (y != 0.0), t, u, v


def _tau_omega(u, v, xi, eta, phi):
    delta = wrap_pi(u - v)
    A = torch.sin(u) - torch.sin(delta)
    B = torch.cos(u) - torch.cos(delta) - 1.0
    t1 = torch.atan2(eta * A - xi * B, xi * A + eta * B)
    t2 = 2.0 * (torch.cos(delta) - torch.cos(v) - torch.cos(u)) + 3.0
    tau = torch.where(t2 < 0.0, wrap_pi(t1 + PI), wrap_pi(t1))
    omega = wrap_pi(tau - u + v - phi)
    return tau, omega


def _lrlrn(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho = 0.25 * (2.0 + torch.sqrt(xi * xi + eta * eta))
    ok = rho <= 1.0
    u = torch.arccos(torch.clamp(rho, -1.0, 1.0))
    t, v = _tau_omega(u, -u, xi, eta, phi)
    return ok & (t >= 0.0) & (v <= 0.0), t, u, v


def _lrlrp(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho = (20.0 - xi * xi - eta * eta) / 16.0
    ok = (rho >= 0.0) & (rho <= 1.0)
    u = -torch.arccos(torch.clamp(rho, -1.0, 1.0))
    ok = ok & (u >= -0.5 * PI)
    t, v = _tau_omega(u, u, xi, eta, phi)
    return ok & (t >= 0.0) & (v >= 0.0), t, u, v


def _lrsl(x, y, phi):
    xi = x - torch.sin(phi)
    eta = y - 1.0 + torch.cos(phi)
    rho, theta = _polar(xi, eta)
    ok = rho >= 2.0
    r = torch.sqrt(torch.clamp(rho * rho - 4.0, min=0.0))
    u = 2.0 - r
    t = wrap_pi(theta + torch.atan2(r, torch.full_like(r, -2.0)))
    v = wrap_pi(phi - 0.5 * PI - t)
    return ok & (t >= 0.0) & (u <= 0.0) & (v <= 0.0), t, u, v


def _lrsr(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho, theta = _polar(-eta, xi)
    ok = rho >= 2.0
    t = theta
    u = 2.0 - rho
    v = wrap_pi(t + 0.5 * PI - phi)
    return ok & (t >= 0.0) & (u <= 0.0) & (v <= 0.0), t, u, v


def _lrslr(x, y, phi):
    xi = x + torch.sin(phi)
    eta = y - 1.0 - torch.cos(phi)
    rho, _ = _polar(xi, eta)
    ok = rho >= 2.0
    u = 4.0 - torch.sqrt(torch.clamp(rho * rho - 4.0, min=0.0))
    ok = ok & (u <= 0.0)
    t = wrap_pi(torch.atan2((4.0 - u) * xi - 2.0 * eta, -2.0 * xi + (u - 4.0) * eta))
    v = wrap_pi(t - phi)
    return ok & (t >= 0.0) & (v >= 0.0), t, u, v


# ---------------------------------------------------------------------------
# the word table: (base_fn, input variant, segment arrangement, steers)
# ---------------------------------------------------------------------------

L, S, R = 1, 0, -1

# input variants: (sx, sy, sphi, backwards)
_ID = (1, 1, 1, False)
_TIME = (-1, 1, -1, False)     # timeflip: negate x, phi; negate output lengths
_REFL = (1, -1, -1, False)     # reflect: negate y, phi; swap L<->R
_BOTH = (-1, -1, 1, False)
_ID_B = (1, 1, 1, True)        # backwards: (xb, yb) input, reversed segment order
_TIME_B = (-1, 1, -1, True)
_REFL_B = (1, -1, -1, True)
_BOTH_B = (-1, -1, 1, True)


def _build_table():
    """Static word table, in the JAX package's order. Each entry:
    (fn, variant, seg_pattern, steer_pattern); seg_pattern holds
    ('t'|'u'|'v'|float, sign) per segment."""
    T = []

    def add(fn, variant, segs, steers):
        sx, sy, sphi, backwards = variant
        negate = sx == -1
        refl = sy == -1
        st = tuple((-s if refl else s) for s in steers)
        sg = tuple((sym, -sgn if negate else sgn) for (sym, sgn) in segs)
        if backwards:
            sg = tuple(reversed(sg))
            st = tuple(reversed(st))
        T.append((fn, variant, sg, st))

    add(_sls, _ID, (("t", 1), ("u", 1), ("v", 1)), (S, L, S))
    add(_sls, _REFL, (("t", 1), ("u", 1), ("v", 1)), (S, L, S))
    for fn, steers in ((_lsl, (L, S, L)), (_lsr, (L, S, R))):
        for var in (_ID, _TIME, _REFL, _BOTH):
            add(fn, var, (("t", 1), ("u", 1), ("v", 1)), steers)
    for var in (_ID, _TIME, _REFL, _BOTH):
        add(_lrl, var, (("t", 1), ("u", 1), ("v", 1)), (L, R, L))
    for var in (_ID_B, _TIME_B, _REFL_B, _BOTH_B):
        add(_lrl, var, (("t", 1), ("u", 1), ("v", 1)), (L, R, L))
    for var in (_ID, _TIME, _REFL, _BOTH):
        add(_lrlrn, var, (("t", 1), ("u", 1), ("u", -1), ("v", 1)), (L, R, L, R))
    for var in (_ID, _TIME, _REFL, _BOTH):
        add(_lrlrp, var, (("t", 1), ("u", 1), ("u", 1), ("v", 1)), (L, R, L, R))
    half = 0.5 * PI
    for fn, steers in ((_lrsl, (L, R, S, L)), (_lrsr, (L, R, S, R))):
        for var in (_ID, _TIME, _REFL, _BOTH):
            add(fn, var, (("t", 1), (-half, 1), ("u", 1), ("v", 1)), steers)
    for fn, steers in ((_lrsl, (L, R, S, L)), (_lrsr, (L, R, S, R))):
        for var in (_ID_B, _TIME_B, _REFL_B, _BOTH_B):
            add(fn, var, (("t", 1), (-half, 1), ("u", 1), ("v", 1)), steers)
    for var in (_ID, _TIME, _REFL, _BOTH):
        add(_lrslr, var, (("t", 1), (-half, 1), ("u", 1), (-half, 1), ("v", 1)),
            (L, R, S, L, R))
    assert len(T) == N_WORDS, len(T)
    return T


_TABLE = _build_table()

# words grouped by base formula, in order of first appearance
_GROUPS: dict = {}
for _i, (_fn, _var, _, _) in enumerate(_TABLE):
    _GROUPS.setdefault(_fn, []).append(_i)
# row of each word in the concatenation of the groups
_ROW = np.empty(N_WORDS, np.int64)
for _r, _i in enumerate([i for idx in _GROUPS.values() for i in idx]):
    _ROW[_i] = _r

_STEERS = np.zeros((N_WORDS, N_SEG), np.float32)
# per (word, segment): which of [t, u, v, -pi/2, 0] it takes, and its sign
# (-pi/2 is the only fixed arc in the table)
_SRC = {"t": 0, "u": 1, "v": 2, -0.5 * PI: 3}
_SEG_SRC = np.full((N_WORDS, N_SEG), 4, np.int64)
_SEG_SIGN = np.ones((N_WORDS, N_SEG), np.float32)
for _i, (_, _, _sg, _st) in enumerate(_TABLE):
    for _j, _s in enumerate(_st):
        _STEERS[_i, _j] = _s
    for _j, (_sym, _sgn) in enumerate(_sg):
        _SEG_SRC[_i, _j] = _SRC[_sym]
        _SEG_SIGN[_i, _j] = _sgn


@functools.lru_cache(maxsize=None)
def _device_tables(dev: torch.device):
    """(_ROW, _SEG_SRC, _SEG_SIGN, _STEERS) on ``dev``, copied there once:
    a copy from the host on every call would wait for the device, and a
    CUDA graph cannot hold one."""
    return tuple(torch.as_tensor(a, device=dev) for a in (_ROW, _SEG_SRC, _SEG_SIGN, _STEERS))


class RSCandidates(NamedTuple):
    lengths: torch.Tensor   # (..., 46, 5) signed, curvature-normalized
    steers: torch.Tensor    # (..., 46, 5) in {-1, 0, 1}
    valid: torch.Tensor     # (..., 46) bool
    L: torch.Tensor         # (..., 46) total normalized length


def all_words(x, y, phi) -> RSCandidates:
    """Evaluate every RS word for normalized goals (x, y, phi) of any shape."""
    c, s = torch.cos(phi), torch.sin(phi)
    bxy = (x * c + y * s, x * s - y * c)
    valids, tuvs = [], []
    for fn, idx in _GROUPS.items():
        ins = [[], [], []]
        for i in idx:
            sx, sy, sphi, backwards = _TABLE[i][1]
            bx, by = bxy if backwards else (x, y)
            ins[0].append(sx * bx)
            ins[1].append(sy * by)
            ins[2].append(sphi * phi)
        ok, t, u, v = fn(*(torch.stack(a, dim=-1) for a in ins))
        valids.append(ok)
        tuvs.append(torch.stack([t, u, v], dim=-1))
    row, seg_src, seg_sign, word_steers = _device_tables(x.device)
    valid = torch.cat(valids, dim=-1)[..., row]                     # (..., 46)
    tuv = torch.cat(tuvs, dim=-2)[..., row, :]                      # (..., 46, 3)
    src = torch.cat([tuv, torch.full_like(tuv[..., :1], -0.5 * PI),
                     torch.zeros_like(tuv[..., :1])], dim=-1)      # (..., 46, 5)
    idx = seg_src.expand(src.shape)
    lengths = seg_sign * torch.gather(src, -1, idx)

    Ltot = torch.sum(torch.abs(lengths), dim=-1)
    # zero-length / overlong candidates are invalid (reference set_path:68-73)
    valid = valid & (Ltot >= 0.001) & (Ltot < MAX_LENGTH)
    lengths = torch.where(valid[..., None], lengths, 0.0)
    steers = word_steers.expand(lengths.shape)
    return RSCandidates(lengths, steers, valid, torch.where(valid, Ltot, torch.inf))


def goal_to_local(start, goal, maxc):
    """(..., 3) goals into the start frames, scaled by max curvature."""
    dx = goal[..., 0] - start[..., 0]
    dy = goal[..., 1] - start[..., 1]
    dth = goal[..., 2] - start[..., 2]
    c = torch.cos(start[..., 2])
    s = torch.sin(start[..., 2])
    return (c * dx + s * dy) * maxc, (-s * dx + c * dy) * maxc, dth


def candidates(start, goal, maxc) -> RSCandidates:
    """All word candidates for (..., 3) (start, goal) pairs."""
    return all_words(*goal_to_local(start, goal, maxc))


def optimal_length(start, goal, maxc):
    """Length (metres) of the shortest RS path."""
    return torch.amin(candidates(start, goal, maxc).L, dim=-1) / maxc


def sample_path(lengths, steers, start, maxc, n_points: int, step_m: float):
    """Discretize candidates into fixed (..., N, 3) pose buffers + masks.

    Uniform arc-length sampling at ``step_m`` metres, with the exact path
    endpoint as the last live sample.

    Args:
      lengths: (..., n_seg) signed normalized segment lengths.
      steers: (..., n_seg) in {-1, 0, 1}.
      start: (..., 3) world start poses (broadcast against lengths' batch).

    Returns:
      poses (..., N, 3) (dead samples clamp to the path end), mask (..., N)
      bool, dirs (..., N) +1 forward / -1 backward.
    """
    n_seg = lengths.shape[-1]
    dev = lengths.device
    cum = torch.cumsum(torch.abs(lengths), dim=-1)
    total = cum[..., -1:]
    starts_cum = torch.cat([torch.zeros_like(cum[..., :1]), cum[..., :-1]], dim=-1)

    seg_starts = []
    x0 = y0 = th0 = torch.zeros_like(lengths[..., 0])
    for i in range(n_seg):
        seg_starts.append(torch.stack([x0, y0, th0], dim=-1))
        l, sig_i = lengths[..., i], steers[..., i]
        straight = sig_i == 0.0
        x0 = torch.where(straight, x0 + l * torch.cos(th0),
                         x0 + sig_i * (torch.sin(th0 + sig_i * l) - torch.sin(th0)))
        y0 = torch.where(straight, y0 + l * torch.sin(th0),
                         y0 - sig_i * (torch.cos(th0 + sig_i * l) - torch.cos(th0)))
        th0 = th0 + sig_i * l
    seg_start_poses = torch.stack(seg_starts, dim=-2)               # (..., n_seg, 3)

    step_n = step_m * maxc
    ar = torch.arange(n_points, device=dev)
    s = ar.to(torch.float32) * step_n
    mask = s <= total + 0.5 * step_n                                # (..., N)
    s = torch.minimum(s, total)
    live_cnt = torch.sum(mask, dim=-1, keepdim=True)
    s = torch.where(ar == live_cnt - 1, total, s)

    seg_idx = torch.clamp(torch.sum(cum[..., None, :] <= s[..., :, None], dim=-1),
                          0, n_seg - 1)                             # (..., N)
    base = torch.gather(seg_start_poses, -2, seg_idx[..., None].expand(*seg_idx.shape, 3))
    l_seg = torch.gather(lengths, -1, seg_idx)
    sig = torch.gather(steers, -1, seg_idx)
    p = torch.clamp(s - torch.gather(starts_cum, -1, seg_idx), min=0.0)
    ps = torch.sign(l_seg) * p

    th0 = base[..., 2]
    straight = sig == 0.0
    x = torch.where(straight, base[..., 0] + ps * torch.cos(th0),
                    base[..., 0] + sig * (torch.sin(th0 + sig * ps) - torch.sin(th0)))
    y = torch.where(straight, base[..., 1] + ps * torch.sin(th0),
                    base[..., 1] - sig * (torch.cos(th0 + sig * ps) - torch.cos(th0)))
    th = th0 + sig * ps

    st = start[..., None, :]
    c0, s0 = torch.cos(st[..., 2]), torch.sin(st[..., 2])
    wx = (c0 * x - s0 * y) / maxc + st[..., 0]
    wy = (s0 * x + c0 * y) / maxc + st[..., 1]
    wth = wrap_pi(th + st[..., 2])

    dirs = torch.where(torch.sign(l_seg) >= 0, 1.0, -1.0)
    return torch.stack([wx, wy, wth], dim=-1), mask, dirs
