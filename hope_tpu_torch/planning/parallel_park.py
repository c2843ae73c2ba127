"""Multi-cusp parallel-parking maneuver templates (a numpy copy of
``hope_tpu/planning/parallel_park.py``; ``build_templates`` gives the same
arrays).

Extrem procedural scenes are parallel slots only (slot length = car + 0.6-0.9
m), where the Reeds-Shepp validity manifold is little more than the parked
pose itself: a single RS word carries at most two cusps, and threading a car
into a slot 0.6 m longer than itself takes many alternating full-lock arcs.
So the pure-MPC mode synthesizes the maneuver explicitly.

A small library of scene-independent wiggle templates is built in the slot
frame (x along the slot axis, y toward the aisle, destination pose at the
origin) by simulating the EXIT maneuver from the parked pose (alternating
forward and reverse full-lock arcs, or arcs and straight reverses, or a
corner-exact run to contact inside a slot envelope), then swinging out into
the aisle and time-reversing the whole thing: an ENTRY plan that ends exactly
at the destination pose. Each template is a fixed-length list of
constant-steer segments, the representation of RS paths, so
``reeds_shepp.sample_path`` discretizes it, ``rs_select`` sweeps it and
``build_action_queue`` executes it. ``staging.compute_staging`` places every
template at each scene's slot, sweeps it against the scene's obstacles and
appends the valid ones as staging candidates.

Template parameters are swept over a grid rather than derived from per-scene
clearances: the swept-car collision check is the arbiter, the grid only has
to contain one workable schedule per geometry. Two behaviours are kept as the
reference has them: templates get no length budget (``emit``), and the dedup
key holds the segment lengths only, not the steers.
"""
from __future__ import annotations

import math

import numpy as np

N_WIGGLE_SEG = 40          # fixed segment slots per template (zero-padded)


def _arc(x, y, th, sigma, length):
    """Exact unit-curvature arc update (matches reeds_shepp.sample_path)."""
    if sigma == 0.0:
        return x + length * math.cos(th), y + length * math.sin(th), th
    nx = x + sigma * (math.sin(th + sigma * length) - math.sin(th))
    ny = y - sigma * (math.cos(th + sigma * length) - math.cos(th))
    return nx, ny, th + sigma * length


def _exit_template(margin_n, phi_cap, th_exit, aisle_y_n, back_to_n=None,
                   max_pairs=12):
    """One EXIT maneuver in the normalized (unit-curvature) slot frame.

    Returns (segments [(signed_len, steer)], end_pose) or None if the wiggle
    budget can't reach ``th_exit``.  ``margin_n``/``aisle_y_n`` are normalized
    (multiply metres by max curvature).  ``margin_n`` may be a scalar
    (symmetric budget) or a ``(front, back)`` pair: the parked dest pose is
    NOT generally centered in the real gap, and the zero-coverage
    scenes fail in the last wiggle arcs precisely because the symmetric
    envelope wastes room on the roomy side (benchmarks/diag_extrem_wiggle.py).
    """
    m_fwd, m_back = (margin_n if isinstance(margin_n, tuple)
                     else (margin_n, margin_n))
    segs = []
    x = y = th = 0.0
    for _ in range(max_pairs):
        if th >= th_exit:
            break
        # forward-left arc, longitudinal excursion capped at +margin_front
        room = math.sin(th) + max(0.0, m_fwd - x)
        phi = max(0.0, math.asin(min(1.0, room)) - th)
        phi = min(phi, phi_cap, th_exit - th)
        if phi > 1e-4:
            x, y, th = _arc(x, y, th, +1.0, phi)
            segs.append((phi, +1.0))
        if th >= th_exit:
            break
        # reverse-right arc (heading still increases), excursion >= -margin_back
        room = math.sin(th) + max(0.0, m_back + x)
        phi = max(0.0, math.asin(min(1.0, room)) - th)
        phi = min(phi, phi_cap, th_exit - th)
        if phi <= 1e-4:
            if not segs:
                return None
            break
        x, y, th = _arc(x, y, th, -1.0, -phi)
        segs.append((-phi, -1.0))
    if th < th_exit - 1e-3:
        return None
    # swing out into the aisle: forward-left until the lateral rise plus the
    # straightening forward-right arc (y gain 1 - cos(th)) reaches aisle_y
    while y + (1.0 - math.cos(th)) < aisle_y_n and th < 1.25:
        phi = min(0.15, 1.25 - th)
        x, y, th = _arc(x, y, th, +1.0, phi)
        segs.append((phi, +1.0))
    # forward-right arc back to heading 0; its length equals the heading
    th_pre = th
    x, y, th = _arc(x, y, th, -1.0, th_pre)
    segs.append((th_pre, -1.0))
    if back_to_n is not None and x > back_to_n:
        # straight reverse along the aisle, so the ENTRY (time-reversed)
        # starts BESIDE the slot instead of over the front neighbour — the
        # dominant start-pose collision mode on cluttered scenes
        segs.append((-(x - back_to_n), 0.0))
        x = back_to_n
    return segs, (x, y, th)


def _exit_template_arcstraight(margin_n, phi_cap, th_exit, aisle_y_n,
                               back_to_n=None, max_pairs=16):
    """Second wiggle family: (forward-left arc, reverse-STRAIGHT) pairs.

    The first family's reverse-right arcs rotate the car while backing up,
    swinging the rear corner toward the curb — the binding constraint on the
    narrowest slots.  Here heading only grows on forward arcs and the reverse
    legs are straight (no rotation), trading ~2x the cusps for zero
    rear-swing.  Same return contract (and asymmetric-margin convention) as
    :func:`_exit_template`."""
    m_fwd, m_back = (margin_n if isinstance(margin_n, tuple)
                     else (margin_n, margin_n))
    segs = []
    x = y = th = 0.0
    for _ in range(max_pairs):
        if th >= th_exit:
            break
        room = math.sin(th) + max(0.0, m_fwd - x)
        phi = max(0.0, math.asin(min(1.0, room)) - th)
        phi = min(phi, phi_cap, th_exit - th)
        if phi > 1e-4:
            x, y, th = _arc(x, y, th, +1.0, phi)
            segs.append((phi, +1.0))
        if th >= th_exit:
            break
        d = max(0.0, (x + m_back) / max(math.cos(th), 0.3))
        if d <= 1e-4:
            if not segs:
                return None
            break
        x, y, th = _arc(x, y, th, 0.0, -d)
        segs.append((-d, 0.0))
    if th < th_exit - 1e-3:
        return None
    while y + (1.0 - math.cos(th)) < aisle_y_n and th < 1.25:
        phi = min(0.15, 1.25 - th)
        x, y, th = _arc(x, y, th, +1.0, phi)
        segs.append((phi, +1.0))
    th_pre = th
    x, y, th = _arc(x, y, th, -1.0, th_pre)
    segs.append((th_pre, -1.0))
    if back_to_n is not None and x > back_to_n:
        segs.append((-(x - back_to_n), 0.0))
        x = back_to_n
    return segs, (x, y, th)


def _exit_template_envelope(maxc, dims, m_fwd, m_back, c_curb, aisle_y,
                            v_top_extra=0.0, back_to=None, dphi=0.01,
                            max_cusps=16, th_cap=1.35,
                            rev_mode="straight", rev_budget_m=0.3):
    """Third family: corner-EXACT greedy exit inside a slot envelope (metres).

    The first two families schedule arcs from the rear-axle's longitudinal
    excursion only; a collision autopsy
    (benchmarks/inspect_extrem_fail.py) shows the scenes they miss fail on
    CORNER geometry — the rear corner digs into the curb or rear neighbor
    during rotation, or the nose pokes the front row during swing-in.  Here
    the exit is simulated with the true car footprint against a parameterized
    slot envelope and each arc runs to CONTACT (classic bang-bang parking):

        rear face  u <= -(rear_hang + m_back)   (solid below the row top)
        front face u >= front_len + m_fwd       (solid below the row top)
        curb       v <= -(width/2 + c_curb)     (solid everywhere)
        row top    v  = width/2 + v_top_extra   (free space above)

    Forward-left phases run to contact (they gain both heading and curb
    headroom); reverse phases are BUDGET-CAPPED (``rev_budget_m``) rather
    than run-to-contact — a reverse arc loses curb headroom 1:1 with the
    forward gains, so myopic reverse-to-contact deadlocks against the curb
    around th~0.37 (a measured trace) — and come in two modes: "arc"
    (reverse-right, gains heading, loses more y) and "straight" (family-2
    style, zero rear swing).

    A template built this way is feasible by construction for every scene
    whose true clearances dominate the envelope's; the per-scene sweep in
    ``staging.compute_staging`` remains the exact arbiter.

    Args:
      dims: (rear_hang, front_len, half_width) in metres.
      back_to: like the other families — straight reverse along the aisle so
        the ENTRY starts beside the slot rather than over the front row.

    Returns (segments [(normalized_len, steer)], end_pose_normalized) or
    None; same contract as :func:`_exit_template`.
    """
    rear_hang, front_len, half_w = dims
    R = 1.0 / maxc
    u_front = front_len + m_fwd
    u_rear = -(rear_hang + m_back)
    v_curb = -(half_w + c_curb)
    v_top = half_w + v_top_extra
    rel = ((-rear_hang, -half_w), (front_len, -half_w),
           (front_len, half_w), (-rear_hang, half_w))

    def corners(x, y, th):
        c, s = math.cos(th), math.sin(th)
        return tuple((x + cu * c - cv * s, y + cu * s + cv * c)
                     for cu, cv in rel)

    def ok(x, y, th):
        for cu, cv in corners(x, y, th):
            if cv < v_curb:
                return False
            if cv < v_top and (cu > u_front or cu < u_rear):
                return False
        return True

    def swung_out(y, th):
        # the forward-right straighten arc ends at y + (1 - cos th) * R:
        # reaching aisle_y there means the car straightens fully in the aisle
        return y + (1.0 - math.cos(th)) * R >= aisle_y

    def run_arc(x, y, th, s_sign, k, phi_budget, stop_on_swing=True):
        """Micro-step one constant-curvature phase to contact; returns
        (x, y, th, swept_phi, done) — done marks the swing-out criterion."""
        swept = 0.0
        while swept + dphi <= phi_budget + 1e-9:
            s = s_sign * dphi / abs(k) if k != 0.0 else s_sign * dphi
            th2 = th + s * k
            if k != 0.0:
                x2 = x + (math.sin(th2) - math.sin(th)) / k
                y2 = y - (math.cos(th2) - math.cos(th)) / k
            else:
                x2, y2 = x + s * math.cos(th), y + s * math.sin(th)
            if not ok(x2, y2, th2) or th2 > th_cap or th2 < -1e-9:
                break
            x, y, th = x2, y2, th2
            swept += dphi
            if stop_on_swing and s_sign > 0 and swung_out(y, th):
                return x, y, th, swept, True
        return x, y, th, swept, False

    segs = []
    x = y = th = 0.0
    done = False
    for _ in range(max_cusps):
        # forward-left to contact (or clearance)
        x, y, th, phi, done = run_arc(x, y, th, +1.0, maxc, th_cap - th)
        if phi > 1e-9:
            segs.append((phi, +1.0))
        if done:
            break
        if rev_mode == "arc":
            # reverse-right (heading keeps increasing), capped
            budget = min(rev_budget_m * maxc, th_cap - th)
            x, y, th, phi, _ = run_arc(x, y, th, -1.0, -maxc, budget)
            if phi <= 1e-9:
                return None              # both directions at contact
            segs.append((-phi, -1.0))
        else:
            # reverse straight: pure front-room creation, zero rear swing
            x, y, th, d, _ = run_arc(x, y, th, -1.0, 0.0, rev_budget_m)
            if d <= 1e-9:
                return None
            segs.append((-d * maxc, 0.0))    # normalized straight length
    if not done:
        return None
    # straighten (forward-right, length = heading) back to heading 0
    th_pre = th
    x, y, th, phi, _ = run_arc(x, y, th, +1.0, -maxc, th_pre,
                               stop_on_swing=False)
    if th > 1e-6:
        return None              # straighten arc blocked mid-way
    segs.append((th_pre, -1.0))
    if back_to is not None and x > back_to:
        segs.append((-(x - back_to) * maxc, 0.0))
        x = back_to
    # merge adjacent same-steer, same-direction phases (the swing loop and
    # the last wiggle arc are one physical arc)
    merged = []
    for ln, st in segs:
        if merged and merged[-1][1] == st and merged[-1][0] * ln > 0:
            merged[-1][0] += ln
        else:
            merged.append([ln, st])
    segs = [(ln, st) for ln, st in merged]
    # normalized contract: lengths in radians/unit-curvature, pose scaled
    return segs, (x * maxc, y * maxc, th)


def build_templates(maxc: float,
                    margins_m=(0.15, 0.22, 0.32, 0.45),
                    phi_caps=(0.06, 0.10, 0.16, 0.26),
                    th_exits=(0.3, 0.4, 0.5, 0.65, 0.8),
                    aisle_y_m=(2.0, 2.4, 2.8),
                    back_to_m=(None, 0.8),
                    asym_margins=((0.06, 0.20), (0.20, 0.06), (0.10, 0.35),
                                  (0.35, 0.10), (0.12, 0.50), (0.50, 0.12),
                                  (0.18, 0.30), (0.30, 0.18), (0.08, 0.25),
                                  (0.25, 0.08)),
                    asym_caps=(0.03, 0.05, 0.10, 0.16),
                    asym_th_exits=(0.3, 0.45, 0.6, 0.8),
                    asym_aisle_y=(1.7, 2.4, 3.2),
                    dims=(0.93, 3.76, 0.97),
                    env_margins=((0.05, 0.15), (0.15, 0.05), (0.10, 0.10),
                                 (0.15, 0.30), (0.30, 0.15), (0.25, 0.25)),
                    env_curbs=(0.10, 0.20, 0.35),
                    env_rev=(("straight", 0.2), ("straight", 0.4),
                             ("arc", 0.15)),
                    env_aisle_y=(2.2, 2.8),
                    env_back_to=(None, 0.8)):
    """Static template library (three families; see the module docstring).

    The asym_* grid is a second sweep pass over families 1-2 with
    ASYMMETRIC (front, back) margin budgets: the parked dest pose is not
    generally centered in the real gap, and a coverage study
    (benchmarks/iter_extrem_templates.py) measured the symmetric grid
    missing exactly the skewed slots — asymmetric pairs + tight per-arc
    caps + a shallower/deeper aisle rescued 19/38 zero-coverage Extrem
    scenes on the seed-0 bank.

    Args:
      dims: (rear_hang, front_len, half_width) in metres for the corner-exact
        envelope family (reference VehicleBox dims by default).
      env_*: the envelope family's parameter grid — (front, back) clearance
        pairs, curb clearances, (reverse mode, budget) pairs, aisle exit
        heights, optional back-off.

    Returns:
      lengths: (T, N_WIGGLE_SEG) signed segment lengths in METRES (entry
        order — executing them from the start pose ends exactly at the slot).
      steers: (T, N_WIGGLE_SEG) in {-1, 0, 1}.
      starts: (T, 3) entry start pose in the slot frame, METRES (x along
        slot axis, y toward aisle, theta relative to slot heading).
    """
    R = 1.0 / maxc
    out_l, out_s, out_p = [], [], []
    seen = set()

    def emit(t):
        if t is None:
            return
        segs, end = t
        if len(segs) > N_WIGGLE_SEG:
            return
        # ENTRY = time-reversed exit: reverse order, flip travel direction,
        # same steer per arc
        entry = [(-l, s) for (l, s) in reversed(segs)]
        key = tuple(round(l, 5) for l, _ in entry)
        if key in seen:
            return
        seen.add(key)
        L = np.zeros(N_WIGGLE_SEG, np.float32)
        S = np.zeros(N_WIGGLE_SEG, np.float32)
        for i, (l, s) in enumerate(entry):
            L[i] = l * R              # normalized -> metres
            S[i] = s
        out_l.append(L)
        out_s.append(S)
        # entry starts where the exit ended; mirror for the opposite approach
        # side is NOT needed: slot frame y always points toward the aisle by
        # construction of the generator (aisle side = +normal)
        out_p.append(np.asarray([end[0] * R, end[1] * R, 0.0], np.float32))
    for m in margins_m:
        for cap in phi_caps:
            for te in th_exits:
                for ay in aisle_y_m:
                    for bk in back_to_m:
                        for fam in (_exit_template,
                                    _exit_template_arcstraight):
                            m_n = (tuple(v * maxc for v in m)
                                   if isinstance(m, tuple) else m * maxc)
                            emit(fam(m_n, cap, te, ay * maxc,
                                     None if bk is None else bk * maxc))
    for m in asym_margins:
        for cap in asym_caps:
            for te in asym_th_exits:
                for ay in asym_aisle_y:
                    for bk in back_to_m:
                        for fam in (_exit_template,
                                    _exit_template_arcstraight):
                            m_n = tuple(v * maxc for v in m)
                            emit(fam(m_n, cap, te, ay * maxc,
                                     None if bk is None else bk * maxc,
                                     max_pairs=24))
    for mf, mb in env_margins:
        for cc in env_curbs:
            for rm, rb in env_rev:
                for ay in env_aisle_y:
                    for bk in env_back_to:
                        emit(_exit_template_envelope(
                            maxc, dims, mf, mb, cc, ay, back_to=bk,
                            rev_mode=rm, rev_budget_m=rb))
    return (np.stack(out_l), np.stack(out_s), np.stack(out_p))
