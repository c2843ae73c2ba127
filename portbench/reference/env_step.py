"""The parking environment's control step, written out plainly in float64:
the bicycle's Euler sub-steps, arrival (95% of the slot covered) and
collision at each sub-step, the first event freezing the car, the status,
the shaped reward; the observation (lidar, target, mask, image); a
Reeds-Shepp path held to what a found path must be; and the hybrid RS
takeover replayed row by row.

Where float32 and float64 can land on either side of a threshold (a car
edge grazing an obstacle edge, an overlap at the arrival ratio, a beam
grazing an obstacle's corner), the comparison does not guess: a sub-step
event is judged with a margin of ``EPS`` metres both ways, a row whose
events the margin cannot settle is left out (and counted), and a lidar beam
is held between the readings with every edge moved by what float32 can
move it (``lidar_bounds``).
"""
from __future__ import annotations

import math

import torch

from . import kernels
from .compare import ROUNDING, values_differ
from .spec import ARRIVED, COLLIDED, CONTINUE, ENV, OBS, OUTBOUND, OUTTIME, REWARD, VEHICLE

EPS = 1e-4       # metres a threshold is given
# what float32 can move an edge in the car's frame (a few units in the last
# place of coordinates of ~16 m)
NORMAL = 2e-5
# what float32 leaves of the slot overlap's ratio at DLP's coordinates (up to
# 136 m): the program's overlap in world coordinates read up to 9.3e-5 off
# float64 over 9920 random overlaps of a car with its slot
AREA_TOL = 3e-4
F64 = torch.float64


def box(pose):
    """(..., 3) poses -> (..., 4, 2) car corners, float64."""
    return kernels.pose_to_box(pose.to(F64), kernels.corners(pose.device, F64))


# ------------------------------------------------------------ geometry


def _cross(ax, ay, bx, by):
    return ax * by - ay * bx


def segments_hit(e1, e2, tol: float):
    """(..., M, 4) x (..., N, 4) -> (..., M, N): the segments meet, with
    each grown (``tol`` > 0) or shrunk (< 0) by ``tol`` metres at both ends.
    Parallel pairs never meet."""
    p, r = e1[..., :, None, 0:2], e1[..., :, None, 2:4] - e1[..., :, None, 0:2]
    q, s = e2[..., None, :, 0:2], e2[..., None, :, 2:4] - e2[..., None, :, 0:2]
    rxs = _cross(r[..., 0], r[..., 1], s[..., 0], s[..., 1])
    qp = q - p
    den = torch.where(rxs == 0, 1.0, rxs)
    t = _cross(qp[..., 0], qp[..., 1], s[..., 0], s[..., 1]) / den
    u = _cross(qp[..., 0], qp[..., 1], r[..., 0], r[..., 1]) / den
    tt = tol / torch.linalg.norm(r, dim=-1).clamp(min=1e-12)
    tu = tol / torch.linalg.norm(s, dim=-1).clamp(min=1e-12)
    return (t >= -tt) & (t <= 1 + tt) & (u >= -tu) & (u <= 1 + tu) & (rxs != 0)


def _clip(poly, n, a, b):
    """Sutherland-Hodgman: convex ``poly`` (..., 8, 2) with ``n`` live
    vertices, cut by the half-plane left of a -> b."""
    V = poly.shape[-2]
    idx = torch.arange(V, device=poly.device)
    nxt = torch.gather(poly, -2, torch.where(idx + 1 >= n[..., None], 0, idx + 1)[..., None]
                       .expand(poly.shape))
    ex, ey = b[..., 0, None] - a[..., 0, None], b[..., 1, None] - a[..., 1, None]
    dc, dn = (_cross(ex, ey, p[..., 0] - a[..., 0, None], p[..., 1] - a[..., 1, None])
              for p in (poly, nxt))
    live = idx < n[..., None]
    keep_c = (dc >= 0) & live
    cross = ((dc >= 0) != (dn >= 0)) & live
    w = dc / torch.where(dc - dn == 0, 1.0, dc - dn)
    xp = poly + w[..., None] * (nxt - poly)
    # each vertex emits itself where kept, then the crossing to its successor
    pts = torch.stack([poly, xp], dim=-2).flatten(-3, -2)              # (..., 2V, 2)
    use = torch.stack([keep_c, cross], dim=-1).flatten(-2)
    order = torch.sort((~use).to(torch.uint8), dim=-1, stable=True).indices[..., :V]
    out = torch.gather(pts, -2, order[..., None].expand(*order.shape, 2))
    return out, use.sum(-1).clamp(max=V)


def area(poly, n):
    x, y = poly[..., 0], poly[..., 1]
    live = torch.arange(poly.shape[-2], device=poly.device) < n[..., None]
    x, y = torch.where(live, x, x[..., :1]), torch.where(live, y, y[..., :1])
    return 0.5 * torch.abs(torch.sum(x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y, -1))


def overlap(b1, b2):
    """Area of two convex quads' intersection (..., 4, 2) x (..., 4, 2)."""
    poly = torch.cat([b1, b1[..., :4, :]], dim=-2)                     # room for 8
    n = torch.full(b1.shape[:-2], 4, device=b1.device)
    for i in range(4):
        poly, n = _clip(poly, n, b2[..., i, :], b2[..., (i + 1) % 4, :])
    return torch.where(n >= 3, area(poly, n), 0.0)


# --------------------------------------------------------- the transition


def substeps(pose, action):
    """(B, 3), (B, 2) physical -> (B, n, 3) poses after each sub-step: HOPE's
    kinematic model, 20 Euler iterations per 0.05 s sub-step."""
    v = VEHICLE
    steer = action[:, 0].to(F64).clamp(-v["max_steer"], v["max_steer"])
    speed = action[:, 1].to(F64).clamp(-v["max_speed"], v["max_speed"])
    h = v["dt"] / v["euler_iters"]
    dth = speed * torch.tan(steer) / v["wheel_base"] * h
    x, y, th = (pose[:, i].to(F64) for i in range(3))
    out = []
    for _ in range(v["n_substep"]):
        for _ in range(v["euler_iters"]):
            x, y, th = x + speed * torch.cos(th) * h, y + speed * torch.sin(th) * h, th + dth
        out.append(torch.stack([x, y, th], -1))
    return torch.stack(out, 1)


def transition(pose, t, accum, action, scene):
    """One control step from (pose, t, accum) under the physical ``action``,
    on ``scene`` (the program's, checked against the reference's own).
    Returns a dict: pose, t, accum, status, reward, ``overlap`` (B,) rows
    whose reward takes the slot overlap in, and ``unsure`` (B,) rows whose
    events the margin cannot settle."""
    B = pose.shape[0]
    dev = pose.device
    rows = torch.arange(B, device=dev)
    traj = substeps(pose, action)
    n = traj.shape[1]
    boxes = box(traj)                                                   # (B, n, 4, 2)
    dbox = scene["dest_box"].to(F64)
    dest_area = area(dbox, torch.full((B,), 4, device=dev))
    ratio = overlap(boxes, dbox[:, None]) / dest_area[:, None]
    thr = ENV["arrive_overlap"]
    arr, arr_unsure = ratio > thr, (ratio - thr).abs() < AREA_TOL
    car = kernels.box_to_edges(boxes).reshape(B, n * 4, 4)
    edges, emask = scene["edges"].to(F64), scene["edge_mask"]
    hit_in = (segments_hit(car, edges, -EPS) & emask[:, None]).reshape(B, n, -1).any(-1)
    hit_out = (segments_hit(car, edges, EPS) & emask[:, None]).reshape(B, n, -1).any(-1)
    col = hit_in
    event = arr | col
    has = event.any(1)
    f0 = torch.argmax(event.to(torch.uint8), 1)
    # the events up to the one that decides (all of them where none does)
    upto = torch.arange(n, device=dev)[None] <= torch.where(has, f0, n - 1)[:, None]
    unsure = ((arr_unsure | (hit_out != hit_in)) & upto).any(1)
    arr_f0 = arr[rows, f0]
    final = torch.where(~has, n - 1, torch.where(arr_f0, f0, f0 - 1))
    take = final >= 0
    new = torch.where(take[:, None], traj[rows, final.clamp(min=0)], pose.to(F64))

    t1 = t + 1
    b = scene["bounds"].to(F64)
    x, y = new[:, 0], new[:, 1]
    out = (x < b[:, 0]) | (x > b[:, 1]) | (y < b[:, 2]) | (y > b[:, 3])
    margin = torch.stack([x - b[:, 0], b[:, 1] - x, y - b[:, 2], b[:, 3] - y], -1).abs()
    unsure |= (margin < EPS).any(-1)
    status = torch.full((B,), CONTINUE, dtype=torch.int32, device=dev)
    status = torch.where(t1 > ENV["tolerant_time"], OUTTIME, status)
    status = torch.where(out, OUTBOUND, status)
    if ENV["env_collide"]:
        status = torch.where(col[:, 0] & ~arr[:, 0], COLLIDED, status)
    status = torch.where(has & arr_f0, ARRIVED, status).to(torch.int32)

    dest, start = scene["dest"].to(F64), scene["start"].to(F64)
    p0 = pose.to(F64)
    time_cost = -torch.tanh(t1.to(F64) / (10.0 * ENV["tolerant_time"]))
    norm = torch.hypot(dest[:, 0] - start[:, 0], dest[:, 1] - start[:, 1]).clamp(min=10.0)
    d1 = torch.hypot(new[:, 0] - dest[:, 0], new[:, 1] - dest[:, 1])
    d0 = torch.hypot(p0[:, 0] - dest[:, 0], p0[:, 1] - dest[:, 1])

    def fold(a):                 # heading difference to the slot, folded to [0, pi/2]
        d = torch.arccos(torch.cos(a - dest[:, 2]).clamp(-1, 1))
        return torch.where(d < math.pi / 2, d, math.pi - d)

    inter = overlap(box(new), dbox)
    union = inter / (2 * dest_area - inter)
    grew = union >= accum.to(F64)
    terms = torch.stack([time_cost, torch.zeros_like(time_cost), (d0 - d1) / norm,
                         (fold(p0[:, 2]) - fold(new[:, 2])) / math.pi,
                         torch.where(grew, union - accum.to(F64), 0.0)], -1)
    cont = status == CONTINUE
    terms = torch.where(cont[:, None], terms, 0.0)
    new_accum = torch.where(cont & grew, union, accum.to(F64))
    r = REWARD
    w = torch.tensor([r["w_time"], 0.0, r["w_dist"], r["w_angle"], r["w_box_union"]],
                     dtype=F64, device=dev)
    reward = (terms * w).sum(-1)
    for code, value in ((OUTTIME, r["r_outtime"]), (OUTBOUND, r["r_outbound"]),
                        (COLLIDED, r["r_collided"]), (ARRIVED, r["r_arrived"])):
        reward = torch.where(status == code, value, reward)
    return {"pose": new, "t": t1, "overlap": (inter > 0) | (accum > 0), "accum": new_accum,
            "status": status, "reward": reward * r["ratio"], "unsure": unsure}


# --------------------------------------------------------- the observation


def lidar_bounds(pose, edges, emask):
    """(lo, hi) (B, R): each beam's distance to the nearest live edge, less
    the hull, over every placement of the edges within what float32 can
    move them in the car's frame: each edge shifted by ``NORMAL`` metres
    either way along its normal, and grown by ``EPS`` at both ends (lo) or
    shrunk by it (hi). A beam that meets an edge at a shallow angle moves
    by ``NORMAL`` over the sine of that angle."""
    dev = pose.device
    p = pose.to(F64)
    c, s = torch.cos(p[:, 2])[:, None], torch.sin(p[:, 2])[:, None]
    e = edges.to(F64)
    ego = []
    for k in (0, 2):
        dx, dy = e[..., k] - p[:, 0:1], e[..., k + 1] - p[:, 1:2]
        ego += [c * dx + s * dy, -s * dx + c * dy]
    ax, ay, bx, by = (v[:, None] for v in ego)                    # (B, 1, E)
    ang = kernels.beam_angles(dev).to(F64)
    rx, ry = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    ex, ey = bx - ax, by - ay
    length = torch.hypot(ex, ey).clamp(min=1e-12)
    nx, ny = -ey / length, ex / length
    den = _cross(rx, ry, ex, ey)
    ok = (den != 0) & emask[:, None]
    den = torch.where(den == 0, 1.0, den)
    rng = OBS["max_range"]

    def hits(shift, grow):
        qx, qy = ax + shift * nx, ay + shift * ny
        t = _cross(qx, qy, ex, ey) / den                          # along the beam
        u = _cross(qx, qy, rx, ry) / den                          # along the edge
        gu = grow / length
        return torch.where(ok & (t >= -EPS) & (u >= -gu) & (u <= 1 + gu), t, torch.inf)

    lo = torch.minimum(hits(NORMAL, EPS), hits(-NORMAL, EPS)).amin(-1)
    hi = torch.maximum(hits(NORMAL, -EPS), hits(-NORMAL, -EPS)).amin(-1)
    hull = kernels.hull_base(dev).to(F64)
    return [v.clamp(0.0, rng) - hull for v in (lo, hi)]


def target(pose, dest):
    """(B, 5): distance, cos / sin of the bearing, cos of the heading
    difference twice (HOPE repeats the cosine where it meant the sine)."""
    p, d = pose.to(F64), dest.to(F64)
    dx, dy = d[:, 0] - p[:, 0], d[:, 1] - p[:, 1]
    a, h = torch.atan2(dy, dx) - p[:, 2], d[:, 2] - p[:, 2]
    return torch.stack([torch.hypot(dx, dy), torch.cos(a), torch.sin(a), torch.cos(h),
                        torch.cos(h)], -1)


def observation_differs(obs, pose, ref_scene, table) -> int:
    """How many values of the program's observation of ``pose`` (B, 3) are
    wrong: lidar outside its bounds by more than rounding; target by more
    than rounding; the mask worked out from the program's lidar, and the
    image from the program's pose on the reference's scene, exactly."""
    lo, hi = lidar_bounds(pose, ref_scene["edges"], ref_scene["edge_mask"])
    li = obs["lidar"].to(F64)
    tol = ROUNDING * OBS["max_range"]
    bad = int(((li < lo - tol) | (li > hi + tol)).sum())
    bad += values_differ(obs["target"], target(pose, ref_scene["dest"]))
    bad += values_differ(obs["action_mask"], kernels.action_mask(obs["lidar"], table))
    vbox = kernels.pose_to_box(pose, kernels.corners(pose.device))
    img = kernels.render_bev(pose, vbox, ref_scene["dest_box"], ref_scene["edges"],
                             ref_scene["edge_mask"], ref_scene["raw_poly"])
    return bad + int((obs["img"] != img).sum())


# ------------------------------------------------------------ RS paths


def path_end(pose, lengths, steers):
    """Where the RS path (B, 5) signed metres / steers in {-1, 0, 1} from
    ``pose`` ends: arcs at the full curvature, straights, in turn."""
    k = VEHICLE["max_curvature"]
    x, y, th = (pose[:, i].to(F64) for i in range(3))
    for i in range(lengths.shape[1]):
        ln, sg = lengths[:, i].to(F64), steers[:, i].to(F64)
        arc = sg != 0
        c = torch.where(arc, sg * k, 1.0)
        th1 = th + torch.where(arc, ln * c, 0.0)
        x = torch.where(arc, x + (torch.sin(th1) - torch.sin(th)) / c, x + ln * torch.cos(th))
        y = torch.where(arc, y - (torch.cos(th1) - torch.cos(th)) / c, y + ln * torch.sin(th))
        th = th1
    return torch.stack([x, y, th], -1)


def path_samples(pose, lengths, steers, step: float, n_max: int):
    """(B, n_max, 3) poses every ``step`` metres along the path, its end as
    the last live one, and (B, n_max) live."""
    L = lengths.abs().sum(-1).to(F64)
    s = torch.arange(n_max, device=pose.device, dtype=F64)[None] * step
    live = s <= L[:, None] + 0.5 * step
    last = live.sum(-1, keepdim=True) - 1
    s = torch.where(torch.arange(n_max, device=pose.device)[None] == last, L[:, None],
                    torch.minimum(s, L[:, None]))
    # the path cut at arc length s: each segment taken up to what is left
    cum = torch.cumsum(lengths.abs().to(F64), -1)
    before = cum - lengths.abs().to(F64)
    part = (s[..., None] - before[:, None]).clamp(min=0).minimum(lengths.abs().to(F64)[:, None])
    part = part * torch.sign(lengths.to(F64))[:, None]
    B, N = s.shape
    flat = path_end(pose[:, None].expand(B, N, 3).reshape(-1, 3), part.reshape(B * N, -1),
                    steers[:, None].expand(B, N, -1).reshape(B * N, -1))
    return flat.reshape(B, N, 3), live


def rs_invalid(pose, found, lengths, steers, L, dest, edges, emask, bounds,
               want=None, unsure=None, chunk: int = 32) -> int:
    """How many found paths are not what a found path must be: one found
    where no search was due (``want``); its length not the sum of its
    segments, or over the sweep's budget; not ending on the destination
    (1e-3 m, 1e-3 rad); or where the car, at the search's samples along it,
    surely crosses a live edge or leaves the bounds (by ``EPS``)."""
    bad = torch.zeros_like(found)
    if want is not None:
        bad |= found & ~want
    f = found if unsure is None else found & ~unsure
    if f.any():
        idx = torch.nonzero(f).flatten()
        ln, sg = lengths[idx], steers[idx]
        total = ln.abs().sum(-1).to(F64)
        Lw = L[idx].to(F64)
        b = ((total - Lw).abs() > 1e-4 * Lw.clamp(min=1.0))
        b |= Lw > ENV["rs_points"] * ENV["rs_step"] + 1e-4
        end = path_end(pose[idx], ln, sg)
        d = dest[idx].to(F64)
        dh = torch.remainder(end[:, 2] - d[:, 2] + math.pi, 2 * math.pi) - math.pi
        b |= (torch.hypot(end[:, 0] - d[:, 0], end[:, 1] - d[:, 1]) > 1e-3) | (dh.abs() > 1e-3)
        for j in range(0, idx.shape[0], chunk):
            sl = slice(j, j + chunk)
            i = idx[sl]
            poses, live = path_samples(pose[i], ln[sl], sg[sl], ENV["rs_step"],
                                       ENV["rs_points"])
            car = kernels.box_to_edges(box(poses)).reshape(i.shape[0], -1, 4)
            live4 = live.repeat_interleave(4, -1)
            hit = (segments_hit(car, edges[i].to(F64), -EPS) & live4[..., None]
                   & emask[i][:, None]).flatten(1).any(-1)
            bb = bounds[i].to(F64)[:, None]
            x, y = poses[..., 0], poses[..., 1]
            out = (((x < bb[..., 0] - EPS) | (x > bb[..., 1] + EPS) | (y < bb[..., 2] - EPS)
                    | (y > bb[..., 3] + EPS)) & live).any(-1)
            b[sl] |= hit | out
        bad[idx] |= b
    return int(bad.sum())


# ---------------------------------------------------------- the takeover


def queue(lengths, steers, found, step_ratio: float, size: int):
    """A found path as the controls that drive it, normalized [steer,
    speed]: each segment in whole steps of ``step_ratio`` metres at full
    speed and a last part step for what is left over 1e-3 of a step; at most
    ``size``. One list of (steer, speed) a row."""
    out = []
    for ln, sg, fd in zip(lengths.tolist(), steers.tolist(), found.tolist()):
        q = []
        if fd:
            for li, si in zip(ln, sg):
                m = abs(li) / step_ratio
                whole = math.floor(m)
                sign = math.copysign(1.0, li) if li != 0 else 0.0
                q += [(si, sign)] * whole
                if m - whole > 1e-3:
                    q.append((si, sign * (m - whole)))
        out.append(q[:size])
    return out


def takeover_mismatch(per_step: list, rows, scale) -> int:
    """Steps x rows where the control the program applied is not the one
    HOPE's hybrid agent gives: the latched RS path's next control while one
    is running, else the policy's; a path found after a step is latched
    where none runs. ``per_step``: for each step, the policy's actions,
    the target observation, the applied controls and the RS finds. Rows the
    stuck detector gave a random action are not judged."""
    rows_l = rows.tolist()
    qs = {r: [] for r in rows_l}
    cur = {r: 0 for r in rows_l}
    last = None
    bad = 0
    ms, mv = float(scale[0]), float(scale[1])
    for s in per_step:
        if "applied" not in s:
            break
        tgt = s["target"][rows].double().cpu()
        stuck = (torch.zeros(len(rows_l), dtype=torch.bool) if last is None
                 else (tgt - last).abs().lt(1e-12).all(-1))
        last = tgt
        pol = s["action"][rows].double().cpu().tolist()
        applied = s["applied"][rows].double().cpu().tolist()
        for k, r in enumerate(rows_l):
            running = cur[r] < len(qs[r])
            if running:
                a = qs[r][cur[r]]
                cur[r] += 1
            else:
                a = pol[k]
            want = (max(-1.0, min(1.0, a[0])) * ms, max(-1.0, min(1.0, a[1])) * mv)
            if (running or not bool(stuck[k])) and any(
                    abs(w - g) > 1e-5 * max(1.0, abs(w)) for w, g in zip(want, applied[k])):
                bad += 1
        rs = s["rs"]
        new = queue(rs.lengths[rows].cpu(), rs.steers[rows].cpu(), rs.found[rows].cpu(),
                    ENV["step_ratio"], ENV["rs_queue"])
        for k, r in enumerate(rows_l):
            if new[k] and not cur[r] < len(qs[r]):
                qs[r], cur[r] = new[k], 0
    return bad
