"""Scenario difficulty classifier — Normal / Complex / Extrem (a numpy
copy of ``hope_tpu/envs/map_level.py``, which imports no JAX either; the
port keeps its own).

Array-native re-design of the reference classifier
(``env/map_level.py:27-112``): instead of shapely ``Point``/``LinearRing``
distance and ``MultiPoint.minimum_rotated_rectangle`` queries over Python
lists, scenes arrive as the packed padded edge arrays of ``envs.scene`` and
every query is a vectorized broadcast (point/segment distance, grouped
per-polygon minima, monotone-chain hull + rotating calipers for the minimum
rotated rectangle). Classification happens once per case at load time, on
the host (``DLPDataset`` for an npz without a ``levels`` table).

Behavioural contract (reference semantics reproduced):
  * <= 1 obstacle polygon -> Normal                            (:34-35)
  * Extrem if start 30 m+ away with a tight slot, or a parallel slot
    shorter than min(1.2 L, L + 0.9)                           (:120-136)
  * bay slots (left+right neighbours, open front): Complex when the drive
    distance exceeds 15 m, the slot is narrower than the Normal-level
    minimum, or the approach corridor (minimum rotated rectangle over the
    slot mouth + start) hits a third obstacle                  (:55-76)
  * parallel slots (front+back neighbours): same structure with the
    outward corridor and the Normal-level minimum length       (:78-106)
  * open slots -> Normal; anything else -> Complex             (:107-112)
"""
from __future__ import annotations

import numpy as np

from ..config import VehicleConfig
from .scene import LEVEL_COMPLEX, LEVEL_EXTREM, LEVEL_NORMAL

# classification thresholds (reference configs.py:43-74, map_level.py:12)
MAX_DRIVE_DISTANCE = 15.0
EXTREM_DISTANCE = 30.0
_CORRIDOR_NEAR = 0.2
_CORRIDOR_MARGIN = 0.5
_BAY_WALL_DIST_NORMAL = 7.0
_PARA_WALL_DIST_NORMAL = 4.5


# --------------------------------------------------------------- primitives


def _pose_box(pose, corners):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    R = np.array([[c, -s], [s, c]])
    return corners @ R.T + pose[:2]


def _pt_seg_dist(pts, segs):
    """(P, 2) points x (S, 4) segments -> (P, S) distances."""
    a = segs[None, :, :2]
    ab = segs[None, :, 2:] - a
    p = pts[:, None, :]
    t = np.clip(
        np.sum((p - a) * ab, -1) / np.maximum(np.sum(ab * ab, -1), 1e-12), 0.0, 1.0
    )
    return np.linalg.norm(p - (a + t[..., None] * ab), axis=-1)


def _segs_cross(A, B):
    """(N, 4) x (M, 4) -> (N, M) segment intersection (incl. touching)."""
    ax, ay, bx, by = A[:, 0, None], A[:, 1, None], A[:, 2, None], A[:, 3, None]
    cx, cy, dx, dy = B[None, :, 0], B[None, :, 1], B[None, :, 2], B[None, :, 3]

    def cross(ox, oy, px, py, qx, qy):
        return (px - ox) * (qy - oy) - (py - oy) * (qx - ox)

    d1 = cross(ax, ay, bx, by, cx, cy)
    d2 = cross(ax, ay, bx, by, dx, dy)
    d3 = cross(cx, cy, dx, dy, ax, ay)
    d4 = cross(cx, cy, dx, dy, bx, by)
    proper = (d1 * d2 < 0) & (d3 * d4 < 0)

    def on(ox, oy, px, py, qx, qy, d):
        return (
            (np.abs(d) < 1e-12)
            & (np.minimum(ox, px) - 1e-12 <= qx) & (qx <= np.maximum(ox, px) + 1e-12)
            & (np.minimum(oy, py) - 1e-12 <= qy) & (qy <= np.maximum(oy, py) + 1e-12)
        )

    touch = (
        on(ax, ay, bx, by, cx, cy, d1)
        | on(ax, ay, bx, by, dx, dy, d2)
        | on(cx, cy, dx, dy, ax, ay, d3)
        | on(cx, cy, dx, dy, bx, by, d4)
    )
    return proper | touch


def _seg_seg_dist(A, B):
    """(N, 4) x (M, 4) -> (N, M) distances (0 where they intersect)."""
    d = np.minimum(_pt_seg_dist(A[:, :2], B), _pt_seg_dist(A[:, 2:], B))
    d = np.minimum(d, _pt_seg_dist(B[:, :2], A).T)
    d = np.minimum(d, _pt_seg_dist(B[:, 2:], A).T)
    return np.where(_segs_cross(A, B), 0.0, d)


def _per_poly_min(values, poly, mask, n_polys):
    """Min of per-edge ``values`` grouped by polygon id; inf for empty ids."""
    out = np.full(max(int(n_polys), 1), np.inf)
    live = np.asarray(mask, bool)
    np.minimum.at(out, np.asarray(poly)[live], np.asarray(values)[live])
    return out


def _convex_hull(pts):
    """Andrew monotone chain; returns hull vertices CCW."""
    pts = np.unique(np.round(np.asarray(pts, np.float64), 9), axis=0)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 2:
        return pts

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(seq):
        h = []
        for p in seq:
            while len(h) >= 2 and cross2(h[-2], h[-1], p) <= 0:
                h.pop()
            h.append(p)
        return h

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _min_rotated_rect(pts):
    """Minimum-area oriented bounding rectangle of a point set, as (4, 2)
    corners (shapely ``MultiPoint.minimum_rotated_rectangle`` equivalent)."""
    hull = _convex_hull(pts)
    if len(hull) == 1:
        return np.tile(hull[0], (4, 1))
    best_area, best = np.inf, None
    n = len(hull)
    for i in range(n if n > 2 else 1):
        e = hull[(i + 1) % n] - hull[i]
        L = np.hypot(*e)
        if L < 1e-12:
            continue
        u = e / L
        v = np.array([-u[1], u[0]])
        x = hull @ u
        y = hull @ v
        area = (x.max() - x.min()) * (y.max() - y.min())
        if area < best_area:
            best_area = area
            best = np.stack([
                u * x.min() + v * y.min(),
                u * x.max() + v * y.min(),
                u * x.max() + v * y.max(),
                u * x.min() + v * y.max(),
            ])
    return best


def _pts_in_convex_quad(pts, quad):
    """(P, 2) x (4, 2 CCW-or-CW) -> (P,) strict containment."""
    area2 = np.sum(quad[:, 0] * np.roll(quad[:, 1], -1)
                   - np.roll(quad[:, 0], -1) * quad[:, 1])
    sign = 1.0 if area2 >= 0 else -1.0
    inside = np.ones(len(pts), bool)
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        cr = (b[0] - a[0]) * (pts[:, 1] - a[1]) - (b[1] - a[1]) * (pts[:, 0] - a[0])
        inside &= sign * cr > 1e-12
    return inside


def _quad_to_edges(quad):
    return np.concatenate([quad, np.roll(quad, -1, axis=0)], axis=1)


def _rect_intersects_poly(quad, edges):
    """Filled convex quad vs polygon ring edges (shapely
    ``Polygon.intersects(LinearRing)``: edge crossing or ring-vertex-in-quad)."""
    if len(edges) == 0:
        return False
    if _segs_cross(_quad_to_edges(quad), edges).any():
        return True
    return bool(_pts_in_convex_quad(edges[:, :2], quad).any())


# ------------------------------------------------------------- classifier


class _SceneGeom:
    """Start-independent per-scene geometry, computed once per case and shared
    across start candidates (the DLP bank has up to 128 per case)."""

    def __init__(self, dest, edges, edge_mask, edge_poly, n_polys, vcfg):
        self.vcfg = vcfg
        self.dest = np.asarray(dest, np.float64)
        live = np.asarray(edge_mask, bool)
        # padded rows never participate: drop them up front
        self.edges = np.asarray(edges, np.float64)[live]
        self.poly = np.asarray(edge_poly, np.int64)[live]
        self.mask = np.ones(len(self.edges), bool)
        self.n_polys = int(n_polys)
        self.corners = np.asarray(vcfg.box_corners(), np.float64)
        # reference VehicleBox corner order: rb, rf, lf, lb (configs.py:20-24)
        self.dest_box = _pose_box(self.dest, self.corners)
        rb, rf, lf, lb = self.dest_box
        self.mids = {
            "left": (lf + lb) / 2,
            "right": (rf + rb) / 2,
            "front": (lf + rf) / 2,
            "back": (lb + rb) / 2,
        }
        box_edges = _quad_to_edges(self.dest_box)
        self._poly_box_dist = _per_poly_min(
            np.min(_seg_seg_dist(self.edges, box_edges), axis=-1),
            self.poly, self.mask, self.n_polys,
        )
        self._surrounding = None

    def surrounding(self):
        if self._surrounding is None:
            self._surrounding = self._compute_surrounding()
        return self._surrounding

    def _compute_surrounding(self):
        """Nearest distinct polygon id (or -1) off each dest-box face midpoint
        within LENGTH/2, claimed in the reference's query order left, right,
        front, back (map_level.py:14-25)."""
        found = {}
        taken = []
        for name in ("left", "right", "front", "back"):
            pt = self.mids[name][None, :]
            d = _pt_seg_dist(pt, self.edges)[0]
            poly_d = _per_poly_min(d, self.poly, self.mask, self.n_polys)
            for t in taken:
                poly_d[t] = np.inf
            i = int(np.argmin(poly_d)) if len(poly_d) else -1
            if len(poly_d) == 0 or poly_d[i] >= self.vcfg.length / 2:
                found[name] = -1
            else:
                found[name] = i
                taken.append(i)
        return found["left"], found["right"], found["front"], found["back"]

    def box_dist(self, poly_id):
        return float(self._poly_box_dist[poly_id])

    def poly_edges(self, exclude):
        keep = self.mask & ~np.isin(self.poly, [e for e in exclude if e >= 0])
        return self.edges[keep]

    def enough_space(self, width=None, length=None):
        """reference _has_enough_space (:158-184): clearance on both sides of
        the slot plus the vehicle dimension must reach the required size."""
        left, right, front, back = self.surrounding()
        ok = True
        if width is not None and left >= 0 and right >= 0:
            ok &= self.box_dist(left) + self.box_dist(right) + self.vcfg.width >= width
        if length is not None and front >= 0 and back >= 0:
            ok &= self.box_dist(front) + self.box_dist(back) + self.vcfg.length >= length
        return ok


def get_map_level(start, dest, edges, edge_mask, edge_poly, n_polys,
                  vcfg: VehicleConfig = VehicleConfig()) -> int:
    """Classify one packed scene; returns LEVEL_NORMAL / _COMPLEX / _EXTREM."""
    g = _SceneGeom(dest, edges, edge_mask, edge_poly, n_polys, vcfg)
    return _classify(g, start)


def _classify(g: _SceneGeom, start) -> int:
    vcfg = g.vcfg
    g.start = np.asarray(start, np.float64)
    g.start_box = _pose_box(g.start, g.corners)
    L, W = vcfg.length, vcfg.width
    min_len_normal = L * 1.25
    min_width_normal = W + 0.85
    extrem_len = min(L * 1.2, L + 0.9)

    if g.n_polys <= 1:
        return LEVEL_NORMAL

    left, right, front, back = g.surrounding()
    drive_dist = float(np.hypot(*(g.start[:2] - g.dest[:2])))

    # --- Extrem (:120-136)
    if drive_dist > EXTREM_DISTANCE:
        if front >= 0 and back >= 0 and not g.enough_space(length=min_len_normal):
            return LEVEL_EXTREM
        if left >= 0 and right >= 0 and not g.enough_space(width=min_width_normal):
            return LEVEL_EXTREM
    if front >= 0 and back >= 0 and not g.enough_space(length=extrem_len):
        return LEVEL_EXTREM

    distance_exceed = drive_dist > MAX_DRIVE_DISTANCE
    rb, rf, lf, lb = g.dest_box
    h = g.dest[2]
    fwd = np.array([np.cos(h), np.sin(h)])

    if left >= 0 and right >= 0 and front < 0:  # bay parking (:55-76)
        if distance_exceed or not g.enough_space(width=min_width_normal):
            return LEVEL_COMPLEX
        key_pts = [
            lf + fwd * _CORRIDOR_NEAR,
            rf + fwd * _CORRIDOR_NEAR,
            lf + fwd * (_BAY_WALL_DIST_NORMAL - _CORRIDOR_MARGIN),
            rf + fwd * (_BAY_WALL_DIST_NORMAL - _CORRIDOR_MARGIN),
            g.start[:2],
        ]
        corridor = _min_rotated_rect(np.asarray(key_pts))
        others = g.poly_edges(exclude=(left, right))
        return LEVEL_COMPLEX if _rect_intersects_poly(corridor, others) else LEVEL_NORMAL

    if front >= 0 and back >= 0:  # parallel parking (:78-106)
        if distance_exceed or not g.enough_space(length=min_len_normal):
            return LEVEL_COMPLEX
        out_dir = h + np.pi / 2
        out = np.array([np.cos(out_dir), np.sin(out_dir)])
        if float(out @ (g.start[:2] - g.dest[:2])) < 0:
            out = -out
            kp_front, kp_back = rf, rb
        else:
            kp_front, kp_back = lf, lb
        key_pts = [
            kp_front + out * _CORRIDOR_NEAR,
            kp_back + out * _CORRIDOR_NEAR,
            kp_front + out * (_PARA_WALL_DIST_NORMAL - _CORRIDOR_MARGIN),
            kp_back + out * (_PARA_WALL_DIST_NORMAL - _CORRIDOR_MARGIN),
            *g.start_box,
            g.start[:2],
        ]
        corridor = _min_rotated_rect(np.asarray(key_pts))
        others = g.poly_edges(exclude=(front, back))
        return LEVEL_COMPLEX if _rect_intersects_poly(corridor, others) else LEVEL_NORMAL

    if (left < 0 or right < 0) and (front < 0 or back < 0):  # open slot (:107-108)
        return LEVEL_NORMAL
    return LEVEL_COMPLEX  # unconsidered surround pattern (:109-112)


def classify_cases(starts, dests, edges, edge_mask, edge_poly, n_polys,
                   n_starts=None,
                   vcfg: VehicleConfig = VehicleConfig()) -> np.ndarray:
    """Classify a whole case bank: (C, S, 3) start candidates x (C, 3) dests ->
    (C, S) int levels.  Used by the DLP loader at init so that a reset's level
    is a table lookup.  Padded start slots (>= n_starts[c]) copy the
    first candidate's level."""
    starts = np.asarray(starts)
    dests = np.asarray(dests)
    C, S = starts.shape[:2]
    out = np.zeros((C, S), np.int32)
    for c in range(C):
        g = _SceneGeom(dests[c], edges[c], edge_mask[c], edge_poly[c],
                       n_polys[c], vcfg)
        live = S if n_starts is None else max(1, int(np.asarray(n_starts)[c]))
        for s in range(min(live, S)):
            out[c, s] = _classify(g, starts[c, s])
        out[c, live:] = out[c, 0]
    return out
