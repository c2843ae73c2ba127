"""Edge sets that meet the special cases of the BEV raster's crossing test,
for tests/test_torch_ops.py (CPU) and tests/test_torch_card.py (card). Numpy
only."""
import numpy as np


def adversarial_edges(n: int, res: float, rng):
    """Ego-frame edges for a pose at (-cx_off, 0, 0), where the ego frame is
    the world frame exactly (v = x, u = y)."""
    f = np.float32
    res = f(res)
    half = f((n - 1) / 2.0)
    v = (half - np.arange(n, dtype=f)) * res
    u = (np.arange(n, dtype=f) - half) * res
    ext = half * res
    e = []
    for j in rng.choice(n, 6, replace=False):           # ui exactly u_j: vertical edges
        e.append([f(-2.0), u[j], f(3.0), u[j]])
    for i in rng.choice(n, 6, replace=False):           # an end point on a row's v
        k = int(rng.integers(n))
        e.append([v[i], f(rng.normal() * 4), v[k] + res / f(3), f(rng.normal() * 4)])
    for i in rng.choice(n, 3, replace=False):           # dv == 0, on a row and off it
        e.append([v[i], f(-1.0), v[i], f(2.0)])
        e.append([v[i] + res / f(2), f(-1.0), v[i] + res / f(2), f(2.0)])
    for i in rng.choice(n - 1, 4, replace=False):       # near-horizontal: su = ±inf, ui NaN
        vr = v[i]
        lo, hi = np.nextafter(vr, f(-np.inf)), np.nextafter(vr, f(np.inf))
        e.append([lo, f(-1e31), hi, f(1e31)])
        e.append([lo, f(1e31), hi, f(-1e31)])
    big = f(1.5e38)              # |su| = 1e38, v1*su overflows, v*su does not: ui = ±inf
    for a, b in ((5, 2), (-5, -2)):
        e.append([f(a), big, f(b), -big])
        e.append([f(a), -big, f(b), big])
    e.append([f(0.0), f(-0.0), f(-0.0), f(0.0)])        # ±0: a point, dv == 0
    e.append([f(-0.0), f(-0.0), ext, f(0.0)])
    e.append([f(-1.0), ext + f(1), f(1.0), ext + f(2)])  # entirely right
    e.append([f(-1.0), -ext - f(1), f(1.0), -ext - f(2)])  # entirely left
    e += (rng.normal(size=(24, 4)) * ext).astype(f).tolist()   # clutter
    return np.asarray(e, f)
