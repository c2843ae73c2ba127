"""Gaps between what the program produced and what the reference works out
again, as plain numbers for the checks."""
from __future__ import annotations

import torch


def max_abs(a, b) -> float:
    """Largest absolute difference (inf where the finite patterns differ)."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return float("inf")
    return float((a[fa] - b[fb]).abs().max()) if fa.any() else 0.0


def max_rel(a, b, floor: float = 1.0) -> float:
    """Largest |a - b| / max(|b|, floor) (inf where the finite patterns
    differ)."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return float("inf")
    if not fa.any():
        return 0.0
    d = (a[fa] - b[fb]).abs() / b[fb].abs().clamp(min=floor)
    return float(d.max())


# a value equals the reference's where they differ by no more than float32
# rounding of a result of this size (a few units in the last place)
ROUNDING = 1e-5


def values_differ(a, b, rel: float = ROUNDING) -> int:
    """How many values of ``a`` differ from ``b``'s by more than rounding:
    |a - b| > rel * max(1, |b|), or one finite and the other not, or two
    non-finite values that are not the same."""
    a, b = a.double(), b.double()
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    far = (a - b).abs() > rel * b.abs().clamp(min=1.0)
    odd = (fa != fb) | (~fa & ~fb & ~((a == b) | (a.isnan() & b.isnan())))
    return int((far & both).sum() + odd.sum())


def rows_differ(*pairs) -> torch.Tensor:
    """(B,) bool: rows where any pair of (B, ...) tensors differs (exactly)."""
    out = None
    for a, b in pairs:
        d = (a != b).reshape(a.shape[0], -1).any(dim=1)
        out = d if out is None else out | d
    return out
