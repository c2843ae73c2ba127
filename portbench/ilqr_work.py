"""The floating-point work of one batched iLQR solve at the MPC
configuration's shapes, frozen here so that a change to the program cannot
move the yardstick of ``mfu.mpc``.

A solve of B rows, horizon N, E edge slots, I iterations and A step sizes
evaluates the clearance cost at every (pose, body disc, edge slot): its
rollout's N + 1 poses once, then per iteration the N + 1 poses of the
derivatives and A x (N + 1) poses of the line search. One evaluation is ~25
operations (the edge vector and the offset, two dot products, a division,
the clamp, the foot point, the squared distance, its root, the mask and the
minimum). Beside it, per row and step: the arc step ~30, its Jacobians ~80,
the derivatives of the goal and control terms ~40, the Riccati step ~250
(3 x 3 and 3 x 2 products, the 2 x 2 inverse), the feedback ~20 per step
size. Dead edge slots are computed as live ones, so E counts every slot.
"""
from __future__ import annotations

DISCS = 3
PAIR = 25.0
STEP, JACOBIAN, TERMS, RICCATI, FEEDBACK = 30.0, 80.0, 40.0, 250.0, 20.0


def solve_flops(B: int, N: int, E: int, iters: int, alphas: int) -> float:
    """Floating-point operations of one solve (see the module docstring)."""
    pairs = (N + 1) * DISCS * E
    first = pairs * PAIR + N * STEP
    per_iter = ((1 + alphas) * pairs * PAIR + N * (JACOBIAN + TERMS + RICCATI)
                + alphas * N * (FEEDBACK + STEP))
    return float(B) * (first + iters * per_iter)
