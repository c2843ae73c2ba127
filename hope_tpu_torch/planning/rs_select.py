"""Cost-ordered, collision-checked Reeds-Shepp path selection over a batch
(counterpart of ``hope_tpu/planning/rs_select.py``).

The ``max_tries`` shortest words of each env are swept and collision-checked
at once, and the winner is the first eligible collision-free one. The sweep
runs through ``ops.swept_collide`` (the CUDA kernel for CUDA tensors).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import box_to_edges, pose_to_box, segments_intersect
from ..ops.sweep_collide import swept_collide
from . import reeds_shepp as rs


class RSPath(NamedTuple):
    """Selected RS paths for a batch (lengths in metres)."""

    found: torch.Tensor     # (B,) bool
    lengths: torch.Tensor   # (B, 5) signed metres
    steers: torch.Tensor    # (B, 5) {-1, 0, 1}
    L: torch.Tensor         # (B,) metres


def _outbound(poses, mask, bounds):
    """(..., N, 3) poses vs (..., 4) bounds -> (...) any live pose out of bounds."""
    b = bounds[..., None, :]
    out = ((poses[..., 0] < b[..., 0]) | (poses[..., 0] > b[..., 1])
           | (poses[..., 1] < b[..., 2]) | (poses[..., 1] > b[..., 3]))
    return torch.any(out & mask, dim=-1)


def traj_collides(poses, pose_mask, corners, edges, edge_mask, bounds):
    """Swept-trajectory collision + outbound test, one path (the plain form
    with the divided segment test, ``segments_intersect``).

    Args: poses (N, 3), pose_mask (N,), corners (4, 2), edges (E, 4),
    edge_mask (E,), bounds (4,). Returns () bool.
    """
    outbound = _outbound(poses, pose_mask, bounds)
    car_edges = box_to_edges(pose_to_box(poses, corners)).reshape(-1, 4)
    live = torch.repeat_interleave(pose_mask, 4)
    hits = segments_intersect(car_edges, edges) & live[:, None] & edge_mask[None, :]
    return outbound | torch.any(hits)


def find_path_batch(starts, goals, maxc, corners, edges, edge_masks, bounds,
                    n_points: int = 288, step_m: float = 0.1,
                    max_tries: int = 6) -> RSPath:
    """Shortest collision-free RS path for each of B scenarios.

    Candidates are considered in ascending length; ones longer than 1.6 x the
    shortest are eligible only among the first 2 (the reference's give-up
    rule); a path longer than the sweep budget is never eligible.
    """
    K = max_tries
    cand = rs.candidates(starts[:, None, :], goals[:, None, :], maxc)
    cand = rs.RSCandidates(*(t.squeeze(1) for t in cand))
    L_m = cand.L / maxc                                          # (B, 46)
    # stable ascending sort: equal lengths keep the lower word index first,
    # as jax.lax.top_k does (torch.topk does not promise it)
    Ls, idxs = torch.sort(L_m, dim=1, stable=True)
    Ls, idxs = Ls[:, :K], idxs[:, :K]
    gi = idxs[:, :, None].expand(-1, -1, rs.N_SEG)
    lengths = torch.gather(cand.lengths, 1, gi)                  # (B, K, 5)
    steers = torch.gather(cand.steers, 1, gi)

    poses, mask, _ = rs.sample_path(lengths, steers, starts[:, None, :], maxc,
                                    n_points, step_m)            # (B, K, N, ·)
    outbound = _outbound(poses, mask, bounds[:, None, :])        # (B, K)
    B, _, N = poses.shape[:3]
    car_edges = box_to_edges(pose_to_box(poses, corners)).reshape(B, K, N * 4, 4)
    live4 = torch.repeat_interleave(mask, 4, dim=-1)
    collide = swept_collide(car_edges.contiguous(), live4.contiguous(),
                            edges.contiguous(), edge_masks.contiguous()) | outbound

    rank = torch.arange(K, device=starts.device)[None, :]
    sweepable = Ls <= n_points * step_m
    eligible = sweepable & torch.isfinite(Ls) & ((rank < 2) | (Ls <= 1.6 * Ls[:, :1]))
    ok = eligible & ~collide
    found = torch.any(ok, dim=1)
    pick = torch.argmax(ok.to(torch.uint8), dim=1)               # first ok = shortest
    rows = torch.arange(B, device=starts.device)
    f = found[:, None]
    return RSPath(
        found=found,
        lengths=torch.where(f, lengths[rows, pick] / maxc, 0.0),
        steers=torch.where(f, steers[rows, pick], 0.0),
        L=torch.where(found, Ls[rows, pick], torch.inf),
    )


def build_action_queue(path: RSPath, step_ratio: float, queue_len: int = 32):
    """Selected RS paths -> fixed-length normalized action queues.

    Each segment becomes steer in {-1, 0, 1} and a run of |len|/step_ratio
    chunks of magnitude <= 1, dropping residues < 1e-3.

    Returns:
      actions: (B, Q, 2) [steer, speed] in [-1, 1].
      n_actions: (B,) int32 live queue lengths, clamped to ``queue_len``.
    """
    n_seg = path.lengths.shape[-1]
    seg_steps = path.lengths / step_ratio
    mag = torch.abs(seg_steps)
    sign = torch.sign(seg_steps)
    n_full = torch.floor(mag).to(torch.int32)
    rem = mag - n_full
    has_rem = rem > 1e-3
    n_chunks = n_full + has_rem.to(torch.int32)                  # (B, S)

    cum = torch.cumsum(n_chunks, dim=-1, dtype=torch.int32)
    starts = cum - n_chunks
    total = cum[:, -1]

    B = cum.shape[0]
    q = torch.arange(queue_len, device=cum.device, dtype=torch.int32)
    seg_idx = torch.clamp(torch.searchsorted(cum, q.expand(B, -1).contiguous(), right=True),
                          0, n_seg - 1)                          # (B, Q)
    within = q - torch.gather(starts, 1, seg_idx)
    is_rem = within == torch.gather(n_full, 1, seg_idx)          # last chunk = remainder
    speed = (torch.where(is_rem, torch.gather(rem, 1, seg_idx), 1.0)
             * torch.gather(sign, 1, seg_idx))
    steer = torch.gather(path.steers, 1, seg_idx)
    live = (q < total[:, None]) & path.found[:, None]
    actions = torch.stack([steer, speed], dim=-1) * live[..., None]
    total = torch.clamp(total, max=queue_len)
    return actions, torch.where(path.found, total, 0).to(torch.int32)
