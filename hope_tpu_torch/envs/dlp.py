"""DLP (Dragon Lake Parking) case bank and batched reset
(counterpart of ``hope_tpu/envs/dlp.py``: ``scene_from_case_arrays`` and
``DLPDataset``).

The bank is ``data/dlp.npz``, read with numpy; its ``levels`` table carries the
per-(case, start) difficulty, so no classification runs here.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import EnvConfig, VehicleConfig
from ..device import resolve_device
from ..geometry import pose_to_box
from .scene import Scene

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "data", "dlp.npz")


@dataclass
class DLPDraws:
    """The random draws of one batch of DLP resets.

    start_idx: (B,) int64 start-candidate index; jitter: (B, 3) standard
    normals (scaled by 0.05 m / 0.05 m / 0.02 rad); flip_dest / flip_start:
    (B,) bool 50/50 orientation flips.
    """

    start_idx: torch.Tensor
    jitter: torch.Tensor
    flip_dest: torch.Tensor
    flip_start: torch.Tensor


def _flip_pose(pose, corners):
    """Mirror (B, 3) poses through their own box centre and turn them around."""
    c = torch.mean(pose_to_box(pose, corners), dim=-2)
    return torch.stack([2 * c[:, 0] - pose[:, 0], 2 * c[:, 1] - pose[:, 1],
                        pose[:, 2] + math.pi], dim=-1)


def scene_from_case_arrays(draws: DLPDraws, edges, live, poly, starts, dest,
                           level_rows, case_ids, cfg: EnvConfig, corners,
                           p_raw: int = 320) -> Scene:
    """A batch of Scenes from B cases' raw arrays (reference
    ParkingMapDLP.reset): the drawn start candidate + jitter, +-20 m bounds,
    polygon-level bounds filter, dest and start orientation flips, live edges
    compacted to the front and cut to ``cfg.max_edges``.

    Args: edges (B, E_raw, 4), live (B, E_raw) bool, poly (B, E_raw) int,
    starts (B, S, 3), dest (B, 3), level_rows (B, S) int, case_ids (B,) int.
    """
    B = edges.shape[0]
    dev = edges.device
    rows = torch.arange(B, device=dev)
    start = starts[rows, draws.start_idx]
    jit3 = draws.jitter * torch.tensor([0.05, 0.05, 0.02], device=dev)
    start = start + jit3

    bounds = torch.stack([
        torch.floor(torch.minimum(start[:, 0], dest[:, 0]) - 20.0),
        torch.ceil(torch.maximum(start[:, 0], dest[:, 0]) + 20.0),
        torch.floor(torch.minimum(start[:, 1], dest[:, 1]) - 20.0),
        torch.ceil(torch.maximum(start[:, 1], dest[:, 1]) + 20.0),
    ], dim=-1)

    dest = torch.where(draws.flip_dest[:, None], _flip_pose(dest, corners), dest)
    start = torch.where(draws.flip_start[:, None], _flip_pose(start, corners), start)

    # polygon-level bounds filter (reference filter_obstacles): drop polygons
    # entirely outside the bounds window
    poly = poly.long()
    big = 1e9

    def seg(vals, reduce, init):
        out = torch.full((B, p_raw), init, dtype=vals.dtype, device=dev)
        return out.scatter_reduce(1, poly, vals, reduce, include_self=True)

    xmin = torch.minimum(edges[..., 0], edges[..., 2])
    xmax = torch.maximum(edges[..., 0], edges[..., 2])
    ymin = torch.minimum(edges[..., 1], edges[..., 3])
    ymax = torch.maximum(edges[..., 1], edges[..., 3])
    px_min = seg(torch.where(live, xmin, big), "amin", big)
    px_max = seg(torch.where(live, xmax, -big), "amax", -big)
    py_min = seg(torch.where(live, ymin, big), "amin", big)
    py_max = seg(torch.where(live, ymax, -big), "amax", -big)
    poly_keep = ~((px_max <= bounds[:, 0:1]) | (px_min >= bounds[:, 1:2])
                  | (py_max <= bounds[:, 2:3]) | (py_min >= bounds[:, 3:4]))
    live = live & torch.gather(poly_keep, 1, poly)

    # compact live edges to the front and truncate to the runtime budget
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices
    E = cfg.max_edges
    order = order[:, :E]
    edges_c = torch.gather(edges, 1, order[..., None].expand(-1, -1, 4))
    live_c = torch.gather(live, 1, order)
    poly_c = torch.gather(poly, 1, order)
    # re-id polygons densely so they fit the rasterizer's max_obstacles
    present = torch.zeros((B, p_raw), dtype=torch.int32, device=dev)
    present.scatter_add_(1, poly_c, torch.ones_like(poly_c, dtype=torch.int32))
    uniq_first = present > 0
    new_id = torch.cumsum(uniq_first.to(torch.int32), dim=1) - 1
    poly_c = torch.clamp(torch.gather(new_id, 1, poly_c), 0, cfg.max_obstacles - 1)

    return Scene(
        edges=edges_c.to(torch.float32),
        edge_mask=live_c,
        edge_poly=poly_c.to(torch.int32),
        n_polys=uniq_first.sum(dim=1).to(torch.int32),
        start=start.to(torch.float32),
        dest=dest.to(torch.float32),
        dest_box=pose_to_box(dest, corners).to(torch.float32),
        bounds=bounds.to(torch.float32),
        level=level_rows[rows, draws.start_idx].to(torch.int32),
        case_id=case_ids.to(torch.int32),
    )


class DLPDataset:
    """The full case bank (248 cases) as tensors on one device."""

    def __init__(self, path: str = _DEFAULT_PATH, env_cfg: EnvConfig | None = None,
                 vcfg: VehicleConfig = VehicleConfig(), device=None):
        dev = resolve_device(device)
        raw = np.load(path)
        self.env_cfg = env_cfg or EnvConfig(max_edges=512, max_obstacles=128)
        self.n_cases = len(raw["n_polys"])
        t = lambda k, dt: torch.as_tensor(raw[k], dtype=dt, device=dev)  # noqa: E731
        self.edges = t("edges", torch.float32)          # (C, E_raw, 4)
        self.edge_mask = t("edge_mask", torch.bool)     # (C, E_raw)
        self.edge_poly = t("edge_poly", torch.int64)    # (C, E_raw)
        self.dest = t("dest", torch.float32)            # (C, 3)
        self.starts = t("starts", torch.float32)        # (C, S, 3)
        self.n_starts = t("n_starts", torch.int64)      # (C,)
        self.level_table = t("levels", torch.int32)     # (C, S)
        self.corners = torch.as_tensor(vcfg.box_corners(), dtype=torch.float32,
                                       device=dev)
        self.device = dev

    def sample_draws(self, case_ids, generator: torch.Generator) -> DLPDraws:
        """Draw the per-reset randomness for ``case_ids`` from ``generator``
        (which must live on this dataset's device)."""
        ids = torch.as_tensor(case_ids, device=self.device) % self.n_cases
        B = ids.shape[0]
        n = self.n_starts[ids]
        u = torch.rand(B, generator=generator, device=self.device)
        si = torch.minimum((u * n).long(), n - 1)
        z = torch.randn((B, 3), generator=generator, device=self.device)
        flips = torch.rand((2, B), generator=generator, device=self.device) > 0.5
        return DLPDraws(si, z, flips[0], flips[1])

    def batch_reset(self, case_ids, generator: torch.Generator | None = None,
                    draws: DLPDraws | None = None) -> Scene:
        """Scenes for ``case_ids`` (taken modulo the bank size), with draws from
        ``generator`` or given as ``draws``."""
        ids = torch.as_tensor(case_ids, device=self.device).long() % self.n_cases
        if draws is None:
            draws = self.sample_draws(ids, generator)
        return scene_from_case_arrays(
            draws, self.edges[ids], self.edge_mask[ids], self.edge_poly[ids],
            self.starts[ids], self.dest[ids], self.level_table[ids], ids,
            self.env_cfg, self.corners)
