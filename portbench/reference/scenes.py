"""DLP scenes from the raw case bank (``data/dlp.npz``, which the program
reads too) and the draws the harness makes: the drawn start candidate plus
its jitter, bounds 20 m around start and destination, the orientation flips
of destination and start, polygons wholly outside the bounds dropped, live
edges moved to the front in their order and cut to the edge budget.

The draws are the harness's, made from the run's seed and handed to both
sides, so both build the same scenes from the same inputs.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from . import compare
from .kernels import corners, pose_to_box
from .spec import DLP

BANK = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "data", "dlp.npz")


@dataclass
class Draws:
    start_idx: torch.Tensor      # (B,) int64
    jitter: torch.Tensor         # (B, 3) standard normals
    flip_dest: torch.Tensor      # (B,) bool
    flip_start: torch.Tensor     # (B,) bool


class Bank:
    """The raw DLP cases, on one device."""

    def __init__(self, device, path: str = BANK):
        raw = np.load(path)
        t = lambda k, dt: torch.as_tensor(raw[k], dtype=dt, device=device)  # noqa: E731
        self.edges, self.live = t("edges", torch.float32), t("edge_mask", torch.bool)
        self.poly = t("edge_poly", torch.int64)
        self.dest, self.starts = t("dest", torch.float32), t("starts", torch.float32)
        self.n_starts, self.levels = t("n_starts", torch.int64), t("levels", torch.int32)
        self.n_cases, self.device = self.edges.shape[0], device


def draw(bank: Bank, case_ids, generator: torch.Generator) -> Draws:
    """The randomness of one batch of resets, from ``generator``."""
    n = bank.n_starts[case_ids]
    B = n.shape[0]
    u = torch.rand(B, generator=generator, device=bank.device)
    z = torch.randn((B, 3), generator=generator, device=bank.device)
    flips = torch.rand((2, B), generator=generator, device=bank.device) > 0.5
    return Draws(torch.minimum((u * n).long(), n - 1), z, flips[0], flips[1])


def _flip(pose, cn):
    """Turned around in place: mirrored through the box centre."""
    c = torch.mean(pose_to_box(pose, cn), dim=-2)
    return torch.stack([2 * c[:, 0] - pose[:, 0], 2 * c[:, 1] - pose[:, 1],
                        pose[:, 2] + np.pi], dim=-1)


def build(bank: Bank, case_ids, d: Draws) -> dict:
    """The scenes of ``case_ids`` (B,) under the draws ``d``: a dict of
    (B, ...) tensors named as the program's ``Scene`` fields, where only the
    live edge slots are set, and ``raw_poly`` holds the bank's polygon of
    each slot (the program renumbers them, which the raster's parity does not
    see)."""
    dev = bank.device
    ids = case_ids.long()
    B = ids.shape[0]
    cn = corners(dev)
    start = bank.starts[ids, d.start_idx] + d.jitter * torch.tensor(DLP["jitter"], device=dev)
    dest = bank.dest[ids]
    m = DLP["margin"]
    bounds = torch.stack([torch.floor(torch.minimum(start[:, 0], dest[:, 0]) - m),
                          torch.ceil(torch.maximum(start[:, 0], dest[:, 0]) + m),
                          torch.floor(torch.minimum(start[:, 1], dest[:, 1]) - m),
                          torch.ceil(torch.maximum(start[:, 1], dest[:, 1]) + m)], dim=-1)
    dest = torch.where(d.flip_dest[:, None], _flip(dest, cn), dest)
    start = torch.where(d.flip_start[:, None], _flip(start, cn), start)

    edges, live, poly = bank.edges[ids], bank.live[ids], bank.poly[ids]
    # a polygon's extent over its live edges; one wholly outside the bounds goes
    n_poly = int(bank.poly.max()) + 1
    big = torch.tensor(1e9, device=dev)

    def extent(v, reduce, fill):
        out = torch.full((B, n_poly), fill, device=dev)
        return out.scatter_reduce(1, poly, torch.where(live, v, fill), reduce)

    xs, ys = edges[..., 0::2], edges[..., 1::2]
    outside = ((extent(xs.amax(-1), "amax", -big) <= bounds[:, 0:1])
               | (extent(xs.amin(-1), "amin", big) >= bounds[:, 1:2])
               | (extent(ys.amax(-1), "amax", -big) <= bounds[:, 2:3])
               | (extent(ys.amin(-1), "amin", big) >= bounds[:, 3:4]))
    keep = live & ~torch.gather(outside, 1, poly)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :DLP["max_edges"]]
    mask = torch.gather(keep, 1, order)
    return {"edges": torch.where(mask[..., None], torch.gather(edges, 1, order[..., None].expand(
                -1, -1, 4)), 0.0),
            "edge_mask": mask, "raw_poly": torch.gather(poly, 1, order),
            "start": start, "dest": dest, "dest_box": pose_to_box(dest, cn), "bounds": bounds,
            "level": bank.levels[ids, d.start_idx], "case_id": ids.to(torch.int32)}


def scene_differs(scene, ref: dict) -> int:
    """How many fields of the program's scenes differ from the reference's:
    the live-edge mask and the live edges exactly, poses, boxes and bounds
    beyond rounding, levels and case ids exactly."""
    m = ref["edge_mask"]
    bad = int((scene.edge_mask != m).sum())
    both = scene.edge_mask & m
    bad += int((scene.edges[both] != ref["edges"][both]).sum())
    for k in ("start", "dest", "dest_box", "bounds"):
        bad += compare.values_differ(getattr(scene, k), ref[k])
    bad += int((scene.level != ref["level"]).sum() + (scene.case_id != ref["case_id"]).sum())
    return bad
