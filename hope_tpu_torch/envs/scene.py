"""Scene container: a batch of padded parking scenarios as tensors
(counterpart of ``hope_tpu/envs/scene.py``)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# difficulty levels (reference env/map_level.py)
LEVEL_NORMAL = 0
LEVEL_COMPLEX = 1
LEVEL_EXTREM = 2
LEVEL_DLP = 3
LEVEL_NAMES = {LEVEL_NORMAL: "Normal", LEVEL_COMPLEX: "Complex",
               LEVEL_EXTREM: "Extrem", LEVEL_DLP: "dlp"}

_DTYPES = {"edges": torch.float32, "edge_mask": torch.bool,
           "edge_poly": torch.int32, "n_polys": torch.int32,
           "start": torch.float32, "dest": torch.float32,
           "dest_box": torch.float32, "bounds": torch.float32,
           "level": torch.int32, "case_id": torch.int32}


@dataclass
class Scene:
    """A batch of B parking scenarios.

    Attributes:
      edges: (B, E, 4) obstacle segments [x1, y1, x2, y2]; padded rows are zeros.
      edge_mask: (B, E) live-edge mask.
      edge_poly: (B, E) int32 polygon id per edge (for the BEV rasterizer).
      n_polys: (B,) int32 number of live polygons.
      start: (B, 3) start pose.
      dest: (B, 3) destination pose.
      dest_box: (B, 4, 2) destination box corners (CCW).
      bounds: (B, 4) [xmin, xmax, ymin, ymax].
      level: (B,) int32 difficulty id.
      case_id: (B,) int32 scenario id.
    """

    edges: torch.Tensor
    edge_mask: torch.Tensor
    edge_poly: torch.Tensor
    n_polys: torch.Tensor
    start: torch.Tensor
    dest: torch.Tensor
    dest_box: torch.Tensor
    bounds: torch.Tensor
    level: torch.Tensor
    case_id: torch.Tensor

    @staticmethod
    def from_numpy(arrays, device) -> "Scene":
        """Scene from a mapping of field name -> array (e.g. a JAX Scene's
        fields converted with ``np.asarray``)."""
        return Scene(**{f: torch.as_tensor(np.array(arrays[f]), dtype=_DTYPES[f],
                                           device=device)
                        for f in _DTYPES})

    def map(self, fn) -> "Scene":
        """Apply ``fn`` to every field."""
        return Scene(**{f.name: fn(getattr(self, f.name))
                        for f in dataclasses.fields(self)})


def pack_polygons(rings, max_edges: int, max_polys: int):
    """Pack a list of polygon rings (each (V, 2), closure implied) into padded
    edge arrays (numpy): (edges (E, 4), mask (E,), poly ids (E,), n_polys)."""
    edges = np.zeros((max_edges, 4), np.float32)
    mask = np.zeros(max_edges, bool)
    poly = np.zeros(max_edges, np.int32)
    k = 0
    n_polys = 0
    for ring in rings[:max_polys]:
        ring = np.asarray(ring, np.float64)
        # drop an explicitly repeated closing vertex
        if len(ring) > 1 and np.allclose(ring[0], ring[-1]):
            ring = ring[:-1]
        v = len(ring)
        if v < 2:
            continue
        for i in range(v):
            if k >= max_edges:
                break
            a, b = ring[i], ring[(i + 1) % v]
            edges[k] = [a[0], a[1], b[0], b[1]]
            mask[k] = True
            poly[k] = n_polys
            k += 1
        n_polys += 1
    return edges, mask, poly, n_polys


def make_scene(rings, start, dest, bounds, level, case_id, dest_box,
               max_edges: int = 256, max_polys: int = 64, *, device) -> Scene:
    """One scenario (fields without a batch dim) on ``device``, from numpy
    polygon rings."""
    edges, mask, poly, n_polys = pack_polygons(rings, max_edges, max_polys)
    return Scene.from_numpy({"edges": edges, "edge_mask": mask, "edge_poly": poly,
                             "n_polys": n_polys, "start": start, "dest": dest,
                             "dest_box": dest_box, "bounds": bounds, "level": level,
                             "case_id": case_id}, device)


def stack_scenes(scenes) -> Scene:
    """Stack single scenarios into one batched Scene, on their device."""
    return Scene(**{f.name: torch.stack([getattr(s, f.name) for s in scenes])
                    for f in dataclasses.fields(Scene)})
