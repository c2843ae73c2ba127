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
