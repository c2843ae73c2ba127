"""Evaluation records (counterpart of ``hope_tpu/evaluation/render.py``;
its plots and animations are not ported yet)."""
from __future__ import annotations

import numpy as np
import torch


def save_record(path: str, metrics: dict):
    """Persist per-episode evaluation arrays as a portable .npz."""
    np.savez_compressed(path, **{k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                                     else np.asarray(v)) for k, v in metrics.items()})
