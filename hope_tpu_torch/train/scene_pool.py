"""Device-resident scenario pools (counterpart of
``hope_tpu/train/scene_pool.py``).

Banks of procedural scenes per level (``envs/scenario_gen.py``) and DLP
resets, padded to one Scene shape, so that a lockstep batch gathers fresh
scenarios of mixed levels with one indexing op per field. The DLP cases come
from the bank held on the device, or streamed from the native bank
(``stream_dlp``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import EnvConfig
from ..device import resolve_device
from ..envs.dlp import DLPDataset, StreamingDLP
from ..envs.scenario_gen import generate_bank
from ..envs.scene import Scene

LEVEL_ORDER = ["Normal", "Complex", "Extrem", "dlp"]


def pad_scene_batch(scene: Scene, max_edges: int, max_polys: int) -> Scene:
    """Pad (or truncate) a batched Scene's edge arrays to ``max_edges`` slots.

    Truncation is only allowed where the dropped tail is all padding
    (procedural scenes use 72 fixed slots, DLP scenes compact live edges to
    the front); it checks that on the host."""
    e = scene.edges.shape[-2]
    if e == max_edges:
        return scene
    if e > max_edges:
        if bool(torch.any(scene.edge_mask[..., max_edges:])):
            raise ValueError(f"cannot truncate scene batch from {e} to {max_edges} edges: "
                             "live edges in tail")
        cut = {"edges": scene.edges[..., :max_edges, :],
               "edge_mask": scene.edge_mask[..., :max_edges],
               "edge_poly": scene.edge_poly[..., :max_edges]}
    else:
        pad = max_edges - e
        cut = {"edges": torch.nn.functional.pad(scene.edges, (0, 0, 0, pad)),
               "edge_mask": torch.nn.functional.pad(scene.edge_mask, (0, pad)),
               "edge_poly": torch.nn.functional.pad(scene.edge_poly, (0, pad))}
    return Scene(**{**{f: getattr(scene, f) for f in scene.__dataclass_fields__}, **cut})


def concat_scenes(parts) -> Scene:
    return Scene(**{f: torch.cat([getattr(p, f) for p in parts])
                    for f in parts[0].__dataclass_fields__})


class ScenePool:
    """Unified pool: [Normal | Complex | Extrem | dlp] segments of
    ``per_level`` scenes each; ``flat_index(level_id, slot)`` -> pool index.

    ``stream_dlp``: keep the DLP bank off the device. Each refresh takes the
    batch of cases that the previous refresh prefetched from the native bank
    (:class:`StreamingDLP`) and prefetches its own ids for the next one, so
    the curriculum's case ids take effect one refresh late; at a cold start
    the same ids are prefetched first. ``dlp_case_ids`` are always the cases
    in the pool."""

    def __init__(self, env_cfg: EnvConfig, per_level: int = 256,
                 dlp: DLPDataset | None = None, seed: int = 0,
                 include_dlp: bool = True, stream_dlp: bool = False, device=None):
        self.device = resolve_device(device)
        self.env_cfg = env_cfg
        self.per_level = per_level
        self.include_dlp = include_dlp
        self.stream: StreamingDLP | None = None
        if include_dlp and stream_dlp and dlp is None:
            self.stream = StreamingDLP(env_cfg=env_cfg, device=self.device)
            self.dlp = None
        else:
            self.dlp = dlp if dlp is not None else (
                DLPDataset(env_cfg=env_cfg, device=self.device) if include_dlp else None)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.pool: Scene | None = None
        self.dlp_case_ids: np.ndarray | None = None
        self.refresh()

    def refresh(self, dlp_case_ids: np.ndarray | None = None):
        """Regenerate all procedural segments and resample the DLP scenes.

        dlp_case_ids: optional (per_level,) case ids from the curriculum;
        random when omitted."""
        cfg = self.env_cfg
        parts = []
        for level in ["Normal", "Complex", "Extrem"]:
            scenes, ok = generate_bank(self.generator, level=level, n=self.per_level)
            # replace the rare failed draws by a clone of a valid scene
            ok = ok.cpu().numpy()
            if not ok.all():
                good = int(np.argmax(ok))
                idx = torch.as_tensor(np.where(ok, np.arange(len(ok)), good),
                                      device=self.device)
                scenes = scenes.map(lambda x: x[idx])
            parts.append(pad_scene_batch(scenes, cfg.max_edges, cfg.max_obstacles))
        if self.include_dlp:
            src = self.stream if self.stream is not None else self.dlp
            if dlp_case_ids is None:
                seed = int(torch.randint(0, 2**31 - 1, (1,), generator=self.generator,
                                         device=self.device))
                dlp_case_ids = np.random.default_rng(seed).integers(
                    0, src.n_cases, self.per_level)
            ids = np.asarray(dlp_case_ids)
            if self.stream is not None:
                if self.stream.pending_ids is None:      # cold start
                    self.stream.prefetch(ids)
                dlp_scenes, self.dlp_case_ids = self.stream.take_scenes(self.generator)
                self.stream.prefetch(ids)                # gathered while the device works
            else:
                self.dlp_case_ids = ids
                dlp_scenes = self.dlp.batch_reset(torch.as_tensor(ids), self.generator)
            parts.append(pad_scene_batch(dlp_scenes, cfg.max_edges, cfg.max_obstacles))
        self.pool = concat_scenes(parts)

    @property
    def pending_ids(self) -> np.ndarray | None:
        """The DLP case ids of the prefetch in flight (streamed pools)."""
        return None if self.stream is None else self.stream.pending_ids

    def resume_stream(self, pending_ids) -> None:
        """Replace the prefetch in flight by one of ``pending_ids`` (those of
        the run being resumed)."""
        if self.stream is not None:
            self.stream.discard()
            if pending_ids is not None:
                self.stream.prefetch(np.asarray(pending_ids))

    def flat_index(self, level_ids: np.ndarray, slots: np.ndarray) -> np.ndarray:
        return level_ids * self.per_level + slots

    def gather(self, flat_idx) -> Scene:
        idx = torch.as_tensor(flat_idx, device=self.device).long()
        return self.pool.map(lambda x: x[idx])

    @property
    def n_levels(self) -> int:
        return 4 if self.include_dlp else 3
