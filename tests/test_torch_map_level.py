"""The port's difficulty classifier (``hope_tpu_torch/envs/map_level.py``,
a numpy copy) against the JAX package's, on the scenes of
``tests/test_map_level.py``, and on the whole DLP bank: ``classify_cases``
reproduces ``data/dlp.npz``'s committed ``levels`` table, and a
``DLPDataset`` of an npz without that table classifies its cases itself.
Exact throughout: both are the same float64 numpy arithmetic.
"""
import numpy as np
import pytest
import torch

from hope_tpu.config import VehicleConfig as JVehicleConfig
from hope_tpu.envs import map_level as jml
from hope_tpu.envs.scene import pack_polygons as jpack
from hope_tpu_torch.config import VehicleConfig
from hope_tpu_torch.envs import LEVEL_COMPLEX, LEVEL_DLP, LEVEL_EXTREM, LEVEL_NORMAL, map_level
from hope_tpu_torch.envs.dlp import DLPDataset
from hope_tpu_torch.envs.scene import pack_polygons

from .test_map_level import L, _bay_scene, _parallel_scene, _rect

DLP = "data/dlp.npz"


def bay(gap, start, want, extra=None):
    rings, dest = _bay_scene(slot_gap=gap, extra=extra)
    return rings, start, dest, want


def parallel(slot_len, dx, want):
    rings, dest = _parallel_scene(slot_len=slot_len)
    return rings, [dest[0] + dx, 3.5, 0.0], dest, want


# (rings, start, dest, level) of each classification test of tests/test_map_level.py
SCENES = {
    "few_obstacles": ([_rect(5, 5, 1, 1)], [8.0, 0, 0], [0.0, 0, np.pi / 2], LEVEL_NORMAL),
    "easy_bay": bay(1.0, [5.0, 6.0, 0.0], LEVEL_NORMAL),
    "blocked_bay": bay(1.0, [5.0, 6.0, 0.0], LEVEL_COMPLEX, _rect(2.5, 7.0, 1.2, 1.2)),
    "face_block": bay(1.0, [5.0, 6.0, 0.0], LEVEL_EXTREM, _rect(0.0, 5.0, 1.2, 1.2)),
    "far_bay": bay(1.0, [16.5, 3.0, 0.0], LEVEL_COMPLEX),
    "narrow_bay": bay(0.3, [5.0, 6.0, 0.0], LEVEL_COMPLEX),
    "easy_parallel": parallel(L * 1.3, 6.0, LEVEL_NORMAL),
    "tight_parallel": parallel(L + 0.5, 6.0, LEVEL_EXTREM),
    "far_tight": parallel(L * 1.22, 32.0, LEVEL_EXTREM),
    "open_slot": ([_rect(8, 8, 1, 1), _rect(-8, 8, 1, 1)], [5.0, 5.0, 0.0], [0.0, 0.0, np.pi / 2],
                  LEVEL_NORMAL),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_get_map_level_matches_jax(name):
    """Each scene of the JAX package's classifier tests: the port's level
    is JAX's and the one those tests expect."""
    rings, start, dest, want = SCENES[name]
    packed = pack_polygons(rings, max_edges=256, max_polys=32)
    for a, b in zip(packed, jpack(rings, max_edges=256, max_polys=32)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = map_level.get_map_level(start, dest, *packed, VehicleConfig())
    assert got == jml.get_map_level(start, dest, *packed, JVehicleConfig()) == want


def test_primitives_match_jax():
    """Segment distances and the minimum rotated rectangle: equal to JAX's."""
    rng = np.random.default_rng(4)
    A, B = rng.uniform(-5, 5, (6, 4)), rng.uniform(-5, 5, (7, 4))
    np.testing.assert_array_equal(map_level._seg_seg_dist(A, B), jml._seg_seg_dist(A, B))
    for n in (1, 2, 5, 11):
        pts = rng.uniform(-4, 4, (n, 2))
        np.testing.assert_array_equal(map_level._min_rotated_rect(pts), jml._min_rotated_rect(pts))


def test_classify_cases_reproduces_dlp_levels():
    """All 248 cases x 128 start slots of data/dlp.npz: classify_cases gives
    the committed levels table."""
    d = np.load(DLP)
    got = map_level.classify_cases(d["starts"], d["dest"], d["edges"], d["edge_mask"],
                                   d["edge_poly"], d["n_polys"], d["n_starts"], VehicleConfig())
    np.testing.assert_array_equal(got, d["levels"])
    assert {LEVEL_NORMAL, LEVEL_COMPLEX, LEVEL_EXTREM} == set(np.unique(got))


def test_dlp_dataset_classifies_an_npz_without_levels(tmp_path):
    """An npz of 6 DLP cases without the levels table: DLPDataset's table is
    the committed one's rows (classify=False: every start of level dlp)."""
    d = np.load(DLP)
    path = str(tmp_path / "cases.npz")
    np.savez(path, **{k: d[k][:6] for k in d.files if k != "levels"})
    ds = DLPDataset(path, device="cpu")
    assert torch.equal(ds.level_table, torch.as_tensor(d["levels"][:6]))
    flat = DLPDataset(path, classify=False, device="cpu")
    assert bool((flat.level_table == LEVEL_DLP).all())
