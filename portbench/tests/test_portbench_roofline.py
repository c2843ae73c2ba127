"""The frozen work and bound arithmetic equals ``chip_smoke.py``'s at the
shapes of PERF.md's kernel table (B = 256 DLP scenes, 512 edge slots, 6 RS
words of 1152 outline segments, the 1200 x 42 x 10 mask table)."""
import os
import sys

import pytest
import torch

from portbench import roofline
from portbench.loops.common import ROOT

sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def test_bound_equals_chip_smoke():
    for nbytes, ops in ((1e6, 1e9), (5e9, 1e6), (0.0, 0.0)):
        assert roofline.bound(nbytes, ops) == chip_smoke.bound(nbytes, ops)


def test_mask_work_equals_chip_smoke_count():
    B, R, table = 256, 120, (1200, 42, 10)
    RU, A, I = table
    want_bytes = 4 * (B * R + RU * A * I + B * A)
    want_ops = 1.0 * B * RU * A * I + 5.0 * B * RU
    assert roofline.mask_work(B, R, table) == (want_bytes, want_ops)


def test_sweep_work_equals_chip_smoke():
    g = torch.Generator().manual_seed(0)
    B, K, S, E = 256, 6, 1152, 512
    live = torch.rand((B, K, S), generator=g) < 0.8
    edges = torch.randn((B, E, 4), generator=g)
    mask = torch.rand((B, E), generator=g) < 0.4
    hit = torch.rand((B, K, S), generator=g) < 0.002
    assert roofline.sweep_work(live, edges, mask, hit) == chip_smoke.sweep_work(live, edges, mask,
                                                                                hit)


def test_raster_work_equals_chip_smoke():
    from hope_tpu_torch.config import ObsConfig, VehicleConfig
    from hope_tpu_torch.envs.dlp import DLPDataset
    from hope_tpu_torch.geometry import pose_to_box

    ds = DLPDataset(device="cpu")
    g = torch.Generator().manual_seed(1)
    s = ds.batch_reset(torch.arange(256) % ds.n_cases, g)
    vcfg, obs = VehicleConfig(), ObsConfig()
    vbox = pose_to_box(s.start, ds.corners)
    args = (s.start, vbox, s.dest_box, s.edges, s.edge_mask, s.edge_poly.to(torch.int32), obs,
            vcfg)
    nbytes, ops, _ = chip_smoke.raster_work(*args)
    assert roofline.raster_work(*args) == pytest.approx((nbytes, ops), rel=0, abs=0)


def test_share_is_none_without_calls():
    assert roofline.share(0.01, 0, 0.0) is None
    assert roofline.share(0.01, 100, 0.002) == pytest.approx(50.0)
    assert os.path.isfile(os.path.join(ROOT, "chip_smoke.py"))
