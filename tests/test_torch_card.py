"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. Imports no JAX, so it also runs where only the
port is installed (the repository's conftest imports JAX; skip it there):

    python -m pytest --noconftest -q tests/test_torch_card.py

Exact equality throughout: the kernels are built with -fmad=false and repeat
their plain versions' float32 arithmetic operation for operation.
"""
import os

import numpy as np
import pytest
import torch

from hope_tpu_torch.config import EnvConfig, ObsConfig, VehicleConfig
from hope_tpu_torch.envs.action_mask import build_table
from hope_tpu_torch.envs.dlp import DLPDataset
from hope_tpu_torch.geometry import pose_to_box
from hope_tpu_torch.ops import mask_steps, raster_bev, sweep_collide

OBS = ObsConfig()
VCFG = VehicleConfig()
CX_OFF = (VCFG.front_hang + VCFG.wheel_base - VCFG.rear_hang) / 2.0
SCENES_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "torch_procedural_scenes.npz")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_mask_step_lengths_on_card(dev):
    rng = np.random.default_rng(5)
    table = build_table(device=dev)
    for B in (1, 37, 256):
        raw = torch.as_tensor(rng.uniform(0, 12, (B, 120)).astype(np.float32), device=dev)
        ext = (torch.clamp(raw, 0.0, 10.0) + table.hull_base).contiguous()
        assert torch.equal(mask_steps.mask_step_lengths(ext, table.dist_star),
                           mask_steps.mask_step_lengths_plain(ext, table.dist_star))


def test_swept_collide_on_card(dev):
    rng = np.random.default_rng(6)
    for B, K, S, E in ((5, 6, 300, 70), (3, 2, 1152, 512), (2, 1, 7, 3)):
        car = torch.as_tensor(rng.normal(size=(B, K, S, 4)).astype(np.float32) * 8, device=dev)
        live = torch.as_tensor(rng.random((B, K, S)) > 0.3, device=dev)
        scene = torch.as_tensor(rng.normal(size=(B, E, 4)).astype(np.float32) * 8, device=dev)
        mask = torch.as_tensor(rng.random((B, E)) > 0.3, device=dev)
        got = sweep_collide.swept_collide(car, live, scene, mask)
        assert torch.equal(got, sweep_collide.swept_collide_plain(car, live, scene, mask))
        assert got.any()


@pytest.mark.parametrize("exact", [True, False])
def test_raster_bev_on_card(dev, exact):
    with np.load(SCENES_NPZ) as f:
        sc = {k: torch.as_tensor(f[k], device=dev) for k in f.files}
    dlp = DLPDataset(env_cfg=EnvConfig(max_edges=512, max_obstacles=128), device=dev)
    dsc = dlp.batch_reset(torch.arange(9) * 27, torch.Generator(device=dev).manual_seed(0))
    corners = torch.as_tensor(VCFG.box_corners(), dtype=torch.float32, device=dev)
    for pose, edges, mask, poly, dest_box in (
            (sc["start"], sc["edges"], sc["edge_mask"], sc["edge_poly"], sc["dest_box"]),
            (dsc.start, dsc.edges, dsc.edge_mask, dsc.edge_poly, dsc.dest_box)):
        params, cnt = raster_bev.ego_edge_params(pose, edges, mask, poly, CX_OFF,
                                                 OBS.img_size, OBS.img_res, exact)
        quads = torch.cat([raster_bev.quad_coeffs(pose, dest_box, CX_OFF),
                           raster_bev.quad_coeffs(pose, pose_to_box(pose, corners), CX_OFF)],
                          dim=1).contiguous()
        got = raster_bev.raster_bev(params, cnt, quads, OBS.img_size, OBS.img_res)
        want = raster_bev.raster_bev_plain(params, cnt, quads, OBS.img_size, OBS.img_res)
        assert torch.equal(got, want)
