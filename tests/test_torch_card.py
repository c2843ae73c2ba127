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

from .torch_raster_cases import adversarial_edges

OBS = ObsConfig()
VCFG = VehicleConfig()
CX_OFF = (VCFG.front_hang + VCFG.wheel_base - VCFG.rear_hang) / 2.0
CORNERS = torch.as_tensor(VCFG.box_corners(), dtype=torch.float32)
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


@pytest.mark.parametrize("B", [1, 7, 9, 1025])
def test_mask_step_lengths_ragged_batch_on_card(dev, B):
    """B around the kernel's group of 8 envs, and past 1024."""
    rng = np.random.default_rng(B)
    table = build_table(device=dev)
    raw = torch.as_tensor(rng.uniform(0, 12, (B, 120)).astype(np.float32), device=dev)
    ext = (torch.clamp(raw, 0.0, 10.0) + table.hull_base).contiguous()
    got = mask_steps.mask_step_lengths(ext, table.dist_star)
    assert torch.equal(got, mask_steps.mask_step_lengths_plain(ext, table.dist_star))
    assert got.max() == 10


# (R, U, A, I): rays not a multiple of the 8 slabs, fewer rays than slabs, A*I
# at one block's 448 columns, just past it (two column blocks), far past it,
# and one action as wide as a block
@pytest.mark.parametrize("R,U,A,I", [(13, 3, 42, 10), (1, 3, 5, 4), (13, 3, 64, 7),
                                     (9, 5, 45, 10), (6, 2, 150, 9), (4, 2, 2, 448)])
def test_mask_step_lengths_random_tables_on_card(dev, R, U, A, I):
    rng = np.random.default_rng(R * 1000 + A)
    tab = torch.as_tensor(rng.uniform(0, 10, (R * U, A, I)).astype(np.float32), device=dev)
    # about one entry per action that can block, so blocked and free actions both occur
    keep = rng.random((R * U, A, I)) < 1.5 / (R * U * I)
    tab = torch.where(torch.as_tensor(keep, device=dev), tab, 0.0)
    for B in (3, 19):
        ext = torch.as_tensor(rng.uniform(0, 10, (B, R)).astype(np.float32), device=dev)
        got = mask_steps.mask_step_lengths(ext, tab, I, U)
        want = mask_steps.mask_step_lengths_plain(ext, tab, I, U)
        assert torch.equal(got, want)
        assert got.min() < I and got.max() == I


def test_mask_step_lengths_special_values_on_card(dev):
    """The kernel keeps `table > lidar` as the sign of `lidar - table`: equal
    values, zeros of both signs, subnormals, infinities and NaNs must come out
    as the plain version's compare does."""
    rng = np.random.default_rng(11)
    R, U, A, I = 2, 2, 96, 3
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-38, 3.0, 3.0000002, np.inf, -np.inf,
                        np.nan, -np.nan, 1e38], np.float32)
    # the non-finite ones are rare: the upsample spreads them to the neighbouring ray
    p = np.where(np.isfinite(special), 1.0, 0.05)
    tab = torch.as_tensor(rng.choice(special, (R * U, A, I), p=p / p.sum()), device=dev)
    ext = torch.as_tensor(rng.choice(special, (40, R), p=p / p.sum()), device=dev)
    got = mask_steps.mask_step_lengths(ext, tab, I, U)
    want = mask_steps.mask_step_lengths_plain(ext, tab, I, U)
    assert torch.equal(got, want)
    assert got.min() < I and got.max() == I
    # zeros of opposite signs compare equal: nothing is blocked
    for lidar, table in ((-0.0, 0.0), (0.0, -0.0), (-0.0, -0.0)):
        got = mask_steps.mask_step_lengths(torch.full((3, R), lidar, device=dev),
                                           torch.full((R * U, A, I), table, device=dev), I, U)
        assert (got == I).all()


def test_mask_step_lengths_refuses_wide_action_on_card(dev):
    tab = torch.zeros((4, 1, mask_steps.MAX_N_ITER + 1), device=dev)
    with pytest.raises(ValueError, match="n_iter"):
        mask_steps.mask_step_lengths(torch.ones((2, 2), device=dev), tab,
                                     mask_steps.MAX_N_ITER + 1, 2)


def _sweep_equal(car, live, scene, mask):
    got = sweep_collide.swept_collide(car, live, scene, mask)
    want = sweep_collide.swept_collide_plain(car, live, scene, mask)
    assert got.dtype == torch.bool and torch.equal(got, want)
    return got


def _random_sweep(rng, dev, B, K, S, E, scale=8.0):
    car = torch.as_tensor(rng.normal(size=(B, K, S, 4)).astype(np.float32) * scale, device=dev)
    live = torch.as_tensor(rng.random((B, K, S)) > 0.3, device=dev)
    scene = torch.as_tensor(rng.normal(size=(B, E, 4)).astype(np.float32) * scale, device=dev)
    mask = torch.as_tensor(rng.random((B, E)) > 0.3, device=dev)
    return car, live, scene, mask


def test_swept_collide_on_card(dev):
    rng = np.random.default_rng(6)
    for B, K, S, E in ((5, 6, 300, 70), (3, 2, 1152, 512), (2, 1, 7, 3)):
        got = _sweep_equal(*_random_sweep(rng, dev, B, K, S, E))
        assert got.any()


# S around the 256-segment slab, E around the 32-edge tile and the 256-slot
# load round
@pytest.mark.parametrize("B,K,S,E", [(4, 3, 257, 33), (2, 2, 513, 600), (3, 6, 255, 31),
                                     (1, 1, 1, 1), (2, 3, 64, 257)])
def test_swept_collide_ragged_shapes_on_card(dev, B, K, S, E):
    rng = np.random.default_rng(S * 1000 + E)
    # short segments far apart: clear and colliding words both occur
    car, live, scene, mask = _random_sweep(rng, dev, B, K, S, E, scale=1.0)
    car[..., 2:] = car[..., :2] + 0.02 * car[..., 2:]
    car[..., :] += 40.0 * torch.as_tensor(rng.normal(size=(B, K, 1, 4)).astype(np.float32)
                                          [..., [0, 1, 0, 1]], device=dev)
    _sweep_equal(car, live, scene, mask)
    _sweep_equal(*_random_sweep(rng, dev, B, K, S, E))


def test_swept_collide_dead_inputs_on_card(dev):
    rng = np.random.default_rng(8)
    car, live, scene, mask = _random_sweep(rng, dev, 4, 6, 300, 70)
    # no live edge anywhere
    assert not _sweep_equal(car, live, scene, torch.zeros_like(mask)).any()
    # no edge slot at all
    assert not _sweep_equal(car, live, scene[:, :0].contiguous(), mask[:, :0].contiguous()).any()
    # all edges dead for one env
    m = mask.clone()
    m[2] = False
    got = _sweep_equal(car, live, scene, m)
    assert not got[2].any() and got[[0, 1, 3]].any()
    # a word with no live segment
    lv = live.clone()
    lv[1, 4] = False
    got = _sweep_equal(car, lv, scene, mask)
    assert not got[1, 4] and got[1, :4].all()


def _grid_case(dev, S, E, n_live):
    """One env: edge slot i is the vertical segment x = 100 + i, |y| <= 1, the
    first ``n_live`` slots live; K = 6 words of S horizontal unit segments at
    y = 50, far from every edge."""
    x = 100.0 + torch.arange(E, dtype=torch.float32, device=dev)
    scene = torch.stack([x, -torch.ones_like(x), x, torch.ones_like(x)], dim=-1)[None]
    mask = (torch.arange(E, device=dev) < n_live)[None]
    car = torch.zeros((1, 6, S, 4), device=dev)
    car[..., 0] = torch.arange(S, device=dev)
    car[..., 2] = car[..., 0] + 1.0
    car[..., 1] = car[..., 3] = 50.0
    live = torch.ones((1, 6, S), dtype=torch.bool, device=dev)
    return car, live, scene.contiguous(), mask.contiguous()


@pytest.mark.parametrize("S,E,n_live", [(1152, 512, 509), (300, 70, 70), (257, 33, 33)])
def test_swept_collide_last_segment_last_edge_on_card(dev, S, E, n_live):
    """The only hit is between the last car segment and the last live edge."""
    car, live, scene, mask = _grid_case(dev, S, E, n_live)
    assert not _sweep_equal(car, live, scene, mask).any()
    xe = 100.0 + n_live - 1
    car[0, 3, S - 1] = torch.tensor([xe - 0.4, 0.0, xe + 0.4, 0.0], device=dev)
    got = _sweep_equal(car, live, scene, mask)
    assert got.tolist() == [[False, False, False, True, False, False]]
    # that edge dead, or that segment dead: clear again
    m = mask.clone()
    m[0, n_live - 1] = False
    assert not _sweep_equal(car, live, scene, m).any()
    lv = live.clone()
    lv[0, 3, S - 1] = False
    assert not _sweep_equal(car, lv, scene, mask).any()


def test_swept_collide_one_clear_five_colliding_on_card(dev):
    car, live, scene, mask = _grid_case(dev, 1152, 512, 300)
    for k, s in zip((0, 1, 2, 4, 5), (0, 255, 256, 700, 1151)):   # first hit at segment s
        car[0, k, s] = torch.tensor([150.6, 0.5, 151.4, -0.5], device=dev)
    got = _sweep_equal(car, live, scene, mask)
    assert got.tolist() == [[True, True, True, False, True, True]]


def test_swept_collide_refuses_too_many_edges_on_card(dev):
    E = sweep_collide.MAX_EDGES + 1
    with pytest.raises(ValueError, match="edge slots"):
        sweep_collide.swept_collide(torch.zeros((1, 1, 4, 4), device=dev),
                                    torch.ones((1, 1, 4), dtype=torch.bool, device=dev),
                                    torch.zeros((1, E, 4), device=dev),
                                    torch.ones((1, E), dtype=torch.bool, device=dev))
    E = sweep_collide.MAX_EDGES            # the most it takes: every slot in shared memory
    rng = np.random.default_rng(9)
    _sweep_equal(*_random_sweep(rng, dev, 1, 2, 40, E))


def _raster_equal(pose, dest_box, edges, mask, poly, exact, n=OBS.img_size):
    """render_bev_batch on the card against render_bev_batch_plain on the same
    card inputs: exact, and exactly one launch."""
    obs = ObsConfig(img_size=n)
    vbox = pose_to_box(pose, CORNERS.to(pose.device)).contiguous()
    before = raster_bev.KERNEL.launches
    got = raster_bev.render_bev_batch(pose, vbox, dest_box, edges, mask, poly, obs, VCFG, exact)
    assert raster_bev.KERNEL.launches == before + (1 if pose.shape[0] else 0)
    want = raster_bev.render_bev_batch_plain(pose, vbox, dest_box, edges, mask, poly, obs, VCFG,
                                             exact)
    assert got.shape == want.shape and torch.equal(got, want)
    return got


def _scenes(dev, B=9):
    """(procedural npz scenes, B DLP scenes) as (pose, dest_box, edges, mask,
    poly) on ``dev``."""
    with np.load(SCENES_NPZ) as f:
        sc = {k: torch.as_tensor(f[k], device=dev) for k in f.files}
    dlp = DLPDataset(env_cfg=EnvConfig(max_edges=512, max_obstacles=128), device=dev)
    dsc = dlp.batch_reset(torch.arange(B) * 27 % dlp.n_cases,
                          torch.Generator(device=dev).manual_seed(0))
    return ((sc["start"], sc["dest_box"], sc["edges"], sc["edge_mask"], sc["edge_poly"]),
            (dsc.start, dsc.dest_box, dsc.edges, dsc.edge_mask, dsc.edge_poly))


@pytest.mark.parametrize("exact", [True, False])
def test_raster_bev_on_card(dev, exact):
    """Procedural and DLP scenes at every image size the kernel takes."""
    for scene in _scenes(dev):
        for n in raster_bev.IMG_SIZES:
            _raster_equal(*scene, exact, n)


@pytest.mark.parametrize("B", [1, 7, 257])
def test_raster_bev_batches_on_card(dev, B):
    _, dlp = _scenes(dev, B)
    for exact in (True, False):
        _raster_equal(*dlp, exact)
    # B = 0: no launch, an empty image
    empty = [t[:0].contiguous() for t in dlp]
    assert _raster_equal(*empty, True).shape == (0, OBS.img_size, OBS.img_size, 3)


@pytest.mark.parametrize("E", [1, 77, 300, raster_bev.MAX_EDGES])
def test_raster_bev_edge_counts_on_card(dev, E):
    """E off the multiples of the block's 256 slots, up to the module's
    maximum: DLP edges repeated and cut to E, plus random ones."""
    _, (pose, dest_box, edges, mask, poly) = _scenes(dev, 3)
    reps = -(-E // edges.shape[1])
    cut = lambda t: t.repeat(1, reps, *([1] * (t.ndim - 2)))[:, :E].contiguous()  # noqa: E731
    for exact in (True, False):
        _raster_equal(pose, dest_box, cut(edges), cut(mask), cut(poly), exact)
    rng = np.random.default_rng(E)
    edges = torch.as_tensor(rng.normal(size=(3, E, 4)).astype(np.float32) * 8, device=dev)
    mask = torch.as_tensor(rng.random((3, E)) > 0.2, device=dev)
    poly = torch.as_tensor(rng.integers(0, 9, (3, E)).astype(np.int32), device=dev)
    for exact in (True, False):
        _raster_equal(pose, dest_box, edges, mask, poly, exact)


def test_raster_bev_refuses_on_card(dev):
    pose, dest_box, edges, mask, poly = _scenes(dev, 2)[1]
    E = raster_bev.MAX_EDGES + 1
    with pytest.raises(ValueError, match="edge slots"):
        _raster_equal(pose, dest_box, torch.zeros((2, E, 4), device=dev),
                      torch.ones((2, E), dtype=torch.bool, device=dev),
                      torch.zeros((2, E), dtype=torch.int32, device=dev), True)
    with pytest.raises(ValueError, match="img_size"):
        _raster_equal(pose, dest_box, edges, mask, poly, True, 48)
    with pytest.raises(ValueError, match="edge_poly"):
        _raster_equal(pose, dest_box, edges, mask, poly.long(), True)
    with pytest.raises(ValueError, match="not contiguous"):
        _raster_equal(pose, dest_box, edges[:, ::2], mask[:, ::2], poly[:, ::2], True)


def test_raster_bev_dead_and_dropped_edges_on_card(dev):
    """No live edge; every edge dropped (far away, or horizontal); no obstacle
    pixel then, only the quads."""
    pose, dest_box, edges, mask, poly = _scenes(dev)[1]
    obst = torch.as_tensor(raster_bev.PALETTE[1], device=dev)
    for exact in (True, False):
        got = _raster_equal(pose, dest_box, edges, torch.zeros_like(mask), poly, exact)
        assert not (got == obst).all(-1).any()
        far = edges + 1e4
        got = _raster_equal(pose, dest_box, far, mask, poly, exact)
        assert not (got == obst).all(-1).any()
        flat = edges.clone()
        flat[..., 2] = flat[..., 0]        # dv == 0 in the frame of a pose at heading 0
        flat[..., 3] = flat[..., 1] + 1.0
        z = torch.zeros_like(pose)
        got = _raster_equal(z, dest_box, flat, mask, poly, exact)
        assert not (got == obst).all(-1).any()


def test_raster_bev_shuffled_ids_on_card(dev):
    """Slots in random order, ids shuffled, merged and interleaved, a repeated
    id far apart: the kernel's sort path."""
    rng = np.random.default_rng(13)
    for pose, dest_box, edges, mask, poly in _scenes(dev):
        perm = torch.as_tensor(rng.permutation(edges.shape[1]), device=dev)
        ids = torch.as_tensor(rng.permutation(int(poly.max()) + 1).astype(np.int32), device=dev)
        poly = (ids[poly.long()] % 40)[:, perm].contiguous()
        for exact in (True, False):
            _raster_equal(pose, dest_box, edges[:, perm].contiguous(),
                          mask[:, perm].contiguous(), poly, exact)


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_raster_bev_adversarial_on_card(dev, n):
    """ui on a column, end points on a row, dv == 0, ui = NaN and ±inf, ±0,
    ids out of order (tests/torch_raster_cases.py)."""
    rng = np.random.default_rng(n)
    edges = adversarial_edges(n, OBS.img_res, rng)
    E = len(edges)
    pose = torch.as_tensor([[-CX_OFF, 0.0, 0.0], [-CX_OFF, -0.0, -0.0], [0.3, -0.2, 0.7]],
                           device=dev)
    B = pose.shape[0]
    box = pose_to_box(torch.tensor([[1.0, 1.0, 0.3]] * B, device=dev),
                      CORNERS.to(dev)).contiguous()
    mask = torch.as_tensor(rng.random((B, E)) > 0.1, device=dev)
    poly = np.tile(rng.integers(0, 5, E), (B, 1)).astype(np.int32)
    poly[:, -3:] = (1 << 24) - 1
    for exact in (True, False):
        _raster_equal(pose, box, torch.as_tensor(np.tile(edges, (B, 1, 1)), device=dev), mask,
                      torch.as_tensor(poly, device=dev), exact, n)
