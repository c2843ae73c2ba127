"""The CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA device. Imports no JAX, so it also runs where only the
port is installed (the repository's conftest imports JAX; skip it there):

    python -m pytest --noconftest -q tests/test_torch_card.py

Exact equality throughout, but for the iLQR kernel: the kernels are built
with -fmad=false and repeat their plain versions' float32 arithmetic
operation for operation. The iLQR kernel sums over the horizon and forms the
Riccati pass's small products in another order than PyTorch's reductions and
cuBLAS, so it is held to ``solve_batch`` within stated tolerances.
"""
import os

import numpy as np
import pytest
import torch

from hope_tpu_torch.config import EnvConfig, ObsConfig, VehicleConfig
from hope_tpu_torch.envs.action_mask import build_table
from hope_tpu_torch.envs.dlp import DLPDataset
from hope_tpu_torch.geometry import pose_to_box
from hope_tpu_torch.ops import ilqr_solve, mask_steps, raster_bev, sweep_collide

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


def test_kernels_on_procedural_bank_on_card(dev, monkeypatch):
    """Every kernel call of a few control steps on procedural scenes (72 edge
    slots of 512, all three levels) equals its plain version."""
    from hope_tpu_torch.envs import ParkingEnv, action_mask, env as env_mod
    from hope_tpu_torch.envs.scenario_gen import generate_bank
    from hope_tpu_torch.planning import rs_select
    from hope_tpu_torch.train.scene_pool import concat_scenes, pad_scene_batch

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    scenes = pad_scene_batch(concat_scenes([generate_bank(gen, level=lv, n=24)[0]
                                            for lv in ("Normal", "Complex", "Extrem")]), 512, 128)
    calls = {}
    for site, attr, plain in ((action_mask, "mask_step_lengths",
                               mask_steps.mask_step_lengths_plain),
                              (env_mod, "render_bev_batch", raster_bev.render_bev_batch_plain),
                              (rs_select, "swept_collide", sweep_collide.swept_collide_plain)):
        def held(*args, _k=getattr(site, attr), _p=plain, _name=attr):
            got = _k(*args)
            assert torch.equal(got, _p(*args)), _name
            calls[_name] = calls.get(_name, 0) + 1
            return got
        monkeypatch.setattr(site, attr, held)
    env = ParkingEnv(EnvConfig(max_edges=512, max_obstacles=128), device=dev)
    st, _ = env.batch_reset(scenes)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for _ in range(3):
        a = torch.rand((72, 2), generator=g, device=dev) * 2 - 1
        st, *_ = env.batch_step(st, env.rescale_action(a))
    assert calls == {"mask_step_lengths": 4, "render_bev_batch": 4, "swept_collide": 3}


def test_sac_update_card_vs_cpu(dev):
    """One SAC update at a small width (image tower on at 16x16, batch 32)
    on the card and on the CPU from the same fresh state, batch and noise,
    TF32 off. Fresh Adams move a parameter by less than lr, so the two
    differ by under 2 lr (+1e-6 of float32 rounding) where a gradient at
    rounding level flips; gradients by reduction order only: 1e-3 of the
    group's largest; the critic loss and entropy (same forward pass) 1e-4
    relative, the actor loss (after the critics' step) 1e-3."""
    import dataclasses

    from hope_tpu_torch.agents import SACAgent
    from hope_tpu_torch.config import (AttentionConfig, SACConfig, actor_net_config,
                                       critic_net_config)
    from hope_tpu_torch.models import MultiObsEmbedding

    obs = ObsConfig(img_size=16)
    narrow = dict(embed_dim=32, hidden_dim=32, img_fc_sizes=(32,),
                  attention=AttentionConfig(depth=1, heads=2, dim_head=8, mlp_dim=32,
                                            hidden_dim=32))
    acfg = dataclasses.replace(actor_net_config(obs), **narrow)
    ccfg = dataclasses.replace(critic_net_config(obs, action_input=True), **narrow)
    cfg = SACConfig(lr_actor=1e-3, lr_critic=1e-3, lr_alpha=1e-3)
    shape = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
    rng = np.random.default_rng(9)
    B = 32
    batch = {"action": rng.uniform(-1, 1, (B, 2)), "reward": rng.normal(size=B),
             "done": rng.uniform(size=B) < 0.2}
    for p in ("obs", "next_obs"):
        batch.update({f"{p}/lidar": rng.normal(size=(B, 120)),
                      f"{p}/action_mask": rng.uniform(size=(B, 42)),
                      f"{p}/img": rng.integers(0, 256, (B, 3, 16, 16)) / 255.0,
                      f"{p}/target": rng.normal(size=(B, 5))})
    batch = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32))
             for k, v in batch.items()}
    noise = [torch.as_tensor(rng.normal(size=(B, 2)).astype(np.float32)) for _ in range(2)]
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for d in ("cpu", dev):
            agent = SACAgent(MultiObsEmbedding(acfg).to(d), cfg, ccfg)
            st = agent.init(shape, torch.Generator().manual_seed(0))
            m = agent.update(st, {k: v.to(d) for k, v in batch.items()},
                             noise=[z.to(d) for z in noise])
            runs.append((st, {k: float(v) for k, v in m.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (cs, cm), (gs, gm) = runs
    for k in cm:
        tol = 1e-3 if k == "actor_loss" else 1e-4
        assert abs(gm[k] - cm[k]) <= max(tol * abs(cm[k]), 1e-5), (k, gm[k], cm[k])
    for grp in ("actor", "critic1", "critic2", "target1", "target2"):
        for (name, pc), pg in zip(getattr(cs, grp).named_parameters(),
                                  getattr(gs, grp).parameters()):
            assert (pg.detach().cpu() - pc.detach()).abs().max() <= 2e-3 + 1e-6, (grp, name)
        if grp in ("actor", "critic1", "critic2"):
            flat = lambda st: torch.cat([  # noqa: E731
                (p.grad if p.grad is not None else torch.zeros_like(p)).flatten().cpu()
                for p in getattr(st, grp).parameters()])
            gc, gg = flat(cs), flat(gs)
            assert (gg - gc).abs().max() <= 1e-3 * gc.abs().max(), grp
    for name in ("log_std", "log_alpha"):
        assert (getattr(gs, name).detach().cpu() - getattr(cs, name).detach()).abs().max() \
            <= 2e-3 + 1e-6, name


def _narrow_ppo(obs, **kw):
    """A PPO agent with narrow nets (image tower at the obs's size)."""
    import dataclasses

    from hope_tpu_torch.agents import PPOAgent
    from hope_tpu_torch.config import (AttentionConfig, PPOConfig, actor_net_config,
                                       critic_net_config)

    narrow = dict(embed_dim=32, hidden_dim=32, img_fc_sizes=(32,),
                  attention=AttentionConfig(depth=1, heads=2, dim_head=8, mlp_dim=32,
                                            hidden_dim=32))
    return lambda table: PPOAgent(dataclasses.replace(actor_net_config(obs), **narrow),
                                  dataclasses.replace(critic_net_config(obs), **narrow),
                                  PPOConfig(**kw), table)


@pytest.mark.parametrize("dist_type", ["gaussian", "beta", "categorical"])
def test_ppo_choose_action_on_card(dev, dist_type):
    """PPOAgent.choose_action on the card and on the CPU from the same state,
    observations and Gumbel noise: the same table actions (the draw is an
    argmax over the noise, which differs between the two only where two
    entries tie to float32 rounding), log-probs to 1e-5; with the noise drawn
    from a CUDA generator every action is a table action."""
    from hope_tpu_torch.envs.action_mask import build_table

    obs = ObsConfig(img_size=16)
    make = _narrow_ppo(obs, dist_type=dist_type)
    rng = np.random.default_rng(21)
    B = 64
    o = {"lidar": rng.normal(size=(B, 120)), "action_mask": rng.uniform(size=(B, 42)),
         "img": rng.integers(0, 256, (B, 3, 16, 16)) / 255.0, "target": rng.normal(size=(B, 5))}
    o = {k: torch.as_tensor(v.astype(np.float32)) for k, v in o.items()}
    noise = -torch.log(-torch.log(torch.rand((B, 42), generator=torch.Generator().manual_seed(3))))
    shape = {k: tuple(v.shape[1:]) for k, v in o.items()}
    runs = []
    for d in ("cpu", dev):
        agent = make(build_table(device=d))
        st = agent.init(shape, torch.Generator().manual_seed(0), d)
        st.norm = type(st.norm)(mean={k: v.to(d) for k, v in st.norm.mean.items()},
                                S={k: torch.ones_like(v).to(d) for k, v in st.norm.S.items()},
                                n=torch.tensor(1, device=d))
        runs.append(agent.choose_action(st, {k: v.to(d) for k, v in o.items()},
                                        noise=noise.to(d)))
        if d != "cpu":
            g = torch.Generator(device=d)
            g.manual_seed(4)
            a, _ = agent.choose_action(st, {k: v.to(d) for k, v in o.items()}, g)
            table = agent.mask_table.actions_norm
            assert ((a[:, None] - table).abs().sum(-1) == 0).any(-1).all()
    (ac, lc), (ag, lg) = runs
    assert torch.equal(ag.cpu(), ac)
    assert (lg.cpu() - lc).abs().max() <= 1e-5 * max(1.0, float(lc.abs().max()))


def test_ppo_update_card_vs_cpu(dev):
    """One PPO update at a small width (image tower at 16x16, T = 8, B = 16,
    minibatch 16, 2 epochs, gradient clip on, lr 1e-3) on the card and on the
    CPU from the same fresh state, buffer and permutations, TF32 off. An Adam
    step moves a parameter by at most about lr, so after 16 steps the two
    differ by under 32 lr (+1e-6 of float32 rounding) where gradients at
    rounding level take other signs in each step; elsewhere gradients differ
    by reduction order (~1e-6 relative) and so do the steps: 1e-4, with at
    most 1 entry in 10^4 looser; metrics 1e-3 relative (1e-5 absolute near
    0); the same Adam counts and kl_stopped."""
    from hope_tpu_torch.agents.ppo import adam_count

    obs = ObsConfig(img_size=16)
    make = _narrow_ppo(obs, mini_batch=16, mini_epoch=2, lr_actor=1e-3, lr_critic=1e-3,
                       gradient_clip=True)
    rng = np.random.default_rng(22)
    Tn, B = 8, 16
    buf = {"action": rng.uniform(-0.9, 0.9, (Tn, B, 2)), "reward": rng.normal(size=(Tn, B)),
           "done": rng.uniform(size=(Tn, B)) < 0.1, "log_prob": rng.normal(size=(Tn, B)) - 1.0}
    for p in ("obs", "next_obs"):
        buf.update({f"{p}/lidar": rng.normal(size=(Tn, B, 120)),
                    f"{p}/action_mask": rng.uniform(size=(Tn, B, 42)),
                    f"{p}/img": rng.integers(0, 256, (Tn, B, 3, 16, 16)) / 255.0,
                    f"{p}/target": rng.normal(size=(Tn, B, 5))})
    buf = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32))
           for k, v in buf.items()}
    g = torch.Generator().manual_seed(5)
    perms = torch.stack([torch.randperm(Tn * B, generator=g) for _ in range(2)])
    shape = {"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        runs = []
        for d in ("cpu", dev):
            agent = make(None)
            st = agent.init(shape, torch.Generator().manual_seed(0), d)
            m = agent.update(st, {k: v.to(d) for k, v in buf.items()}, perms=perms.to(d))
            runs.append((st, {k: float(v) for k, v in m.items()}))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    (cs, cm), (gs, gm) = runs
    for k in cm:
        assert abs(gm[k] - cm[k]) <= max(1e-3 * abs(cm[k]), 1e-5), (k, gm[k], cm[k])
    steps = 2 * Tn * B // 16
    for grp in ("actor", "critic", "critic_target", "log_std"):
        flat = lambda st: torch.cat([  # noqa: E731
            p.detach().flatten().cpu() for p in
            ([st.log_std] if grp == "log_std" else getattr(st, grp).parameters())])
        d = (flat(gs) - flat(cs)).abs()
        assert d.max() <= 2 * steps * 1e-3 + 1e-6, grp
        assert (d > 1e-4).sum() <= 1e-4 * d.numel(), grp
    assert adam_count(gs.opt_actor) == adam_count(cs.opt_actor) == steps
    assert adam_count(gs.opt_critic) == adam_count(cs.opt_critic)


def _mpc_problem(dev, B: int, seed: int):
    """The MPC cell's first iLQR problem on B DLP rows (cases arange(B) %
    248): the CLI's env and iLQR settings, the start poses, the slots as
    goals and the RS warm starts (zeros where none is found)."""
    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.planning import mpc

    env_cfg = mpc.mpc_env_config()
    env = ParkingEnv(env_cfg, device=dev)
    icfg = mpc.mpc_ilqr_config(env_cfg, 40, 12)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    scenes = mpc.battery_scenes(env_cfg, "dlp", B, g, dev)
    with torch.no_grad():
        us, rs = mpc.rs_warm_start(env, scenes.start, scenes, icfg.horizon)
    us0 = torch.where(rs.found[:, None, None], us, 0.0)
    return icfg, env_cfg.vehicle, [t.contiguous() for t in (
        scenes.start, scenes.dest, scenes.edges, scenes.edge_mask, us0)]


def test_ilqr_graphed_solver_on_card(dev):
    """The MPC runner's iLQR solve on the card is one launch of the kernel
    (counted as ``ilqr/kernel_solves``, never as a plain solve); at B = 1, 8
    and 8 again two calls with the same inputs give the same bits, and a
    call reads its own inputs: the second B = 8 call, on new inputs, gives
    another answer and leaves the first call's outputs as they were."""
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.planning.ilqr import ILQRConfig, ILQRSolver
    from hope_tpu_torch.utils import profiling

    cfg = ILQRConfig(horizon=16, n_iters=3)
    solver = ILQRSolver(cfg, VCFG)
    rng = np.random.default_rng(11)
    kept = {}
    for B in (1, 8, 8):
        E = 24
        mid = rng.uniform(-4, 6, (B, E, 2))
        edges = np.concatenate([mid - 0.5, mid + 0.5], -1)
        args = [torch.as_tensor(a.astype(np.float32), device=dev) for a in (
            rng.uniform(-1, 1, (B, 3)), rng.uniform(3, 5, (B, 3)), edges)]
        args.append(torch.ones((B, E), dtype=torch.bool, device=dev))
        args.append(torch.as_tensor(rng.uniform(-1, 1, (B, 16, 2)).astype(np.float32),
                                    device=dev))
        launches = ilqr_solve.KERNEL.launches
        profiling.reset_counters()
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
            got = solver(*args)
            again = solver(*[a.clone() for a in args])
        counts = profiling.counters()
        profiling.reset_counters()
        assert ilqr_solve.KERNEL.launches == launches + 2
        assert counts.get("ilqr/kernel_solves") == 2 and "ilqr/plain_solves" not in counts
        for g, a in zip(got, again):
            assert torch.equal(g, a)
        assert torch.isfinite(got.cost).all()
        if B in kept:
            first, copy = kept[B]
            assert not torch.equal(got.us, first.us)
            for f, c in zip(first, copy):
                assert torch.equal(f, c)
        kept[B] = (got, [t.clone() for t in got])


def test_ilqr_kernel_pieces_match_solve_batch_on_card(dev):
    """From the same warm start, on 64 DLP rows at the MPC cell's settings,
    the kernel's first and second iterations held to one iteration of
    solve_batch by chip_smoke.py's ``kernel_vs_plain`` (the one copy of
    the comparison). Both: the quadraticization the kernel formed, at its
    own iterate, within mpc_parity's derivative bounds (lx, Vx, lxx, Vxx
    within 2e-5 of each point's largest entry + 1e-6; lu within 1e-6 of its
    largest + 1e-7; fx, fu within 1e-4 + 1e-7 / dth^2 at a step turning by
    dth: the same formulas, summed in another order and without cuBLAS),
    and solve_batch's line-search step on more than 90% of the rows. The
    first step, on every row: the same step but at a float32 tie, and where
    the steps agree the cost within 1e-4 relative and the poses and
    controls within 1e-2. The second step starts from the nearest edges
    and the reg the kernel carried out of its first, from iterates where
    one ulp of x0 moves solve_batch's own step by metres on some rows:
    it is held by the same bounds on the rows two one-ulp witnesses show
    well conditioned, at least chip_smoke.ILQR_HELD_FLOOR of them."""
    import chip_smoke

    icfg, vcfg, args = _mpc_problem(dev, 64, 1)
    first = chip_smoke.kernel_vs_plain(args, icfg, vcfg, 1, agree_floor=0.9)
    second = chip_smoke.kernel_vs_plain(args, icfg, vcfg, 2, agree_floor=0.9, every_row=False,
                                        held_floor=chip_smoke.ILQR_HELD_FLOOR)
    assert not first["bad"], first
    assert not second["bad"], second


def test_ilqr_kernel_solve_within_the_cells_limits_on_card(dev):
    """A whole solve at the MPC cell's shapes (256 DLP rows, horizon 40, 512
    edge slots, 12 iterations) held to the float64 reference
    (portbench/reference/ilqr.py) by the cell's own limits
    (portbench/limits/hope_mpc.battery_dlp.json): the reported cost against
    the float64 cost of the kernel's controls (``cost_gap``, worst row) and
    that cost against the float64 solve's from the same warm start
    (``cost_excess``, mean of the rows)."""
    import json

    from hope_tpu_torch.planning.ilqr import ILQRSolver
    from portbench.loops.mpc_battery import replan_gaps
    from portbench.reference import ilqr as ref_ilqr

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs", "hope_mpc.json")) as f:
        sp = ref_ilqr.spec_of(json.load(f))
    with open(os.path.join(root, "portbench", "limits", "hope_mpc.battery_dlp.json")) as f:
        limits = json.load(f)
    icfg, vcfg, args = _mpc_problem(dev, 256, 2)
    with torch.no_grad():
        res = ILQRSolver(icfg, vcfg)(*args)
    keep = args[3].any(0)
    gap, excess = replan_gaps(args[0], args[1], args[2][:, keep], args[3][:, keep], args[4],
                              res, sp)
    assert gap <= limits["cost_gap"] and excess <= limits["cost_excess"], (gap, excess)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def test_graphed_env_step_equals_eager_on_card(dev):
    """20 steps of a 64-row DLP battery, half the rows started 4 m from their
    slot: the graphed batch_step equals the eager one bit for bit (state,
    observation, reward, done, info with the RS path); step j's outputs are
    unchanged after step j + 1 ran (each call's outputs are its own); every
    kernel launches once a step from Python; a replay counts under a
    profiler, and each stage has one graph."""
    from torch.profiler import ProfilerActivity, profile

    from hope_tpu_torch.envs import ParkingEnv
    from hope_tpu_torch.utils import profiling
    from hope_tpu_torch.utils.graphs import ungraphed
    from hope_tpu_torch.utils.tree import tree_leaves

    cfg = EnvConfig(max_edges=512, max_obstacles=128)
    env = ParkingEnv(cfg, device=dev)
    eager = ungraphed(env)
    B = 64
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    scenes = DLPDataset(env_cfg=cfg, device=dev).batch_reset(torch.arange(B) * 3, g)
    near = scenes.dest.clone()
    near[:, 0] += 4.0 * torch.cos(near[:, 2])
    near[:, 1] += 4.0 * torch.sin(near[:, 2])
    scenes.start = torch.where((torch.arange(B, device=dev) % 2 == 0)[:, None], near,
                               scenes.start)
    st, _ = env.batch_reset(scenes)
    kernels = (mask_steps.KERNEL, raster_bev.KERNEL, sweep_collide.KERNEL)
    prev = snap = None
    found = 0
    for j in range(20):
        a = env.rescale_action(torch.rand((B, 2), generator=g, device=dev) * 2 - 1)
        before = [k.launches for k in kernels]
        out = env.batch_step(st, a)
        assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 1]
        want = eager.batch_step(st, a)
        assert out[0].scene is st.scene
        for x, w in zip(tree_leaves(out), tree_leaves(want)):
            assert x.dtype == w.dtype and torch.equal(_bits(x), _bits(w)), j
        if prev is not None:
            for x, s in zip(tree_leaves(prev), snap):
                assert torch.equal(_bits(x), _bits(s)), j
        prev, snap = out, [x.clone() for x in tree_leaves(out)]
        found += int(out[4]["rs"].found.sum())
        st = out[0]
    assert found > 0
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        env.batch_step(st, a)
    counts = profiling.counters()
    profiling.reset_counters()
    assert counts["env/graph_replays"] == 2 and "env/graph_eager" not in counts
    assert [len(h._graphs) for h in (env._transition_graphs, env._rs_graphs)] == [1, 1]


def test_streaming_dlp_on_card(dev):
    """The native bank's batches moved to the card: StreamingDLP (gather and
    prefetch) equals the resident DLPDataset on the card for the same ids and
    draws, field for field, and a streamed ScenePool refreshes on the card."""
    from hope_tpu_torch.envs.dlp import StreamingDLP
    from hope_tpu_torch.train.scene_pool import ScenePool

    cfg = EnvConfig(obs=ObsConfig(use_img=False), max_edges=512, max_obstacles=128)
    resident = DLPDataset(env_cfg=cfg, device=dev)
    stream = StreamingDLP(env_cfg=cfg, device=dev)
    ids = np.arange(0, 248, 7)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    draws = resident.sample_draws(torch.as_tensor(ids), g)
    want = resident.batch_reset(torch.as_tensor(ids), draws=draws)
    stream.prefetch(ids)
    got, used = stream.take_scenes(draws=draws)
    np.testing.assert_array_equal(used, ids)
    for got in (got, stream.batch_reset(ids, draws=draws)):
        for f in want.__dataclass_fields__:
            assert getattr(got, f).device.type == dev.type
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    stream.close()
    pool = ScenePool(cfg, per_level=8, stream_dlp=True, device=dev)
    pool.refresh()
    assert pool.pool.edges.device.type == dev.type and pool.pending_ids is not None
    pool.stream.close()


def test_frozen_encoder_update_on_card(dev):
    """A SAC update with freeze_img_encoder on the card (narrow nets, image
    at 16x16): every embed_img parameter of the actor and both critics keeps
    its bits, every other group moves, Adam's moments for the encoders
    advance."""
    import dataclasses

    from hope_tpu_torch.agents import SACAgent
    from hope_tpu_torch.config import (AttentionConfig, SACConfig, actor_net_config,
                                       critic_net_config)
    from hope_tpu_torch.models import MultiObsEmbedding

    obs = ObsConfig(img_size=16)
    narrow = dict(embed_dim=32, hidden_dim=32, img_fc_sizes=(32,),
                  attention=AttentionConfig(depth=1, heads=2, dim_head=8, mlp_dim=32,
                                            hidden_dim=32))
    actor = MultiObsEmbedding(dataclasses.replace(actor_net_config(obs), **narrow)).to(dev)
    agent = SACAgent(actor,
                     SACConfig(freeze_img_encoder=True, lr_actor=1e-3, lr_critic=1e-3),
                     dataclasses.replace(critic_net_config(obs, action_input=True), **narrow))
    st = agent.init({"lidar": (120,), "action_mask": (42,), "img": (3, 16, 16), "target": (5,)},
                    torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    B = 32
    batch = {"action": rng.uniform(-1, 1, (B, 2)), "reward": rng.normal(size=B),
             "done": rng.uniform(size=B) < 0.2}
    for p in ("obs", "next_obs"):
        batch.update({f"{p}/lidar": rng.normal(size=(B, 120)),
                      f"{p}/action_mask": rng.uniform(size=(B, 42)),
                      f"{p}/img": rng.integers(0, 256, (B, 3, 16, 16)) / 255.0,
                      f"{p}/target": rng.normal(size=(B, 5))})
    batch = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32), device=dev)
             for k, v in batch.items()}
    nets = ("actor", "critic1", "critic2")
    before = {n: {k: v.clone() for k, v in getattr(st, n).state_dict().items()} for n in nets}
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    for _ in range(2):
        agent.update(st, batch, g)
    for n in nets:
        frozen = {id(p) for p in agent.frozen(getattr(st, n))}
        opt = getattr(st, "opt_" + n)
        rest = 0.0
        for k, p in getattr(st, n).named_parameters():
            if id(p) in frozen:
                assert torch.equal(p.detach(), before[n][k]), (n, k)
                if k.endswith("conv.weight"):
                    assert opt.state[p]["exp_avg"].abs().max() > 0, (n, k)
            else:
                rest = max(rest, float((p.detach() - before[n][k]).abs().max()))
        assert frozen and rest > 0, n


@pytest.mark.parametrize("kind", ["train_sac", "train_ppo"])
def test_two_ranks_share_the_card(dev, kind, tmp_path):
    """Two gloo ranks on cuda:0 (separate processes) run two --smoke chunks
    of the CLI's rank worker: both finish, their parameters and Adam states
    are bitwise equal, and each launched the mask and the sweep K times a
    chunk at B / 2 (the mask once more for the first reset)."""
    import subprocess
    import sys

    from hope_tpu_torch.parallel.launch import free_port

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    coord = f"localhost:{free_port()}"
    paths = [str(tmp_path / f"rank{r}.pt") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_cases", kind, coord,
                               str(r), "2", paths[r], "cuda:0"], cwd=repo,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    ranks = [torch.load(p, weights_only=False) for p in paths]

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        else:
            yield prefix, tree

    for (k, a), (_, b) in zip(leaves(ranks[0]["nets"]), leaves(ranks[1]["nets"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, k
    K = 4 if kind == "train_sac" else 8               # --smoke chunk / buffer steps
    for r in ranks:
        assert [c["episodes"] for c in r["chunks"]] == [c["episodes"] for c in ranks[0]["chunks"]]
        assert r["launches"]["mask_steps"] == 2 * K + 1
        assert r["launches"]["sweep_collide"] == 2 * K
        assert r["launches"]["raster_bev"] == 0           # --smoke has no image
