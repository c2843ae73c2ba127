"""The port's pictures against the JAX package's, on the CPU: the same scene
and poses through ``hope_tpu.evaluation.render`` and
``hope_tpu_torch.evaluation.render`` give the same pixels (exactly: the
drawing code is the same matplotlib calls on the same float32 values); the
episode runner's recorded poses; the eval CLI's record, CDF and pictures.
"""
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from hope_tpu.config import VehicleConfig
from hope_tpu.envs.scene import Scene as JScene
from hope_tpu.evaluation import render as jrender
from hope_tpu_torch.envs import Scene
from hope_tpu_torch.evaluation import render

from .test_torch_ops import SCENES_NPZ, SCENE_FIELDS
from .test_torch_weights import NPZ
from .torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scene_and_poses():
    with np.load(SCENES_NPZ) as f:
        fields = {k: f[k][3] for k in SCENE_FIELDS}
    jscene = JScene(**fields)
    tscene = Scene.from_numpy(fields, "cpu")
    start, dest = fields["start"].astype(np.float64), fields["dest"].astype(np.float64)
    poses = np.linspace(start, dest, 14).astype(np.float32)
    corners = np.asarray(VehicleConfig().box_corners(), np.float32)
    return jscene, tscene, poses, corners


def pixels(path):
    return np.asarray(Image.open(path).convert("RGBA"))


def frames(path):
    return [np.asarray(f.convert("RGBA")) for f in ImageSequence.Iterator(Image.open(path))]


def test_pictures_match_jax(tmp_path, scene_and_poses):
    """save_episode_png (the port given tensors), save_success_cdf and
    save_reward_curve: the PNGs' pixels equal JAX's."""
    jscene, tscene, poses, corners = scene_and_poses
    j, t = tmp_path / "j", tmp_path / "t"
    j.mkdir()
    t.mkdir()
    jrender.save_episode_png(str(j / "ep.png"), jscene, poses, corners, title="Normal #3")
    render.save_episode_png(str(t / "ep.png"), tscene, torch.as_tensor(poses),
                            torch.as_tensor(corners), title="Normal #3")
    steps, success = np.array([10, 50, 200, 31]), np.array([1, 1, 0, 1], bool)
    jrender.save_success_cdf(str(j / "cdf.png"), steps, success)
    render.save_success_cdf(str(t / "cdf.png"), torch.as_tensor(steps), torch.as_tensor(success))
    curve = np.sin(np.arange(100) / 5.0)
    jrender.save_reward_curve(str(j / "curve.png"), curve)
    render.save_reward_curve(str(t / "curve.png"), list(curve))
    for name in ("ep.png", "cdf.png", "curve.png"):
        a, b = pixels(j / name), pixels(t / name)
        assert a.shape == b.shape and a.shape[0] > 300, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(np.unique(pixels(t / "ep.png").reshape(-1, 4), axis=0)) > 10


def test_animation_matches_jax(tmp_path, scene_and_poses):
    """animate_episode: the GIF's frames equal JAX's, one per pose; with
    ``live`` and no display it writes the same file and opens no window."""
    jscene, tscene, poses, corners = scene_and_poses
    jrender.animate_episode(str(tmp_path / "j.gif"), jscene, poses, corners, fps=5)
    render.animate_episode(str(tmp_path / "t.gif"), tscene, torch.as_tensor(poses),
                           torch.as_tensor(corners), fps=5)
    a, b = frames(tmp_path / "j.gif"), frames(tmp_path / "t.gif")
    assert len(a) == len(b) == len(poses)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"frame {i}")


def test_animation_live_without_display(tmp_path, scene_and_poses, monkeypatch):
    import matplotlib

    jscene, tscene, poses, corners = scene_and_poses
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    render.animate_episode(str(tmp_path / "live.gif"), tscene, poses[:4], corners, live=True)
    assert len(frames(tmp_path / "live.gif")) == 4
    assert matplotlib.get_backend().lower() == "agg"


def test_pictures_without_matplotlib(tmp_path, scene_and_poses, monkeypatch):
    """Where matplotlib is missing the same files come from Pillow: the
    episode PNG (660 px a side, with the obstacles' gray and the vehicle's
    green), the two plots, and a GIF of one frame per pose."""
    _, tscene, poses, corners = scene_and_poses
    monkeypatch.setattr(render, "HAS_MATPLOTLIB", False)
    render.save_episode_png(str(tmp_path / "ep.png"), tscene, poses, corners, title="t")
    render.save_success_cdf(str(tmp_path / "cdf.png"), np.array([3, 9]), np.array([1, 0]), 10)
    render.save_reward_curve(str(tmp_path / "curve.png"), np.sin(np.arange(30) / 3.0))
    render.animate_episode(str(tmp_path / "ep.gif"), tscene, poses, corners, live=True)
    ep = pixels(tmp_path / "ep.png")[..., :3].reshape(-1, 3)
    assert pixels(tmp_path / "ep.png").shape == (660, 660, 4)
    for color in ((0x96, 0x96, 0x96), (0x1e, 0x64, 0x32)):
        assert (ep == color).all(axis=1).any(), color
    for name in ("cdf.png", "curve.png"):
        assert len(np.unique(pixels(tmp_path / name).reshape(-1, 4), axis=0)) > 2, name
    gif = frames(tmp_path / "ep.gif")
    assert len(gif) == len(poses) and not np.array_equal(gif[0], gif[-1])


def test_episode_runner_records_poses():
    """record_traj: "poses" (T, B, 3) holds each step's poses after the
    finished envs froze; the other metrics are those of a run without it."""
    from hope_tpu_torch.config import EnvConfig, ObsConfig
    from hope_tpu_torch.evaluation.evaluate import build_episode_runner
    from hope_tpu_torch.envs import ParkingEnv

    env = ParkingEnv(EnvConfig(obs=ObsConfig(use_img=False), max_edges=256, max_obstacles=64),
                     device="cpu")
    with np.load(SCENES_NPZ) as f:
        scenes = Scene.from_numpy({k: f[k][:4] for k in SCENE_FIELDS}, "cpu")
    start = scenes.start.clone()
    start[0] = scenes.dest[0]                   # env 0 arrives at its first step
    scenes.start = start

    def act(obs, g):
        a = torch.rand((obs["target"].shape[0], 2), generator=g) * 2 - 1
        return a, torch.zeros(a.shape[0])

    T = 5
    m = build_episode_runner(env, act, T, record_traj=True)(scenes,
                                                            torch.Generator().manual_seed(3))
    ref = build_episode_runner(env, act, T)(scenes, torch.Generator().manual_seed(3))
    assert set(m) == set(ref) | {"poses"}
    for k in ref:
        assert torch.equal(m[k], ref[k]), k
    assert m["poses"].shape == (T, 4, 3)
    assert bool(m["finished"][0]) and int(m["steps"][0]) == 1
    for t in range(1, T):                       # frozen from its end on
        assert torch.equal(m["poses"][t, 0], m["poses"][0, 0])
    assert not torch.equal(m["poses"][0, 1:], m["poses"][-1, 1:])


def test_eval_cli_writes_records_and_pictures(tmp_path):
    """--visualize / --animate: per level the record (no poses), the
    success CDF, N PNGs and N GIFs."""
    from hope_tpu_torch.evaluation import eval_mix_scene

    res = eval_mix_scene.main([NPZ, "--episodes", "3", "--max-steps", "4", "--device", "cpu",
                               "--no-dlp", "--levels", "Normal", "--visualize", "2",
                               "--animate", "1", "--out", str(tmp_path)])
    assert list(res) == ["Normal"]
    with np.load(tmp_path / "record_Normal.npz") as rec:
        assert "poses" not in rec.files and rec["steps"].shape == (3,)
        assert {"success", "steps", "path_length", "status", "level"} <= set(rec.files)
    for name in ("success_cdf_Normal.png", "episode_Normal_0.png", "episode_Normal_1.png",
                 "episode_Normal_0.gif"):
        assert (tmp_path / name).stat().st_size > 1000, name
    assert not (tmp_path / "episode_Normal_2.png").exists()
    assert not (tmp_path / "episode_Normal_1.gif").exists()
