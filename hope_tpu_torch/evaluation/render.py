"""Pictures for people (counterpart of ``hope_tpu/evaluation/render.py``):
matplotlib drawings of scenes, trajectories and evaluation summaries, written
as PNG and GIF files, and the per-episode evaluation record.

The functions take the port's tensors (a single, unbatched ``Scene``; poses
and corners as tensors or arrays) and move them to numpy themselves; the
drawing is the JAX package's, so the same inputs give the same pixels.
Where matplotlib is not installed the files are drawn with Pillow instead
(``render_pil.py``): the same files and content, plainer, and no window.
"""
from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

HAS_MATPLOTLIB = importlib.util.find_spec("matplotlib") is not None


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# colors matched to the reference's pygame palette
OBSTACLE_COLOR = "#969696"   # gray obstacles
DEST_COLOR = "#6496fa"       # blue destination slot
VEHICLE_COLOR = "#1e6432"    # green vehicle
TRAJ_COLOR = "#28a044"


def draw_scene(ax, scene, vehicle_boxes=None, title: str | None = None):
    """Draw one scene: obstacle edges, destination box, start pose, and an
    optional sequence of vehicle footprint boxes (T, 4, 2).

    ``scene`` is a single (unbatched) Scene of tensors or arrays.
    """
    edges = _np(scene.edges)
    mask = _np(scene.edge_mask).astype(bool)
    for (x1, y1, x2, y2) in edges[mask]:
        ax.plot([x1, x2], [y1, y2], color=OBSTACLE_COLOR, lw=1.5)

    dest_box = _np(scene.dest_box)
    ax.fill(*np.vstack([dest_box, dest_box[:1]]).T, color=DEST_COLOR, alpha=0.35)
    dest = _np(scene.dest)
    ax.annotate("", xy=(dest[0] + 1.2 * np.cos(dest[2]), dest[1] + 1.2 * np.sin(dest[2])),
                xytext=(dest[0], dest[1]),
                arrowprops=dict(arrowstyle="->", color=DEST_COLOR))

    start = _np(scene.start)
    ax.plot(start[0], start[1], "o", color=VEHICLE_COLOR, ms=4)

    if vehicle_boxes is not None:
        boxes = _np(vehicle_boxes)
        n = len(boxes)
        for i, b in enumerate(boxes):
            alpha = 0.15 + 0.75 * (i + 1) / n
            closed = np.vstack([b, b[:1]])
            ax.plot(closed[:, 0], closed[:, 1], color=VEHICLE_COLOR, alpha=alpha, lw=1.0)
        centers = boxes.mean(axis=1)
        ax.plot(centers[:, 0], centers[:, 1], "-", color=TRAJ_COLOR, lw=1.0, alpha=0.8)

    b = _np(scene.bounds)
    ax.set_xlim(b[0], b[1])
    ax.set_ylim(b[2], b[3])
    ax.set_aspect("equal")
    if title:
        ax.set_title(title, fontsize=9)


def save_episode_png(path: str, scene, poses, corners, every: int = 4,
                     title: str | None = None):
    """Render one episode's swept trajectory to a PNG.

    poses: (T, 3) world poses; corners: (4, 2) vehicle footprint corners.
    """
    if not HAS_MATPLOTLIB:
        from . import render_pil

        return render_pil.save_episode_png(path, scene, poses, corners, every, title)
    plt = _mpl()
    poses = _np(poses)
    corners = _np(corners)
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # (T,2,2)
    boxes = poses[:, None, :2] + corners[None] @ np.swapaxes(R, -1, -2)
    fig, ax = plt.subplots(figsize=(6, 6))
    draw_scene(ax, scene, vehicle_boxes=boxes[::every], title=title)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_success_cdf(path: str, steps, success, max_steps: int = 200):
    """Cumulative success-vs-steps plot."""
    if not HAS_MATPLOTLIB:
        from . import render_pil

        return render_pil.save_success_cdf(path, steps, success, max_steps)
    plt = _mpl()
    steps = _np(steps)
    success = _np(success).astype(bool)
    xs = np.arange(max_steps + 1)
    cdf = [(success & (steps <= x)).mean() for x in xs]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(xs, cdf)
    ax.set_xlabel("episode steps")
    ax.set_ylabel("cumulative success rate")
    ax.set_ylim(0, 1)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_reward_curve(path: str, rewards, window: int = 50):
    """Smoothed reward curve over training chunks."""
    if not HAS_MATPLOTLIB:
        from . import render_pil

        return render_pil.save_reward_curve(path, rewards, window)
    plt = _mpl()
    r = np.asarray(rewards, dtype=np.float64)
    if len(r) == 0:
        return
    k = min(window, max(1, len(r) // 5))
    smooth = np.convolve(r, np.ones(k) / k, mode="valid")
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(r, alpha=0.25, lw=0.7, label="chunk mean")
    ax.plot(np.arange(k - 1, len(r)), smooth, lw=1.5, label=f"smoothed ({k})")
    ax.set_xlabel("chunk")
    ax.set_ylabel("reward")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def save_record(path: str, metrics: dict):
    """Persist per-episode evaluation arrays as a portable .npz."""
    np.savez_compressed(path, **{k: _np(v) for k, v in metrics.items()})


def _has_display() -> bool:
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


def animate_episode(path: str, scene, poses, corners, fps: int = 10, live: bool = False):
    """Frame-by-frame episode playback, written as an animated GIF at
    ``path`` (always). With ``live`` it also plays the episode in a window
    where a display (and matplotlib) exists, and writes the file alone where
    none does.

    Args:
      scene: single Scene.  poses: (T, 3).  corners: (4, 2) footprint.
    """
    if not HAS_MATPLOTLIB:
        from . import render_pil

        return render_pil.animate_episode(path, scene, poses, corners, fps)
    import matplotlib

    if live and _has_display():
        try:  # pragma: no cover - needs a display
            matplotlib.use("TkAgg")
        except ImportError:
            matplotlib.use("Agg")
            live = False
    else:
        matplotlib.use("Agg")
        live = False
    import matplotlib.pyplot as plt
    from matplotlib import animation

    poses = _np(poses)
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    boxes = np.einsum("tij,kj->tki", rot, _np(corners)) + poses[:, None, :2]

    fig, ax = plt.subplots(figsize=(6, 6))
    draw_scene(ax, scene)
    (outline,) = ax.plot([], [], color=VEHICLE_COLOR, lw=1.6)
    (trail,) = ax.plot([], [], "-", color=TRAJ_COLOR, lw=1.0, alpha=0.8)

    def frame(t):
        closed = np.vstack([boxes[t], boxes[t][:1]])
        outline.set_data(closed[:, 0], closed[:, 1])
        centers = boxes[: t + 1].mean(axis=1)
        trail.set_data(centers[:, 0], centers[:, 1])
        return outline, trail

    anim = animation.FuncAnimation(fig, frame, frames=len(poses), interval=1000 // fps,
                                   blit=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    if live:  # pragma: no cover - needs a display
        plt.show()
    plt.close(fig)
