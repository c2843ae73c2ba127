"""The pictures of ``evaluation/render.py`` drawn with Pillow alone, for a
machine without matplotlib (``render`` picks this module there): the same
files (episode PNG, success CDF, reward curve, episode GIF) with the same
content and colours, in a plainer drawing without fonts beyond Pillow's
default.
"""
from __future__ import annotations

import numpy as np
from PIL import Image, ImageDraw

from .render import DEST_COLOR, OBSTACLE_COLOR, TRAJ_COLOR, VEHICLE_COLOR, _np

SIZE = 660          # pixels a side, as the matplotlib figures' 6 in at 110 dpi
PLOT = (550, 385)   # the plots' 5 x 3.5 in
MARGIN = 50


def _rgb(hex_color: str, alpha: float = 1.0):
    h = hex_color.lstrip("#")
    return tuple(int(h[i:i + 2], 16) for i in (0, 2, 4)) + (int(round(255 * alpha)),)


class _World:
    """World (x, y) -> pixel, equal scale on both axes, over the scene's bounds."""

    def __init__(self, bounds):
        x0, x1, y0, y1 = (float(v) for v in bounds)
        self.s = (SIZE - 2 * MARGIN) / max(x1 - x0, y1 - y0, 1e-6)
        self.cx, self.cy = (x0 + x1) / 2, (y0 + y1) / 2

    def __call__(self, pts):
        pts = np.asarray(pts, np.float64).reshape(-1, 2)
        return [(SIZE / 2 + (x - self.cx) * self.s, SIZE / 2 - (y - self.cy) * self.s)
                for x, y in pts]


def _scene_image(scene, title: str | None = None):
    img = Image.new("RGBA", (SIZE, SIZE), (255, 255, 255, 255))
    d = ImageDraw.Draw(img, "RGBA")
    w = _World(_np(scene.bounds))
    edges = _np(scene.edges)[_np(scene.edge_mask).astype(bool)]
    for e in edges:
        d.line(w(e), fill=_rgb(OBSTACLE_COLOR), width=2)
    d.polygon(w(_np(scene.dest_box)), fill=_rgb(DEST_COLOR, 0.35))
    dest = _np(scene.dest).astype(np.float64)
    tip = dest[:2] + 1.2 * np.array([np.cos(dest[2]), np.sin(dest[2])])
    d.line(w([dest[:2], tip]), fill=_rgb(DEST_COLOR), width=2)
    (tx, ty), = w(tip)
    d.ellipse([tx - 3, ty - 3, tx + 3, ty + 3], fill=_rgb(DEST_COLOR))
    (sx, sy), = w(_np(scene.start)[:2])
    d.ellipse([sx - 3, sy - 3, sx + 3, sy + 3], fill=_rgb(VEHICLE_COLOR))
    if title:
        d.text((MARGIN, 15), title, fill=(0, 0, 0, 255))
    return img, d, w


def _boxes(poses, corners):
    poses = _np(poses).astype(np.float64)
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    return np.einsum("tij,kj->tki", rot, _np(corners).astype(np.float64)) + poses[:, None, :2]


def save_episode_png(path: str, scene, poses, corners, every: int = 4,
                     title: str | None = None):
    img, d, w = _scene_image(scene, title)
    boxes = _boxes(poses, corners)[::every]
    n = len(boxes)
    for i, b in enumerate(boxes):
        d.line(w(np.vstack([b, b[:1]])), fill=_rgb(VEHICLE_COLOR, 0.15 + 0.75 * (i + 1) / n),
               width=1)
    if n > 1:
        d.line(w(boxes.mean(axis=1)), fill=_rgb(TRAJ_COLOR, 0.8), width=1)
    img.convert("RGB").save(path)


def _plot(path: str, series, y_range, x_label: str, y_label: str):
    """Line plots in one frame: ``series`` [(ys (xs, ys), hex colour, alpha)]."""
    W, H = PLOT
    img = Image.new("RGBA", (W, H), (255, 255, 255, 255))
    d = ImageDraw.Draw(img, "RGBA")
    x0, y0, x1, y1 = MARGIN + 10, 15, W - 15, H - MARGIN
    d.rectangle([x0, y0, x1, y1], outline=(0, 0, 0, 255))
    xmax = max(float(xs[-1]) for (xs, _), _, _ in series) or 1.0
    lo, hi = y_range
    span = (hi - lo) or 1.0
    for (xs, ys), color, alpha in series:
        px = x0 + (np.asarray(xs, np.float64) / xmax) * (x1 - x0)
        py = y1 - (np.asarray(ys, np.float64) - lo) / span * (y1 - y0)
        d.line(list(zip(px, py)), fill=_rgb(color, alpha), width=2)
    d.text((x0, y1 + 5), "0", fill=(0, 0, 0, 255))
    d.text((x1 - 30, y1 + 5), f"{xmax:g}", fill=(0, 0, 0, 255))
    d.text((5, y1 - 10), f"{lo:.3g}", fill=(0, 0, 0, 255))
    d.text((5, y0), f"{hi:.3g}", fill=(0, 0, 0, 255))
    d.text(((x0 + x1) // 2 - 40, y1 + 20), x_label, fill=(0, 0, 0, 255))
    d.text((x0 + 5, y0 + 5), y_label, fill=(0, 0, 0, 255))
    img.convert("RGB").save(path)


def save_success_cdf(path: str, steps, success, max_steps: int = 200):
    steps = _np(steps)
    success = _np(success).astype(bool)
    xs = np.arange(max_steps + 1)
    cdf = [(success & (steps <= x)).mean() for x in xs]
    _plot(path, [((xs, cdf), "#1f77b4", 1.0)], (0.0, 1.0), "episode steps",
          "cumulative success rate")


def save_reward_curve(path: str, rewards, window: int = 50):
    r = np.asarray(rewards, dtype=np.float64)
    if len(r) == 0:
        return
    k = min(window, max(1, len(r) // 5))
    smooth = np.convolve(r, np.ones(k) / k, mode="valid")
    xs = np.arange(len(r))
    lo, hi = float(r.min()), float(r.max())
    _plot(path, [((xs, r), "#1f77b4", 0.25), ((np.arange(k - 1, len(r)), smooth), "#ff7f0e", 1.0)],
          (lo, hi if hi > lo else lo + 1.0), "chunk", f"reward (smoothed over {k})")


def animate_episode(path: str, scene, poses, corners, fps: int = 10):
    base, _, w = _scene_image(scene)
    boxes = _boxes(poses, corners)
    centers = boxes.mean(axis=1)
    frames = []
    for t in range(len(boxes)):
        img = base.copy()
        d = ImageDraw.Draw(img, "RGBA")
        d.line(w(np.vstack([boxes[t], boxes[t][:1]])), fill=_rgb(VEHICLE_COLOR), width=2)
        if t:
            d.line(w(centers[: t + 1]), fill=_rgb(TRAJ_COLOR, 0.8), width=1)
        frames.append(img.convert("RGB"))
    frames[0].save(path, save_all=True, append_images=frames[1:], duration=1000 // fps, loop=0)
