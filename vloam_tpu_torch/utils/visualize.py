"""Headless debug visualizations (a copy of ``vloam_tpu/utils/visualize.py``):
the reference's rviz/imshow surface as PNG dumps.

Covers ImageUtil::visualizeKeypoints/visualizeMatches/visualizeOpticalFlow
(image_util.cpp:458-494,573-634) and PointCloudUtil::visualizeDepth
(point_cloud_util.cpp:520-601) without a GUI: each returns an (H, W, 3)
uint8 array; ``save_png`` writes it (PIL, imported when called).  NumPy on
the host: debug paths, not part of the frame step.
"""

from __future__ import annotations

import numpy as np


def _to_rgb(img: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _draw_dot(rgb: np.ndarray, x: int, y: int, color, r: int = 1) -> None:
    h, w, _ = rgb.shape
    y0, y1 = max(y - r, 0), min(y + r + 1, h)
    x0, x1 = max(x - r, 0), min(x + r + 1, w)
    rgb[y0:y1, x0:x1] = color


def _draw_line(rgb: np.ndarray, x0, y0, x1, y1, color) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    h, w, _ = rgb.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    rgb[ys[ok], xs[ok]] = color


def draw_keypoints(img, pts, mask, color=(0, 255, 0)) -> np.ndarray:
    """Keypoint dots (ImageUtil::visualizeKeypoints, image_util.cpp:264-272)."""
    rgb = _to_rgb(img)
    pts = np.asarray(pts)
    for x, y in pts[np.asarray(mask, bool)]:
        _draw_dot(rgb, int(round(x)), int(round(y)), color)
    return rgb


def draw_flow(img, pts0, pts1, ok, color=(0, 255, 0), tip=(255, 0, 0)) -> np.ndarray:
    """Optical-flow arrows on the current image
    (ImageUtil::visualizeOpticalFlow, image_util.cpp:573-634)."""
    rgb = _to_rgb(img)
    p0, p1 = np.asarray(pts0), np.asarray(pts1)
    for (x0, y0), (x1, y1) in zip(p0[np.asarray(ok, bool)], p1[np.asarray(ok, bool)]):
        _draw_line(rgb, x0, y0, x1, y1, color)
        _draw_dot(rgb, int(round(x1)), int(round(y1)), tip)
    return rgb


def draw_matches(img0, img1, pts0, pts1, ok) -> np.ndarray:
    """Side-by-side match lines (ImageUtil::visualizeMatches,
    image_util.cpp:458-494)."""
    a, b = _to_rgb(img0), _to_rgb(img1)
    rgb = np.concatenate([a, b], axis=1)
    off = a.shape[1]
    p0, p1 = np.asarray(pts0), np.asarray(pts1)
    for (x0, y0), (x1, y1) in zip(p0[np.asarray(ok, bool)], p1[np.asarray(ok, bool)]):
        _draw_line(rgb, x0, y0, x1 + off, y1, (0, 255, 0))
    return rgb


def depth_colormap(z, z_min=1.0, z_max=60.0) -> np.ndarray:
    """Near=red -> far=blue, the reference's HSV sweep
    (point_cloud_util.cpp:540-560)."""
    t = np.clip((np.asarray(z, np.float64) - z_min) / (z_max - z_min), 0.0, 1.0)
    h = t * 240.0  # red(0) .. blue(240)
    c = np.ones_like(h)
    hp = h / 60.0
    x = 1.0 - np.abs(hp % 2.0 - 1.0)
    r = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5], [c, x, 0 * c, 0 * c, x], 0)
    g = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5], [x, c, c, x, 0 * c], 0)
    b = np.select([hp < 1, hp < 2, hp < 3, hp < 4, hp < 5], [0 * c, 0 * c, x, c, c], c)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def draw_depth(img, uv, z, valid, z_max=60.0) -> np.ndarray:
    """Projected lidar depth dots over the image
    (PointCloudUtil::visualizeDepth, point_cloud_util.cpp:520-601)."""
    rgb = _to_rgb(img)
    uv = np.asarray(uv)
    colors = depth_colormap(z, z_max=z_max)
    h, w, _ = rgb.shape
    for (x, y), col, ok in zip(uv, colors, np.asarray(valid, bool)):
        if ok:
            _draw_dot(rgb, int(round(x)), int(round(y)), col, r=0)
    return rgb


def save_png(path: str, rgb: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb).save(path)
