"""The synthetic frame stream of ``bench._gen_frames``, as NumPy: raycast
HDL-64 scans, blob camera images, and the host-built layouts the frame step
takes (ring grid, depth buckets, less-flat table).

A copy, because ``bench.py`` imports jax.  The default course drives
``straight_trajectory(speed, yaw_rate)`` through ``default_scene``;
``snake=True`` weaves along the street instead (``snake_trajectory``, the
long validation drive), and ``hard=True`` adds three stressors of real
drives: an open plaza with no structure for x in [55, 90], an oncoming and a
crossing vehicle carrying camera texture (rng seed 23), and a 12-frame
stretch with no camera texture.  Every 8th frame raycasts 700 random pixels
into the world and keeps the hits as persistent blob texture (rng seed 11),
and each image renders the blobs within 90 m.  Tests check that it gives
``bench._gen_frames``'s arrays.
"""

from __future__ import annotations

import numpy as np

from vloam_tpu_torch.config import VloamConfig
from vloam_tpu_torch.data import synthetic
from vloam_tpu_torch.data.gridding import depth_buckets, grid_cloud, less_flat_voxel_table


def camera_matrices(ext) -> tuple[np.ndarray, np.ndarray]:
    """(K (3, 3) float64, proj (3, 4) float32) of an ``Extrinsics``."""
    P = ext.P_rect0.cpu()
    proj = (P @ ext.R_rect0.cpu() @ ext.cam_T_velo.cpu()).numpy()
    return P[:, :3].numpy().astype(np.float64), proj


def _hard_scene(boxes: np.ndarray) -> np.ndarray:
    """The plaza: the street's structure removed for x in [55, 90], two
    buildings 60-75 m out laterally (near the lidar's range) instead."""
    keep = ~((boxes[:, 0] > 55.0) & (boxes[:, 0] < 90.0))
    far = np.array([
        [62.0, 62.0, -1.7, 70.0, 70.0, 8.0],
        [76.0, -74.0, -1.7, 84.0, -66.0, 10.0],
    ])
    return np.concatenate([boxes[keep], far])


def _vehicles(i: int, t: np.ndarray, dyn_face: np.ndarray) -> tuple[list, np.ndarray]:
    """Frame i's moving boxes and the texture points riding them: an
    oncoming vehicle in the adjacent lane every 55 frames (closing at 3.7 m a
    frame) and a crossing vehicle at a junction every 120 frames."""
    dyn, dyn_tex = [], np.zeros((0, 3))
    x_on = t[0] + 90.0 - 3.7 * (i % 55)
    if x_on - t[0] > -15.0:
        dyn.append([x_on, -5.2, -1.7, x_on + 4.2, -2.8, 0.4])
        dyn_tex = np.stack([np.full(len(dyn_face), x_on - 0.01),
                            -5.1 + 2.2 * dyn_face[:, 0], -1.6 + 1.9 * dyn_face[:, 1]], -1)
    x_junc = 45.0 + 108.0 * (i // 120)
    y_cr = -28.0 + 0.9 * (i % 120)
    if abs(y_cr) < 28.0:
        dyn.append([x_junc, y_cr, -1.7, x_junc + 1.8, y_cr + 1.2, 0.2])
        # texture on the camera-facing (-x) side
        dyn_tex = np.concatenate([dyn_tex, np.stack([
            np.full(len(dyn_face), x_junc - 0.01), y_cr + 1.2 * dyn_face[:, 0],
            -1.6 + 1.7 * dyn_face[:, 1]], -1)])
    return dyn, dyn_tex


def gen_raw(cfg: VloamConfig, ext, n_frames: int, speed: float = 0.8, yaw_rate: float = 0.005,
            n_azimuth: int = 1800, noise: float = 0.005, snake: bool = False, hard: bool = False):
    """Returns (raw, poses): raw is a list of (img (H, W) float32, cloud
    (N, 3) float32 in the sensor frame) per frame; poses are the sensor
    (R, t) per frame.  ``yaw_rate`` is the snake's yaw amplitude when
    ``snake``."""
    vc = cfg.visual
    boxes = synthetic.default_scene()
    if hard:
        boxes = _hard_scene(boxes)
    if snake:
        poses = synthetic.snake_trajectory(n_frames, speed=speed, yaw_amp=yaw_rate)
    else:
        poses = synthetic.straight_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate)
    K, _ = camera_matrices(ext)
    rng = np.random.default_rng(11)
    # a fixed pattern on the vehicles: it persists across frames, so it is tracked
    dyn_face = np.random.default_rng(23).uniform(size=(14, 2))
    box_cx = (boxes[:, 0] + boxes[:, 3]) / 2.0

    blob_world = np.zeros((0, 3))
    raw = []
    for i, (R, t) in enumerate(poses):
        R_wc = R @ synthetic.CAM_R_WORLD.T
        if i % 8 == 0:
            # extend the persistent world texture ahead of the camera
            uv = np.stack([rng.uniform(20, vc.img_width - 20, 700),
                           rng.uniform(20, vc.img_height - 20, 700)], -1)
            pc, hit = synthetic.raycast_camera(R_wc, t, boxes, K, uv)
            blob_world = np.concatenate([blob_world, (pc[hit] @ R_wc.T) + t])
        # rays reach 80 m: boxes farther than 100 m cannot be hit
        near = boxes[np.abs(box_cx - t[0]) < 100.0]
        dyn_tex = np.zeros((0, 3))
        if hard:
            dyn, dyn_tex = _vehicles(i, t, dyn_face)
            if dyn:
                near = np.concatenate([near, np.array(dyn)])
        cloud = synthetic.simulate_scan(R, t, near, n_azimuth=n_azimuth, noise=noise, seed=i)
        vis = blob_world[np.linalg.norm(blob_world - t, axis=1) < 90.0]
        if hard:
            if n_frames // 3 <= i < n_frames // 3 + 12:
                vis = vis[:0]                   # the textureless stretch
            elif len(dyn_tex):
                vis = np.concatenate([vis, dyn_tex])
        img = synthetic.render_blob_image((vis - t) @ R_wc, K, vc.img_height, vc.img_width)
        raw.append((img, cloud))
    return raw, poses


def host_frame(cfg: VloamConfig, proj: np.ndarray, img: np.ndarray, cloud: np.ndarray):
    """(img, grid (R, C, 4), gmask (R, C), buckets (u, v, z, count),
    lf_table (slot_grid, base_sums, n_runs)) of one raw frame, built by the
    NumPy host data layer."""
    grid, gmask, _ = grid_cloud(cloud, cfg.scan)
    buckets = depth_buckets(grid.reshape(-1, 4), gmask.reshape(-1), proj, cfg.visual)
    return img, grid, gmask, buckets, less_flat_voxel_table(grid, gmask, cfg.scan)


def gen_frames(cfg: VloamConfig, ext, n_frames: int, speed: float = 0.8,
               yaw_rate: float = 0.005, n_azimuth: int = 1800, noise: float = 0.005,
               snake: bool = False, hard: bool = False):
    """Returns (frames, poses): ``gen_raw``'s frames through ``host_frame``."""
    raw, poses = gen_raw(cfg, ext, n_frames, speed, yaw_rate, n_azimuth, noise, snake, hard)
    proj = camera_matrices(ext)[1]
    return [host_frame(cfg, proj, img, cloud) for img, cloud in raw], poses
