"""The synthetic frame stream of ``bench._gen_frames`` (its default course),
as NumPy: raycast HDL-64 scans, blob camera images, and the host-built
layouts the frame step takes (ring grid, depth buckets, less-flat table).

A copy, because ``bench.py`` imports jax.  The course drives
``straight_trajectory(speed, yaw_rate)`` through ``default_scene``; every
8th frame raycasts 700 random pixels into the world and keeps the hits as
persistent blob texture (rng seed 11), and each image renders the blobs
within 90 m.  Tests check that it gives ``bench._gen_frames``'s arrays.
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


def gen_frames(cfg: VloamConfig, ext, n_frames: int, speed: float = 0.8,
               yaw_rate: float = 0.005, n_azimuth: int = 1800, noise: float = 0.005):
    """Returns (frames, poses).  Each frame is (img (H, W), grid (R, C, 4),
    gmask (R, C), buckets (u, v, z, count), lf_table (slot_grid, base_sums,
    n_runs)); poses are the sensor (R, t) per frame."""
    vc = cfg.visual
    boxes = synthetic.default_scene()
    poses = synthetic.straight_trajectory(n_frames, speed=speed, yaw_rate=yaw_rate)
    K, proj = camera_matrices(ext)
    rng = np.random.default_rng(11)
    box_cx = (boxes[:, 0] + boxes[:, 3]) / 2.0

    blob_world = np.zeros((0, 3))
    frames = []
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
        cloud = synthetic.simulate_scan(R, t, near, n_azimuth=n_azimuth, noise=noise, seed=i)
        vis = blob_world[np.linalg.norm(blob_world - t, axis=1) < 90.0]
        img = synthetic.render_blob_image((vis - t) @ R_wc, K, vc.img_height, vc.img_width)
        grid, gmask, _ = grid_cloud(cloud, cfg.scan)
        buckets = depth_buckets(grid.reshape(-1, 4), gmask.reshape(-1), proj, vc)
        frames.append((img, grid, gmask, buckets, less_flat_voxel_table(grid, gmask, cfg.scan)))
    return frames, poses
