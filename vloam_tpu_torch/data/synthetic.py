"""Synthetic structured lidar world for tests and the chip smoke run.

A NumPy copy of the raycast world of ``vloam_tpu/data/synthetic.py``
(``default_scene``, ``simulate_scan``, ``simulate_scan_distorted``,
``straight_trajectory``, ``pad_cloud``; and for the camera ``render_blob_image``, ``CAM_R_WORLD``,
``raycast_camera``, ``kitti_like_intrinsics``): an HDL-64-like scanner in a
Manhattan world of axis-aligned boxes + ground plane, raycast per (ring,
azimuth) bin, clouds in the sensor frame with exact poses, and camera
images of Gaussian blobs at raycast world points.  Tests check that it
gives the same arrays as the original.
"""

from __future__ import annotations

import numpy as np

# HDL-64-ish vertical angles: KITTI formula maps [-24.33, 2] deg onto rings 0..50
# (upper block 0..31: 2 - ring/3 deg; lower block 32..: -8.83 - (ring-32)/2 deg).


def hdl64_ring_angles() -> np.ndarray:
    upper = 2.0 - np.arange(32) / 3.0          # rings 0..31: +2 .. -8.33
    lower = -8.87 - (np.arange(32)) / 2.0      # rings 32..63: -8.87 .. -24.37
    return np.concatenate([upper, lower])


def default_scene() -> np.ndarray:
    """Axis-aligned boxes (x0,y0,z0,x1,y1,z1) lining a street along +x."""
    boxes = []
    rng = np.random.default_rng(42)
    for i in range(30):
        x = -20.0 + i * 14.0
        w = rng.uniform(6, 12)
        d = rng.uniform(4, 8)
        h = rng.uniform(6, 18)
        side = 1 if i % 2 == 0 else -1
        y0 = side * rng.uniform(8, 14)
        boxes.append([x, min(y0, y0 + side * d), -1.7, x + w, max(y0, y0 + side * d), -1.7 + h])
    # a few thin poles (edge features)
    for i in range(25):
        x = -15.0 + i * 16.0 + rng.uniform(-3, 3)
        y = (1 if i % 2 else -1) * rng.uniform(5.0, 7.0)
        boxes.append([x, y, -1.7, x + 0.3, y + 0.3, 3.5])
    return np.array(boxes, np.float64)


def _ray_aabb(origins, dirs, boxes):
    """Min positive hit distance per ray over all AABBs.  origins (R,3),
    dirs (R,3) unit, boxes (B,6).  Returns t (R,) (inf when no hit)."""
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    lo = boxes[None, :, :3]
    hi = boxes[None, :, 3:]
    t0 = (lo - origins[:, None]) * inv[:, None]
    t1 = (hi - origins[:, None]) * inv[:, None]
    tmin = np.minimum(t0, t1).max(axis=-1)
    tmax = np.maximum(t0, t1).min(axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    tmin = np.where(hit & (tmin > 0), tmin, np.inf)
    return tmin.min(axis=1)


def simulate_scan(
    pose_R: np.ndarray,  # (3,3) sensor-to-world rotation
    pose_t: np.ndarray,  # (3,) sensor origin in world
    boxes: np.ndarray,
    n_azimuth: int = 900,
    max_range: float = 80.0,
    ground_z: float = -1.73,
    noise: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """One lidar sweep in sensor frame, ordered by azimuth (KITTI scan order).

    Returns (N, 3) float32 — only rays that hit something within range.
    """
    rng = np.random.default_rng(seed)
    ring_angles = np.radians(hdl64_ring_angles())
    az = np.linspace(np.pi, -np.pi, n_azimuth, endpoint=False)  # KITTI sweeps clockwise

    azg, elg = np.meshgrid(az, ring_angles, indexing="ij")      # azimuth-major order
    ce = np.cos(elg)
    dirs_sensor = np.stack([ce * np.cos(azg), ce * np.sin(azg), np.sin(elg)], axis=-1).reshape(-1, 3)
    dirs_world = dirs_sensor @ pose_R.T
    origins = np.broadcast_to(pose_t, dirs_world.shape)

    t_box = _ray_aabb(origins, dirs_world, boxes)
    dz = dirs_world[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < -1e-6, (ground_z - pose_t[2]) / np.where(dz == 0, -1.0, dz), np.inf)
    t = np.minimum(t_box, t_ground)
    hit = t < max_range

    pts = dirs_sensor[hit] * t[hit, None]
    if noise > 0:
        pts = pts + rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def _so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    if th < 1e-8:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * th / (2.0 * np.sin(th))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-10:
        return np.eye(3) + np.array(
            [[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]
        )
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def simulate_scan_distorted(
    pose_R_prev: np.ndarray,
    pose_t_prev: np.ndarray,
    pose_R: np.ndarray,   # sweep-END anchor pose (the frame's odometry pose)
    pose_t: np.ndarray,
    boxes: np.ndarray,
    n_azimuth: int = 900,
    max_range: float = 80.0,
    ground_z: float = -1.73,
    noise: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """One motion-distorted sweep: each azimuth column is raycast from the
    sensor pose interpolated between the previous frame's anchor (sweep
    fraction s = 0) and this frame's anchor (s = 1), and expressed in THAT
    interpolated sensor frame.

    This is exactly the acquisition model the reference's TransformToStart
    undistortion inverts (laser_odometry.cpp:150-173): a point captured at
    fraction s relates to the matching (previous) frame by the frame-to-frame
    delta interpolated by s.
    """
    rng = np.random.default_rng(seed)
    ring_angles = np.radians(hdl64_ring_angles())
    az = np.linspace(np.pi, -np.pi, n_azimuth, endpoint=False)

    w_delta = _so3_log(pose_R_prev.T @ pose_R)
    out = []
    for ci in range(n_azimuth):
        s = ci / n_azimuth
        R_s = pose_R_prev @ _so3_exp(s * w_delta)
        t_s = (1.0 - s) * pose_t_prev + s * pose_t
        el = ring_angles
        ce = np.cos(el)
        dirs_sensor = np.stack(
            [ce * np.cos(az[ci]), ce * np.sin(az[ci]), np.sin(el)], axis=-1
        )
        dirs_world = dirs_sensor @ R_s.T
        origins = np.broadcast_to(t_s, dirs_world.shape)
        t_box = _ray_aabb(origins, dirs_world, boxes)
        dz = dirs_world[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_gnd = np.where(
                dz < -1e-6, (ground_z - t_s[2]) / np.where(dz == 0, -1.0, dz), np.inf
            )
        t_hit = np.minimum(t_box, t_gnd)
        hit = t_hit < max_range
        out.append(dirs_sensor[hit] * t_hit[hit, None])
    pts = np.concatenate(out, axis=0)
    if noise > 0:
        pts = pts + rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def straight_trajectory(n_frames: int, speed: float = 1.0, yaw_rate: float = 0.0):
    """Sensor poses (R_i, t_i) driving along +x with optional constant yaw rate."""
    poses = []
    yaw = 0.0
    t = np.zeros(3)
    for _ in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R.copy(), t.copy()))
        t = t + R @ np.array([speed, 0.0, 0.0])
        yaw += yaw_rate
    return poses


def snake_trajectory(n_frames: int, speed: float = 1.0, yaw_amp: float = 0.004,
                     period: int = 100):
    """Sensor poses weaving along +x: the yaw rate oscillates sinusoidally,
    so long drives stay inside the street (a constant yaw rate curves off
    the scene after ~100 frames)."""
    poses = []
    yaw = 0.0
    t = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R.copy(), t.copy()))
        t = t + R @ np.array([speed, 0.0, 0.0])
        yaw += yaw_amp * np.sin(2.0 * np.pi * i / period)
    return poses


def turns_trajectory(n_frames: int, speed: float = 1.0, straight: int = 60,
                     turn_frames: int = 12, turn_angle: float = np.pi / 2,
                     alternate: bool = True):
    """Urban block route: straights joined by sharp turns of ``turn_angle``
    over ``turn_frames`` frames (real KITTI turns reach ~0.09 rad a frame);
    ``alternate`` flips the turn direction so the route stays compact."""
    poses = []
    yaw = 0.0
    t = np.zeros(3)
    period = straight + turn_frames
    sign = 1.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses.append((R.copy(), t.copy()))
        t = t + R @ np.array([speed, 0.0, 0.0])
        phase = i % period
        if phase >= straight:
            yaw += sign * turn_angle / turn_frames
            if alternate and phase == period - 1:
                sign = -sign
    return poses


def pad_cloud(pts: np.ndarray, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """(N,3) -> padded ((cap,3), (cap,) mask)."""
    n = min(len(pts), cap)
    out = np.zeros((cap, 3), np.float32)
    msk = np.zeros((cap,), bool)
    out[:n] = pts[:n]
    msk[:n] = True
    return out, msk


def render_blob_image(
    points_cam: np.ndarray, K: np.ndarray, height: int, width: int, sigma: float = 1.3, seed: int = 0
) -> np.ndarray:
    """Render Gaussian blobs at the projections of camera-frame points:
    trackable, corner-like texture for Shi-Tomasi/KLT.  Returns (H, W)
    float32 in [0, 255]."""
    rng = np.random.default_rng(seed)
    z = points_cam[:, 2]
    vis = z > 0.5
    uv = (points_cam[vis] @ K.T)
    uv = uv[:, :2] / uv[:, 2:3]
    amp = rng.uniform(120.0, 250.0, len(points_cam))[vis]

    img = np.zeros((height, width), np.float32)
    r = int(3 * sigma) + 1
    for (u, v), a in zip(uv, amp):
        ui, vi = int(round(u)), int(round(v))
        if not (r <= ui < width - r and r <= vi < height - r):
            continue
        ys, xs = np.mgrid[vi - r : vi + r + 1, ui - r : ui + r + 1]
        img[vi - r : vi + r + 1, ui - r : ui + r + 1] += a * np.exp(
            -((xs - u) ** 2 + (ys - v) ** 2) / (2 * sigma**2)
        )
    return np.clip(img, 0, 255.0)


CAM_R_WORLD = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
"""KITTI-style camera axes in the lidar/world convention:
cam x = -world y (right), cam y = -world z (down), cam z = world x (forward)."""


def raycast_camera(
    R_wc: np.ndarray,  # (3,3) camera-to-world rotation (columns = cam axes in world)
    t_w: np.ndarray,   # (3,) camera origin in world
    boxes: np.ndarray,
    K: np.ndarray,
    uv: np.ndarray,    # (N, 2) pixel coords
    max_range: float = 90.0,
    ground_z: float = -1.73,
) -> tuple[np.ndarray, np.ndarray]:
    """Cast rays through pixels; returns (points_cam (N,3), hit (N,))."""
    Kinv = np.linalg.inv(K)
    rays_cam = np.concatenate([uv, np.ones((len(uv), 1))], axis=1) @ Kinv.T
    rays_cam = rays_cam / np.linalg.norm(rays_cam, axis=1, keepdims=True)
    rays_w = rays_cam @ R_wc.T
    origins = np.broadcast_to(t_w, rays_w.shape)
    t_box = _ray_aabb(origins, rays_w, boxes)
    dz = rays_w[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_ground = np.where(dz < -1e-6, (ground_z - t_w[2]) / np.where(dz == 0, -1.0, dz), np.inf)
    t = np.minimum(t_box, t_ground)
    hit = t < max_range
    return (rays_cam * np.where(hit, t, 0.0)[:, None]).astype(np.float32), hit


def kitti_like_intrinsics(width: int = 1248, height: int = 376) -> np.ndarray:
    return np.array(
        [[718.856, 0.0, width / 2.0], [0.0, 718.856, height / 2.0], [0.0, 0.0, 1.0]],
        np.float32,
    )
