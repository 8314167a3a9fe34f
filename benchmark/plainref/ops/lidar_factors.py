"""Lidar residual blocks (port of ``vloam_tpu/ops/lidar_factors.py``).

* edge (point-to-line), 3-dim:  r = (lp - a) x (lp - b) / |a - b|
* plane (point-to-plane via unit normal), 1-dim:  r = n . lp + d
with lp = R(q) p + t.  With ``OdometryConfig.distortion`` LO uses the
``*_interp`` forms: each point is mapped by the pose interpolated to its
intra-sweep time fraction s (TransformToStart, laser_odometry.cpp:150-173;
the factors' slerp, lidarFactor.hpp:30-44).
"""

from __future__ import annotations

import torch

from plainref import geometry as geo


def edge_residual(pose, p, a, b):
    """(B,3) point-to-line residuals.  p, a, b: (B,3)."""
    lp = geo.pose_apply(pose, p)
    nu = torch.linalg.cross(lp - a, lp - b, dim=-1)
    de = torch.linalg.vector_norm(a - b, dim=-1, keepdim=True)
    return nu / torch.clamp(de, min=1e-10)


def plane_residual(pose, p, n, d):
    """(B,1) point-to-plane residuals.  n: (B,3) unit normals, d: (B,)."""
    lp = geo.pose_apply(pose, p)
    return (torch.sum(n * lp, dim=-1) + d)[..., None]


def plane_from_three_points(j, l, m):
    """(n, d) of the plane through three points (the LO 3-point form)."""
    n = torch.linalg.cross(j - l, j - m, dim=-1)
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-10)
    d = -torch.sum(n * j, dim=-1)
    return n, d


def pose_apply_interp(pose, p, s):
    """The pose interpolated to per-point time fraction s (B,), applied:
    lp = slerp(I, q; s) p + s t (TransformToStart).  s = 1 is ``pose_apply``."""
    q_s = geo.quat_slerp_identity(geo.pose_q(pose), s)
    return geo.quat_rotate(q_s, p) + s[..., None] * geo.pose_t(pose)


def transform_to_end(pose, p, s):
    """Undistort points to the sweep-END frame (TransformToEnd,
    laser_odometry.cpp:176-193): to the start through the interpolated pose,
    then through the full inverse delta.  The distortion mode stores LO's
    next-frame targets this way, so they are rigid in their anchor frame."""
    return geo.pose_apply(geo.pose_inverse(pose), pose_apply_interp(pose, p, s))


def edge_residual_interp(pose, p, a, b, s):
    """Distortion-aware point-to-line residual (lidarFactor.hpp:30-46)."""
    lp = pose_apply_interp(pose, p, s)
    nu = torch.linalg.cross(lp - a, lp - b, dim=-1)
    de = torch.linalg.vector_norm(a - b, dim=-1, keepdim=True)
    return nu / torch.clamp(de, min=1e-10)


def plane_residual_interp(pose, p, n, d, s):
    """Distortion-aware point-to-plane residual (lidarFactor.hpp:63-111)."""
    lp = pose_apply_interp(pose, p, s)
    return (torch.sum(n * lp, dim=-1) + d)[..., None]


def distance_residual(pose, p, closest):
    """(B,3) point-to-point residuals (R p + t) - closest (LidarDistanceFactor,
    lidarFactor.hpp:146-177; no caller on the LO or MO path)."""
    return geo.pose_apply(pose, p) - closest
