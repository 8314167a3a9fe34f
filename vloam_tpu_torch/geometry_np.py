"""Float64 NumPy pose algebra for the host-side world chains.

The reference accumulates world poses in double precision throughout —
Ceres parameter blocks are ``double[]`` and the accumulation
``t_w_curr = t_w_curr + q_w_curr * t_last_curr`` runs on Eigen doubles
(laser_odometry.cpp:524-525).  The device pipeline solves each frame in
f32, and VloamDriver rebases every frame's f32 delta onto
these f64 chains, so per-frame compose rounding does not random-walk into
the kilometre-scale world positions (at |t| ~ 2 km an f32 ulp is ~1e-4 m
per compose; VloamDriver tracks the realised divergence, ``f32_divergence_m``).

Same (x, y, z, w) quaternion layout and (7,) [q|t] pose layout as
``vloam_tpu_torch.geometry``; plain NumPy, f64, host-only.  A copy of
``vloam_tpu/geometry_np.py`` (tests check the two agree bit for bit).
"""

from __future__ import annotations

import numpy as np


def pose_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], np.float64)


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], np.float64)


def quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([-q[0], -q[1], -q[2], q[3]], np.float64)


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    # v' = v + 2 * qv x (qv x v + qw * v)
    qv = q[:3]
    t = 2.0 * np.cross(qv, v)
    return v + q[3] * t + np.cross(qv, t)


def pose_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    q = quat_normalize(quat_mul(a[:4], b[:4]))
    t = a[4:] + quat_rotate(a[:4], b[4:])
    return np.concatenate([q, t])


def pose_inverse(p: np.ndarray) -> np.ndarray:
    qc = quat_conj(p[:4])
    return np.concatenate([qc, -quat_rotate(qc, p[4:])])


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = quat_normalize(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def pose_to_matrix(p: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_matrix(p[:4])
    m[:3, 3] = p[4:]
    return m


def as_pose64(p) -> np.ndarray:
    """Any (7,) pose-like (CPU tensor or array, f32) -> f64 NumPy pose, renormalised."""
    p = np.asarray(p, np.float64)
    return np.concatenate([quat_normalize(p[:4]), p[4:]])
