"""Lidar residual blocks (port of ``vloam_tpu/ops/lidar_factors.py``).

* edge (point-to-line), 3-dim:  r = (lp - a) x (lp - b) / |a - b|
* plane (point-to-plane via unit normal), 1-dim:  r = n . lp + d
with lp = R(q) p + t.  The distortion-aware ``*_interp`` forms are not
ported yet (see ROADMAP, off-main-path features).
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import geometry as geo


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
