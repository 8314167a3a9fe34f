"""Visual odometry residual blocks (port of ``vloam_tpu/ops/vo_factors.py``).

The two residuals the VO solve uses (visual_odometry.cpp:400-474): the 3D-2D
reprojection for matches whose previous-frame pixel has lidar depth, and the
2D-2D epipolar constraint otherwise.  The pose maps previous-camera
coordinates into current-camera coordinates (cam0_curr_T_cam0_last).  The
reference's unused 3D-3D and 2D-3D forms are not ported (ROADMAP A9).
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import geometry as geo


def reproj_32_residual(pose: torch.Tensor, X0: torch.Tensor, xbar1: torch.Tensor) -> torch.Tensor:
    """(B, 2): r = [(R X0 + t)_x - (R X0 + t)_z * xbar, ..._y - ..._z * ybar]."""
    Y = geo.pose_apply(pose, X0)
    return torch.stack(
        [Y[..., 0] - Y[..., 2] * xbar1[..., 0], Y[..., 1] - Y[..., 2] * xbar1[..., 1]], dim=-1)


def epipolar_22_residual(pose: torch.Tensor, xbar0: torch.Tensor, xbar1: torch.Tensor) -> torch.Tensor:
    """(B, 1): r = X1_bar . (t x (R X0_bar)), the essential-matrix constraint."""
    X0 = torch.cat([xbar0, torch.ones_like(xbar0[..., :1])], dim=-1)
    X1 = torch.cat([xbar1, torch.ones_like(xbar1[..., :1])], dim=-1)
    RX0 = geo.quat_rotate(pose[..., :4], X0)
    t = pose[..., 4:7].expand(RX0.shape)
    return torch.sum(X1 * torch.linalg.cross(t, RX0, dim=-1), dim=-1, keepdim=True)
