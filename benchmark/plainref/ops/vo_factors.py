"""Visual odometry residual blocks (port of ``vloam_tpu/ops/vo_factors.py``).

The two residuals the VO solve uses (visual_odometry.cpp:400-474): the 3D-2D
reprojection for matches whose previous-frame pixel has lidar depth, and the
2D-2D epipolar constraint otherwise.  The 3D-3D (``CostFunctor33``) and
2D-3D (``CostFunctor23``) forms are dead code in the reference (its branches
using them are commented out at visual_odometry.cpp:374-451) and have no
caller here either.  The pose maps previous-camera coordinates into
current-camera coordinates (cam0_curr_T_cam0_last).
"""

from __future__ import annotations

import torch

from plainref import geometry as geo


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


def point_33_residual(pose: torch.Tensor, X0: torch.Tensor, X1: torch.Tensor) -> torch.Tensor:
    """(B, 3) 3D-3D point residual r = (R X0 + t) - X1 (``CostFunctor33``,
    ceres_cost_function.h:10-56)."""
    return geo.pose_apply(pose, X0) - X1


def inverse_23_residual(pose: torch.Tensor, xbar0: torch.Tensor, X1: torch.Tensor) -> torch.Tensor:
    """(B, 2) 2D-3D inverse reprojection (``CostFunctor23``,
    ceres_cost_function.h:102-149): Y = R^T (X1 - t), r = [Yx - Yz x0bar,
    Yy - Yz y0bar]: the current frame's 3D point pulled back into the previous
    frame and compared with the previous frame's normalised pixel."""
    Y = geo.pose_apply(geo.pose_inverse(pose), X1)
    return torch.stack(
        [Y[..., 0] - Y[..., 2] * xbar0[..., 0], Y[..., 1] - Y[..., 2] * xbar0[..., 1]], dim=-1)
