"""Gauss-Newton solves (counterparts of
``vloam_tpu/ops/pallas_gn.solve_pose_gn_lidar`` and ``solve_pose_gn_vo``).

In this copy each wrapper is its plain PyTorch version on every device: the
jacfwd solver over the same residuals (``solve_pose_gn_lidar_reference``,
``solve_pose_gn_vo_reference``); ``solve_pose_gn_lidar_batched`` loops the
single solve over the batch.
"""

from __future__ import annotations

import torch

from plainref.ops import lidar_factors, vo_factors
from plainref.ops.gauss_newton import solve_pose_gn


def solve_pose_gn_lidar_reference(pose0, edge, plane, iters, huber_delta, lm_lambda):
    """Plain PyTorch version: ``solve_pose_gn`` over the edge and plane
    residuals."""
    ep, ea, eb, ev = edge
    pp, pn, pd, pv = plane

    def residuals(p):
        return (
            (lidar_factors.edge_residual(p, ep, ea, eb), ev),
            (lidar_factors.plane_residual(p, pp, pn, pd), pv),
        )

    return solve_pose_gn(residuals, pose0, iters, huber_delta, lm_lambda)


def solve_pose_gn_lidar(pose0, edge, plane, iters, huber_delta, lm_lambda):
    """pose0 (7,); edge = (p (Be,3), a (Be,3), b (Be,3), valid (Be,));
    plane = (p (Bs,3), n (Bs,3), d (Bs,), valid (Bs,)).  Returns the pose."""
    return solve_pose_gn_lidar_reference(pose0, edge, plane, iters, huber_delta, lm_lambda)


def solve_pose_gn_lidar_batched_reference(pose0, edge, plane, iters, huber_delta, lm_lambda):
    """Plain PyTorch version of the batched solve: the plain version of one
    solve, looped over the batch."""
    return torch.stack([
        solve_pose_gn_lidar_reference(pose0[k], tuple(x[k] for x in edge),
                                      tuple(x[k] for x in plane), iters, huber_delta, lm_lambda)
        for k in range(pose0.shape[0])])


def solve_pose_gn_lidar_batched(pose0, edge, plane, iters, huber_delta, lm_lambda):
    """S >= 1 independent lidar solves in one launch (the counterpart of
    ``jax.vmap`` of the reference's ``solve_pose_gn_lidar``: one cluster of
    the kernel per problem).  pose0 (S, 7); edge = (p, a, b (S, Be, 3),
    valid (S, Be)); plane = (p, n (S, Bs, 3), d, valid (S, Bs)); any batch
    stride, 0 included (``expand``).  Returns the poses (S, 7)."""
    return solve_pose_gn_lidar_batched_reference(pose0, edge, plane, iters, huber_delta,
                                                 lm_lambda)


def solve_pose_gn_vo_reference(pose0, X0, xb0, xb1, has_depth, no_depth, iters, huber_delta,
                               lm_lambda):
    """Plain PyTorch version: ``solve_pose_gn`` over the 3D-2D reprojection
    residual (where ``has_depth``) and the 2D-2D epipolar one (where
    ``no_depth``), as pallas_gn.py:314-324."""
    def residuals(p):
        return (
            (vo_factors.reproj_32_residual(p, X0, xb1), has_depth),
            (vo_factors.epipolar_22_residual(p, xb0, xb1), no_depth),
        )

    return solve_pose_gn(residuals, pose0, iters, huber_delta, lm_lambda)


def solve_pose_gn_vo(pose0, X0, xb0, xb1, has_depth, no_depth, iters, huber_delta, lm_lambda):
    """pose0 (7,); X0 (M, 3) unprojected previous-frame points; xb0, xb1
    (M, 2) previous and current normalised rays; has_depth, no_depth (M,)
    bool masks.  Returns the pose cam0_curr_T_cam0_last."""
    return solve_pose_gn_vo_reference(pose0, X0, xb0, xb1, has_depth, no_depth, iters,
                                      huber_delta, lm_lambda)
