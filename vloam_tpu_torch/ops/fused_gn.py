"""Fused Gauss-Newton solves (counterparts of
``vloam_tpu/ops/pallas_gn.solve_pose_gn_lidar`` and ``solve_pose_gn_vo``).

Each wrapper runs all inner GN iterations of one solve in a single launch
of its CUDA kernel for CUDA tensors (``csrc/gn_lidar.cu``, ``csrc/gn_vo.cu``)
and its plain PyTorch version, the jacfwd solver over the same residuals
(``solve_pose_gn_lidar_reference``, ``solve_pose_gn_vo_reference``), for CPU
tensors.  Neither falls back from one to the other.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops import lidar_factors, vo_factors
from vloam_tpu_torch.ops.gauss_newton import solve_pose_gn

LAUNCHES = 0     # kernel launches by solve_pose_gn_lidar (plain-version calls do not count)
LAUNCHES_VO = 0  # kernel launches by solve_pose_gn_vo


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
    global LAUNCHES
    if pose0.device.type == "cpu":
        return solve_pose_gn_lidar_reference(pose0, edge, plane, iters, huber_delta, lm_lambda)
    ep, ea, eb, ev = edge
    pp, pn, pd, pv = plane
    kernels.require_cuda("solve_pose_gn_lidar", pose0, ep, ea, eb, ev, pp, pn, pd, pv)
    # iteration-invariant edge constants: r = lp x c + k (pallas_gn.py:394-397)
    c = ea - eb
    inv = 1.0 / torch.clamp(torch.linalg.vector_norm(c, dim=-1, keepdim=True), min=1e-10)
    ch = c * inv
    ek = torch.linalg.cross(ea, eb, dim=-1) * inv
    ed = torch.cat([ep.T, ch.T, ek.T, ev.to(torch.float32)[None]], dim=0).contiguous()
    pl = torch.cat([pp.T, pn.T, pd[None], pv.to(torch.float32)[None]], dim=0).contiguous()
    pose0 = pose0.to(torch.float32).contiguous()
    out = torch.empty(7, dtype=torch.float32, device=pose0.device)
    rc = kernels.lib().vloam_gn_lidar(
        pose0.data_ptr(), ed.data_ptr(), ed.shape[1], pl.data_ptr(), pl.shape[1],
        iters, float(huber_delta), float(lm_lambda), out.data_ptr(),
        kernels.stream_ptr(pose0.device),
    )
    kernels.check(rc, "solve_pose_gn_lidar")
    LAUNCHES += 1
    return out


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
    global LAUNCHES_VO
    if pose0.device.type == "cpu":
        return solve_pose_gn_vo_reference(pose0, X0, xb0, xb1, has_depth, no_depth, iters,
                                          huber_delta, lm_lambda)
    kernels.require_cuda("solve_pose_gn_vo", pose0, X0, xb0, xb1, has_depth, no_depth)
    m = X0.shape[0]
    if (X0.shape != (m, 3) or xb0.shape != (m, 2) or xb1.shape != (m, 2)
            or has_depth.shape != (m,) or no_depth.shape != (m,)):
        raise ValueError("solve_pose_gn_vo: want X0 (M, 3), xb0 and xb1 (M, 2), masks (M,)")
    # one SoA (9, M) array: X0 xyz, xb0 xy, xb1 xy, has_depth, no_depth
    soa = torch.cat([X0.T, xb0.T, xb1.T, has_depth.to(torch.float32)[None],
                     no_depth.to(torch.float32)[None]], dim=0).to(torch.float32).contiguous()
    pose0 = pose0.to(torch.float32).contiguous()
    out = torch.empty(7, dtype=torch.float32, device=pose0.device)
    rc = kernels.lib().vloam_gn_vo(
        pose0.data_ptr(), soa.data_ptr(), soa.shape[1], iters, float(huber_delta),
        float(lm_lambda), out.data_ptr(), kernels.stream_ptr(pose0.device),
    )
    kernels.check(rc, "solve_pose_gn_vo")
    LAUNCHES_VO += 1
    return out
