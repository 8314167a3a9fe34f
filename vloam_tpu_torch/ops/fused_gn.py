"""Fused lidar Gauss-Newton solve (counterpart of
``vloam_tpu/ops/pallas_gn.solve_pose_gn_lidar``).

``solve_pose_gn_lidar`` runs all inner GN iterations of one solve in a
single launch of the CUDA kernel ``csrc/gn_lidar.cu`` for CUDA tensors, and
the plain PyTorch version, ``solve_pose_gn_lidar_reference`` (the jacfwd
solver over the lidar factors), for CPU tensors.  It never falls back from
one to the other.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops import lidar_factors
from vloam_tpu_torch.ops.gauss_newton import solve_pose_gn

LAUNCHES = 0  # kernel launches by solve_pose_gn_lidar (plain-version calls do not count)


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
