"""Fused Gauss-Newton solves (counterparts of
``vloam_tpu/ops/pallas_gn.solve_pose_gn_lidar`` and ``solve_pose_gn_vo``).

Each wrapper runs all inner GN iterations of one solve in a single launch
of its CUDA kernel for CUDA tensors (``csrc/gn_lidar.cu``, ``csrc/gn_vo.cu``)
and its plain PyTorch version, the jacfwd solver over the same residuals
(``solve_pose_gn_lidar_reference``, ``solve_pose_gn_vo_reference``), for CPU
tensors.  Neither falls back from one to the other.
``solve_pose_gn_lidar_batched`` runs a batch of independent lidar solves
(loop closure's seeds) in one launch of the same kernel, one thread-block
cluster each; ``solve_pose_gn_lidar`` is its batch of one.

The kernels read the factor arrays as the call sites make them: (B, 3) and
(B, 2) float32 rows at any row stride (the points are (B, 4)[:, :3] views),
(B,) arrays at any stride, bool masks as bytes.  ``lidar_layout`` and
``vo_layout`` check that and return the row strides, so a wrapper issues no
PyTorch operation before its launch but the output's ``torch.empty``.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import kernels
from vloam_tpu_torch.ops import lidar_factors, vo_factors
from vloam_tpu_torch.ops.gauss_newton import solve_pose_gn

LAUNCHES = 0     # kernel launches by solve_pose_gn_lidar (plain-version calls do not count)
LAUNCHES_VO = 0  # kernel launches by solve_pose_gn_vo
LAUNCHES_BATCHED = 0  # kernel launches by solve_pose_gn_lidar_batched


def _strides(name, specs):
    """Row strides (elements) of the arrays in ``specs`` = ((label, tensor,
    shape, dtype), ...), checked against what the kernel reads: one device,
    the dtype, the shape, and unit stride along the last dim of a 2-D array.
    Raises ValueError on anything else."""
    dev = specs[0][1].device
    strides = []
    for label, t, shape, dtype in specs:   # one test per array; a message only on failure
        st = t.stride()
        if (t.device != dev or t.dtype != dtype or t.shape != shape
                or (len(shape) == 2 and st[1] != 1 and t.numel())):
            raise ValueError(f"{name}: {label} must be {dtype} of shape {shape} on {dev}, with "
                             f"unit stride along its last dim; got {t.dtype} of shape "
                             f"{tuple(t.shape)} on {t.device}, strides {st}")
        strides.append(st[0])
    return strides


def lidar_layout(pose0, edge, plane):
    """The lidar kernel's view of its arguments: (arrays, row strides, Be,
    Bs), the arrays in its order pose0, ep, ea, eb, ev, pp, pn, pd, pv."""
    ep, ea, eb, ev = edge
    pp, pn, pd, pv = plane
    be, bs = ep.shape[0], pp.shape[0]
    f32, b8 = torch.float32, torch.bool
    arrays = (pose0, ep, ea, eb, ev, pp, pn, pd, pv)
    strides = _strides("solve_pose_gn_lidar", (
        ("pose0", pose0, (7,), f32), ("edge p", ep, (be, 3), f32), ("edge a", ea, (be, 3), f32),
        ("edge b", eb, (be, 3), f32), ("edge valid", ev, (be,), b8),
        ("plane p", pp, (bs, 3), f32), ("plane n", pn, (bs, 3), f32),
        ("plane d", pd, (bs,), f32), ("plane valid", pv, (bs,), b8)))
    return arrays, strides, be, bs


def lidar_batched_layout(pose0, edge, plane):
    """The batched lidar kernel's view of its arguments: (arrays, row
    strides, batch strides, S, Be, Bs), the arrays in the order of
    ``lidar_layout``, each with a leading batch axis of S >= 1 problems at any
    batch stride (0 shares one array among all of them).  Problem 0 is
    checked by ``lidar_layout``; raises ValueError on anything the kernel does
    not read."""
    arrays = (pose0, *edge, *plane)
    S = pose0.shape[0] if pose0.dim() == 2 else -1
    if S < 1 or any(t.dim() < 2 or t.shape[0] != S for t in arrays):
        raise ValueError(f"solve_pose_gn_lidar_batched: every array needs the leading batch axis "
                         f"of pose0 (S, 7), S >= 1; got shapes "
                         f"{[tuple(t.shape) for t in arrays]}")
    _, strides, be, bs = lidar_layout(pose0[0], tuple(x[0] for x in edge),
                                      tuple(x[0] for x in plane))
    return arrays, strides, [t.stride(0) for t in arrays], S, be, bs


def vo_layout(pose0, X0, xb0, xb1, has_depth, no_depth):
    """The VO kernel's view of its arguments: (arrays, row strides, M), the
    arrays in its order pose0, X0, xb0, xb1, has_depth, no_depth."""
    m = X0.shape[0]
    f32, b8 = torch.float32, torch.bool
    arrays = (pose0, X0, xb0, xb1, has_depth, no_depth)
    strides = _strides("solve_pose_gn_vo", (
        ("pose0", pose0, (7,), f32), ("X0", X0, (m, 3), f32), ("xb0", xb0, (m, 2), f32),
        ("xb1", xb1, (m, 2), f32), ("has_depth", has_depth, (m,), b8),
        ("no_depth", no_depth, (m,), b8)))
    return arrays, strides, m


def _pointers(name, arrays, strides):
    """(pointer, stride) pairs, flat, of arrays on one CUDA device."""
    if arrays[0].device.type != "cuda":
        raise ValueError(f"{name}: all inputs must be on one CUDA device, got {arrays[0].device}")
    return [v for a, s in zip(arrays, strides) for v in (a.data_ptr(), s)]


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


def _launch_lidar(name, S, arrays, strides, batch_strides, be, bs, iters, huber_delta,
                  lm_lambda, out):
    """One launch of the lidar kernel: S problems, one cluster each, problem
    k's arrays ``k * batch_strides`` elements past the first's."""
    p = [v for a, s, b in zip(_pointers(name, arrays, strides)[::2], strides, batch_strides)
         for v in (a, s, b)]
    rc = kernels.lib().vloam_gn_lidar(
        S, *p[:15], be, *p[15:], bs, iters, float(huber_delta), float(lm_lambda),
        out.data_ptr(), 7, kernels.stream_ptr(out.device),
    )
    kernels.check(rc, name)


def solve_pose_gn_lidar(pose0, edge, plane, iters, huber_delta, lm_lambda):
    """pose0 (7,); edge = (p (Be,3), a (Be,3), b (Be,3), valid (Be,));
    plane = (p (Bs,3), n (Bs,3), d (Bs,), valid (Bs,)).  Returns the pose."""
    global LAUNCHES
    if pose0.device.type == "cpu":
        return solve_pose_gn_lidar_reference(pose0, edge, plane, iters, huber_delta, lm_lambda)
    arrays, strides, be, bs = lidar_layout(pose0, edge, plane)
    out = torch.empty(7, dtype=torch.float32, device=pose0.device)
    _launch_lidar("solve_pose_gn_lidar", 1, arrays, strides, [0] * len(arrays), be, bs, iters,
                  huber_delta, lm_lambda, out)
    LAUNCHES += 1
    return out


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
    global LAUNCHES_BATCHED
    if pose0.device.type == "cpu":
        return solve_pose_gn_lidar_batched_reference(pose0, edge, plane, iters, huber_delta,
                                                     lm_lambda)
    arrays, strides, batch_strides, S, be, bs = lidar_batched_layout(pose0, edge, plane)
    out = torch.empty((S, 7), dtype=torch.float32, device=pose0.device)
    _launch_lidar("solve_pose_gn_lidar_batched", S, arrays, strides, batch_strides, be, bs,
                  iters, huber_delta, lm_lambda, out)
    LAUNCHES_BATCHED += 1
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
    arrays, strides, m = vo_layout(pose0, X0, xb0, xb1, has_depth, no_depth)
    ptrs = _pointers("solve_pose_gn_vo", arrays, strides)
    out = torch.empty(7, dtype=torch.float32, device=pose0.device)
    rc = kernels.lib().vloam_gn_vo(
        *ptrs, m, iters, float(huber_delta), float(lm_lambda), out.data_ptr(),
        kernels.stream_ptr(pose0.device),
    )
    kernels.check(rc, "solve_pose_gn_vo")
    LAUNCHES_VO += 1
    return out
