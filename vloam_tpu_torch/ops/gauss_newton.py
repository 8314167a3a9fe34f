"""Gauss-Newton / Levenberg-Marquardt on SE(3) (port of
``vloam_tpu/ops/gauss_newton.py``).

The Jacobian with respect to the local 6-DoF tangent delta comes from
``torch.func.jacfwd`` through ``pose_plus`` (where the reference uses
``jax.jacfwd``).  Huber weights act per residual block (Ceres semantics),
applied as IRLS weights sqrt(rho'(s)).  This is the plain version of the
fused CUDA GN kernel (``ops/fused_gn.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.ops.linalg3 import solve_spd_small


def huber_block_weight(sq_norm: torch.Tensor, delta: float) -> torch.Tensor:
    """sqrt(rho'(s)) for Huber: 1 inside, sqrt(delta/||r||) outside."""
    r = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
    return torch.where(r <= delta, 1.0, torch.sqrt(delta / r))


def normal_equations(r, J, w):
    """Weighted J^T J and J^T r.  r: (NR,), J: (NR, D), w: (NR,)."""
    Jw = J * w[:, None]
    rw = r * w
    return Jw.T @ Jw, Jw.T @ rw


def lm_step(jtj: torch.Tensor, jtr: torch.Tensor, lm_lambda: float) -> torch.Tensor:
    """Solve (J^T J + lambda diag(J^T J)) dx = -J^T r."""
    d = torch.diagonal(jtj)
    damped = jtj + torch.diag(lm_lambda * d + 1e-10)
    return solve_spd_small(damped, -jtr)


def pose_plus(pose: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Local update: q <- exp(dtheta) (x) q,  t <- t + dt.  delta = [dtheta, dt]."""
    dq = geo.angle_axis_to_quat(delta[:3])
    q = geo.quat_normalize(geo.quat_mul(dq, geo.pose_q(pose)))
    return geo.pose_from_qt(q, geo.pose_t(pose) + delta[3:])


def solve_pose_gn(
    residual_fn: Callable[[torch.Tensor], tuple],
    pose0: torch.Tensor,
    iters: int,
    huber_delta: float,
    lm_lambda: float,
) -> torch.Tensor:
    """Iterate GN on a 7-vector pose with 6-DoF tangent updates.

    ``residual_fn(pose)`` returns ``((res (B, Rdim), valid (B,)), ...)``.
    """
    pose = pose0
    for _ in range(iters):
        def local(delta, pose=pose):
            groups = residual_fn(pose_plus(pose, delta))
            return tuple(r for r, _ in groups), groups

        zero = torch.zeros(6, dtype=pose0.dtype, device=pose0.device)
        Js, groups = torch.func.jacfwd(local, has_aux=True)(zero)
        jtj = torch.zeros((6, 6), dtype=pose0.dtype, device=pose0.device)
        jtr = torch.zeros((6,), dtype=pose0.dtype, device=pose0.device)
        for J, (r, valid) in zip(Js, groups):
            # r: (B, Rdim), J: (B, Rdim, 6)
            sq = torch.sum(r * r, dim=-1)
            w_blk = huber_block_weight(sq, huber_delta) * valid.to(r.dtype)
            w = torch.repeat_interleave(w_blk, r.shape[-1])
            a, b = normal_equations(r.reshape(-1), J.reshape(-1, 6), w)
            jtj = jtj + a
            jtr = jtr + b
        pose = pose_plus(pose, lm_step(jtj, jtr, lm_lambda))
    return pose
