"""Pose-graph optimisation (port of ``vloam_tpu/parallel/pose_graph.py``).

Gauss-Newton over a window of poses with relative-pose factors (odometry
links, loop closures):

  r_ij = [ log_q( zq_ij^-1 (x) (q_i^-1 (x) q_j) ),  R_i^T (t_j - t_i) - zt_ij ]

All factors' residuals and Jacobians come from one ``torch.func.vmap`` of
``torch.func.jacfwd``.  Two solvers share that evaluation:

* ``optimize_pose_graph``: arbitrary graphs, the (6W, 6W) block system
  scatter-added and solved densely;
* ``optimize_pose_graph_banded``: a chain plus a few loop factors, solved by
  block-Thomas (block-LDL^T, two loops over the W blocks) on the
  block-tridiagonal chain system and the Woodbury identity for the loop
  factors, O(W * 6^3) an iteration.

Everything is float32, as in the reference, and no call checks its result on
the host (``torch.linalg.solve_ex``), so nothing here waits for the device.
Plain PyTorch: the reference computes this with no Pallas kernel.  With a
map mesh (``optimize_pose_graph(..., group=)``), each rank evaluates its
block of the factors and the normal equations are summed over the ranks,
as the reference's ``axis_name`` does over a device mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.parallel.mesh import psum


class PoseGraphFactors(NamedTuple):
    i: torch.Tensor         # (F,) int source pose index
    j: torch.Tensor         # (F,) int target pose index
    z: torch.Tensor         # (F, 7) measured i_T_j (maps j-frame points into i-frame)
    weight: torch.Tensor    # (F,) scalar information weight
    valid: torch.Tensor     # (F,) bool


def relative_pose_residual(pose_i, pose_j, z):
    """(..., 6) residual of a factor."""
    rel = geo.pose_compose(geo.pose_inverse(pose_i), pose_j)
    dq = geo.quat_mul(geo.quat_conj(z[..., :4]), rel[..., :4])
    return torch.cat([geo.quat_to_angle_axis(dq), rel[..., 4:] - z[..., 4:]], dim=-1)


def _plus(p, d):
    """Left-multiplicative local update: d = (omega, dt) applied to pose p."""
    dq = geo.angle_axis_to_quat(d[..., :3])
    return geo.pose_from_qt(geo.quat_normalize(geo.quat_mul(dq, p[..., :4])),
                            p[..., 4:] + d[..., 3:])


def _eval_factors(poses, factors: PoseGraphFactors, huber_delta: float):
    """Huber-weighted residuals and Jacobians of every factor.

    Returns (Jf (F, 6, 12), rf (F, 6)); columns 0:6 of Jf differentiate the
    local update of pose i, columns 6:12 of pose j.  Invalid factors weigh 0."""
    F = factors.i.shape[0]
    if F == 0:
        return poses.new_zeros((0, 6, 12)), poses.new_zeros((0, 6))
    zero = torch.zeros(12, dtype=poses.dtype, device=poses.device)

    def one_factor(pi, pj, z):
        def local(d):
            r = relative_pose_residual(_plus(pi, d[:6]), _plus(pj, d[6:]), z)
            return r, r

        return torch.func.jacfwd(local, has_aux=True)(zero)

    Jf, r = torch.func.vmap(one_factor)(poses[factors.i], poses[factors.j], factors.z)
    # forward-mode AD can promote a tangent to float64 (a division's, on some
    # PyTorch builds); the values are those of the float32 primal
    Jf = Jf.to(poses.dtype)
    sq = torch.sum(r * r, dim=-1)
    w = torch.where(sq > huber_delta**2, huber_delta / torch.sqrt(sq + 1e-12), 1.0)
    w = w * factors.weight * factors.valid.to(poses.dtype)
    return Jf * w[:, None, None], r * w[:, None]


def _solve(A, b):
    """A^-1 b without a check on the host (b may be a matrix)."""
    return torch.linalg.solve_ex(A, b).result


def optimize_pose_graph(
    poses: torch.Tensor,            # (W, 7)
    factors: PoseGraphFactors,
    iters: int = 5,
    lm_lambda: float = 1e-5,
    huber_delta: float = 0.5,
    group=None,
) -> torch.Tensor:
    """GN/LM over the window; pose 0 is gauge-fixed with a strong prior.

    ``group`` (a ``parallel.mesh.MapMesh``): ``factors`` is this rank's block
    of the factors (padding factors invalid), and JtJ and Jtr are summed over
    the ranks (one ``all_reduce`` an iteration), so every rank solves the
    same system."""
    W = poses.shape[0]
    D = 6 * W
    fi, fj = factors.i.long(), factors.j.long()
    for _ in range(iters):
        Jf, rf = _eval_factors(poses, factors, huber_delta)   # (F, 6, 12), (F, 6)
        Ji, Jj = Jf[:, :, :6], Jf[:, :, 6:]
        jtj_ij = torch.einsum("fri,frj->fij", Ji, Jj)
        JtJ = torch.zeros((W, W, 6, 6), dtype=poses.dtype, device=poses.device)
        JtJ.index_put_((fi, fi), torch.einsum("fri,frj->fij", Ji, Ji), accumulate=True)
        JtJ.index_put_((fi, fj), jtj_ij, accumulate=True)
        JtJ.index_put_((fj, fi), jtj_ij.transpose(-1, -2), accumulate=True)
        JtJ.index_put_((fj, fj), torch.einsum("fri,frj->fij", Jj, Jj), accumulate=True)
        Jtr = torch.zeros((W, 6), dtype=poses.dtype, device=poses.device)
        Jtr.index_add_(0, fi, torch.einsum("fri,fr->fi", Ji, rf))
        Jtr.index_add_(0, fj, torch.einsum("fri,fr->fi", Jj, rf))
        if group is not None:
            both = psum(torch.cat([JtJ.reshape(-1), Jtr.reshape(-1)]), group)
            JtJ, Jtr = both[:JtJ.numel()].reshape(JtJ.shape), both[JtJ.numel():].reshape(W, 6)

        A = JtJ.permute(0, 2, 1, 3).reshape(D, D)
        gauge = torch.zeros(D, dtype=poses.dtype, device=poses.device)
        gauge[:6] = 1e6                                        # prior on pose 0
        A = A + torch.diag(gauge)
        A = A + torch.diag(lm_lambda * torch.diagonal(A) + 1e-8)
        delta = _solve(A, -Jtr.reshape(D, 1))[:, 0].reshape(W, 6)
        poses = _plus(poses, delta)
    return poses


def _block_thomas_solve(diag, upper, rhs):
    """Solve the SPD block-tridiagonal system T x = rhs for several RHS.

    diag (W, 6, 6) are the diagonal blocks, upper (W-1, 6, 6) the (w, w+1)
    blocks, rhs (W, 6, R).  Block-LDL^T: a forward Schur recursion
    S_w = D_w - U_{w-1}^T S_{w-1}^-1 U_{w-1} with substitution, then a
    backward substitution, each a loop over the W blocks."""
    W = diag.shape[0]
    eye = torch.eye(6, dtype=diag.dtype, device=diag.device)
    sinv, ys = [], []
    for w in range(W):
        if w == 0:
            S, b = diag[0], rhs[0]
        else:
            U = upper[w - 1]
            S = diag[w] - U.T @ sinv[-1] @ U
            b = rhs[w] - U.T @ ys[-1]
        sinv.append(_solve(S, eye))
        ys.append(sinv[-1] @ b)
    xs = [ys[-1]]
    for w in range(W - 2, -1, -1):
        xs.append(ys[w] - sinv[w] @ (upper[w] @ xs[-1]))
    return torch.stack(xs[::-1])


def optimize_pose_graph_banded(
    poses: torch.Tensor,                        # (W, 7)
    chain_factors: PoseGraphFactors,            # contract: j == i + 1 elementwise
    loop: PoseGraphFactors | None = None,       # few factors, arbitrary (i, j)
    iters: int = 5,
    lm_lambda: float = 1e-5,
    huber_delta: float = 0.5,
) -> torch.Tensor:
    """GN over a chain-plus-loops graph, exploiting its structure.

    ``chain_factors`` MUST connect consecutive poses (j == i + 1; several
    chains over the same poses are fine).  Their JtJ is block-tridiagonal
    and solves by block-Thomas.  ``loop`` factors (L of them) add
    JtJ_loop = U U^T with U a (6W, 6L) sparse matrix, folded in by the
    Woodbury identity

      (T + U U^T)^-1 b = T^-1 b - T^-1 U (I + U^T T^-1 U)^-1 U^T T^-1 b,

    one multi-RHS block-Thomas solve with 6L extra columns plus a (6L, 6L)
    dense solve.  The result matches ``optimize_pose_graph`` on the same
    factor set (the same Huber weights, gauge prior on pose 0, and LM damping
    from the full system diagonal including the loop blocks)."""
    W = poses.shape[0]
    dtype, dev = poses.dtype, poses.device
    if loop is not None and loop.i.shape[0] == 0:
        loop = None
    ci, cj = chain_factors.i.long(), chain_factors.j.long()
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    for _ in range(iters):
        Jf, rf = _eval_factors(poses, chain_factors, huber_delta)
        Ji, Jj = Jf[:, :, :6], Jf[:, :, 6:]
        diag = torch.zeros((W, 6, 6), dtype=dtype, device=dev)
        diag.index_add_(0, ci, torch.einsum("fri,frj->fij", Ji, Ji))
        diag.index_add_(0, cj, torch.einsum("fri,frj->fij", Jj, Jj))
        upper = torch.zeros((W - 1, 6, 6), dtype=dtype, device=dev)
        upper.index_add_(0, ci, torch.einsum("fri,frj->fij", Ji, Jj))
        b = torch.zeros((W, 6), dtype=dtype, device=dev)
        b.index_add_(0, ci, torch.einsum("fri,fr->fi", Ji, rf))
        b.index_add_(0, cj, torch.einsum("fri,fr->fi", Jj, rf))

        if loop is not None:
            li, lj = loop.i.long(), loop.j.long()
            Jl, rl = _eval_factors(poses, loop, huber_delta)
            Li, Lj = Jl[:, :, :6], Jl[:, :, 6:]      # (L, 6, 6)
            b.index_add_(0, li, torch.einsum("lri,lr->li", Li, rl))
            b.index_add_(0, lj, torch.einsum("lri,lr->li", Lj, rl))

        # gauge prior on pose 0, then LM damping from the FULL diagonal
        # (chain + gauge + loop blocks): exactly the dense solver's damping
        diag[0] += 1e6 * eye6
        full_diag = torch.diagonal(diag, dim1=1, dim2=2).clone()   # (W, 6)
        if loop is not None:
            full_diag.index_add_(0, li, torch.sum(Li * Li, dim=1))
            full_diag.index_add_(0, lj, torch.sum(Lj * Lj, dim=1))
        diag = diag + torch.diag_embed(lm_lambda * full_diag + 1e-8)

        if loop is None:
            delta = _block_thomas_solve(diag, upper, (-b)[..., None])[..., 0]
            poses = _plus(poses, delta)
            continue

        L = li.shape[0]
        # dense form of the sparse U: U[p, a, 6l + r] = J_l[r, a] at p = i_l, j_l
        r6 = torch.arange(6, device=dev)
        cols = (torch.arange(L, device=dev) * 6)[:, None, None] + r6[None, None, :]   # (L, 1, 6)
        rows = r6[None, :, None]
        U = torch.zeros((W, 6, 6 * L), dtype=dtype, device=dev)
        U.index_put_((li[:, None, None], rows, cols), Li.transpose(1, 2), accumulate=True)
        U.index_put_((lj[:, None, None], rows, cols), Lj.transpose(1, 2), accumulate=True)

        X = _block_thomas_solve(diag, upper, torch.cat([(-b)[..., None], U], dim=-1))
        x0 = X[..., 0]      # T^-1 (-b)     (W, 6)
        Z = X[..., 1:]      # T^-1 U        (W, 6, 6L)

        def Ut(Y):
            """U^T @ Y for Y of shape (W, 6) or (W, 6, K)."""
            out = (torch.einsum("lra,la...->lr...", Li, Y[li])
                   + torch.einsum("lra,la...->lr...", Lj, Y[lj]))
            return out.reshape((6 * L,) + tuple(Y.shape[2:]))

        M = torch.eye(6 * L, dtype=dtype, device=dev) + Ut(Z)
        w = _solve(M, Ut(x0)[:, None])[:, 0]
        poses = _plus(poses, x0 - torch.einsum("wak,k->wa", Z, w))
    return poses


def odometry_factors(deltas: torch.Tensor, weight: float = 1.0) -> PoseGraphFactors:
    """Chain factors from frame-to-frame deltas: z_k = k_T_{k+1}."""
    F, dev = deltas.shape[0], deltas.device
    return PoseGraphFactors(
        i=torch.arange(F, dtype=torch.int64, device=dev),
        j=torch.arange(1, F + 1, dtype=torch.int64, device=dev),
        z=deltas,
        weight=torch.full((F,), weight, dtype=torch.float32, device=dev),
        valid=torch.ones((F,), dtype=torch.bool, device=dev),
    )


def concat_factors(*fs: PoseGraphFactors) -> PoseGraphFactors:
    return PoseGraphFactors(*[torch.cat(parts) for parts in zip(*fs)])
