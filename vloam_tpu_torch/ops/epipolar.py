"""Essential-matrix RANSAC and relative-pose recovery, every hypothesis at
once (port of ``vloam_tpu/ops/epipolar.py``).

Parity target: ``VisualOdometry::solveRANSAC`` (reference
visual_odometry.cpp:234-299): OpenCV ``findEssentialMat`` (RANSAC, 1 px
threshold) followed by ``recoverPose``.  Instead of a sequential
hypothesise-and-test loop, all hypotheses are solved in one batch: one
(H, 9, 9) eigendecomposition for the 8-point null vectors, one (H, 3, 3) SVD
onto the essential manifold, one (H, N) Sampson-distance pass that scores
every hypothesis against every match, and a cheirality vote over the four
(R, t) decompositions of the winner.

The minimal samples are the reference's own: ``ops/threefry`` reproduces its
Gumbel draw exactly, so the same seed and shape give the same sample
indices.  Eigenvector and singular-vector signs are arbitrary and differ
between LAPACK, cuSOLVER and XLA; E is defined up to sign, and neither the
Sampson errors nor the cheirality vote depend on it.  The winner and its
inliers stay on the device (no ``argmax`` is read back); the batched
``eigh`` and ``svd`` check their convergence on the host on a GPU.  The
decompositions run in float64, the rest in float32 as in the reference.
"""

from __future__ import annotations

import torch

from vloam_tpu_torch import geometry as geo
from vloam_tpu_torch.models.visual_odometry import inv3
from vloam_tpu_torch.ops import threefry


def _homogeneous(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _normalize(uv: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> normalised camera coords (x, y) with z = 1."""
    X = _homogeneous(uv) @ K_inv.T
    return X[..., :2] / torch.clamp(X[..., 2:3], min=1e-9)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (elementwise, no LU)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def eight_point(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Batched 8-point essential matrix.

    x0, x1: (H, 8, 2) normalised coords in the two views.  Returns (H, 3, 3)
    essential matrices with x1h^T E x0h = 0, projected onto the essential
    manifold (singular values 1, 1, 0)."""
    a0, b0 = x0[..., 0], x0[..., 1]
    a1, b1 = x1[..., 0], x1[..., 1]
    # row of A per match: [x1*x0, x1*y0, x1, y1*x0, y1*y0, y1, x0, y0, 1]
    A = torch.stack([a1 * a0, a1 * b0, a1, b1 * a0, b1 * b0, b1, a0, b0, torch.ones_like(a0)],
                    dim=-1)                                    # (H, 8, 9)
    # null vector of A = eigenvector of A^T A with the smallest eigenvalue, in
    # float64: the two smallest eigenvalues lie 1e-11..1e-5 of the largest apart
    # (the coords are normalised by K alone), and the card's batched float32
    # eigh lost the null vector of well-posed samples there
    A = A.double()
    _, vecs = torch.linalg.eigh(torch.einsum("hni,hnj->hij", A, A))   # ascending
    E = vecs[..., 0].reshape(*vecs.shape[:-2], 3, 3)
    U, _, Vt = torch.linalg.svd(E)
    # singular values -> (1, 1, 0)
    return (U[..., :, :2] @ Vt[..., :2, :]).to(x0.dtype)


def sampson_error(E: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance.  E: (H, 3, 3); x0, x1: (N, 2) -> (H, N)."""
    x0h, x1h = _homogeneous(x0), _homogeneous(x1)
    Ex0 = torch.einsum("hij,nj->hni", E, x0h)                  # (H, N, 3)
    Etx1 = torch.einsum("hji,nj->hni", E, x1h)                 # E^T x1
    num = torch.einsum("ni,hni->hn", x1h, Ex0) ** 2            # (x1^T E x0)^2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def ransac_samples(mask: torch.Tensor, n_hypotheses: int, seed: int) -> torch.Tensor:
    """(H, 8) indices of the reference's minimal samples: per hypothesis the
    8 valid matches with the largest Gumbel draw (``ops/threefry``)."""
    keys = threefry.device_keys(seed, n_hypotheses, mask.shape[0], mask.device)
    return threefry.select_samples(keys, mask)


def find_essential_ransac(uv0, uv1, mask, K, n_hypotheses: int = 256, thresh_px: float = 1.0,
                          seed: int = 0):
    """RANSAC essential matrix from (N, 2) pixel matches ``uv0`` -> ``uv1``
    with valid-match mask ``mask`` (N,) and intrinsics ``K`` (3, 3).

    Returns (E (3, 3), inlier mask (N,)); the inlier count decides the
    winner (cv::findEssentialMat, reference visual_odometry.cpp:254)."""
    K_inv = inv3(K)
    x0, x1 = _normalize(uv0, K_inv), _normalize(uv1, K_inv)
    idx = ransac_samples(mask, n_hypotheses, seed)
    E = eight_point(x0[idx], x1[idx])
    # threshold in normalised coords: px / focal length
    f = 0.5 * (K[0, 0] + K[1, 1])
    err = sampson_error(E, x0, x1)                             # (H, N)
    inl = (err < (thresh_px / f) ** 2) & mask[None, :]
    best = torch.argmax(inl.sum(dim=1))[None]                  # stays on the device
    return E[best][0], inl[best][0]


def _triangulate_depth(R, t, x0h, x1h):
    """Depth of each point in both cameras for candidates (R (C, 3, 3), t (C, 3)).

    x1 x (d0 R x0 + t) = 0  =>  d0 = -(x1 x t) . (x1 x R x0) / |x1 x R x0|^2
    (x0h, x1h are (N, 3) homogeneous rays).  Returns (d0, z1), each (C, N)."""
    Rx0 = torch.einsum("cij,nj->cni", R, x0h)
    x1b = x1h.expand(Rx0.shape)
    c1 = torch.linalg.cross(x1b, t[:, None, :].expand(Rx0.shape), dim=-1)
    c2 = torch.linalg.cross(x1b, Rx0, dim=-1)
    d0 = -torch.sum(c1 * c2, dim=-1) / torch.clamp(torch.sum(c2 * c2, dim=-1), min=1e-12)
    return d0, d0 * Rx0[..., 2] + t[:, 2:3]


def recover_pose(E, x0, x1, mask):
    """The (R, t) of E's four decompositions that puts most points in front
    of both cameras.  x0, x1: (N, 2) normalised coords.  Returns (pose (7,)
    = curr_T_last with unit-norm translation, n_good), cv::recoverPose
    semantics (reference visual_odometry.cpp:258)."""
    U, _, Vt = torch.linalg.svd(E.double())
    # keep the rotations proper
    U = (U * torch.sign(_det3(U))).to(E.dtype)
    Vt = (Vt * torch.sign(_det3(Vt))).to(E.dtype)
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]
    UW = torch.stack([U[:, 1], -U[:, 0], U[:, 2]], dim=-1)
    UWt = torch.stack([-U[:, 1], U[:, 0], U[:, 2]], dim=-1)
    R1, R2 = UW @ Vt, UWt @ Vt
    tvec = U[:, 2]
    cands_R = torch.stack([R1, R1, R2, R2])                    # (4, 3, 3)
    cands_t = torch.stack([tvec, -tvec, tvec, -tvec])
    d0, z1 = _triangulate_depth(cands_R, cands_t, _homogeneous(x0), _homogeneous(x1))
    votes = ((d0 > 0) & (z1 > 0) & mask[None, :]).sum(dim=1)
    k = torch.argmax(votes)[None]
    q = geo.matrix_to_quat(cands_R[k][0])
    return geo.pose_from_qt(q, cands_t[k][0]), votes[k][0]


def solve_ransac_pose(uv0, uv1, mask, K, n_hypotheses: int = 256, thresh_px: float = 1.0,
                      seed: int = 0):
    """solveRANSAC: E by RANSAC, then (R, unit t) by cheirality.  Returns
    (pose (7,), n_inliers).  Like the reference, which only logs the result,
    the translation's scale is unobservable from 2D-2D matches."""
    E, inl = find_essential_ransac(uv0, uv1, mask, K, n_hypotheses, thresh_px, seed)
    K_inv = inv3(K)
    pose, _ = recover_pose(E, _normalize(uv0, K_inv), _normalize(uv1, K_inv), inl)
    return pose, inl.sum()
