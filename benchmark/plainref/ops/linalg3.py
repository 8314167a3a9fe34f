"""Closed-form batched 3x3 symmetric linear algebra and the small SPD solve.

Port of ``vloam_tpu/ops/linalg3.py``: the analytic trigonometric
eigensolver (used by the mapping line fit), Cramer's rule for the plane fit,
and the unrolled Cholesky of the 6x6 Gauss-Newton normal matrix.  Everything
is component-wise (structure of arrays), as in the reference.
"""

from __future__ import annotations

import math

import torch


def eigh3x3_sym(a, b, c, d, e, f):
    """Eigendecomposition of symmetric [[a, d, f], [d, b, e], [f, e, c]]
    batches given component-wise.

    Returns ((e1, e2, e3) ascending, ((v1x, v1y, v1z), (v2x, ...), (v3x, ...))).
    """
    tr = a + b + c
    q = tr / 3.0
    p1 = d * d + f * f + e * e
    aq, bq, cq = a - q, b - q, c - q
    p2 = aq * aq + bq * bq + cq * cq + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))

    inv_p = 1.0 / p
    a_, b_, c_ = aq * inv_p, bq * inv_p, cq * inv_p
    d_, e_, f_ = d * inv_p, e * inv_p, f * inv_p
    det = a_ * (b_ * c_ - e_ * e_) - d_ * (d_ * c_ - e_ * f_) + f_ * (d_ * e_ - b_ * f_)
    r = torch.clamp(det / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0

    e3 = q + 2.0 * p * torch.cos(phi)                        # largest
    e1 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    e2 = tr - e1 - e3

    iso = p2 < 1e-20
    e1 = torch.where(iso, a, e1)
    e2 = torch.where(iso, b, e2)
    e3 = torch.where(iso, c, e3)

    def eigvec(lam):
        # rows of (A - lam I); the eigenvector is the largest cross product
        # of two rows
        r0x, r0y, r0z = a - lam, d, f
        r1x, r1y, r1z = d, b - lam, e
        r2x, r2y, r2z = f, e, c - lam

        def cross(x1, y1, z1, x2, y2, z2):
            return y1 * z2 - z1 * y2, z1 * x2 - x1 * z2, x1 * y2 - y1 * x2

        c01 = cross(r0x, r0y, r0z, r1x, r1y, r1z)
        c02 = cross(r0x, r0y, r0z, r2x, r2y, r2z)
        c12 = cross(r1x, r1y, r1z, r2x, r2y, r2z)
        n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
        n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
        n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
        pick01 = n01 >= n02
        bx = torch.where(pick01, c01[0], c02[0])
        by = torch.where(pick01, c01[1], c02[1])
        bz = torch.where(pick01, c01[2], c02[2])
        bn = torch.maximum(n01, n02)
        pickb = bn >= n12
        bx = torch.where(pickb, bx, c12[0])
        by = torch.where(pickb, by, c12[1])
        bz = torch.where(pickb, bz, c12[2])
        bn = torch.maximum(bn, n12)
        inv = 1.0 / torch.sqrt(torch.clamp(bn, min=1e-30))
        ok = bn >= 1e-24
        # isotropic fallback: any axis
        return (
            torch.where(ok, bx * inv, 1.0),
            torch.where(ok, by * inv, 0.0),
            torch.where(ok, bz * inv, 0.0),
        )

    v1 = eigvec(e1)
    v3 = eigvec(e3)
    v2x = v3[1] * v1[2] - v3[2] * v1[1]
    v2y = v3[2] * v1[0] - v3[0] * v1[2]
    v2z = v3[0] * v1[1] - v3[1] * v1[0]
    n2 = torch.clamp(torch.sqrt(v2x * v2x + v2y * v2y + v2z * v2z), min=1e-30)
    v2 = (v2x / n2, v2y / n2, v2z / n2)
    return (e1, e2, e3), (v1, v2, v3)


def solve_spd_small(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for a small SPD matrix with an unrolled Cholesky
    (the same pivot floor, 1e-12, as the reference and the CUDA GN kernel)."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-12))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve3x3_sym(a, b, c, d, e, f, bx, by, bz):
    """Cramer's-rule solve of symmetric [[a,d,f],[d,b,e],[f,e,c]] x = rhs,
    all inputs component batches.  Returns (x0, x1, x2)."""
    m00 = b * c - e * e
    m01 = d * c - e * f
    m02 = d * e - b * f
    det = a * m00 - d * m01 + f * m02
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    det0 = bx * m00 - d * (by * c - e * bz) + f * (by * e - b * bz)
    det1 = a * (by * c - e * bz) - bx * m01 + f * (d * bz - by * f)
    det2 = a * (b * bz - e * by) - d * (d * bz - by * f) + bx * m02
    inv = 1.0 / det
    return det0 * inv, det1 * inv, det2 * inv
