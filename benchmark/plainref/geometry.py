"""SO(3)/SE(3) primitives on xyzw quaternions and 7-vector poses.

Port of ``vloam_tpu/geometry.py``.  Conventions are identical:

* quaternions are ``(x, y, z, w)``;
* a pose is ``[qx qy qz qw tx ty tz]``;
* ``pose_apply(T, p) = R(q) @ p + t``.

Every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

QUAT_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=QUAT_EPS)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, both xyzw."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit quaternion q (two-cross-product form)."""
    xyz, v = torch.broadcast_tensors(q[..., :3], v)  # linalg.cross needs equal ndim
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(xyz, v, dim=-1)
    return v + w * t + torch.linalg.cross(xyz, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (xyzw), branch-free Shepperd's method:
    all four constructions, the one with the largest diagonal pivot kept."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    piv = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                       1.0 - m00 - m11 + m22], dim=-1)
    piv = torch.sqrt(torch.clamp(piv, min=QUAT_EPS)) * 0.5
    w0, x1, y2, z3 = piv.unbind(-1)
    cand = torch.stack(
        [
            torch.stack([(m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0), w0], -1),
            torch.stack([x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1), (m21 - m12) / (4 * x1)], -1),
            torch.stack([(m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2), (m02 - m20) / (4 * y2)], -1),
            torch.stack([(m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3, (m10 - m01) / (4 * z3)], -1),
        ],
        dim=-2,
    )  # (..., 4 candidates, 4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cand, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_normalize(q)


def quat_slerp_identity(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Eigen's ``Identity().slerp(s, q)``: interpolate from the identity to q
    on the short arc (q flipped when w < 0), with a lerp where sin(theta) <
    1e-5.  Only selects separate the branches: at q = identity the arccos's
    derivative is infinite, and forward-mode AD (``torch.func.jacfwd``)
    takes the selected branch's tangent alone, so none of it reaches a
    Jacobian."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    theta = torch.arccos(w)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe_sin = torch.where(small, 1.0, sin_theta)
    w_id = torch.where(small, 1.0 - s, torch.sin((1.0 - s) * theta) / safe_sin)
    w_q = torch.where(small, s, torch.sin(s * theta) / safe_sin)
    # w_id * identity + w_q * q
    out = torch.cat([w_q[..., None] * q[..., :3], (w_id + w_q * q[..., 3])[..., None]], dim=-1)
    return quat_normalize(out)


def quat_to_angle_axis(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> angle-axis vector, on the w >= 0 hemisphere.  Below
    |xyz| = 1e-8 the scale is the limit 2 (the pose graph differentiates this
    at residual ~0: the guarded division keeps the untaken branch finite)."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    xyz = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    sin_half = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, w)
    scale = torch.where(sin_half < 1e-8, 2.0, angle / torch.clamp(sin_half, min=1e-12))
    return xyz * scale[..., None]


def angle_axis_to_quat(aa: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(aa, dim=-1, keepdim=True)
    half = 0.5 * theta
    small = theta < 1e-8
    k = torch.where(small, 0.5, torch.sin(half) / torch.clamp(theta, min=1e-12))
    xyz = aa * k
    w = torch.where(small, 1.0, torch.cos(half))
    return quat_normalize(torch.cat([xyz, w], dim=-1))


def pose_identity(device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def pose_from_qt(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([q, t], dim=-1)


def pose_q(p: torch.Tensor) -> torch.Tensor:
    return p[..., :4]


def pose_t(p: torch.Tensor) -> torch.Tensor:
    return p[..., 4:7]


def pose_apply(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(p[..., :4], v) + p[..., 4:7]


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b: (a∘b)(x) = a(b(x))."""
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return pose_from_qt(quat_normalize(q), t)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    qinv = quat_conj(p[..., :4])
    return pose_from_qt(qinv, -quat_rotate(qinv, p[..., 4:7]))
