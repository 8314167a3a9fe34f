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
