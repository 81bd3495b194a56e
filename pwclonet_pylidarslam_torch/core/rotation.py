"""SO(3) rotation math: euler angles, quaternions, axis-angle, jacobians.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/rotation.py``, with
the same conventions:

- quaternions are scalar-first ``(w, x, y, z)``; convert only at IO
  boundaries (:func:`quat_to_scalar_last`);
- euler angles follow ``R = Rz(ez) @ Ry(ey) @ Rx(ex)``;
- every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# Elementary rotations + analytic derivatives
# ---------------------------------------------------------------------------


def _rot_stack(rows) -> torch.Tensor:
    """Stack a 3x3 matrix from 9 broadcastable scalars, batch-last-two-dims."""
    r = [torch.broadcast_tensors(*row) for row in rows]
    return torch.stack([torch.stack(row, dim=-1) for row in r], dim=-2)


def rot_x(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot_stack([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot_stack([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rot_stack([[c, -s, z], [s, c, z], [z, z, o]])


def euler_to_mat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles ``(..., 3)`` = (ex, ey, ez) → rotation ``(..., 3, 3)``."""
    ex, ey, ez = euler[..., 0], euler[..., 1], euler[..., 2]
    return rot_z(ez) @ rot_y(ey) @ rot_x(ex)


def mat_to_euler(rot: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` → euler ``(..., 3)`` (xyz convention).

    When ``|r20| ≈ 1`` (gimbal lock) the x angle is set to 0 and z absorbs
    the remaining degree of freedom.
    """
    r20 = torch.clamp(rot[..., 2, 0], -1.0, 1.0)
    singular = torch.abs(torch.abs(r20) - 1.0) < eps
    ey = -torch.arcsin(r20)
    ex_reg = torch.arctan2(rot[..., 2, 1], rot[..., 2, 2])
    ez_reg = torch.arctan2(rot[..., 1, 0], rot[..., 0, 0])
    ex_sing = torch.zeros_like(ey)
    ez_sing = torch.arctan2(-rot[..., 0, 1], rot[..., 1, 1])
    ex = torch.where(singular, ex_sing, ex_reg)
    ez = torch.where(singular, ez_sing, ez_reg)
    return torch.stack([ex, ey, ez], dim=-1)


def euler_jacobian(euler: torch.Tensor) -> torch.Tensor:
    """Analytic ``dR/d(euler)`` → ``(..., 3, 3, 3)``; index 0 of the new axis
    is dR/dex."""
    ex, ey, ez = euler[..., 0], euler[..., 1], euler[..., 2]
    c, s = torch.cos, torch.sin
    z = torch.zeros_like(ex)
    jrx = _rot_stack([[z, z, z], [z, -s(ex), -c(ex)], [z, c(ex), -s(ex)]])
    jry = _rot_stack([[-s(ey), z, c(ey)], [z, z, z], [-c(ey), z, -s(ey)]])
    jrz = _rot_stack([[-s(ez), -c(ez), z], [c(ez), -s(ez), z], [z, z, z]])
    rx, ry, rz = rot_x(ex), rot_y(ey), rot_z(ez)
    return torch.stack([rz @ ry @ jrx, rz @ jry @ rx, jrz @ ry @ rx], dim=-3)


# ---------------------------------------------------------------------------
# Quaternions (scalar-first wxyz)
# ---------------------------------------------------------------------------


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_inverse(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Inverse of a (possibly non-unit) quaternion."""
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    return quat_conjugate(q) / torch.clamp_min(sq, eps)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``a ⊗ b`` over ``(..., 4)`` scalar-first quats."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Rotate ``points (..., N, 3)`` by unit quats ``q (..., 4)`` with the
    expanded Rodrigues form."""
    qw = q[..., None, 0:1]
    qv = q[..., None, 1:4]
    t = 2.0 * _cross(qv, points)
    return points + qw * t + _cross(qv, t)


def quat_apply(q: torch.Tensor, t: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``R(q) @ p + t`` for points ``(..., N, 3)``, ``t (..., 3)``."""
    return quat_rotate(q, points) + t[..., None, :]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion ``(..., 4)`` → rotation matrix ``(..., 3, 3)``."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return _rot_stack(
        [
            [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
            [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
            [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
        ]
    )


def mat_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``(..., 3, 3)`` → scalar-first unit quat ``(..., 4)``.

    Branch-free Shepperd method: all four candidates are computed and the one
    with the largest diagonal combination is kept; the sign makes ``w >= 0``.
    """
    m = rot
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack(
        [qw2, m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] - m[..., 0, 1]],
        dim=-1,
    )
    cx = torch.stack(
        [m[..., 2, 1] - m[..., 1, 2], qx2, m[..., 1, 0] + m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0]],
        dim=-1,
    )
    cy = torch.stack(
        [m[..., 0, 2] - m[..., 2, 0], m[..., 1, 0] + m[..., 0, 1], qy2, m[..., 2, 1] + m[..., 1, 2]],
        dim=-1,
    )
    cz = torch.stack(
        [m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] + m[..., 2, 0], m[..., 2, 1] + m[..., 1, 2], qz2],
        dim=-1,
    )
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # (..., 4 candidates, 4)
    chosen = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    denom = torch.take_along_dim(mags, best[..., None], dim=-1)
    q = chosen / (2.0 * torch.sqrt(torch.clamp_min(denom, 1e-20)))
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def quat_to_scalar_last(q: torch.Tensor) -> torch.Tensor:
    """wxyz → xyzw (IO boundary only)."""
    return torch.cat([q[..., 1:4], q[..., 0:1]], dim=-1)


def quat_from_scalar_last(q: torch.Tensor) -> torch.Tensor:
    """xyzw → wxyz (IO boundary only)."""
    return torch.cat([q[..., 3:4], q[..., 0:3]], dim=-1)


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Spherical linear interpolation between unit quats; ``alpha``
    broadcasts against the batch dims."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    a = torch.as_tensor(alpha, dtype=q0.dtype, device=q0.device)[..., None]
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(small, 1.0 - a, torch.sin((1.0 - a) * theta) / safe)
    w1 = torch.where(small, a, torch.sin(a * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# Axis-angle / so(3)
# ---------------------------------------------------------------------------


def hat(v: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` → skew-symmetric ``(..., 3, 3)``."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return _rot_stack([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(omega: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rodrigues: axis-angle ``(..., 3)`` → rotation ``(..., 3, 3)``, with
    Taylor branches near zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, eps * eps))
    small = theta2 < eps
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, eps * eps)
    )
    k = hat(omega)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def so3_log(rot: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation ``(..., 3, 3)`` → axis-angle ``(..., 3)`` (principal branch).

    ``arccos`` is evaluated on a cosine clipped away from ±1; the series and
    near-π branches are selected on the unclipped cosine.
    """
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_raw = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    cos_safe = torch.clamp(cos_raw, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_safe)
    w = vee(rot - rot.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    sin_theta = torch.sin(theta)
    small = cos_raw > 1.0 - eps
    scale = torch.where(
        small,
        1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta),
    )
    near_pi = cos_raw < -1.0 + 1e-4
    m = rot + torch.eye(3, dtype=rot.dtype, device=rot.device)
    col_norms = torch.linalg.norm(m, dim=-2)
    best_col = torch.argmax(col_norms, dim=-1)
    axis = torch.take_along_dim(m, best_col[..., None, None], dim=-1)[..., 0]
    axis = axis / torch.clamp_min(torch.linalg.norm(axis, dim=-1, keepdim=True), 1e-12)
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    log_near_pi = axis * sign * theta[..., None]
    return torch.where(near_pi[..., None], log_near_pi, w * scale[..., None])


def project_to_so3(mat: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix by SVD."""
    u, _, vt = torch.linalg.svd(mat)
    det = torch.linalg.det(u @ vt)
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    return (u * d[..., None, :]) @ vt


def is_rotation_matrix(rot: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Elementwise check ``RᵀR = I`` and ``det R = 1``."""
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    ortho = torch.amax(torch.abs(rot.transpose(-1, -2) @ rot - eye), dim=(-1, -2)) < eps
    det = torch.abs(torch.linalg.det(rot) - 1.0) < eps
    return ortho & det
