"""SE(3) pose math: matrices, twists, parameterizations, interpolation.

PyTorch counterpart of ``pwclonet_pylidarslam_tpu/core/se3.py``. Pose
parameters are ``(..., 6)`` = (t, rotation params) and quaternion params are
``(..., 7)`` = ``(tx, ty, tz, qw, qx, qy, qz)``. The solvers use twist
(se(3)) parameters ``(v, omega)``.
"""

from __future__ import annotations

import torch

from pwclonet_pylidarslam_torch.core import rotation as rot


def make_pose(rotation_mat: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """``(..., 3, 3)`` + ``(..., 3)`` → homogeneous ``(..., 4, 4)``."""
    batch = torch.broadcast_shapes(rotation_mat.shape[:-2], translation.shape[:-1])
    top = torch.cat([rotation_mat.expand(batch + (3, 3)),
                     translation.to(rotation_mat.dtype).expand(batch + (3,))[..., None]], dim=-1)
    # the last row from a kernel: writing a Python 1.0 into a CUDA tensor
    # copies it from the host and synchronizes
    last = torch.eye(4, dtype=rotation_mat.dtype, device=rotation_mat.device)[3]
    return torch.cat([top, last.expand(batch + (1, 4))], dim=-2)


def identity_pose(batch_shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(tuple(batch_shape) + (4, 4))


def inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    r_t = pose[..., :3, :3].transpose(-1, -2)
    t = pose[..., :3, 3]
    return make_pose(r_t, -torch.einsum("...ij,...j->...i", r_t, t))


def transform(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply ``(..., 4, 4)`` to points ``(..., N, 3)``."""
    r = pose[..., :3, :3]
    t = pose[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", r, points) + t[..., None, :]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` — kept explicit for readability at call sites."""
    return a @ b


def relative(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """``a⁻¹ b``: pose of frame b expressed in frame a."""
    return inverse(pose_a) @ pose_b


def to_relative_chain(absolute: torch.Tensor) -> torch.Tensor:
    """Absolute poses ``(T, 4, 4)`` → relative ``(T, 4, 4)``; entry 0 = I."""
    rel = inverse(absolute[:-1]) @ absolute[1:]
    eye = identity_pose((1,), absolute.dtype, absolute.device)
    return torch.cat([eye, rel], dim=0)


def from_relative_chain(relative_poses: torch.Tensor) -> torch.Tensor:
    """Relative poses ``(T, 4, 4)`` → absolute by prefix composition."""
    out = [relative_poses[0]]
    for t in range(1, relative_poses.shape[0]):
        out.append(out[-1] @ relative_poses[t])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Twist (se(3)) parameterization — solver-facing
# ---------------------------------------------------------------------------


def exp(twist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """se(3) exp: ``(..., 6)`` = (v, omega) → ``(..., 4, 4)``."""
    v, omega = twist[..., :3], twist[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, eps * eps))
    small = theta2 < eps
    k = rot.hat(omega)
    k2 = k @ k
    a = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, eps * eps)
    )
    b = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, eps**3),
    )
    eye = torch.eye(3, dtype=twist.dtype, device=twist.device).expand(k.shape)
    v_mat = eye + a[..., None, None] * k + b[..., None, None] * k2
    r_mat = rot.so3_exp(omega)
    t = torch.einsum("...ij,...j->...i", v_mat, v)
    return make_pose(r_mat, t)


def log(pose: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SE(3) log: ``(..., 4, 4)`` → twist ``(..., 6)`` (v, omega)."""
    omega = rot.so3_log(pose[..., :3, :3], eps)
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, eps * eps))
    small = theta2 < eps
    k = rot.hat(omega)
    k2 = k @ k
    # V^{-1} = I - K/2 + c * K^2,  c = (1 - theta cot(theta/2)/2) / theta^2
    half = theta / 2.0
    cot_term = half * torch.cos(half) / torch.where(small, torch.ones_like(half), torch.sin(half))
    c = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / torch.clamp_min(theta2, eps * eps)
    )
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device).expand(k.shape)
    v_inv = eye - 0.5 * k + c[..., None, None] * k2
    v = torch.einsum("...ij,...j->...i", v_inv, pose[..., :3, 3])
    return torch.cat([v, omega], dim=-1)


def apply_delta(pose: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update ``exp(twist) @ pose`` (GN step)."""
    return exp(twist) @ pose


# ---------------------------------------------------------------------------
# Parameter layouts
# ---------------------------------------------------------------------------


def params_to_pose_euler(params: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` = (t, euler-xyz) → ``(..., 4, 4)``."""
    return make_pose(rot.euler_to_mat(params[..., 3:]), params[..., :3])


def pose_to_params_euler(pose: torch.Tensor) -> torch.Tensor:
    return torch.cat([pose[..., :3, 3], rot.mat_to_euler(pose[..., :3, :3])], dim=-1)


def params_to_pose_quat(params: torch.Tensor) -> torch.Tensor:
    """``(..., 7)`` = (t, q_wxyz) → ``(..., 4, 4)``."""
    return make_pose(rot.quat_to_mat(params[..., 3:]), params[..., :3])


def pose_to_params_quat(pose: torch.Tensor) -> torch.Tensor:
    return torch.cat([pose[..., :3, 3], rot.mat_to_quat(pose[..., :3, :3])], dim=-1)


def normalize(pose: torch.Tensor) -> torch.Tensor:
    """Re-project the rotation block onto SO(3)."""
    return make_pose(rot.project_to_so3(pose[..., :3, :3]), pose[..., :3, 3])


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------


def interpolate_poses(pose0: torch.Tensor, pose1: torch.Tensor, alpha) -> torch.Tensor:
    """Interpolate between two poses at fractions ``alpha (...,)``: rotation
    by quaternion slerp, translation linearly."""
    q0 = rot.mat_to_quat(pose0[..., :3, :3])
    q1 = rot.mat_to_quat(pose1[..., :3, :3])
    q = rot.quat_slerp(q0, q1, alpha)
    a = torch.as_tensor(alpha, dtype=pose0.dtype, device=pose0.device)[..., None]
    t = (1.0 - a) * pose0[..., :3, 3] + a * pose1[..., :3, 3]
    return make_pose(rot.quat_to_mat(q), t)


def interpolate_timestamps(
    poses: torch.Tensor, pose_times: torch.Tensor, query_times: torch.Tensor
) -> torch.Tensor:
    """Sample ``poses (T, 4, 4)`` at sorted ``pose_times (T,)`` for
    ``query_times (Q,)`` → ``(Q, 4, 4)``, clamped at both ends."""
    idx = torch.searchsorted(pose_times, query_times, right=True) - 1
    idx = torch.clamp(idx, 0, poses.shape[0] - 2)
    t0 = pose_times[idx]
    t1 = pose_times[idx + 1]
    alpha = torch.clamp((query_times - t0) / torch.clamp_min(t1 - t0, 1e-12), 0.0, 1.0)
    return interpolate_poses(poses[idx], poses[idx + 1], alpha)
