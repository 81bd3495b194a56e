"""Port parity: ``pwclonet_pylidarslam_torch.core`` (rotation, se3) against
the JAX reference on the same float32 inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pwclonet_pylidarslam_torch.core import rotation as trot
from pwclonet_pylidarslam_torch.core import se3 as tse3
from pwclonet_pylidarslam_tpu.core import rotation as jrot
from pwclonet_pylidarslam_tpu.core import se3 as jse3


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _both(fn_t, fn_j, *arrays):
    out_t = fn_t(*(torch.from_numpy(a) for a in arrays))
    out_j = jax.jit(fn_j)(*(jnp.asarray(a) for a in arrays))
    return out_t.numpy(), np.asarray(out_j)


def _unit_quats(rng, *shape):
    q = _f32(rng, *shape, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _rotations(rng, n):
    return np.asarray(jrot.quat_to_mat(jnp.asarray(_unit_quats(rng, n)))).astype(np.float32)


# the functions the PWCLO-Net path calls, held at atol 1e-6
ON_PATH = {
    "quat_normalize": (trot.quat_normalize, jrot.quat_normalize, lambda r: (_f32(r, 5, 4),)),
    "quat_multiply": (trot.quat_multiply, jrot.quat_multiply,
                      lambda r: (_unit_quats(r, 5), _unit_quats(r, 5))),
    "quat_rotate": (trot.quat_rotate, jrot.quat_rotate,
                    lambda r: (_unit_quats(r, 3), _f32(r, 3, 17, 3))),
    "quat_apply": (trot.quat_apply, jrot.quat_apply,
                   lambda r: (_unit_quats(r, 3), _f32(r, 3, 3), _f32(r, 3, 17, 3))),
    "quat_to_mat": (trot.quat_to_mat, jrot.quat_to_mat, lambda r: (_f32(r, 6, 4),)),
    "params_to_pose_quat": (tse3.params_to_pose_quat, jse3.params_to_pose_quat,
                            lambda r: (_f32(r, 4, 7),)),
}


@pytest.mark.parametrize("name", sorted(ON_PATH))
def test_path_functions_match_reference(rng, name):
    fn_t, fn_j, make = ON_PATH[name]
    a, b = _both(fn_t, fn_j, *make(rng))
    assert a.shape == b.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, b, atol=1e-6)


# the rest of both files, for the slices that need them
REST = {
    "euler_to_mat": (trot.euler_to_mat, jrot.euler_to_mat, lambda r: (_f32(r, 6, 3),)),
    "mat_to_euler": (trot.mat_to_euler, jrot.mat_to_euler, lambda r: (_rotations(r, 6),)),
    "euler_jacobian": (trot.euler_jacobian, jrot.euler_jacobian, lambda r: (_f32(r, 4, 3),)),
    "mat_to_quat": (trot.mat_to_quat, jrot.mat_to_quat, lambda r: (_rotations(r, 8),)),
    "quat_inverse": (trot.quat_inverse, jrot.quat_inverse, lambda r: (_f32(r, 5, 4),)),
    "quat_slerp": (lambda a, b: trot.quat_slerp(a, b, 0.3),
                   lambda a, b: jrot.quat_slerp(a, b, 0.3),
                   lambda r: (_unit_quats(r, 5), _unit_quats(r, 5))),
    "quat_scalar_last": (lambda q: trot.quat_from_scalar_last(trot.quat_to_scalar_last(q)),
                         lambda q: jrot.quat_from_scalar_last(jrot.quat_to_scalar_last(q)),
                         lambda r: (_f32(r, 3, 4),)),
    "so3_exp": (trot.so3_exp, jrot.so3_exp, lambda r: (_f32(r, 6, 3, scale=0.7),)),
    "so3_log": (trot.so3_log, jrot.so3_log, lambda r: (_rotations(r, 6),)),
    "project_to_so3": (trot.project_to_so3, jrot.project_to_so3,
                       lambda r: (_rotations(r, 4) + _f32(r, 4, 3, 3, scale=1e-3),)),
    "inverse": (tse3.inverse, jse3.inverse,
                lambda r: (np.asarray(jse3.exp(jnp.asarray(_f32(r, 4, 6)))).astype(np.float32),)),
    "transform": (tse3.transform, jse3.transform,
                  lambda r: (np.asarray(jse3.exp(jnp.asarray(_f32(r, 2, 6)))).astype(np.float32),
                             _f32(r, 2, 9, 3, scale=10.0))),
    "se3_exp": (tse3.exp, jse3.exp, lambda r: (_f32(r, 5, 6),)),
    "se3_log": (tse3.log, jse3.log,
                lambda r: (np.asarray(jse3.exp(jnp.asarray(_f32(r, 5, 6)))).astype(np.float32),)),
    "params_to_pose_euler": (tse3.params_to_pose_euler, jse3.params_to_pose_euler,
                             lambda r: (_f32(r, 4, 6),)),
    "pose_to_params_quat": (tse3.pose_to_params_quat, jse3.pose_to_params_quat,
                            lambda r: (np.asarray(jse3.exp(jnp.asarray(_f32(r, 4, 6)))).astype(np.float32),)),
    "relative_chain": (lambda p: tse3.from_relative_chain(tse3.to_relative_chain(p)),
                       lambda p: jse3.from_relative_chain(jse3.to_relative_chain(p)),
                       lambda r: (np.asarray(jse3.exp(jnp.asarray(_f32(r, 6, 6, scale=0.3)))).astype(np.float32),)),
    "interpolate_poses": (lambda a, b: tse3.interpolate_poses(a, b, torch.full((3,), 0.25)),
                          lambda a, b: jse3.interpolate_poses(a, b, jnp.full((3,), 0.25, jnp.float32)),
                          lambda r: tuple(np.asarray(jse3.exp(jnp.asarray(_f32(r, 3, 6, scale=0.3))))
                                          .astype(np.float32) for _ in range(2))),
}


@pytest.mark.parametrize("name", sorted(REST))
def test_rest_matches_reference(rng, name):
    fn_t, fn_j, make = REST[name]
    a, b = _both(fn_t, fn_j, *make(rng))
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_interpolate_timestamps_matches_reference(rng):
    poses = np.asarray(jse3.exp(jnp.asarray(_f32(rng, 5, 6, scale=0.3)))).astype(np.float32)
    times = np.arange(5, dtype=np.float32)
    query = np.array([-1.0, 0.0, 0.5, 2.25, 3.9, 7.0], np.float32)
    a, b = _both(tse3.interpolate_timestamps, jse3.interpolate_timestamps, poses, times, query)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_is_rotation_matrix(rng):
    rots = _rotations(rng, 4)
    rots[1, 0, 0] += 0.1
    a, b = _both(trot.is_rotation_matrix, jrot.is_rotation_matrix, rots)
    np.testing.assert_array_equal(a, b)
    assert a.tolist() == [True, False, True, True]
