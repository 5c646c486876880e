"""Geometry helpers: local frames, slerp, camera interpolation (the port's
copy of vqnerf_release_tpu/ops/geom.py, numpy and scipy; tests hold the two
bit for bit).
"""

import numpy as np

__all__ = ["world2local", "slerp_rotations", "interpolate_pose"]


def _tf_l2_normalize(x, eps=1e-6):
    """tf.linalg.l2_normalize semantics: x * rsqrt(max(sum(x^2), eps))."""
    sq = np.sum(np.square(x), axis=-1, keepdims=True)
    return x / np.sqrt(np.maximum(sq, eps))


def world2local(normal, eps=1e-6):
    """Orthonormal tangent frames [N, 3, 3] (rows: t, b, n) from normals.

    Exactly the reference construction (geom.py:63-92 gen_world2local):
    tangent = cross(normal, (0,0,1)+eps) — the eps nudge on the up axis is
    what makes normals colinear with +Z well-defined — then binormal =
    cross(normal, tangent); parity-tested against the reference in
    tests/test_reference_parity.py.
    """
    n = _tf_l2_normalize(np.asarray(normal, np.float64), eps)
    z = np.tile([[eps, eps, 1.0 + eps]], (n.shape[0], 1))
    t = _tf_l2_normalize(np.cross(n, z), eps)
    b = _tf_l2_normalize(np.cross(n, t), eps)
    return np.stack([t, b, n], axis=1)


def _quat_from_mat(R):
    from scipy.spatial.transform import Rotation
    return Rotation.from_matrix(R).as_quat()


def slerp_rotations(R0, R1, ts):
    """Spherical interpolation between two rotation matrices."""
    from scipy.spatial.transform import Rotation, Slerp
    key = Rotation.from_matrix(np.stack([R0, R1]))
    s = Slerp([0.0, 1.0], key)
    return s(np.asarray(ts)).as_matrix()


def interpolate_pose(c2w0, c2w1, t):
    """Interpolate two c2w poses: slerp rotation + lerp translation
    (the nerfset.gen_rays_between pattern)."""
    R = slerp_rotations(c2w0[:3, :3], c2w1[:3, :3], [t])[0]
    out = np.eye(4)
    out[:3, :3] = R
    out[:3, 3] = (1 - t) * c2w0[:3, 3] + t * c2w1[:3, 3]
    return out
