"""MERL measured-BRDF reading and Rusinkiewicz-coordinate lookup (the
port's copy of vqnerf_release_tpu/data/merl.py, numpy only; tests hold the
two bit for bit).

The MERL .binary format: int32 dims (90, 90, 180) then float64 data of
shape [3, 90, 90, 180] ordered (channel, theta_h, theta_d, phi_d), with
per-channel scales (1/1500, 1.15/1500, 1.66/1500) and a sqrt mapping on
theta_h.
"""

import struct

import numpy as np

__all__ = ["read_merl", "merl_lookup", "rusink_angles"]

MERL_DIMS = (90, 90, 180)
MERL_SCALES = np.array([1.0 / 1500, 1.15 / 1500, 1.66 / 1500])


def read_merl(path):
    """Returns [3, 90, 90, 180] float64 BRDF cube (already scaled)."""
    with open(path, "rb") as f:
        dims = struct.unpack("3i", f.read(12))
        if tuple(dims) != MERL_DIMS:
            raise ValueError(f"{path}: unexpected MERL dims {dims}")
        n = dims[0] * dims[1] * dims[2] * 3
        data = np.frombuffer(f.read(n * 8), dtype=np.float64)
    cube = data.reshape(3, *MERL_DIMS).copy()
    cube *= MERL_SCALES[:, None, None, None]
    return cube


def rusink_angles(wi, wo, n, t=None):
    """(theta_h, theta_d, phi_d) from in/out dirs and normal.

    wi/wo [N,3] unit, n [N,3] unit, optional tangent t. Matches the
    reference `dir2rusink` (nerfactor/util/geom.py:95-134, which rotates
    its SECOND argument — pass the rotated direction as ``wi``):
    h = normalize(wi+wo); theta_h/phi_h from h in the (t, b, n) frame;
    diff = Ry(-theta_h) @ Rz(-phi_h) @ wi_local; theta_d = acos(diff.z);
    phi_d = atan2(diff.y, diff.x) mod pi. Parity-tested against the
    reference in tests/test_reference_parity.py.
    """
    wi = wi / np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = wo / np.linalg.norm(wo, axis=-1, keepdims=True)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    h = wi + wo
    h = h / np.maximum(np.linalg.norm(h, axis=-1, keepdims=True), 1e-12)

    if t is None:
        # arbitrary tangent orthogonal to n
        a = np.where(
            np.abs(n[:, :1]) < 0.9,
            np.tile([[1.0, 0, 0]], (n.shape[0], 1)),
            np.tile([[0, 1.0, 0]], (n.shape[0], 1)))
        t = np.cross(n, a)
        t = t / np.linalg.norm(t, axis=-1, keepdims=True)
    b = np.cross(n, t)

    # local coordinates (rows t, b, n)
    def local(v):
        return np.stack([np.sum(v * t, axis=-1), np.sum(v * b, axis=-1),
                         np.sum(v * n, axis=-1)], axis=-1)

    hl, wil = local(h), local(wi)
    theta_h = np.arccos(np.clip(hl[:, 2], -1, 1))
    phi_h = np.arctan2(hl[:, 1], hl[:, 0])

    # diff = Ry(-theta_h) @ Rz(-phi_h) @ wil (geom.py:120-127)
    c, s = np.cos(-phi_h), np.sin(-phi_h)
    x1 = c * wil[:, 0] - s * wil[:, 1]
    y1 = s * wil[:, 0] + c * wil[:, 1]
    z1 = wil[:, 2]
    ct, st = np.cos(-theta_h), np.sin(-theta_h)
    d = np.stack([ct * x1 + st * z1, y1, -st * x1 + ct * z1], axis=-1)

    theta_d = np.arccos(np.clip(d[:, 2], -1, 1))
    phi_d = np.arctan2(d[:, 1], d[:, 0]) % np.pi
    return theta_h, theta_d, phi_d


def merl_lookup(cube, theta_h, theta_d, phi_d):
    """Nearest-bin lookup (merl.py index mapping): theta_h uses the sqrt
    warp idx = floor(sqrt(th / (pi/2)) * 90)."""
    th_idx = np.clip(
        (np.sqrt(np.clip(theta_h / (np.pi / 2), 0, 1))
         * MERL_DIMS[0]).astype(np.int64), 0, MERL_DIMS[0] - 1)
    td_idx = np.clip(
        (theta_d / (np.pi / 2) * MERL_DIMS[1]).astype(np.int64),
        0, MERL_DIMS[1] - 1)
    pd_idx = np.clip(
        (phi_d / np.pi * MERL_DIMS[2]).astype(np.int64),
        0, MERL_DIMS[2] - 1)
    return np.stack(
        [cube[c, th_idx, td_idx, pd_idx] for c in range(3)], axis=-1)
