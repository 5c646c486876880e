"""Camera rays for the two camera conventions, and stage 1's near/far and
bounding radius (the port's own copy of what it uses from
vqnerf_release_tpu/data/rays.py, numpy only; tests hold the two bit for
bit).

  * NeRF convention (c2w + fov): pixel directions ((x-cx)/f, -(y-cy)/f, -1)
    rotated into world; stage 2 leaves them unnormalized.
  * DTU convention (world/scale projection matrices): P = world_mat @
    scale_mat decomposed into K and c2w; directions are K^-1 pixel,
    normalized in camera space, then rotated.
  * NDC warping of forward-facing rays (``ndc_rays``).
  * The video-trajectory metadata forms that stage-1 trajectory extraction
    writes (focal + c2w, or intrinsic + c2w), read back by the stage-2
    video dataset.
"""

import numpy as np

__all__ = ["nerf_rays", "dtu_rays", "decompose_projection",
           "near_far_fixed", "near_far_sphere", "max_radius_from_poses",
           "ndc_rays", "video_nerf_rays", "video_dtu_rays"]


def nerf_rays(c2w, cam_angle_x, imh, imw, cx=None, cy=None, normalize=False):
    """Rays for the NeRF/Blender convention.

    c2w: [4,4]; cam_angle_x: horizontal FOV. Returns (rayo [h,w,3],
    rayd [h,w,3]). ``normalize=True`` matches stage 1 (nerfset.py:105);
    stage 2 leaves directions unnormalized (shape_unit.py:290-291).
    """
    c2w = np.asarray(c2w, np.float64)
    fl = 0.5 * imw / np.tan(0.5 * cam_angle_x)
    if cx is None:
        cx = 0.5 * imw
    if cy is None:
        cy = 0.5 * imh
    xs, ys = np.meshgrid(
        np.arange(imw, dtype=np.float64), np.arange(imh, dtype=np.float64))
    dirs = np.stack(
        ((xs - cx) / fl, -(ys - cy) / fl, -np.ones_like(xs)), axis=-1)
    rayd = np.einsum("hwk,rk->hwr", dirs, c2w[:3, :3])
    if normalize:
        rayd = rayd / np.linalg.norm(rayd, axis=-1, keepdims=True)
    rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
    return rayo.astype(np.float32), rayd.astype(np.float32)


def decompose_projection(P):
    """K, c2w from a 3x4 projection matrix (shape_unit.py:295-312).

    Pure-numpy RQ decomposition replacing cv2.decomposeProjectionMatrix:
    P[:, :3] = K R where K is upper-triangular with positive diagonal and R
    is a rotation; camera center c solves P [c;1] = 0.
    """
    P = np.asarray(P, np.float64)
    M = P[:3, :3]
    # RQ decomposition via QR of the flipped transpose
    flip = np.flipud(np.eye(3))
    q, r = np.linalg.qr((flip @ M).T)
    K = flip @ r.T @ flip
    R = flip @ q.T
    # enforce positive diagonal on K
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1
    K = K * signs[None, :]
    R = R * signs[:, None]
    if np.linalg.det(R) < 0:
        K, R = -K, -R
    K = K / K[2, 2]
    # camera center: -M^-1 p4
    c = -np.linalg.inv(M) @ P[:3, 3]
    intrinsics = np.eye(4)
    intrinsics[:3, :3] = K
    pose = np.eye(4)
    pose[:3, :3] = R.T
    pose[:3, 3] = c
    return intrinsics, pose


def dtu_rays(world_mat, scale_mat, imh_meta, imw_meta, imh, cx_scale=None):
    """Rays for the DTU projection-matrix convention (shape_unit.py:158-171).

    The metadata image size (imh_meta, imw_meta) is rescaled to target imh;
    intrinsics rows 0:2 scale with k = imh / imh_meta.
    Returns (rayo [h,w,3], rayd [h,w,3]) with camera-space-normalized dirs.
    """
    k = imh / imh_meta
    imw = int(k * imw_meta)
    P = (np.asarray(world_mat) @ np.asarray(scale_mat))[0:3, 0:4]
    intrinsic, c2w = decompose_projection(P)
    intrinsic = intrinsic.copy()
    intrinsic[:2, :3] *= k
    intrinsic_inv = np.linalg.inv(intrinsic)

    xs, ys = np.meshgrid(
        np.arange(imw, dtype=np.float64), np.arange(imh, dtype=np.float64))
    p = np.stack((xs, ys, np.ones_like(xs)), axis=-1)
    p = np.einsum("rk,hwk->hwr", intrinsic_inv[:3, :3], p)
    rayd = p / np.linalg.norm(p, axis=-1, keepdims=True)
    rayd = np.einsum("rk,hwk->hwr", c2w[:3, :3], rayd)
    rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
    return rayo.astype(np.float32), rayd.astype(np.float32)


def near_far_fixed(n, near, far):
    return (np.full((n, 1), near, np.float32),
            np.full((n, 1), far, np.float32))


def near_far_sphere(rays_o, rays_d):
    """Sphere-mid near/far of the DTU loader (dtuset.py:142-148):
    mid = -<o, d>; near/far = mid -/+ 1."""
    a = np.sum(rays_d**2, axis=-1, keepdims=True)
    b = 2.0 * np.sum(rays_o * rays_d, axis=-1, keepdims=True)
    mid = 0.5 * (-b) / a
    return (mid - 1.0).astype(np.float32), (mid + 1.0).astype(np.float32)


def max_radius_from_poses(c2ws, near, far):
    """Max distance of the near/far frustum corners from origin
    (nerfset.py:138-145)."""
    bd = np.array([[0.0, 0.0], [0.0, 0.0], [-near, -far], [1.0, 1.0]])
    r = 0.0
    for c2w in c2ws:
        pts = (np.asarray(c2w) @ bd)[:3, :]
        r = max(r, float(np.max(np.sqrt(np.sum(pts**2, axis=0)))))
    return r


def video_nerf_rays(c2w, focal, imh, imw, cx=None, cy=None):
    """Rays from the video-trajectory metadata form (focal + c2w), the
    NeRF branch of datasets/video_nfr.py:292-317 — unnormalized
    directions, cx/cy defaulting to the image center."""
    c2w = np.asarray(c2w, np.float64)
    if cx is None:
        cx = 0.5 * imw
    if cy is None:
        cy = 0.5 * imh
    xs, ys = np.meshgrid(
        np.arange(imw, dtype=np.float64), np.arange(imh, dtype=np.float64))
    dirs = np.stack(
        ((xs - cx) / focal, -(ys - cy) / focal, -np.ones_like(xs)), axis=-1)
    rayd = np.einsum("hwk,rk->hwr", dirs, c2w[:3, :3])
    rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
    return rayo.astype(np.float32), rayd.astype(np.float32)


def video_dtu_rays(c2w, intrinsic, imh, imw):
    """Rays from the DTU video-trajectory metadata form (intrinsic + c2w),
    the dtu branch of datasets/video_nfr.py:292-311 — K^-1 pixel dirs,
    camera-space normalized, rotated into world."""
    c2w = np.asarray(c2w, np.float64)
    intrinsic_inv = np.linalg.inv(np.asarray(intrinsic, np.float64)[:3, :3])
    xs, ys = np.meshgrid(
        np.arange(imw, dtype=np.float64), np.arange(imh, dtype=np.float64))
    p = np.stack((xs, ys, np.ones_like(xs)), axis=-1)
    p = np.einsum("rk,hwk->hwr", intrinsic_inv, p)
    rayd = p / np.linalg.norm(p, axis=-1, keepdims=True)
    rayd = np.einsum("rk,hwk->hwr", c2w[:3, :3], rayd)
    rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
    return rayo.astype(np.float32), rayd.astype(np.float32)


def ndc_rays(h, w, focal, near, rays_o, rays_d):
    """Shift rays to normalized device coordinates (the NeRF forward-facing
    convention; datasets/nerf.py:216-266 NDC support)."""
    rays_o = np.asarray(rays_o, np.float64)
    rays_d = np.asarray(rays_d, np.float64)
    # shift origins to the near plane
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -focal / (0.5 * w) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -focal / (0.5 * h) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -focal / (0.5 * w) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -focal / (0.5 * h) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return (np.stack([o0, o1, o2], -1).astype(np.float32),
            np.stack([d0, d1, d2], -1).astype(np.float32))
