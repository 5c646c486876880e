"""COLMAP sparse-model reading and pose conversion (the port's copy of
vqnerf_release_tpu/preprocess/colmap_model.py, numpy only; tests hold the
two bit for bit).

  * binary model parsing (cameras.bin / images.bin / points3D.bin, the
    public COLMAP format)
  * poses_bounds.npy rows: per image [3, 5] (c2w | [h, w, f]) in the LLFF
    axis convention plus near/far depth bounds from the visible points
  * NeuS cameras_sphere.npz: world_mat = K @ w2c with a scale matrix that
    puts the point cloud into the unit sphere
"""

import collections
import os
import struct

import numpy as np

__all__ = [
    "read_cameras_binary", "read_images_binary", "read_points3d_binary",
    "qvec2rotmat", "compute_poses_bounds", "neus_cameras_from_colmap",
]

Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"])
Image = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys",
              "point3d_ids"])
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids"])

_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5), 4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8), 6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path):
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, n_params = _CAMERA_MODELS[model_id]
            params = np.array(_read(f, "<%dd" % n_params))
            out[cam_id] = Camera(cam_id, name, width, height, params)
    return out


def read_images_binary(path):
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            data = np.array(_read(f, "<%dd" % (3 * n_pts))).reshape(-1, 3)
            xys = data[:, :2]
            ids = data[:, 2].astype(np.int64)
            out[img_id] = Image(img_id, qvec, tvec, cam_id,
                                name.decode(), xys, ids)
    return out


def read_points3d_binary(path):
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.array(
                _read(f, "<%di" % (2 * track_len))).reshape(-1, 2)
            out[pid] = Point3D(pid, xyz, rgb, err, track[:, 0])
    return out


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y]])


def _focal(cam):
    return cam.params[0]


def compute_poses_bounds(cameras, images, points3d):
    """poses_bounds [N, 17]: flattened [3,5] (LLFF c2w | hwf) + near/far
    (pose_utils.py:246+ semantics: bounds from 0.1/99.9 percentiles of
    visible point depths scaled by 0.9/5.0... we use the common
    min*0.9/max*5 rule of the LLFF script)."""
    rows = []
    for img_id in sorted(images, key=lambda i: images[i].name):
        im = images[img_id]
        cam = cameras[im.camera_id]
        R = qvec2rotmat(im.qvec)
        t = im.tvec
        c2w_R = R.T
        c2w_t = -R.T @ t
        # world->llff axis flip: [-y, x, z] columns (LLFF convention)
        m = np.concatenate(
            [c2w_R[:, 1:2], c2w_R[:, 0:1], -c2w_R[:, 2:3],
             c2w_t[:, None]], axis=1)
        hwf = np.array([[cam.height], [cam.width], [_focal(cam)]])
        mat = np.concatenate([m, hwf], axis=1)  # [3, 5]

        depths = []
        for pid in im.point3d_ids:
            if pid == -1 or pid not in points3d:
                continue
            z = (R @ points3d[pid].xyz + t)[2]
            if z > 0:
                depths.append(z)
        if depths:
            near, far = np.min(depths) * 0.9, np.max(depths) * 5.0
        else:
            near, far = 0.1, 10.0
        rows.append(np.concatenate([mat.ravel(), [near, far]]))
    return np.stack(rows)


def neus_cameras_from_colmap(cameras, images, points3d, out_npz=None):
    """cameras_sphere.npz: world_mat_i = K @ w2c_i; scale_mat from the
    bounding sphere of the point cloud (gen_cameras.py of the colmap
    pipeline)."""
    pts = np.stack([p.xyz for p in points3d.values()]) \
        if points3d else np.zeros((1, 3))
    center = pts.mean(axis=0)
    radius = float(np.percentile(
        np.linalg.norm(pts - center, axis=1), 99.0)) or 1.0
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= radius
    scale_mat[:3, 3] = center

    cam_dict = {}
    for i, img_id in enumerate(
            sorted(images, key=lambda k: images[k].name)):
        im = images[img_id]
        cam = cameras[im.camera_id]
        K = np.eye(4)
        K[0, 0] = K[1, 1] = _focal(cam)
        if cam.model == "PINHOLE":
            K[1, 1] = cam.params[1]
            K[0, 2], K[1, 2] = cam.params[2], cam.params[3]
        else:
            K[0, 2], K[1, 2] = cam.params[1], cam.params[2]
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(im.qvec)
        w2c[:3, 3] = im.tvec
        world_mat = (K @ w2c).astype(np.float32)
        cam_dict["world_mat_%d" % i] = world_mat
        cam_dict["world_mat_inv_%d" % i] = np.linalg.inv(world_mat)
        cam_dict["scale_mat_%d" % i] = scale_mat.astype(np.float32)
        cam_dict["scale_mat_inv_%d" % i] = np.linalg.inv(
            scale_mat).astype(np.float32)
    if out_npz:
        os.makedirs(os.path.dirname(out_npz) or ".", exist_ok=True)
        np.savez(out_npz, **cam_dict)
    return cam_dict
