"""ArUco calibration output -> NeuS camera file (counterpart of
vqnerf_release_tpu/preprocess/aruco_cameras.py, with the port's io in
place of cv2).

Reads tmp/poses.npy ([N, 2, 3] rvec | tvec) and tmp/intrinsic.npy from the
calibrator, builds per view world_mat = K @ [R | t] (w2c) with identity
scale mats, and writes preprocessed/cameras_sphere.npz plus the
centre-cropped image/ and mask/ directories. The undistorted images are
read as cv2.imread(path) reads them (``data.io.imread_color``) and
written as 8-bit RGB PNGs with the same pixels.
"""

import os
from glob import glob
from os.path import join

import numpy as np

from ..data import io as vio

__all__ = ["convert_cameras", "rodrigues"]


def rodrigues(rvec):
    """Rotation matrix from an axis-angle vector (cv2.Rodrigues)."""
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def convert_cameras(work_dir, crop_pixels=0):
    poses = np.load(join(work_dir, "tmp", "poses.npy"))
    intrinsic_raw = np.load(join(work_dir, "tmp", "intrinsic.npy"))
    n_images = len(poses)

    intrinsic = np.eye(4, dtype=np.float32)
    intrinsic[:3, :3] = intrinsic_raw
    intrinsic[0, 2] -= crop_pixels
    intrinsic[1, 2] -= crop_pixels

    cam_dict = {}
    for i in range(n_images):
        rot = rodrigues(np.asarray(poses[i][0], np.float64))
        pose = np.eye(4)
        pose[:3, :3] = rot
        pose[:3, 3] = poses[i][1]  # w2c
        world_mat = (intrinsic @ pose).astype(np.float32)
        cam_dict["camera_mat_%d" % i] = intrinsic
        cam_dict["camera_mat_inv_%d" % i] = np.linalg.inv(intrinsic)
        cam_dict["world_mat_%d" % i] = world_mat
        cam_dict["world_mat_inv_%d" % i] = np.linalg.inv(world_mat)
        cam_dict["scale_mat_%d" % i] = np.eye(4, dtype=np.float32)
        cam_dict["scale_mat_inv_%d" % i] = np.eye(4, dtype=np.float32)

    out_dir = join(work_dir, "preprocessed")
    os.makedirs(join(out_dir, "image"), exist_ok=True)
    os.makedirs(join(out_dir, "mask"), exist_ok=True)
    np.savez(join(out_dir, "cameras_sphere.npz"), **cam_dict)

    image_list = sorted(glob(join(work_dir, "tmp", "image_undistort",
                                  "*.png")))
    for i, path in enumerate(image_list):
        img = vio.imread_color(path)
        if crop_pixels > 0:
            img = img[crop_pixels:-crop_pixels, crop_pixels:-crop_pixels]
        vio.write_png(join(out_dir, "image", "%03d.png" % i), img)
        mask = np.full(img.shape[:2], 255, np.uint8)
        vio.write_png(join(out_dir, "mask", "%03d.png" % i), mask)
    return out_dir
