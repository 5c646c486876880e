"""COLMAP SfM driver (the port's copy of
vqnerf_release_tpu/preprocess/colmap_wrapper.py): feature extraction,
matching and mapping by the colmap binary through subprocess where it is
installed, then the sparse model converted to poses_bounds.npy and NeuS
cameras. The conversion works on any existing sparse/0 directory.
"""

import os
import shutil
import subprocess
from os.path import join

import numpy as np

from . import colmap_model as cm

__all__ = ["run_colmap", "imgs2poses"]


def run_colmap(scene_dir, match_type="exhaustive_matcher",
               colmap_bin="colmap"):
    """feature_extractor -> matcher -> mapper (colmap_wrapper.py)."""
    if shutil.which(colmap_bin) is None:
        raise FileNotFoundError(
            "colmap binary not found on PATH — install COLMAP or convert "
            "an existing sparse model with imgs2poses(run_sfm=False)")
    db = join(scene_dir, "database.db")
    sparse = join(scene_dir, "sparse")
    os.makedirs(sparse, exist_ok=True)
    logfile = join(scene_dir, "colmap_output.txt")
    with open(logfile, "w") as log:
        subprocess.check_call(
            [colmap_bin, "feature_extractor", "--database_path", db,
             "--image_path", join(scene_dir, "images"),
             "--ImageReader.single_camera", "1"], stdout=log, stderr=log)
        subprocess.check_call(
            [colmap_bin, match_type, "--database_path", db],
            stdout=log, stderr=log)
        subprocess.check_call(
            [colmap_bin, "mapper", "--database_path", db, "--image_path",
             join(scene_dir, "images"), "--output_path", sparse],
            stdout=log, stderr=log)
    return join(sparse, "0")


def imgs2poses(scene_dir, run_sfm=True, colmap_bin="colmap"):
    """Full imgs2poses flow: (optionally) run SfM, then write
    poses_bounds.npy and preprocessed/cameras_sphere.npz."""
    model_dir = join(scene_dir, "sparse", "0")
    if run_sfm and not os.path.isdir(model_dir):
        model_dir = run_colmap(scene_dir, colmap_bin=colmap_bin)
    cams = cm.read_cameras_binary(join(model_dir, "cameras.bin"))
    imgs = cm.read_images_binary(join(model_dir, "images.bin"))
    p3d = cm.read_points3d_binary(join(model_dir, "points3D.bin"))
    pb = cm.compute_poses_bounds(cams, imgs, p3d)
    np.save(join(scene_dir, "poses_bounds.npy"), pb)
    out_npz = join(scene_dir, "preprocessed", "cameras_sphere.npz")
    cm.neus_cameras_from_colmap(cams, imgs, p3d, out_npz=out_npz)
    return pb
