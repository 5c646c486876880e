"""Stage-1 (geometry) scene datasets (counterpart of the two scene classes
of vqnerf_release_tpu/data/neus_dataset.py, on the port's own io and rays).

  * NeRF convention: transforms_{train,val}.json with per-frame c2w and
    camera_angle_x (and optional cx/cy); 16-bit RGBA images at
    <data_dir>/{train,val}_*/rgba.png; fixed near/far; max_radius from the
    camera frustum corners.
  * DTU convention: {train,val}.json with world_mat/scale_mat lists;
    P-matrix decomposition; radius 1; per-ray sphere near/far (mid -/+ 1).
  * Video trajectories (cameras only, no images): transforms_test.json in
    the NeRF convention, or DTU's test.json (c2w poses and one intrinsic at
    the capture resolution, found two directories up when the scene has
    none), each frame's full-frame rays and the metadata that the stage-2
    video dataset reads back.

Images are preloaded to host numpy; rays are generated on the host and
copied to the device by the caller.
"""

import json
import os
from glob import glob

import numpy as np

from . import io as vio
from . import rays as vrays

__all__ = ["NerfSceneDataset", "DtuSceneDataset", "TrajectoryDataset",
           "DtuTrajectoryDataset"]


def _resize_all(imgs, new_h):
    """(images resized to height new_h, the factor k)."""
    h, w = imgs[0].shape[:2]
    k = new_h / h
    return [vio.resize_u8_linear(im, int(new_h), int(w * k))
            for im in imgs], k


class _Base:
    def gen_random_rays(self, img_idx, batch_size, rng):
        """A random-pixel batch as a dict of arrays."""
        xs = rng.randint(0, self.W, size=batch_size)
        ys = rng.randint(0, self.H, size=batch_size)
        color = self.images[img_idx][ys, xs]
        mask = self.masks[img_idx][ys, xs][:, :1]
        rayo, rayd = self._rays_at_pixels(img_idx, xs, ys)
        return {
            "rays_o": rayo.astype(np.float32),
            "rays_d": rayd.astype(np.float32),
            "rgb": color.astype(np.float32),
            "mask": mask.astype(np.float32),
        }

    def gen_rays_at(self, img_idx):
        xs, ys = np.meshgrid(np.arange(self.W), np.arange(self.H))
        rayo, rayd = self._rays_at_pixels(
            img_idx, xs.reshape(-1), ys.reshape(-1))
        return (rayo.reshape(self.H, self.W, 3).astype(np.float32),
                rayd.reshape(self.H, self.W, 3).astype(np.float32))


class NerfSceneDataset(_Base):
    def __init__(self, data_dir, is_train=True, near=2.0, far=6.0,
                 new_h=0, longint=True):
        name = "transforms_train.json" if is_train else "transforms_val.json"
        prefix = "train_*" if is_train else "val_*"
        with open(os.path.join(data_dir, name)) as f:
            cams = json.load(f)
        self.near_v, self.far_v = near, far
        self.cx = cams.get("cx")
        self.cy = cams.get("cy")
        self.images_lis = sorted(glob(os.path.join(data_dir, prefix)))
        self.n_images = len(self.images_lis)

        imgs = [
            vio.read_rgba16(os.path.join(d, "rgba.png"), longint=longint)
            for d in self.images_lis
        ]
        if new_h > 0:
            imgs, k = _resize_all(imgs, new_h)
            if self.cx is not None:
                self.cx, self.cy = self.cx * k, self.cy * k
        self.images = np.stack([im[..., :3] for im in imgs]) / 255.0
        self.masks = np.stack(
            [np.repeat(im[..., 3:], 3, axis=-1) for im in imgs]) / 255.0

        self.poses = []
        for idx in range(self.n_images):
            pm = cams["frames"][idx]["transform_matrix"]
            if isinstance(pm, str):
                pm = [float(x) for x in pm.split(",")]
            self.poses.append(np.asarray(pm, np.float64).reshape(4, 4))
        self.H, self.W = self.images.shape[1:3]
        self.focal = 0.5 * self.W / np.tan(0.5 * cams["camera_angle_x"])
        self.max_radius = vrays.max_radius_from_poses(self.poses, near, far)

    def _rays_at_pixels(self, img_idx, xs, ys):
        cx = self.W // 2 if self.cx is None else int(self.cx)
        cy = self.H // 2 if self.cy is None else int(self.cy)
        p = np.stack(
            [(xs - cx) / self.focal, -(ys - cy) / self.focal,
             -np.ones_like(xs, np.float64)], axis=-1)
        c2w = self.poses[img_idx]
        rayd = p @ c2w[:3, :3].T
        rayd = rayd / np.linalg.norm(rayd, axis=-1, keepdims=True)
        rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
        return rayo, rayd

    def near_far(self, rays_o, rays_d):
        n = rays_o.shape[0]
        return vrays.near_far_fixed(n, self.near_v, self.far_v)


class DtuSceneDataset(_Base):
    def __init__(self, data_dir, is_train=True, new_h=0):
        name = "train.json" if is_train else "val.json"
        prefix = "train_*" if is_train else "val_*"
        with open(os.path.join(data_dir, name)) as f:
            cams = json.load(f)
        self.images_lis = sorted(glob(os.path.join(data_dir, prefix)))
        self.n_images = len(self.images_lis)

        imgs = [
            vio.read_rgba16(os.path.join(d, "rgba.png"))
            for d in self.images_lis
        ]
        k = 1.0
        if new_h > 0:
            imgs, k = _resize_all(imgs, new_h)
        self.images = np.stack([im[..., :3] for im in imgs]) / 255.0
        self.masks = np.stack(
            [np.repeat(im[..., 3:], 3, axis=-1) for im in imgs]) / 255.0

        self.poses, self.intrinsics_inv = [], []
        for idx in range(self.n_images):
            P = (np.asarray(cams["world_mat"][idx])
                 @ np.asarray(cams["scale_mat"][idx]))[0:3, 0:4]
            intr, pose = vrays.decompose_projection(P)
            intr[:2, :3] *= k
            self.poses.append(pose)
            self.intrinsics_inv.append(np.linalg.inv(intr))
        self.H, self.W = self.images.shape[1:3]
        self.k = k  # resize factor, reused by a DTU trajectory dataset
        self.data_dir = data_dir
        self.max_radius = 1.0

    def _rays_at_pixels(self, img_idx, xs, ys):
        p = np.stack([xs, ys, np.ones_like(xs, np.float64)], axis=-1)
        Kinv = self.intrinsics_inv[img_idx][:3, :3]
        p = p @ Kinv.T
        rayd = p / np.linalg.norm(p, axis=-1, keepdims=True)
        c2w = self.poses[img_idx]
        rayd = rayd @ c2w[:3, :3].T
        rayo = np.broadcast_to(c2w[:3, 3], rayd.shape).copy()
        return rayo, rayd

    def near_far(self, rays_o, rays_d):
        return vrays.near_far_sphere(rays_o, rays_d)


class TrajectoryDataset(_Base):
    """The cameras of a NeRF-convention video trajectory,
    ``transforms_test.json``, at imh x imw; fixed near/far."""

    def __init__(self, data_dir, imh, imw, near=2.0, far=6.0,
                 transforms_name="transforms_test.json"):
        with open(os.path.join(data_dir, transforms_name)) as f:
            cams = json.load(f)
        self.H, self.W = imh, imw
        self.near_v, self.far_v = near, far
        self.cx = cams.get("cx")
        self.cy = cams.get("cy")
        self.focal = 0.5 * imw / np.tan(0.5 * cams["camera_angle_x"])
        self.cam_angle_x = cams["camera_angle_x"]
        self.poses = []
        for fr in cams["frames"]:
            pm = fr["transform_matrix"]
            if isinstance(pm, str):
                pm = [float(x) for x in pm.split(",")]
            self.poses.append(np.asarray(pm, np.float64).reshape(4, 4))
        self.n_images = len(self.poses)
        self.max_radius = vrays.max_radius_from_poses(self.poses, near, far)
        self.masks = None  # a novel trajectory has no GT masks

    _rays_at_pixels = NerfSceneDataset._rays_at_pixels
    near_far = NerfSceneDataset.near_far

    def frame_metadata(self, idx):
        """The video metadata form (focal, cx/cy, c2w as nested lists) plus
        the train metadata's keys, so that either reader takes the frame."""
        return {
            "focal": float(self.focal),
            "cx": self.cx, "cy": self.cy,
            "imh": self.H, "imw": self.W,
            "cam_angle_x": self.cam_angle_x,
            "cam_transform_mat": self.poses[idx].tolist(),
        }


class DtuTrajectoryDataset(_Base):
    """The cameras of a DTU-convention video trajectory: ``test.json``'s
    c2w poses and its one intrinsic, scaled by the train set's resize
    factor; frame size from the train set."""

    def __init__(self, data_dir, train_set, cameras_name="test.json"):
        path = os.path.join(data_dir, cameras_name)
        if not os.path.exists(path):
            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(data_dir))),
                cameras_name)
        with open(path) as f:
            cams = json.load(f)
        self.H, self.W = train_set.H, train_set.W
        intr = np.asarray(cams["intrinsic"], np.float64).reshape(4, 4)
        intr[:2, :3] *= train_set.k
        self.intrinsic = intr
        self.poses = [np.asarray(p, np.float64).reshape(4, 4)
                      for p in cams["poses"]]
        self.n_images = len(self.poses)
        self.intrinsics_inv = [np.linalg.inv(intr)] * self.n_images
        self.max_radius = 1.0
        self.masks = None

    _rays_at_pixels = DtuSceneDataset._rays_at_pixels
    near_far = DtuSceneDataset.near_far

    def frame_metadata(self, idx):
        """The DTU video metadata form: the scaled intrinsic and c2w."""
        return {"intrinsic": self.intrinsic.tolist(),
                "cam_transform_mat": self.poses[idx].tolist()}
