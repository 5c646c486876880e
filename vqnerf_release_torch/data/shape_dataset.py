"""Stage-2 view dataset (counterpart of ShapeView/ShapeDataset in
vqnerf_release_tpu/data/shape_dataset.py), read without OpenCV.

Layout: data_root/{train,val}_NNN/{metadata.json, rgba.png} and
data_nerf_root/<view>/{xyz.npy, normal.npy, alpha.png[, lvis.npy, rgb.png]}.
Each view is loaded whole into host numpy arrays with the same fixes as the
JAX loader: collapsed xyz moved 0.1 along the ray, zero normals set to
(0, 1, 0) and renormalized, RGB alpha-blended onto the background, and in
test mode the ground-truth alpha replaced by the predicted one. Rays come
from the port's own ``data/rays.py``.

``VideoDataset`` reads a video trajectory: <video_root>/test_NNN/ holds a
frame's metadata.json and all its buffers, the rendered rgb.png stands for
both the pseudo-GT rgb and the reference buffer, and frames are taken every
``interp``-th.
"""

import glob
import os
from dataclasses import dataclass
from os.path import basename, dirname, join
from typing import List, Optional

import numpy as np

from . import io as vio
from . import rays as vrays

__all__ = ["ShapeView", "ShapeDataset", "VideoDataset"]


@dataclass
class ShapeView:
    id: str
    h: int
    w: int
    rayo: np.ndarray  # [N, 3]
    rayd: np.ndarray  # [N, 3]
    rgb: np.ndarray  # [N, 3]
    alpha: np.ndarray  # [N, 1]
    pred_alpha: np.ndarray  # [N, 1]
    xyz: np.ndarray  # [N, 3]
    normal: np.ndarray  # [N, 3]
    lvis: Optional[np.ndarray] = None  # [N, L]
    ref: Optional[np.ndarray] = None  # [N, 3]

    def as_batch(self):
        b = {
            "rayo": self.rayo, "rayd": self.rayd, "rgb": self.rgb,
            "alpha": self.alpha, "pred_alpha": self.pred_alpha,
            "xyz": self.xyz, "normal": self.normal,
        }
        if self.lvis is not None:
            b["lvis"] = self.lvis
        if self.ref is not None:
            b["ref"] = self.ref
        return b


def _fix_buffers(xyz, normal, rayo, rayd):
    """Move collapsed xyz (on the ray origin) 0.1 along the ray, in place;
    returns the normals with zero ones set to (0, 1, 0), renormalized."""
    zero_bg = np.linalg.norm(xyz - rayo, axis=-1) == 0.0
    xyz[zero_bg] = rayo[zero_bg] + rayd[zero_bg] * 0.1
    zero_n = np.mean(normal, axis=-1) == 0.0
    normal[zero_n] = np.array([0.0, 1.0, 0.0], np.float32)
    return normal / np.maximum(
        np.linalg.norm(normal, axis=-1, keepdims=True), 1e-12)


class ShapeDataset:
    def __init__(self, data_root, data_nerf_root, data_type="nerf",
                 imh=512, white_bg=True, mode="train", with_ref=False):
        if mode not in ("train", "vali", "test", "render"):
            raise ValueError(f"unknown mode {mode!r}")
        self.data_root = data_root
        self.data_nerf_root = data_nerf_root
        self.data_type = data_type
        self.imh = imh
        self.white_bg = white_bg
        self.mode = mode
        self.with_ref = with_ref
        self.files = self._glob()

    def _glob(self) -> List[str]:
        mode_str = "train" if self.mode in ("train", "render") else "val"
        meta_dirs = sorted(glob.glob(join(self.data_root, "%s_???" % mode_str)))
        out = []
        for d in meta_dirs:
            mp = join(d, "metadata.json")
            if not os.path.exists(mp):
                continue
            vid = basename(d)
            need = [
                join(self.data_nerf_root, vid, "xyz.npy"),
                join(self.data_nerf_root, vid, "normal.npy"),
                join(self.data_nerf_root, vid, "alpha.png"),
                join(d, "rgba.png"),
            ]
            if self.data_type == "nerf":
                need.append(join(self.data_nerf_root, vid, "lvis.npy"))
            if self.with_ref:
                need.append(join(self.data_nerf_root, vid, "rgb.png"))
            if all(os.path.exists(p) for p in need):
                out.append(mp)
        return out

    def __len__(self):
        return len(self.files)

    def _gen_rays(self, metadata):
        if self.data_type == "dtu":
            return vrays.dtu_rays(
                np.array(metadata["world_mat"]),
                np.array(metadata["scale_mat"]),
                metadata["imh"], metadata["imw"], self.imh)
        imh, imw = self.imh, int(
            metadata["imw"] * self.imh / metadata["imh"])
        c2w = np.array(
            [float(x) for x in metadata["cam_transform_mat"].split(",")]
        ).reshape(4, 4)
        cx = cy = None
        if "cx" in metadata:
            k = self.imh / metadata["imh"]
            cx, cy = k * metadata["cx"], k * metadata["cy"]
        return vrays.nerf_rays(
            c2w, metadata["cam_angle_x"], imh, imw, cx=cx, cy=cy)

    def load_view(self, metadata_path) -> ShapeView:
        metadata = vio.read_json(metadata_path)
        view_dir = dirname(metadata_path)
        vid = basename(view_dir)
        nerf_dir = join(self.data_nerf_root, vid)

        rayo, rayd = self._gen_rays(metadata)
        imh, imw = rayo.shape[:2]

        xyz = np.load(join(nerf_dir, "xyz.npy")).astype(np.float32)
        normal = np.load(join(nerf_dir, "normal.npy")).astype(np.float32)
        pred_alpha = vio.load_img_f32(join(nerf_dir, "alpha.png"))
        if pred_alpha.ndim == 3:
            pred_alpha = pred_alpha[..., 0]
        rgba = vio.load_img_f32(join(view_dir, "rgba.png"))
        if rgba.ndim != 3 or rgba.shape[2] != 4:
            raise ValueError(f"{view_dir}/rgba.png must be RGBA")
        rgb = rgba[..., :3]
        alpha = pred_alpha if self.mode == "test" else rgba[..., 3]

        if imh != xyz.shape[0]:
            xyz = vio.resize(xyz, new_h=imh)
        if imh != normal.shape[0]:
            normal = vio.resize(normal, new_h=imh)
        if imh != alpha.shape[0]:
            alpha = vio.resize(alpha, new_h=imh)
        if imh != pred_alpha.shape[0]:
            pred_alpha = vio.resize(pred_alpha, new_h=imh)
        if imh != rgb.shape[0]:
            rgb = vio.resize(rgb, new_h=imh)

        normal = _fix_buffers(xyz, normal, rayo, rayd)

        bg = np.ones_like(rgb) if self.white_bg else np.zeros_like(rgb)
        rgb = vio.alpha_blend(rgb, alpha, bg).astype(np.float32)

        view = ShapeView(
            id=vid, h=imh, w=imw,
            rayo=rayo.reshape(-1, 3), rayd=rayd.reshape(-1, 3),
            rgb=rgb.reshape(-1, 3),
            alpha=alpha.reshape(-1, 1).astype(np.float32),
            pred_alpha=pred_alpha.reshape(-1, 1).astype(np.float32),
            xyz=xyz.reshape(-1, 3), normal=normal.reshape(-1, 3))
        if self.data_type == "nerf":
            lvis = np.load(join(nerf_dir, "lvis.npy")).astype(np.float32)
            if imh != lvis.shape[0]:
                lvis = vio.resize(lvis, new_h=imh)
            view.lvis = np.clip(lvis, 0, 1).reshape(imh * imw, -1)
        if self.with_ref:
            ref = vio.load_img_f32(join(nerf_dir, "rgb.png"))[..., :3]
            if imh != ref.shape[0]:
                ref = vio.resize(ref, new_h=imh)
            view.ref = ref.reshape(-1, 3)
        return view


class VideoDataset(ShapeDataset):
    """The frames of a video trajectory, in test mode (no GT alpha)."""

    def __init__(self, video_root, data_type="nerf", imh=512,
                 white_bg=True, interp=1, with_ref=True):
        self.video_root = video_root
        self.data_root = video_root
        self.data_nerf_root = video_root
        self.data_type = data_type
        self.imh = imh
        self.white_bg = white_bg
        self.mode = "test"
        self.with_ref = with_ref
        self.interp = interp
        self.files = self._glob_video()

    def _glob_video(self):
        metas = sorted(
            glob.glob(join(self.video_root, "test_???", "metadata.json")))
        out = []
        for mp in metas[:: self.interp]:
            d = dirname(mp)
            need = [join(d, "xyz.npy"), join(d, "normal.npy"),
                    join(d, "alpha.png"), join(d, "rgb.png")]
            if self.data_type == "nerf":
                need.append(join(d, "lvis.npy"))
            if all(os.path.exists(p) for p in need):
                out.append(mp)
        return out

    def _gen_video_rays(self, metadata, buf_h, buf_w):
        """Rays from a frame's metadata: focal/cx/cy + c2w (NeRF-style
        trajectories) or intrinsic + c2w (DTU), at the buffers' size
        rescaled to ``imh``; the train metadata's form otherwise."""
        cm = metadata["cam_transform_mat"]
        c2w = np.asarray(
            [float(x) for x in cm.split(",")] if isinstance(cm, str)
            else cm, np.float64).reshape(4, 4)
        k = self.imh / buf_h
        imh, imw = self.imh, int(round(buf_w * k))
        if "intrinsic" in metadata:
            intr = np.asarray(metadata["intrinsic"], np.float64).copy()
            intr = intr.reshape(4, 4)
            intr[:2, :3] *= k
            return vrays.video_dtu_rays(c2w, intr, imh, imw)
        if "focal" in metadata:
            cx = metadata.get("cx")
            cy = metadata.get("cy")
            return vrays.video_nerf_rays(
                c2w, metadata["focal"] * k, imh, imw,
                cx=None if cx is None else cx * k,
                cy=None if cy is None else cy * k)
        return self._gen_rays(metadata)

    def load_view(self, metadata_path) -> ShapeView:
        metadata = vio.read_json(metadata_path)
        vdir = dirname(metadata_path)
        buf_shape = np.load(join(vdir, "xyz.npy"), mmap_mode="r").shape
        rayo, rayd = self._gen_video_rays(
            metadata, buf_shape[0], buf_shape[1])
        imh, imw = rayo.shape[:2]

        xyz = np.load(join(vdir, "xyz.npy")).astype(np.float32)
        normal = np.load(join(vdir, "normal.npy")).astype(np.float32)
        pred_alpha = vio.load_img_f32(join(vdir, "alpha.png"))
        if pred_alpha.ndim == 3:
            pred_alpha = pred_alpha[..., 0]
        rgb = vio.load_img_f32(join(vdir, "rgb.png"))[..., :3]

        if imh != xyz.shape[0]:
            xyz = vio.resize(xyz, new_h=imh)
        if imh != normal.shape[0]:
            normal = vio.resize(normal, new_h=imh)
        if imh != pred_alpha.shape[0]:
            pred_alpha = vio.resize(pred_alpha, new_h=imh)
        if imh != rgb.shape[0]:
            rgb = vio.resize(rgb, new_h=imh)
        normal = _fix_buffers(xyz, normal, rayo, rayd)

        alpha = pred_alpha.reshape(-1, 1).astype(np.float32)
        view = ShapeView(
            id=basename(vdir), h=imh, w=imw,
            rayo=rayo.reshape(-1, 3), rayd=rayd.reshape(-1, 3),
            rgb=rgb.reshape(-1, 3).astype(np.float32),
            alpha=alpha, pred_alpha=alpha,
            xyz=xyz.reshape(-1, 3), normal=normal.reshape(-1, 3))
        if self.data_type == "nerf":
            lvis = np.load(join(vdir, "lvis.npy")).astype(np.float32)
            if imh != lvis.shape[0]:
                lvis = vio.resize(lvis, new_h=imh)
            view.lvis = np.clip(lvis, 0, 1).reshape(imh * imw, -1)
        if self.with_ref:
            view.ref = view.rgb
        return view
