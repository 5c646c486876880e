"""Rays-only NeRF dataset (counterpart of
vqnerf_release_tpu/data/nerf_rays_dataset.py, numpy only): per view,
camera rays and RGB(A) targets, no geometry buffers, with optional NDC
ray warping for forward-facing captures.
"""

from glob import glob
from os.path import basename, dirname, join

import numpy as np

from . import io as vio
from . import rays as vrays

__all__ = ["NerfRaysDataset"]


class NerfRaysDataset:
    def __init__(self, data_root, mode="train", imh=512, white_bg=True,
                 ndc=False, near=2.0, far=6.0):
        if mode not in ("train", "vali", "test"):
            raise ValueError(f"mode {mode!r}: train, vali or test")
        mode_str = "train" if mode == "train" else "val"
        self.files = sorted(
            glob(join(data_root, "%s_???" % mode_str, "metadata.json")))
        self.imh = imh
        self.white_bg = white_bg
        self.ndc = ndc
        self.near, self.far = near, far

    def __len__(self):
        return len(self.files)

    def load_view(self, metadata_path):
        meta = vio.read_json(metadata_path)
        vdir = dirname(metadata_path)
        imh = self.imh
        imw = int(meta["imw"] * imh / meta["imh"])
        c2w = np.array(
            [float(x) for x in meta["cam_transform_mat"].split(",")]
        ).reshape(4, 4)
        rayo, rayd = vrays.nerf_rays(
            c2w, meta["cam_angle_x"], imh, imw)
        if self.ndc:
            focal = 0.5 * imw / np.tan(0.5 * meta["cam_angle_x"])
            rayo, rayd = vrays.ndc_rays(
                imh, imw, focal, 1.0, rayo, rayd)
        rgba = vio.load_img_f32(join(vdir, "rgba.png"))
        if rgba.shape[0] != imh:
            rgba = vio.resize(rgba, new_h=imh)
        rgb, alpha = rgba[..., :3], rgba[..., 3]
        bg = np.ones_like(rgb) if self.white_bg else np.zeros_like(rgb)
        rgb = vio.alpha_blend(rgb, alpha, bg).astype(np.float32)
        return {
            "id": basename(vdir),
            "h": imh, "w": imw,
            "rayo": rayo.reshape(-1, 3),
            "rayd": rayd.reshape(-1, 3),
            "rgb": rgb.reshape(-1, 3),
            "alpha": alpha.reshape(-1, 1).astype(np.float32),
        }
