"""Per-view output writers (counterpart of vis_view / vis_embed_map in
vqnerf_release_tpu/utils/vis.py), without OpenCV.

Writes, per view directory, the same files as the JAX writer in test mode:
pred_rgb.png / gt_rgb.png (alpha-blended), pred_{albedo,spec,rough,ks,
basecolor}.{png,npy}, pred_normal.png, pred_rgb_probes_<name>.png,
pred_rgb_olat_<name>.png, embed_map.png with pred_embed.npy, and
metadata.json. The validation-mode outputs (PSNR, flipbook, component
renders, xyz and lvis maps) come with training.
"""

import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio

__all__ = ["EMBED_COLORS", "vis_embed_map", "vis_view"]

EMBED_COLORS = np.array([
    [255, 0, 0], [0, 255, 0], [0, 0, 255],
    [255, 255, 0], [255, 0, 255], [0, 255, 255],
    [128, 0, 0], [0, 128, 0], [0, 0, 128],
    [128, 128, 0], [128, 0, 128], [0, 128, 128],
    [255, 128, 128], [128, 255, 128], [128, 128, 255],
    [255, 255, 128], [255, 128, 255], [128, 255, 255],
], np.uint8)


def vis_embed_map(embed, outpath):
    """embed: [H, W] int ids (0 = background, 1..18 = codes)."""
    embed = np.asarray(embed)
    out = np.zeros(embed.shape + (3,), np.uint8)
    for i in range(1, 19):
        out[embed == i] = EMBED_COLORS[i - 1]
    os.makedirs(os.path.dirname(str(outpath)) or ".", exist_ok=True)
    vio.write_png(outpath, out)
    return out


def _blend(v, alpha, white_bg):
    bg = np.ones_like(v) if white_bg else np.zeros_like(v)
    return vio.alpha_blend(v, alpha, bg)


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def vis_view(to_vis, hw, outdir, view_id, white_bg=True, mode="test",
             probe_names=None, olat_names=None, alpha_thres=0.8):
    """to_vis: dict of [N, ...] ray arrays or tensors keyed pred_*/gt_*.
    Returns the written images (uint8) by key."""
    if mode not in ("test", "render"):
        raise NotImplementedError(
            f"vis_view(mode={mode!r}): the validation-mode metrics come "
            "with the trainer port")
    h, w = hw
    os.makedirs(outdir, exist_ok=True)
    data = {}
    for k, v in to_vis.items():
        v = _to_numpy(v)
        if k.endswith(("rgb_olat", "rgb_probes")):
            data[k] = v.reshape(h, w, v.shape[1], 3)
        elif v.ndim == 2 and v.shape[1] == 3:
            data[k] = v.reshape(h, w, 3)
        elif v.ndim == 1 or v.shape[-1] == 1:
            data[k] = v.reshape(h, w)
        else:
            data[k] = v.reshape((h, w) + v.shape[1:])

    alpha = np.array(data.get("gt_alpha", data.get("pred_alpha")))
    alpha[alpha < alpha_thres] = 0  # stricter compositing

    img_dict = {}
    for k, v in data.items():
        if k == "pred_rgb_probes" and probe_names is not None:
            for i, name in enumerate(probe_names):
                img = _blend(v[:, :, i], alpha, white_bg)
                img_dict[k + "_" + name] = vio.write_img(
                    img, join(outdir, f"{k}_{name}.png"))
        elif k == "pred_rgb_olat" and olat_names is not None:
            for i, name in enumerate(olat_names):
                img = _blend(v[:, :, i], alpha, white_bg)
                img_dict[k + "_" + name] = vio.write_img(
                    img, join(outdir, f"{k}_{name}.png"))
        elif k.endswith("rgb"):
            img = _blend(v, alpha, white_bg)
            img_dict[k] = vio.write_img(img, join(outdir, k + ".png"))
        elif k.endswith(("albedo", "spec", "rough", "ks", "basecolor")):
            np.save(join(outdir, k + ".npy"), v)
            img_dict[k] = vio.write_img(v, join(outdir, k + ".png"))
        elif k.endswith("normal"):
            img = _blend((v + 1.0) / 2.0, alpha, white_bg)
            img_dict[k] = vio.write_img(img, join(outdir, k + ".png"))
        elif k.endswith("embed"):
            np.save(join(outdir, k + ".npy"), v.astype(np.int16))
            img_dict[k] = vis_embed_map(v, join(outdir, "embed_map.png"))
        elif k.endswith("alpha"):
            img_dict[k] = vio.write_img(v, join(outdir, k + ".png"))

    vio.write_json({"id": str(view_id)}, join(outdir, "metadata.json"))
    return img_dict
