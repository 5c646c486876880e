"""Per-view output writers and video-frame helpers (counterpart of
vqnerf_release_tpu/utils/vis.py), without OpenCV or PIL.

Writes, per view directory, the same files as the JAX writer:
pred_rgb.png / gt_rgb.png (alpha-blended), pred_{albedo,spec,rough,ks,
basecolor}.{png,npy}, pred_normal.png, pred_rgb_probes_<name>.png,
pred_rgb_olat_<name>.png, embed_map.png with pred_embed.npy, the linear
component renders pred_rgb_{diff,spec}.{png,npy}, and metadata.json. In
validation mode the metadata carries the PSNR and luma PSNR of pred_rgb
against gt_rgb, and a pred-vs-gt_rgb.apng flipbook is written
(``make_anim``).

``make_frame`` composes one video frame from a batch dir's buffer PNGs and
``make_anim`` writes an animated PNG flipbook, as the JAX functions do.
"""

import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..eval.metrics import psnr, psnr_luma

__all__ = ["EMBED_COLORS", "vis_embed_map", "vis_view", "make_anim",
           "make_frame"]


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


def make_anim(frames, outpath, duration=1000):
    """Animated PNG flipbook that loops forever, the first frame also the
    still image; returns ``str(outpath)``. As PIL's APNG writer, which the
    JAX function goes through, a frame equal to the one before it lengthens
    that one's delay, and a single frame left is written as a still PNG.
    Frames share one shape and dtype (uint8 or uint16)."""
    kept, delays = [], []
    for f in frames:
        f = _to_numpy(f)
        if kept and np.array_equal(f, kept[-1]):
            delays[-1] += duration
        else:
            kept.append(f)
            delays.append(duration)
    os.makedirs(os.path.dirname(str(outpath)) or ".", exist_ok=True)
    if len(kept) == 1:
        vio.write_png(str(outpath), kept[0])
    else:
        vio.write_apng(str(outpath), kept, delays)
    return str(outpath)


def vis_view(to_vis, hw, outdir, view_id, white_bg=True, mode="test",
             probe_names=None, olat_names=None, alpha_thres=0.8):
    """to_vis: dict of [N, ...] ray arrays or tensors keyed pred_*/gt_*.
    Returns the written images (uint8) by key."""
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
        elif k.endswith(("rgb_diff", "rgb_spec")):
            np.save(join(outdir, k + ".npy"), v)
            img = _blend(v, alpha, white_bg)
            img_dict[k] = vio.write_img(img, join(outdir, k + ".png"))
        elif k.endswith("xyz"):
            np.save(join(outdir, k + ".npy"), v)
        elif k.endswith("alpha"):
            img_dict[k] = vio.write_img(v, join(outdir, k + ".png"))
        elif k.endswith("lvis"):
            img = _blend(np.mean(v, axis=2), alpha, white_bg)
            img_dict[k] = vio.write_img(img, join(outdir, k + ".png"))

    metadata = {"id": str(view_id)}
    if mode not in ("test", "render") and "gt_rgb" in img_dict \
            and "pred_rgb" in img_dict:
        gt, pred = img_dict["gt_rgb"], img_dict["pred_rgb"]
        metadata["psnr"] = psnr(gt, pred)
        metadata["psnr_luma"] = psnr_luma(gt, pred)
        make_anim([gt, pred], join(outdir, "pred-vs-gt_rgb.apng"))
    vio.write_json(metadata, join(outdir, "metadata.json"))
    return img_dict


def make_frame(batch_dir, layout, rgb_embed_light=None, pad=2):
    """Compose one video frame from a batch dir's buffer PNGs laid out as
    rows x cols of buffer names. A cell reads '<name>.png', else
    'pred_<name>.png' (``imread_color``: RGB, uint8); 'nn' or a name with
    neither file is a black cell. Every cell takes the size of the last
    one found, in row-major order (bilinear, ``resize_u8_linear``); the
    light thumbnail goes into the bottom-left corner of each cell whose
    name starts with 'rgb' where it fits; white gutters ``pad`` wide
    separate cells and rows. Returns an HxWx3 uint8 frame, or None where
    no cell was found. A file that does not decode raises."""
    cells = []
    size = None
    for row in layout:
        r = []
        for name in row:
            img = None
            if name != "nn":
                for cand in (name + ".png", "pred_" + name + ".png"):
                    path = os.path.join(batch_dir, cand)
                    if os.path.exists(path):
                        img = vio.imread_color(path)
                        break
            if img is not None:
                size = img.shape[:2]
            r.append((name, img))
        cells.append(r)
    if size is None:
        return None
    h, w = size
    rows_img = []
    for r in cells:
        row_imgs = []
        for name, img in r:
            if img is None:
                img = np.zeros((h, w, 3), np.uint8)
            elif img.shape[:2] != (h, w):
                img = vio.resize_u8_linear(img, h, w)
            if name.startswith("rgb") and rgb_embed_light is not None:
                light = _to_numpy(rgb_embed_light)
                lh, lw = light.shape[:2]
                if lh < h and lw < w:
                    img = img.copy()
                    img[-lh:, :lw] = light[..., :3]
            row_imgs.append(img)
            row_imgs.append(np.full((h, pad, 3), 255, np.uint8))
        rows_img.append(np.concatenate(row_imgs[:-1], axis=1))
        rows_img.append(
            np.full((pad, rows_img[-1].shape[1], 3), 255, np.uint8))
    return np.concatenate(rows_img[:-1], axis=0)
