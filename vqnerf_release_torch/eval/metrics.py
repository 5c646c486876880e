"""Image quality metrics of the validation writers (the port's own copy of
what it uses from vqnerf_release_tpu/eval/metrics.py, numpy only): PSNR over
uint8 images (data range 255), PSNR of the BT.601 luma, and the name of the
LPIPS backend that the metric JSONs record.
"""

import os

import numpy as np

__all__ = ["psnr", "psnr_luma", "lpips_impl"]


def _to_float(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float64), 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float64), 65535.0
    return img.astype(np.float64), 1.0


def psnr(im1, im2):
    a, rng = _to_float(im1)
    b, _ = _to_float(im2)
    err = np.mean((a - b) ** 2)
    return float(10.0 * np.log10(rng**2 / max(err, 1e-12)))


def _luma(img):
    # ITU-R BT.601
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def psnr_luma(im1, im2):
    a, rng = _to_float(im1)
    b, _ = _to_float(im2)
    err = np.mean((_luma(a) - _luma(b)) ** 2)
    return float(10.0 * np.log10(rng**2 / max(err, 1e-12)))


def lpips_impl():
    """Which backend an lpips value comes from: "alexnet" (weights at
    VQNERF_LPIPS_WEIGHTS) or "proxy" (a gradient-domain substitute on
    another scale). Writers of metric JSONs record it beside the values."""
    weights_path = os.environ.get("VQNERF_LPIPS_WEIGHTS", "")
    if weights_path and os.path.exists(weights_path):
        return "alexnet"
    return "proxy"
