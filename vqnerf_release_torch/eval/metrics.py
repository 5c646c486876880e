"""Image quality metrics (counterpart of vqnerf_release_tpu/eval/metrics.py):
PSNR over uint8 images (data range 255) and PSNR of the BT.601 luma, in
numpy as there; MSE; SSIM with tf.image.ssim's window (11x11 Gaussian,
sigma 1.5, K1 0.01, K2 0.03, zero padding, the 5-pixel border dropped, the
mean over channels); LPIPS from the AlexNet weights at VQNERF_LPIPS_WEIGHTS
(eval/lpips_net.py) or, without them, the documented gradient-domain proxy
on another scale, with ``lpips_impl`` naming which one a value comes from.

Every function takes numpy images as the JAX ones do. SSIM, LPIPS and the
proxy compute in float64 on ``device`` (default "cuda", through
utils/device.py::resolve_device, which raises without a card); the
proxy gives the same bits on every device, SSIM and AlexNet LPIPS agree
to the last digits (the convolutions sum in each library's order).
"""

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

__all__ = ["psnr", "psnr_luma", "ssim", "lpips", "lpips_impl", "mse"]


def _to_float(img):
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float64), 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float64), 65535.0
    return img.astype(np.float64), 1.0


def mse(im1, im2):
    a, _ = _to_float(im1)
    b, _ = _to_float(im2)
    return float(np.mean((a - b) ** 2))


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


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (ax / sigma) ** 2)
    k = np.outer(g, g)
    return k / k.sum()


def ssim(im1, im2, data_range=None, k1=0.01, k2=0.03, device="cuda"):
    """tf.image.ssim's SSIM: the window's local statistics by one float64
    convolution on ``device`` with zero padding (scipy.ndimage.convolve's
    mode "constant"; the window is symmetric, so correlation equals
    convolution), the 5-pixel border dropped, the mean over the rest and
    over the channels."""
    device = resolve_device(device)
    a, rng_a = _to_float(im1)
    b, _ = _to_float(im2)
    rng = data_range if data_range is not None else rng_a
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    x = torch.as_tensor(a, device=device).permute(2, 0, 1)
    y = torch.as_tensor(b, device=device).permute(2, 0, 1)
    kern = torch.as_tensor(_gaussian_kernel(), device=device)[None, None]
    c1 = (k1 * rng) ** 2
    c2 = (k2 * rng) ** 2
    stats = torch.cat([x, y, x * x, y * y, x * y])[:, None]
    stats = F.conv2d(stats, kern, padding=5)[:, 0]
    mu_x, mu_y, xx, yy, xy = stats.chunk(5)
    var_x = xx - mu_x**2
    var_y = yy - mu_y**2
    cov = xy - mu_x * mu_y
    s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
        (mu_x**2 + mu_y**2 + c1) * (var_x + var_y + c2))
    pad = 5
    return float(s[:, pad:-pad, pad:-pad].mean())


def _lpips_proxy(im1, im2, device="cuda"):
    """The documented LPIPS substitute when no weights are available: the
    root of the pixel MSE plus the root of the MSE of the luma's gradient
    (np.gradient's central differences, one-sided at the edges), in
    [0, 1] space; monotone with perceptual difference on the distortions
    evaluated, NOT the published LPIPS scale. Elementwise on ``device``,
    the means on the host."""
    device = resolve_device(device)
    a, rng = _to_float(im1)
    b, _ = _to_float(im2)
    a = torch.as_tensor(a / rng, device=device)
    b = torch.as_tensor(b / rng, device=device)
    gax, gay = torch.gradient(_luma(a) if a.ndim == 3 else a)
    gbx, gby = torch.gradient(_luma(b) if b.ndim == 3 else b)
    pix = np.mean(((a - b) ** 2).cpu().numpy())
    grad = np.mean(((gax - gbx) ** 2 + (gay - gby) ** 2).cpu().numpy())
    return float(np.sqrt(pix) + np.sqrt(grad))


_PROXY_WARNED = False


def lpips_impl():
    """Which backend an lpips value comes from: "alexnet" (weights at
    VQNERF_LPIPS_WEIGHTS) or "proxy" (a gradient-domain substitute on
    another scale). Writers of metric JSONs record it beside the values."""
    weights_path = os.environ.get("VQNERF_LPIPS_WEIGHTS", "")
    if weights_path and os.path.exists(weights_path):
        return "alexnet"
    return "proxy"


def lpips(im1, im2, device="cuda"):
    global _PROXY_WARNED
    if lpips_impl() == "alexnet":
        from .lpips_net import lpips_from_weights
        return lpips_from_weights(
            im1, im2, os.environ["VQNERF_LPIPS_WEIGHTS"], device=device)
    if not _PROXY_WARNED:
        _PROXY_WARNED = True
        warnings.warn(
            "VQNERF_LPIPS_WEIGHTS unset: 'lpips' values are the documented "
            "gradient-domain proxy, not AlexNet LPIPS (different scale). "
            "Output JSONs carry lpips_impl='proxy'.")
    return _lpips_proxy(im1, im2, device=device)
