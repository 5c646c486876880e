"""sRGB <-> linear conversions (counterpart of
vqnerf_release_tpu/ops/colorspace.py): IEC 61966-2-1 curves with the same
input clip and pow floors."""

import torch

SRGB_LINEAR_THRES = 0.0031308
SRGB_INV_THRES = 0.04045
SRGB_LINEAR_COEFF = 12.92
SRGB_EXP_COEFF = 1.055
SRGB_EXPONENT = 2.4


def linear2srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    lin = x * SRGB_LINEAR_COEFF
    safe_x = torch.clamp(x, min=SRGB_LINEAR_THRES)
    nonlin = SRGB_EXP_COEFF * safe_x ** (1.0 / SRGB_EXPONENT) - (
        SRGB_EXP_COEFF - 1.0)
    return torch.where(x <= SRGB_LINEAR_THRES, lin, nonlin)


def srgb2linear(x):
    lin = x / SRGB_LINEAR_COEFF
    base = torch.clamp((x + SRGB_EXP_COEFF - 1.0) / SRGB_EXP_COEFF, min=1e-8)
    nonlin = base ** SRGB_EXPONENT
    return torch.where(x <= SRGB_INV_THRES, lin, nonlin)
