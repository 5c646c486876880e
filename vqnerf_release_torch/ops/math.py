"""Safe math primitives (counterpart of vqnerf_release_tpu/ops/math.py).

The formulas are written as the JAX package writes them, so that values
agree to the last bits where the arithmetic allows: in particular
``safe_l2_normalize`` is TF's ``x * rsqrt(max(sum(x**2), eps))`` and not
``torch.nn.functional.normalize`` (which divides by ``max(||x||, 1e-12)``
and differs on short vectors).
"""

import torch

__all__ = ["divide_no_nan", "clip_preserve_gradient", "safe_l2_normalize",
           "rgb2chromaticity"]


def divide_no_nan(x, y):
    """x / y, and 0 where y == 0 (``tf.math.divide_no_nan``)."""
    ok = y != 0
    safe_y = torch.where(ok, y, torch.ones_like(y))
    return torch.where(ok, x / safe_y, torch.zeros_like(x))


def clip_preserve_gradient(x, lo, hi):
    """Clip the value to [lo, hi]; let the gradient through unclipped
    (``tfp.math.clip_by_value_preserve_gradient``)."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def safe_l2_normalize(x, axis=None, eps=1e-6):
    """``x * rsqrt(max(sum(x**2, axis), eps))`` (TF epsilon semantics)."""
    if axis is None:
        sq = torch.sum(torch.square(x))
    else:
        sq = torch.sum(torch.square(x), dim=axis, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


def rgb2chromaticity(rgb):
    """rgb / ||rgb||_2, 0 where the norm vanishes."""
    denom = torch.sqrt(torch.sum(torch.square(rgb), dim=-1, keepdim=True))
    return divide_no_nan(rgb, denom)
