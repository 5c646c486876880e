"""Safe math primitives (counterpart of vqnerf_release_tpu/ops/math.py).

The formulas are written as the JAX package writes them, so that values
agree to the last bits where the arithmetic allows: in particular
``safe_l2_normalize`` is TF's ``x * rsqrt(max(sum(x**2), eps))`` and not
``torch.nn.functional.normalize`` (which divides by ``max(||x||, 1e-12)``
and differs on short vectors).
"""

import torch

__all__ = ["divide_no_nan", "clip_preserve_gradient", "safe_l2_normalize",
           "safe_atan2", "safe_acos", "rgb2chromaticity"]


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


class _SafeAtan2(torch.autograd.Function):
    """atan2(x, y) whose gradient has eps in the squared norm's place, so
    it stays finite at (0, 0) (util/math.py:24-38 of the reference)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return torch.atan2(x, y)

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        denom = x**2 + y**2 + 1e-6
        return grad * (y / denom), grad * (-x / denom)


class _SafeAcos(torch.autograd.Function):
    """acos of x clipped to [-1, 1], with the gradient
    -1 / (sqrt(1 - x^2 + eps) + eps) of the clipped x, finite at +/-1
    (util/math.py:41-60 of the reference)."""

    @staticmethod
    def forward(ctx, x):
        x_clip = torch.clamp(x, -1.0, 1.0)
        ctx.save_for_backward(x_clip)
        return torch.acos(x_clip)

    @staticmethod
    def backward(ctx, grad):
        (x_clip,) = ctx.saved_tensors
        return grad * (-1.0 / (torch.sqrt(1.0 - x_clip**2 + 1e-6) + 1e-6))


def safe_atan2(x, y):
    """atan2(x, y) with a gradient that is finite at (0, 0)."""
    return _SafeAtan2.apply(x, y)


def safe_acos(x):
    """acos(clip(x, -1, 1)) with a gradient that is finite at +/-1."""
    return _SafeAcos.apply(x)


def rgb2chromaticity(rgb):
    """rgb / ||rgb||_2, 0 where the norm vanishes."""
    denom = torch.sqrt(torch.sum(torch.square(rgb), dim=-1, keepdim=True))
    return divide_no_nan(rgb, denom)
