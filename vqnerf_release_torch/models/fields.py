"""NeuS network fields: SDF MLP, IDR colour MLP, background NeRF, variance
(counterpart of vqnerf_release_tpu/models/fields.py).

The networks are lists of ``ops.nn`` layers whose parameter names are the
JAX pytree's keys (``v``/``g``/``b`` for the weight-norm layers, ``w``/``b``
for the background NeRF), held in ``nn.ModuleList``s; the forwards are plain
functions of (params, inputs, cfg), as in the stage-2 models.

The SDF's spatial gradient is ``torch.autograd.grad`` of channel 0 with
respect to the points, under a local ``torch.enable_grad()``, so it also
works for a caller inside ``torch.no_grad()``. ``create_graph`` is False for
inference; training sets it, because the Eikonal term differentiates the
gradient again.

The SDF init is numpy on a ``RandomState`` and gives the JAX package's
weights for the same seed. The colour and background nets draw from an
explicit ``torch.Generator``: same distributions as the JAX init, another
stream.
"""

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..ops import nn as vnn
from ..ops.embed import posenc, posenc_dim

__all__ = [
    "SDFConfig", "ColorConfig", "BgNeRFConfig",
    "init_sdf", "sdf_apply", "sdf_only", "sdf_gradient",
    "sdf_value_feature_gradient", "pack_sdf_params",
    "init_color", "color_apply",
    "init_bg_nerf", "bg_nerf_apply",
    "init_variance", "inv_s_from",
]

SOFTPLUS_BETA = 100.0


class _Softplus100(torch.autograd.Function):
    """The stable form's value with the derivative sigmoid(100 x), itself
    differentiable. Autograd through the stable form would give 1 at x = 0
    (clamp's derivative there), where the derivative is 1/2: a layer whose
    pre-activations are all 0 (the geometric init's skip layer when there
    is no encoding) would otherwise get twice the JAX package's gradient."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        e = torch.exp(-torch.abs(SOFTPLUS_BETA * x))
        return torch.clamp(x, min=0.0) + torch.log1p(e) / SOFTPLUS_BETA

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.sigmoid(SOFTPLUS_BETA * x)


def softplus100(x):
    """Softplus(beta=100) in the stable form max(x, 0) + log1p(exp(-|100
    x|)) / 100, which the CUDA kernel uses too; its derivative is
    sigmoid(100 x) everywhere, 0 included, as ``jax.nn.softplus``'s."""
    return _Softplus100.apply(x)


@dataclass(frozen=True)
class SDFConfig:
    d_in: int = 3
    d_out: int = 257
    d_hidden: int = 256
    n_layers: int = 8
    skip_in: Tuple[int, ...] = (4,)
    multires: int = 6
    bias: float = 0.5
    scale: float = 1.0
    inside_outside: bool = False


@dataclass(frozen=True)
class ColorConfig:
    d_feature: int = 256
    mode: str = "idr"
    d_in: int = 9
    d_out: int = 3
    d_hidden: int = 256
    n_layers: int = 4
    multires_view: int = 4
    squeeze_out: bool = True


@dataclass(frozen=True)
class BgNeRFConfig:
    depth: int = 8
    width: int = 256
    d_in: int = 4
    d_in_view: int = 3
    multires: int = 10
    multires_view: int = 4
    skips: Tuple[int, ...] = (4,)


def _sdf_dims(cfg: SDFConfig):
    d_embed = posenc_dim(cfg.d_in, cfg.multires) if cfg.multires > 0 \
        else cfg.d_in
    return [d_embed] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]


def init_sdf(seed, cfg: SDFConfig):
    """Geometric init + weight norm: a ModuleList of WNDense layers."""
    dims = _sdf_dims(cfg)
    rng = np.random.RandomState(seed)
    raw = vnn.geometric_sdf_init(
        rng, dims, cfg.skip_in, dims[0], bias=cfg.bias,
        inside_outside=cfg.inside_outside)
    return nn.ModuleList(
        vnn.wn_dense_init(None, w.shape[0], w.shape[1], w=w, b=b)
        for (w, b) in raw)


def sdf_apply(params, x, cfg: SDFConfig):
    """Full SDF net output [N, d_out]: channel 0 is the (rescaled) SDF."""
    inputs = x * cfg.scale
    if cfg.multires > 0:
        inputs = posenc(inputs, cfg.multires)
    h = inputs
    n_lin = len(params)
    for l, p in enumerate(params):
        if l in cfg.skip_in:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
        h = p(h)
        if l < n_lin - 1:
            h = softplus100(h)
    return torch.cat([h[:, :1] / cfg.scale, h[:, 1:]], dim=-1)


def sdf_only(params, x, cfg: SDFConfig):
    return sdf_apply(params, x, cfg)[:, 0]


def sdf_gradient(params, x, cfg: SDFConfig, create_graph=False):
    """d sdf / d x [N, 3] by autograd. With ``create_graph`` the result is
    differentiable in the parameters (the Eikonal term needs that)."""
    with torch.enable_grad():
        pts = x.detach().requires_grad_(True)
        total = torch.sum(sdf_only(params, pts, cfg))
        (grad,) = torch.autograd.grad(total, pts, create_graph=create_graph)
    return grad


def sdf_value_feature_gradient(params, x, cfg: SDFConfig,
                               create_graph=False):
    """(sdf [N,1], feature [N,d_out-1], d sdf/d x [N,3]) from ONE forward
    pass. Without ``create_graph`` all three come back detached."""
    with torch.enable_grad():
        pts = x.detach().requires_grad_(True)
        out = sdf_apply(params, pts, cfg)
        (grad,) = torch.autograd.grad(
            torch.sum(out[:, 0]), pts, create_graph=create_graph,
            retain_graph=create_graph)
    if not create_graph:
        out = out.detach()
    return out[:, :1], out[:, 1:], grad


def pack_sdf_params(params):
    """Weight-norm SDF layers -> list of plain (W [in, out], b [out]),
    detached."""
    with torch.no_grad():
        return [(p.folded().contiguous(), p.b.detach().clone())
                for p in params]


def init_color(generator, cfg: ColorConfig):
    d_view_embed = posenc_dim(3, cfg.multires_view) \
        if cfg.multires_view > 0 else 3
    d0 = cfg.d_in + cfg.d_feature + (d_view_embed - 3)
    dims = [d0] + [cfg.d_hidden] * cfg.n_layers + [cfg.d_out]
    return nn.ModuleList(
        vnn.wn_dense_init(generator, dims[l], dims[l + 1])
        for l in range(len(dims) - 1))


def color_apply(params, points, normals, view_dirs, feature,
                cfg: ColorConfig):
    if cfg.multires_view > 0:
        view_dirs = posenc(view_dirs, cfg.multires_view)
    if cfg.mode == "idr":
        h = torch.cat([points, view_dirs, normals, feature], dim=-1)
    elif cfg.mode == "no_view_dir":
        h = torch.cat([points, normals, feature], dim=-1)
    elif cfg.mode == "no_normal":
        h = torch.cat([points, view_dirs, feature], dim=-1)
    else:
        raise NotImplementedError(cfg.mode)
    n_lin = len(params)
    for l, p in enumerate(params):
        h = p(h)
        if l < n_lin - 1:
            h = torch.relu(h)
    return torch.sigmoid(h) if cfg.squeeze_out else h


class BgNeRF(nn.Module):
    """Background NeRF, use_viewdirs layout; attribute names are the JAX
    pytree's keys."""

    def __init__(self, cfg: BgNeRFConfig, generator=None):
        super().__init__()
        make = (vnn.Dense if generator is None
                else lambda a, b: vnn.dense_init(generator, a, b))
        d_pts = posenc_dim(cfg.d_in, cfg.multires)
        d_view = posenc_dim(cfg.d_in_view, cfg.multires_view)
        pts = []
        cur = d_pts
        for i in range(cfg.depth):
            pts.append(make(cur, cfg.width))
            cur = cfg.width + (d_pts if i in cfg.skips else 0)
        self.pts = nn.ModuleList(pts)
        self.views = nn.ModuleList(
            [make(d_view + cfg.width, cfg.width // 2)])
        self.feature = make(cfg.width, cfg.width)
        self.alpha = make(cfg.width, 1)
        self.rgb = make(cfg.width // 2, 3)


def init_bg_nerf(generator, cfg: BgNeRFConfig):
    return BgNeRF(cfg, generator)


def bg_nerf_apply(params, pts, views, cfg: BgNeRFConfig):
    pts_e = posenc(pts, cfg.multires)
    views_e = posenc(views, cfg.multires_view)
    h = pts_e
    for i, p in enumerate(params.pts):
        h = torch.relu(p(h))
        if i in cfg.skips:
            h = torch.cat([pts_e, h], dim=-1)
    alpha = params.alpha(h)
    feat = params.feature(h)
    h = torch.cat([feat, views_e], dim=-1)
    for p in params.views:
        h = torch.relu(p(h))
    rgb = params.rgb(h)
    return alpha, rgb


class Variance(nn.Module):
    """SingleVariance: one scalar, named as in the JAX pytree."""

    def __init__(self, init_val=0.3):
        super().__init__()
        self.variance = nn.Parameter(torch.tensor(init_val,
                                                  dtype=torch.float32))


def init_variance(init_val=0.3):
    return Variance(init_val)


def inv_s_from(params, clip=(1e-6, 1e6)):
    """exp(10 * v), clipped."""
    return torch.clamp(torch.exp(params.variance * 10.0), clip[0], clip[1])
