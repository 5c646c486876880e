"""Microfacet (GGX) BRDF (counterpart of vqnerf_release_tpu/ops/microfacet.py).

  D: GGX with alpha = rough**2
  G: product of two Schlick-GGX terms, 2cos / (cos + sqrt(a^2 + (1-a^2)cos^2))
  F: Schlick with a per-channel f0
  glossy = F G D / (4 |l.n| |v.n|)   (divide_no_nan)
  diffuse = albedo / pi

Shapes: pts2l [N,L,3], pts2c [N,3], normal [N,3], albedo [N,3], rough [N,1],
f0 [N,3] -> (brdf, glossy, diffuse), each [N,L,3].
"""

import math

import torch

from .math import clip_preserve_gradient, divide_no_nan, safe_l2_normalize

__all__ = ["microfacet_brdf"]


def _gsub(cos_theta, alpha):
    cos_theta = clip_preserve_gradient(cos_theta, 0.0, 1.0)
    denom_a = torch.abs(alpha**2 + (1.0 - alpha**2) * torch.square(cos_theta))
    denom = cos_theta + torch.sqrt(denom_a)
    return divide_no_nan(2.0 * cos_theta, denom)


def microfacet_brdf(pts2l, pts2c, normal, albedo=None, rough=None, f0=None):
    n = pts2c.shape[0]
    ones = dict(dtype=torch.float32, device=pts2c.device)
    if albedo is None:
        albedo = torch.ones((n, 3), **ones)
    if f0 is None:
        f0 = 0.91 * torch.ones((n, 3), **ones)
    if rough is None:
        rough = torch.ones((n, 1), **ones)

    pts2l = safe_l2_normalize(pts2l, axis=2)
    pts2c = safe_l2_normalize(pts2c, axis=1)
    normal = safe_l2_normalize(normal, axis=1)

    h = safe_l2_normalize(pts2l + pts2c[:, None, :], axis=2)  # NxLx3

    cos_vh = clip_preserve_gradient(
        torch.einsum("nlk,nk->nl", h, pts2c)[:, :, None], 0.0, 1.0)
    f = f0[:, None, :] + (1.0 - f0[:, None, :]) * (1.0 - cos_vh) ** 5

    alpha = (rough**2)[:, None, :]  # Nx1x1

    cos_nh = clip_preserve_gradient(
        torch.einsum("nlk,nk->nl", h, normal), 0.0, 1.0)
    denom_d = math.pi * torch.square(
        torch.square(cos_nh)[:, :, None] * (alpha**2 - 1.0) + 1.0)
    d = divide_no_nan(alpha**2, denom_d)  # NxLx1

    cos_ln = torch.einsum("nlk,nk->nl", pts2l, normal)[:, :, None]  # NxLx1
    cos_vn = torch.einsum("nk,nk->n", normal, pts2c)[:, None, None]  # Nx1x1
    g = _gsub(cos_ln, alpha) * _gsub(cos_vn, alpha)  # NxLx1

    denom = 4.0 * torch.abs(cos_ln) * torch.abs(cos_vn)
    glossy = divide_no_nan(f * g * d, denom)  # NxLx3

    diffuse = (albedo / math.pi)[:, None, :].expand(glossy.shape)
    return glossy + diffuse, glossy, diffuse
