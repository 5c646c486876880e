"""The decomposition-stage rendering equation (counterpart of
vqnerf_release_tpu/ops/render.py):

  rgb = sum_L brdf * (front_lit * lvis * light) * cos * d_omega

then the learned gamma for real (non-'nerf') data, and a clip to [0, 1].
``light`` is one map ([Lh, Lw, 3] or [L, 3]) or, with ``probe_batch``, a
stack of E envmaps [E, L, 3] rendered by one einsum. The fused renders
compute the same through the kernels of ``kernels/render.py``: one map
(``fused_render_equation``) or a stack of E (``fused_render_maps``).
"""

import torch

from ..kernels.render import (fused_brdf_render, fused_brdf_render_maps,
                              pack_light_maps, pack_lights)
from .math import clip_preserve_gradient

__all__ = ["render_equation", "fused_render_equation", "fused_render_maps"]


def _finish(rgb, gamma):
    if gamma is not None:
        g_bias, g_index = gamma
        rgb = torch.clamp(rgb * g_bias, min=1e-12) ** g_index
    return clip_preserve_gradient(rgb, 0.0, 1.0)


def render_equation(brdf, surf2l, normal, lareas, light, light_vis=None,
                    gamma=None, probe_batch=False):
    """Integrate over the light sphere.

    brdf [N,L,3], surf2l [N,L,3] unit, normal [N,3] unit, lareas [L],
    light_vis optional [N,L]; gamma optional (bias, index).
    Returns [N,3], or [N,E,3] with probe_batch.
    """
    cos = torch.einsum("nlk,nk->nl", surf2l, normal)  # NxL
    front_lit = (cos > 0).to(brdf.dtype)
    lvis = front_lit if light_vis is None else front_lit * light_vis
    areas = lareas.reshape(1, -1, 1)

    contrib_w = brdf * (lvis * cos)[:, :, None] * areas  # NxLx3

    if probe_batch:
        return _finish(torch.einsum("nlc,elc->nec", contrib_w, light), gamma)
    light_flat = light.reshape(-1, 3)
    return _finish(torch.einsum("nlc,lc->nc", contrib_w, light_flat), gamma)


def fused_render_equation(xyz, normal, surf2c, albedo, rough, f0, lvis,
                          lareas, lxyz, light, gamma=None):
    """Single-envmap render through the fused BRDF+integration kernel
    (``kernels/render.py``), which never holds the [N, L, 3] BRDF tensors in
    device memory; then the same gamma and clip tail as render_equation.
    ``lvis`` may be None (front-lit mask only)."""
    packed = pack_lights(lxyz, lareas, light.reshape(-1, 3))
    rgb = fused_brdf_render(
        xyz.contiguous(), normal.contiguous(), surf2c.contiguous(),
        albedo.contiguous(), rough.contiguous(), f0.contiguous(),
        None if lvis is None else lvis.contiguous(), packed)
    return _finish(rgb, gamma)


def fused_render_maps(xyz, normal, surf2c, albedo, rough, f0, lvis, lareas,
                      lxyz, lights, gamma=None):
    """Render under each of the E maps ``lights`` [E, L, 3] through the
    multi-map kernel (``kernels/render.py::fused_brdf_render_maps``), which
    evaluates each ray-light pair's BRDF once for all maps and never holds
    an [N, L, 3] tensor; then render_equation's gamma and clip on every
    map. Returns [N, E, 3], as render_equation with ``probe_batch``."""
    rgb = fused_brdf_render_maps(
        xyz.contiguous(), normal.contiguous(), surf2c.contiguous(),
        albedo.contiguous(), rough.contiguous(), f0.contiguous(),
        None if lvis is None else lvis.contiguous(),
        pack_light_maps(lxyz, lareas, lights))
    return _finish(rgb, gamma)
