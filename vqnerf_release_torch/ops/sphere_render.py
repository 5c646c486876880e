"""BRDFs rendered on a unit sphere under an envmap, to look at materials
(counterpart of vqnerf_release_tpu/ops/sphere_render.py): an orthographic
unit sphere facing the camera, per-pixel normals from the sphere, the
rendering equation over the lat-long light sphere with directional lights.
As in the JAX package this is the plain ``render_equation`` over the
[N, L, 3] BRDF, not the fused render kernel.
"""

import numpy as np
import torch

from ..utils.device import resolve_device
from .light import gen_light_xyz
from .microfacet import microfacet_brdf
from .render import render_equation

__all__ = ["sphere_normals", "render_brdf_sphere"]


def sphere_normals(imh):
    """Orthographic sphere: (normals [N, 3] float32, mask [imh, imh]) where
    the sphere projects to the centred disk."""
    ys, xs = np.meshgrid(
        np.linspace(1, -1, imh), np.linspace(-1, 1, imh), indexing="ij")
    rr = xs**2 + ys**2
    mask = rr <= 1.0
    z = np.sqrt(np.clip(1.0 - rr, 0.0, 1.0))
    normals = np.stack([xs, ys, z], axis=-1)
    normals[~mask] = np.array([0.0, 0.0, 1.0])
    return normals.reshape(-1, 3).astype(np.float32), mask


@torch.no_grad()
def render_brdf_sphere(albedo, rough, f0, envmap, imh=128, light_h=16,
                       device="cuda"):
    """One material on the sphere under ``envmap`` [Lh, Lw, 3] (numpy).

    albedo / f0: [3]; rough: a scalar. Returns a numpy [imh, imh, 3]
    linear image, black off the sphere."""
    device = resolve_device(device)
    normals, mask = sphere_normals(imh)
    n = normals.shape[0]
    f32 = dict(dtype=torch.float32, device=device)
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    lxyz = lxyz.reshape(-1, 3)
    lxyz_flat = torch.as_tensor(
        lxyz / np.linalg.norm(lxyz, axis=-1, keepdims=True), **f32)
    surf2l = lxyz_flat[None].expand((n,) + lxyz_flat.shape)
    surf2c = torch.as_tensor(np.tile([[0.0, 0.0, 1.0]], (n, 1)), **f32)
    normals_t = torch.as_tensor(normals, **f32)
    albedo_t = torch.as_tensor(np.asarray(albedo, np.float32), **f32)
    f0_t = torch.as_tensor(np.asarray(f0, np.float32), **f32)
    brdf, _, _ = microfacet_brdf(
        surf2l, surf2c, normals_t, albedo=albedo_t[None].expand(n, 3),
        rough=torch.full((n, 1), float(rough), **f32),
        f0=f0_t[None].expand(n, 3))
    rgb = render_equation(
        brdf, surf2l, normals_t,
        torch.as_tensor(np.asarray(lareas, np.float32).reshape(-1), **f32),
        torch.as_tensor(np.asarray(envmap, np.float32), **f32))
    img = rgb.cpu().numpy().reshape(imh, imh, 3).copy()
    img[~mask] = 0.0
    return img
