"""NeuS volume renderer: hierarchical SDF up-sampling, logistic-CDF alpha
compositing and the Eikonal error (counterpart of
vqnerf_release_tpu/models/neus.py).

  * uniform n_samples, then up_sample_steps rounds of importance sampling
    with inv_s = 64 * 2**i, min-of-adjacent-cos section estimation and
    deterministic inverse-CDF midpoints, all without gradient;
  * section alpha = clip((sig(prev) - sig(next) + 1e-5) / (sig(prev) +
    1e-5)) with cos annealing;
  * inside-sphere masking, optional background NeRF blending, composited
    colour / surface point / depth, Eikonal error over the relaxed sphere.

``neus_occlusion`` is the shadow-ray pass of the geometry extractor: the
same sampling and alpha, weight_sum only, no colour net.

**Fused SDF.** ``use_fused_sdf=None`` (the default) evaluates the up-sample
chain with ``kernels.sdf.sdf_fwd`` and the final pass of ``neus_occlusion``
with ``kernels.sdf.sdf_fwdgrad`` when the rays are CUDA tensors, and with
the plain autograd path on the CPU; True / False override. There is no gate
on the number of points and nothing gives way to the plain path: with the
switch on, a kernel that fails to build or launch raises.

Sorts are stable, because the carried SDF follows the merge order. Random
perturbation is an input: pre-drawn ``rand`` values or a ``generator``;
with neither the render is deterministic.
"""

from dataclasses import dataclass, field
from typing import Optional

import torch
from torch import nn

from ..kernels import sdf as sdf_kernel
from ..ops.sampling import sample_pdf
from . import fields

__all__ = ["NeuSConfig", "NeuS", "init_neus", "neus_render",
           "neus_occlusion", "fused_sdf_enabled"]


@dataclass(frozen=True)
class NeuSConfig:
    sdf: fields.SDFConfig = field(default_factory=fields.SDFConfig)
    color: fields.ColorConfig = field(default_factory=fields.ColorConfig)
    bg: Optional[fields.BgNeRFConfig] = None
    n_samples: int = 64
    n_importance: int = 64
    n_outside: int = 0
    up_sample_steps: int = 4
    perturb: float = 1.0
    variance_init: float = 0.3


class NeuS(nn.Module):
    """The parameters of a NeuS scene; attribute names are the JAX pytree's
    keys (``sdf``, ``color``, ``variance`` and, with a background, ``bg``)."""

    def __init__(self, sdf, color, variance, bg=None):
        super().__init__()
        self.sdf = sdf
        self.color = color
        self.variance = variance
        if bg is not None:
            self.bg = bg

    @property
    def has_bg(self):
        return "bg" in self._modules


def init_neus(seed, cfg: NeuSConfig):
    """Geometric-init SDF (the JAX package's weights for this seed), and
    colour and background nets drawn from torch.Generator().manual_seed(
    seed)."""
    gen = torch.Generator().manual_seed(seed)
    bg = None
    color = fields.init_color(gen, cfg.color)
    if cfg.n_outside > 0:
        bg = fields.init_bg_nerf(gen, cfg.bg or fields.BgNeRFConfig())
    return NeuS(fields.init_sdf(seed, cfg.sdf), color,
                fields.init_variance(cfg.variance_init), bg)


def fused_sdf_enabled(use_fused_sdf, tensor):
    """The switch: None -> on for CUDA tensors, off for CPU tensors."""
    if use_fused_sdf is None:
        return tensor.device.type == "cuda"
    return bool(use_fused_sdf)


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod along the last axis of a tensor with no zero, whose
    backward is the one PyTorch takes for such a tensor,
    reversed_cumsum(output * grad) / input, without the test for zeros
    that reads a flag back to the host (a CUDA graph cannot capture that
    read)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        w = out * grad
        return torch.flip(torch.cumsum(torch.flip(w, [-1]), -1), [-1]) / x


def _trans(alpha):
    """Transmittance before each section: exclusive cumprod of 1 - alpha +
    1e-7 (positive, as alpha <= 1)."""
    ones = alpha.new_ones((alpha.shape[0], 1))
    return _CumprodPositive.apply(
        torch.cat([ones, 1.0 - alpha + 1e-7], dim=-1))[:, :-1]


def _up_sample(rays_o, rays_d, z_vals, sdf, r_limit, n_importance, inv_s):
    """One importance-sampling round."""
    batch_size, n_samples = z_vals.shape
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    radius = torch.linalg.norm(pts, dim=-1)
    inside_sphere = ((radius[:, :-1] < r_limit)
                     | (radius[:, 1:] < r_limit)).to(z_vals.dtype)
    prev_sdf, next_sdf = sdf[:, :-1], sdf[:, 1:]
    prev_z, next_z = z_vals[:, :-1], z_vals[:, 1:]
    mid_sdf = (prev_sdf + next_sdf) * 0.5
    cos_val = (next_sdf - prev_sdf) / (next_z - prev_z + 1e-5)

    # min(cos, prev_cos): robust section slope
    prev_cos = torch.cat(
        [cos_val.new_zeros((batch_size, 1)), cos_val[:, :-1]], dim=-1)
    cos_val = torch.minimum(prev_cos, cos_val)
    cos_val = torch.clamp(cos_val, -1e3, 0.0) * inside_sphere

    dist = next_z - prev_z
    prev_esti = mid_sdf - cos_val * dist * 0.5
    next_esti = mid_sdf + cos_val * dist * 0.5
    prev_cdf = torch.sigmoid(prev_esti * inv_s)
    next_cdf = torch.sigmoid(next_esti * inv_s)
    alpha = (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5)
    weights = alpha * _trans(alpha)
    return sample_pdf(z_vals, weights, n_importance).detach()


def _cat_z_vals(sdf_fn, rays_o, rays_d, z_vals, new_z_vals, sdf, last=False):
    """Merge-and-sort new samples, carrying their SDF values. The sort is
    stable: equal z keep the order old-then-new, and the SDF follows."""
    z_all = torch.cat([z_vals, new_z_vals], dim=-1)
    z_sorted, order = torch.sort(z_all, dim=-1, stable=True)
    if last:
        return z_sorted, None
    pts = rays_o[:, None, :] + rays_d[:, None, :] * new_z_vals[..., None]
    new_sdf = sdf_fn(pts.reshape(-1, 3)).reshape(new_z_vals.shape)
    sdf_all = torch.cat([sdf, new_sdf], dim=-1)
    return z_sorted, torch.gather(sdf_all, 1, order)


def _sdf_eval_fn(params, cfg, fused, packed):
    """The SDF of flat points for the up-sample chain, without gradient."""
    if fused:
        if packed is None:
            packed = sdf_kernel.pack_sdf(params.sdf, cfg.sdf)
        return (lambda pts: sdf_kernel.sdf_fwd(packed, pts.contiguous())), \
            packed

    def plain(pts):
        with torch.no_grad():
            return fields.sdf_only(params.sdf, pts, cfg.sdf)
    return plain, packed


def _hierarchical_z(sdf_fn, cfg, rays_o, rays_d, z_vals, radius):
    """The up-sample rounds: z_vals [R, n_samples] -> [R, n_samples +
    n_importance], sorted."""
    batch_size = rays_o.shape[0]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    sdf = sdf_fn(pts.reshape(-1, 3)).reshape(batch_size, cfg.n_samples)
    z_cur = z_vals
    for i in range(cfg.up_sample_steps):
        new_z = _up_sample(
            rays_o, rays_d, z_cur, sdf, radius,
            cfg.n_importance // cfg.up_sample_steps, 64 * 2**i)
        z_cur, sdf = _cat_z_vals(
            sdf_fn, rays_o, rays_d, z_cur, new_z, sdf,
            last=(i + 1 == cfg.up_sample_steps))
    return z_cur.detach()


def _section_alpha(sdf, gradients, dirs_flat, d_flat, inv_s,
                   cos_anneal_ratio):
    """(alpha [N, 1] before clipping's reshape, prev_cdf) of flat section
    midpoints. ``cos_anneal_ratio``: a float, or the pair (1 - ratio,
    ratio) of 0-dim float32 tensors that a captured training step reads
    (each the float32 of the double the float path rounds)."""
    if isinstance(cos_anneal_ratio, tuple):
        one_minus, ratio = cos_anneal_ratio
    else:
        one_minus, ratio = 1.0 - cos_anneal_ratio, cos_anneal_ratio
    true_cos = torch.sum(dirs_flat * gradients, dim=-1, keepdim=True)
    # cos annealing; always non-positive
    iter_cos = -(
        torch.relu(-true_cos * 0.5 + 0.5) * one_minus
        + torch.relu(-true_cos) * ratio)
    prev_cdf = torch.sigmoid((sdf - iter_cos * d_flat * 0.5) * inv_s)
    next_cdf = torch.sigmoid((sdf + iter_cos * d_flat * 0.5) * inv_s)
    return (prev_cdf - next_cdf + 1e-5) / (prev_cdf + 1e-5), prev_cdf


def _render_core(params, cfg: NeuSConfig, rays_o, rays_d, z_vals, sample_dist,
                 radius, background_alpha=None, background_color=None,
                 background_rgb=None, cos_anneal_ratio=1.0, to_light=False,
                 create_graph=False):
    batch_size, n_samples = z_vals.shape

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    if to_light:
        last = sample_dist  # per-ray [R, 1]
    else:
        last = torch.full_like(dists[..., :1], sample_dist)
    dists = torch.cat([dists, last], dim=-1)
    mid_z_vals = z_vals + dists * 0.5

    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dirs = rays_d[:, None, :].expand(pts.shape)
    pts_flat = pts.reshape(-1, 3)
    dirs_flat = dirs.reshape(-1, 3)

    sdf, feature, gradients = fields.sdf_value_feature_gradient(
        params.sdf, pts_flat, cfg.sdf, create_graph=create_graph)
    sampled_color = fields.color_apply(
        params.color, pts_flat, gradients, dirs_flat, feature, cfg.color
    ).reshape(batch_size, n_samples, 3)

    inv_s = fields.inv_s_from(params.variance)
    ratio, c = _section_alpha(sdf, gradients, dirs_flat,
                              dists.reshape(-1, 1), inv_s, cos_anneal_ratio)
    alpha = torch.clamp(ratio.reshape(batch_size, n_samples), 0.0, 1.0)

    pts_radius = torch.linalg.norm(pts, dim=-1).detach()  # [R, S]
    inside_sphere = (pts_radius < radius).to(alpha.dtype)
    relax_inside = (pts_radius < radius * 1.1).to(alpha.dtype)

    if background_alpha is not None:
        alpha = alpha * inside_sphere + background_alpha[:, :n_samples] * (
            1.0 - inside_sphere)
        alpha = torch.cat([alpha, background_alpha[:, n_samples:]], dim=-1)
        sampled_color = sampled_color * inside_sphere[:, :, None] + \
            background_color[:, :n_samples] * (1.0 - inside_sphere)[:, :, None]
        sampled_color = torch.cat(
            [sampled_color, background_color[:, n_samples:]], dim=1)

    weights = alpha * _trans(alpha)
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)

    color = torch.sum(sampled_color * weights[:, :, None], dim=1)
    surf = torch.sum(pts * weights[:, :n_samples, None], dim=1)
    depth = torch.linalg.norm(surf - rays_o, dim=-1, keepdim=True)

    if background_rgb is not None:
        color = color + background_rgb * (1.0 - weights_sum)

    grad_img = gradients.reshape(batch_size, n_samples, 3)
    gradient_error = (torch.linalg.norm(grad_img, dim=-1) - 1.0) ** 2
    # the un-normalised sum and count too, so that a caller rendering a
    # batch in several tiers can combine them into one all-points mean
    grad_err_sum = torch.sum(relax_inside * gradient_error)
    grad_err_cnt = torch.sum(relax_inside)
    gradient_error = grad_err_sum / (grad_err_cnt + 1e-5)

    return {
        "color": color,
        "grad_err_sum": grad_err_sum,
        "grad_err_cnt": grad_err_cnt,
        "sdf": sdf,
        "dists": dists,
        "gradients": grad_img,
        "s_val": 1.0 / inv_s,
        "mid_z_vals": mid_z_vals,
        "weights": weights,
        "cdf": c.reshape(batch_size, n_samples),
        "gradient_error": gradient_error,
        "inside_sphere": inside_sphere,
        "surf": surf,
        "depth": depth,
    }


def _draw(rand, name, generator, shape, device):
    """Pre-drawn uniforms ``rand[name]`` if given, else a draw from
    ``generator``."""
    if rand is not None and name in rand:
        return rand[name]
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def neus_render(params, cfg: NeuSConfig, rays_o, rays_d, near, far, radius,
                generator=None, rand=None, perturb_overwrite=-1.0,
                background_rgb=None, cos_anneal_ratio=0.0, to_light=False,
                use_fused_sdf=None, packed=None, occ_grid=None,
                occ_floor=0.05, create_graph=False):
    """Full hierarchical render.

    near/far: [R, 1]. Returns the reference's output dict. Perturbation
    needs ``cfg.perturb > 0`` and a source of randomness: ``rand`` (dict of
    pre-drawn uniforms: "t_rand" [R, 1], "occ_u" [R, n_samples] with an
    occ_grid, "outside" [R, n_outside]) or a ``generator``; with neither
    the render is deterministic.

    use_fused_sdf: the up-sample chain's SDF evaluations go through the
    fused forward kernel (see the module docstring); ``packed`` is a
    ``kernels.sdf.pack_sdf`` of the SDF, packed here when absent. The chain
    carries no gradient, so this is safe inside a training step.

    occ_grid: optional [res, res, res] occupancy grid (ops.occupancy): the
    initial n_samples are drawn from the grid's per-ray PDF instead of
    uniformly.
    """
    batch_size = rays_o.shape[0]
    device = rays_o.device
    if to_light:
        sample_dist = (far - near) / cfg.n_samples  # [R, 1]
    else:
        sample_dist = 2.0 * radius / cfg.n_samples

    perturb = cfg.perturb if perturb_overwrite < 0 else perturb_overwrite
    random = perturb > 0 and (generator is not None or rand is not None)
    z_vals_outside = None
    if cfg.n_outside > 0:
        z_vals_outside = torch.linspace(
            1e-3, 1.0 - 1.0 / (cfg.n_outside + 1.0), cfg.n_outside,
            device=device)

    if occ_grid is not None:
        from ..ops.occupancy import sample_z_occ
        u = _draw(rand, "occ_u", generator, (batch_size, cfg.n_samples),
                  device) if random else None
        z_vals = sample_z_occ(rays_o, rays_d, near, far, occ_grid, radius,
                              cfg.n_samples, u=u, floor=occ_floor)
    else:
        z_lin = torch.linspace(0.0, 1.0, cfg.n_samples, device=device)
        z_vals = near + (far - near) * z_lin[None, :]
        if random:
            t_rand = _draw(rand, "t_rand", generator, (batch_size, 1),
                           device) - 0.5
            z_vals = z_vals + t_rand * 2.0 * radius / cfg.n_samples

    if random and cfg.n_outside > 0:
        mids = 0.5 * (z_vals_outside[1:] + z_vals_outside[:-1])
        upper = torch.cat([mids, z_vals_outside[-1:]])
        lower = torch.cat([z_vals_outside[:1], mids])
        t_rand = _draw(rand, "outside", generator,
                       (batch_size, cfg.n_outside), device)
        z_vals_outside = lower[None, :] + (upper - lower)[None, :] * t_rand

    if cfg.n_outside > 0:
        z_vals_outside = far / torch.flip(z_vals_outside, dims=[-1]) + \
            1.0 / cfg.n_samples

    background_alpha = None
    background_color = None

    if cfg.n_importance > 0:
        sdf_fn, _ = _sdf_eval_fn(
            params, cfg, fused_sdf_enabled(use_fused_sdf, rays_o), packed)
        z_vals = _hierarchical_z(sdf_fn, cfg, rays_o, rays_d, z_vals, radius)

    if cfg.n_outside > 0:
        z_feed = torch.sort(
            torch.cat([z_vals, z_vals_outside], dim=-1), dim=-1).values
        bg = _render_bg(params, cfg, rays_o, rays_d, z_feed,
                        2.0 * radius / cfg.n_samples)
        background_color = bg["sampled_color"]
        background_alpha = bg["alpha"]

    ret = _render_core(
        params, cfg, rays_o, rays_d, z_vals,
        sample_dist, radius,
        background_alpha=background_alpha,
        background_color=background_color,
        background_rgb=background_rgb,
        cos_anneal_ratio=cos_anneal_ratio,
        to_light=to_light, create_graph=create_graph)

    weights = ret["weights"]
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    return {
        "color_fine": ret["color"],
        "grad_err_sum": ret["grad_err_sum"],
        "grad_err_cnt": ret["grad_err_cnt"],
        "s_val": ret["s_val"].expand(batch_size, 1),
        "cdf_fine": ret["cdf"],
        "weight_sum": weights_sum,
        "weight_max": torch.amax(weights, dim=-1, keepdim=True),
        "gradients": ret["gradients"],
        "weights": weights,
        "gradient_error": ret["gradient_error"],
        "inside_sphere": ret["inside_sphere"],
        "surf": ret["surf"],
        "depth": ret["depth"],
    }


@torch.no_grad()
def neus_occlusion(params, cfg: NeuSConfig, rays_o, rays_d, near, far,
                   radius, cos_anneal_ratio=1.0, use_fused_sdf=None,
                   packed=None, occ_grid=None, occ_floor=0.05):
    """weight_sum [R, 1] only: the light-visibility shadow pass needs
    neither the colour network nor the feature vector. Sampling and alpha
    are those of neus_render (without to_light, so the last section is 2 r
    / n long, and without inside-sphere masking, which _render_core applies
    only with a background model).

    With the fused SDF on, the up-sample chain runs through
    ``kernels.sdf.sdf_fwd`` and the final pass through
    ``kernels.sdf.sdf_fwdgrad``, at any number of rays.

    occ_grid: optional occupancy grid; the initial samples then draw from
    the per-ray occupancy PDF (they land on every occupied band the shadow
    ray crosses), with the floor as the uniform safety net."""
    batch_size = rays_o.shape[0]
    sample_dist = 2.0 * radius / cfg.n_samples
    fused = fused_sdf_enabled(use_fused_sdf, rays_o)
    sdf_fn, packed = _sdf_eval_fn(params, cfg, fused, packed)

    if occ_grid is not None:
        from ..ops.occupancy import sample_z_occ
        z_vals = sample_z_occ(rays_o, rays_d, near, far, occ_grid,
                              radius, cfg.n_samples, u=None,
                              floor=occ_floor)
    else:
        z_lin = torch.linspace(0.0, 1.0, cfg.n_samples,
                               device=rays_o.device)
        z_vals = near + (far - near) * z_lin[None, :]

    n_samples = cfg.n_samples
    if cfg.n_importance > 0:
        z_vals = _hierarchical_z(sdf_fn, cfg, rays_o, rays_d, z_vals, radius)
        n_samples = cfg.n_samples + cfg.n_importance

    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat(
        [dists, dists.new_full((batch_size, 1), sample_dist)], dim=-1)
    mid_z_vals = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dirs_flat = rays_d[:, None, :].expand(pts.shape).reshape(-1, 3)
    pts_flat = pts.reshape(-1, 3)

    if fused:
        sdf_v, gradients = sdf_kernel.sdf_fwdgrad(packed,
                                                  pts_flat.contiguous())
        sdf = sdf_v[:, None]
    else:
        sdf = fields.sdf_only(params.sdf, pts_flat, cfg.sdf)[:, None]
        gradients = fields.sdf_gradient(params.sdf, pts_flat, cfg.sdf)
    inv_s = fields.inv_s_from(params.variance)

    ratio, _ = _section_alpha(sdf, gradients, dirs_flat,
                              dists.reshape(-1, 1), inv_s, cos_anneal_ratio)
    alpha = torch.clamp(ratio.reshape(batch_size, n_samples), 0.0, 1.0)
    return torch.sum(alpha * _trans(alpha), dim=-1, keepdim=True)


def _render_bg(params, cfg: NeuSConfig, rays_o, rays_d, z_vals, sample_dist):
    """Background NeRF rendering."""
    batch_size, n_samples = z_vals.shape
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat(
        [dists, torch.full_like(dists[..., :1], sample_dist)], dim=-1)
    mid_z_vals = z_vals + dists * 0.5
    pts = rays_o[:, None, :] + rays_d[:, None, :] * mid_z_vals[..., None]
    dis_to_center = torch.clamp(
        torch.linalg.norm(pts, dim=-1, keepdim=True), 1.0, 1e10)
    pts4 = torch.cat([pts / dis_to_center, 1.0 / dis_to_center], dim=-1)
    dirs = rays_d[:, None, :].expand(pts.shape)
    density, color = fields.bg_nerf_apply(
        params.bg, pts4.reshape(-1, 4), dirs.reshape(-1, 3),
        cfg.bg or fields.BgNeRFConfig())
    alpha = 1.0 - torch.exp(
        -torch.nn.functional.softplus(
            density.reshape(batch_size, n_samples)) * dists)
    weights = alpha * _trans(alpha)
    color = color.reshape(batch_size, n_samples, 3)
    return {
        "sampled_color": color,
        "alpha": alpha,
        "weights": weights,
        "color": torch.sum(weights[:, :, None] * color, dim=1),
    }
