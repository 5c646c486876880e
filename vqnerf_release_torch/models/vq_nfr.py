"""vq_nfr: BRDF decomposition with a VQ material codebook (counterpart of
vqnerf_release_tpu/models/vq_nfr.py), inference side: init, encode, the
fast render with edits, albedo scale and probe/OLAT relighting, and the
segmentation embed. Training comes with the trainer port.
"""

import copy

import torch

from ..ops.colorspace import linear2srgb
from ..ops.math import safe_l2_normalize
from ..ops.microfacet import microfacet_brdf
from ..ops.render import fused_render_equation, render_equation
from ..ops.vq import init_vq_ema_state, vq_lookup
from . import decomp_common as dc

__all__ = ["VqNfr", "init_vq_nfr", "vq_encode", "vq_fast_render",
           "vq_fast_embed"]


class VqNfr(dc.ParamModule):
    """fine_enc, bottleneck; diff_main, spec_main, rough_main (the nfr_unit
    heads); diff_vq, spec_vq, rough_vq; light [Lh, Lw, 3]; codebook [D, K];
    and gamma_bias/gamma_index for real data."""


def init_vq_nfr(generator, cfg: dc.DecompConfig, nfr, cluster_centers):
    """vq_nfr from a trained nfr_unit and k-means centers [K, z_dim].
    Returns (model, ema_state); nfr's parts are copied, not shared."""
    parts = {
        "fine_enc": nfr.fine_enc,
        "bottleneck": nfr.bottleneck,
        "diff_main": nfr.diff_out,
        "spec_main": nfr.spec_out,
        "rough_main": nfr.rough_out,
    }
    parts = {k: copy.deepcopy(v) for k, v in parts.items()}
    parts.update({
        "diff_vq": dc.init_head(generator, cfg.z_dim, 3),
        "spec_vq": dc.init_head(generator, cfg.z_dim, 3),
        "rough_vq": dc.init_head(generator, cfg.z_dim, 1),
        "light": nfr.light.detach().clone(),
        "codebook": torch.as_tensor(cluster_centers, dtype=torch.float32).T,
    })
    if not cfg.is_nerf:
        for k in ("gamma_bias", "gamma_index"):
            parts[k] = (getattr(nfr, k).detach().clone() if hasattr(nfr, k)
                        else torch.ones((1,)))
    model = VqNfr(**parts)
    return model, init_vq_ema_state(cfg.z_dim, cfg.num_embed)


def _decode_main(model, z, cfg):
    basecolor = cfg.albedo_slope * model.diff_main(z) + cfg.albedo_bias
    ks = model.spec_main(z)
    rough = model.rough_main(z)
    return basecolor, ks, rough, ks * basecolor, (1.0 - ks) * basecolor


def _geom(batch, cfg, lxyz):
    mask = (batch["alpha"][:, 0] > 0).to(torch.float32)
    xyz, normal, rayo = batch["xyz"], batch["normal"], batch["rayo"]
    lvis = batch.get("lvis") if cfg.is_nerf else None
    surf2c = dc.calc_vdir(rayo, xyz)
    surf2l = dc.calc_ldir(lxyz, xyz)
    normal_pred = dc.normal_correct(normal, surf2c)
    return mask, xyz, surf2c, surf2l, normal_pred, lvis


def vq_encode(model, xyz, cfg):
    """xyz -> (z_enc, z_norm)."""
    z_enc = dc.apply_encoder(model, xyz, cfg)
    return z_enc, safe_l2_normalize(z_enc, axis=1)


def _edit(src, val, em):
    """src, or the edit value inside the mask; a negative first channel of
    the value means no edit."""
    val = torch.as_tensor(val, dtype=torch.float32, device=src.device)
    return torch.where(val[0] < 0, src, src * (1 - em) + em * val)


def _relight(brdf, surf2l, normal_pred, lareas, envs, lvis, gamma, cfg, m):
    rgb = render_equation(brdf, surf2l, normal_pred, lareas, envs,
                          light_vis=lvis, gamma=gamma, probe_batch=True)
    return (linear2srgb(rgb) if cfg.is_nerf else rgb) * m[:, :, None]


def vq_fast_render(model, batch, cfg: dc.DecompConfig, lxyz, lareas,
                   novel_probes=None, novel_olat=None, opt_scale=None,
                   edit_mask=None, edit_material=None, dst_env=None,
                   gen_embed=False, thres=None, rng=None, vis_scale=False):
    """Inference render: continuous heads, optional material edit, optional
    albedo scale, and probe/OLAT relighting.

    novel_probes/novel_olat: [E, L, 3] stacked envmaps or None.
    edit_material: dict diff/spec/rough of [3]/[3]/[1] values.
    dst_env: optional [L, 3] envmap in place of the learned light.
    """
    mask, xyz, surf2c, surf2l, normal_pred, lvis = _geom(batch, cfg, lxyz)
    z_enc, z_norm = vq_encode(model, xyz, cfg)

    embed_ind = None
    if gen_embed:
        look = vq_lookup(dc.get_codebook(model), z_norm, thres=thres, rng=rng)
        embed_ind = look["encoding_indices"] + 1

    basecolor, ks, rough, spec, albedo = _decode_main(model, z_enc, cfg)

    if edit_mask is not None:
        em = (edit_mask[:, 0:1] > 0).to(torch.float32)
        albedo = _edit(albedo, edit_material["diff"], em)
        spec = _edit(spec, edit_material["spec"], em)
        rough = _edit(rough, edit_material["rough"], em)

    # vis_scale (the pd_test pass): render unscaled, but emit sRGB-encoded,
    # then scaled, basecolor/spec maps
    if opt_scale is not None and not vis_scale:
        s_albedo, s_spec = albedo * opt_scale, spec * opt_scale
    else:
        s_albedo, s_spec = albedo, spec

    light = dc.get_light(model) if dst_env is None else dst_env
    gamma = None if cfg.is_nerf else dc.get_gamma(model)
    relight = novel_probes is not None or novel_olat is not None
    if dc.fused_render_enabled(cfg, xyz.device) and not relight:
        rgb_pred = fused_render_equation(
            xyz, normal_pred, surf2c, s_albedo, rough, s_spec, lvis,
            lareas, lxyz, light, gamma=gamma)
    else:
        brdf, _, _ = microfacet_brdf(
            surf2l, surf2c, normal_pred, albedo=s_albedo, rough=rough,
            f0=s_spec)
        rgb_pred = render_equation(
            brdf, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma)

    if opt_scale is not None and vis_scale:
        basecolor = linear2srgb(basecolor) * opt_scale
        spec = linear2srgb(spec) * opt_scale

    m = mask[:, None]
    pred = {
        "alpha": batch.get("pred_alpha", batch["alpha"]),
        "basecolor": basecolor * m,
        "albedo": albedo * m,
        "spec": spec * m,
        "rough": rough * m,
        "rgb": (linear2srgb(rgb_pred) if cfg.is_nerf else rgb_pred) * m,
    }
    if embed_ind is not None:
        pred["embed"] = embed_ind.to(torch.int32) * mask.to(torch.int32)
    if novel_probes is not None:
        pred["rgb_probes"] = _relight(brdf, surf2l, normal_pred, lareas,
                                      novel_probes, lvis, gamma, cfg, m)
    if novel_olat is not None:
        pred["rgb_olat"] = _relight(brdf, surf2l, normal_pred, lareas,
                                    novel_olat, lvis, gamma, cfg, m)
    return pred


def vq_fast_embed(model, batch, cfg: dc.DecompConfig, thres=None, rng=None):
    """Segmentation map: the nearest (possibly pruned) code per foreground
    ray, 1-based; background rows get id 0."""
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.int32)
    _, z_norm = vq_encode(model, batch["xyz"], cfg)
    look = vq_lookup(dc.get_codebook(model), z_norm, thres=thres, rng=rng)
    embed = (look["encoding_indices"].to(torch.int32) + 1) * mask
    return {"embed": embed, "alpha": batch.get("pred_alpha", alpha)}
