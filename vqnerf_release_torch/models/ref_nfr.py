"""ref_nfr: residual appearance baking on top of a trained vq_nfr
(counterpart of vqnerf_release_tpu/models/ref_nfr.py).

The parameters keep the JAX package's split: ``frozen`` holds fine_enc,
bottleneck, the spec head (``spec_out``) and the converged light;
``trainable`` (the JAX ``train`` subtree; ``train`` is a method name on
nn.Module) holds rgb_enc, the diff/rough heads over concat(z_xyz, z_ref)
and, for real data, the gamma.

The frozen part is evaluated under ``torch.no_grad()`` and the light is
detached, as the JAX package wraps them in ``stop_gradient``: no gradient
reaches them even if a caller turns their ``requires_grad`` back on. The
training forward renders eagerly, as JAX does; only ``ref_fast_render``'s
raw pass goes through the fused render kernel.
"""

import copy

import torch
from torch import nn

from ..ops.colorspace import linear2srgb, srgb2linear
from ..ops.math import clip_preserve_gradient
from ..ops.microfacet import microfacet_brdf
from ..ops.nn import mlp_init
from ..ops.render import fused_render_equation, render_equation
from . import decomp_common as dc
from .vq_nfr import _edit, _relight

__all__ = ["RefNfr", "init_ref_nfr", "ref_nfr_forward", "ref_nfr_loss",
           "ref_fast_render"]

RGB_ENC_ACTS = [None, "relu", "sigmoid"]


class RefNfr(nn.Module):
    def __init__(self, frozen: dc.ParamModule, trainable: dc.ParamModule):
        super().__init__()
        self.frozen = frozen.requires_grad_(False)
        self.trainable = trainable


def init_ref_nfr(generator, cfg: dc.DecompConfig, vq, light) -> RefNfr:
    """vq: a trained VqNfr; light: the converged [Lh, Lw, 3] light."""
    frozen = dc.ParamModule(
        fine_enc=copy.deepcopy(vq.fine_enc),
        bottleneck=copy.deepcopy(vq.bottleneck),
        spec_out=copy.deepcopy(vq.spec_main),
        light=torch.as_tensor(light, dtype=torch.float32))
    train = {
        "rgb_enc": mlp_init(generator, 3, [cfg.z_dim] * 3, RGB_ENC_ACTS),
        "diff_out": dc.init_head(generator, 2 * cfg.z_dim, 3,
                                 width=cfg.z_dim),
        "rough_out": dc.init_head(generator, 2 * cfg.z_dim, 1,
                                  width=cfg.z_dim),
    }
    if not cfg.is_nerf:
        for k in ("gamma_bias", "gamma_index"):
            train[k] = (getattr(vq, k).detach().clone() if hasattr(vq, k)
                        else torch.ones((1,)))
    return RefNfr(frozen, dc.ParamModule(**train))


def _brdf_maps(model, batch, cfg):
    frozen, train = model.frozen, model.trainable
    with torch.no_grad():  # the frozen encoder path
        z_xyz = dc.apply_encoder(frozen, batch["xyz"], cfg)
        ks = frozen.spec_out(z_xyz)
    z_ref = train.rgb_enc(batch["ref"])
    z_bias = torch.cat([z_xyz, z_ref], dim=-1)
    basecolor = cfg.albedo_slope * train.diff_out(z_bias) + cfg.albedo_bias
    rough = train.rough_out(z_bias)
    return basecolor, ks, rough, ks * basecolor, (1.0 - ks) * basecolor


def _gamma(model, cfg):
    """None for CG data, else (bias, index) with the index clipped to
    [0, 5]."""
    if cfg.is_nerf:
        return None
    t = model.trainable
    return (t.gamma_bias, clip_preserve_gradient(t.gamma_index, 0.0, 5.0))


def _light(model):
    """The frozen light, a constant of the render."""
    return model.frozen.light.detach()


def ref_nfr_forward(model, batch, cfg: dc.DecompConfig, lxyz, lareas,
                    mode="train", opt_scale=None, novel_probes=None,
                    novel_olat=None):
    """Training/validation/test forward; returns (pred, aux). Outside
    training pred also holds the diffuse and specular renders, which stay
    linear for CG scenes too. opt_scale scales albedo and spec in test mode
    only."""
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.float32)
    xyz, normal, rayo = batch["xyz"], batch["normal"], batch["rayo"]
    lvis = batch.get("lvis") if cfg.is_nerf else None
    surf2c = dc.calc_vdir(rayo, xyz)
    surf2l = dc.calc_ldir(lxyz, xyz)
    normal_pred = dc.normal_correct(normal, surf2c)

    basecolor, ks, rough, spec, albedo = _brdf_maps(model, batch, cfg)
    if opt_scale is not None and mode == "test":
        albedo = albedo * opt_scale
        spec = spec * opt_scale

    brdf, brdf_spec, brdf_diff = microfacet_brdf(
        surf2l, surf2c, normal_pred, albedo=albedo, rough=rough, f0=spec)
    light = _light(model)
    gamma = _gamma(model, cfg)
    rgb_pred = render_equation(
        brdf, surf2l, normal_pred, lareas, light, light_vis=lvis, gamma=gamma)

    aux = {"mask": mask, "rgb_gt": batch["rgb"], "rgb_pred_linear": rgb_pred}
    m = mask[:, None]
    pred = {
        "rgb": (linear2srgb(rgb_pred) if cfg.is_nerf else rgb_pred) * m,
        "normal": normal_pred * m,
        "albedo": albedo * m,
        "basecolor": basecolor * m,
        "spec": spec * m,
        "rough": rough * m,
        "ks": ks * m,
        "alpha": batch.get("pred_alpha", alpha),
    }
    if mode != "train":
        pred["rgb_diff"] = render_equation(
            brdf_diff, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
        pred["rgb_spec"] = render_equation(
            brdf_spec, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
    if novel_probes is not None:
        pred["rgb_probes"] = _relight(brdf, surf2l, normal_pred, lareas,
                                      novel_probes, lvis, gamma, cfg, m)
    if novel_olat is not None:
        pred["rgb_olat"] = _relight(brdf, surf2l, normal_pred, lareas,
                                    novel_olat, lvis, gamma, cfg, m)
    return pred, aux


def ref_nfr_loss(aux, cfg: dc.DecompConfig, mode="train"):
    """Masked-mean MSE in linear space; returns (loss, loss dict)."""
    mask = aux["mask"]
    gt = aux["rgb_gt"]
    linear_gt = srgb2linear(gt) if cfg.is_nerf else gt
    per_ray = torch.mean((linear_gt - aux["rgb_pred_linear"]) ** 2, dim=-1)
    loss = torch.sum(per_ray * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss, {"rgb": loss, "loss": loss}


def ref_fast_render(model, batch, cfg: dc.DecompConfig, lxyz, lareas,
                    opt_scale=None, novel_probes=None, novel_olat=None,
                    edit_mask=None, edit_material=None):
    """Inference: the raw reconstruction from the UNSCALED residual BRDF;
    relighting from the scaled and edited one."""
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.float32)
    xyz, normal, rayo = batch["xyz"], batch["normal"], batch["rayo"]
    lvis = batch.get("lvis") if cfg.is_nerf else None
    surf2c = dc.calc_vdir(rayo, xyz)
    surf2l = dc.calc_ldir(lxyz, xyz)
    normal_pred = dc.normal_correct(normal, surf2c)

    basecolor, ks, rough, spec, albedo = _brdf_maps(model, batch, cfg)

    if edit_mask is not None:
        em = (edit_mask[:, 0:1] > 0).to(torch.float32)
        albedo = _edit(albedo, edit_material["diff"], em)
        spec = _edit(spec, edit_material["spec"], em)
        rough = _edit(rough, edit_material["rough"], em)

    if opt_scale is not None:
        albedo_s, spec_s = albedo * opt_scale, spec * opt_scale
    else:
        albedo_s, spec_s = albedo, spec
    relight = novel_probes is not None or novel_olat is not None
    if relight:  # the scaled BRDF feeds only the relighting passes
        brdf, _, _ = microfacet_brdf(
            surf2l, surf2c, normal_pred, albedo=albedo_s, rough=rough,
            f0=spec_s)

    light = _light(model)
    gamma = _gamma(model, cfg)
    if dc.fused_render_enabled(cfg, xyz.device) and not relight:
        rgb_pred = fused_render_equation(
            xyz, normal_pred, surf2c, albedo, rough, spec, lvis,
            lareas, lxyz, light, gamma=gamma)
    else:
        raw_brdf, _, _ = microfacet_brdf(
            surf2l, surf2c, normal_pred, albedo=albedo, rough=rough, f0=spec)
        rgb_pred = render_equation(
            raw_brdf, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma)

    m = mask[:, None]
    pred = {
        "rgb": (linear2srgb(rgb_pred) if cfg.is_nerf else rgb_pred) * m,
        "alpha": batch.get("pred_alpha", alpha),
    }
    if novel_probes is not None:
        pred["rgb_probes"] = _relight(brdf, surf2l, normal_pred, lareas,
                                      novel_probes, lvis, gamma, cfg, m)
    if novel_olat is not None:
        pred["rgb_olat"] = _relight(brdf, surf2l, normal_pred, lareas,
                                    novel_olat, lvis, gamma, cfg, m)
    return pred
