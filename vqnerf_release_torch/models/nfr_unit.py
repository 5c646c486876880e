"""nfr_unit, the continuous BRDF warm-up model (counterpart of
vqnerf_release_tpu/models/nfr_unit.py).

Forward: foreground mask -> view and light directions -> normal correction
-> encoder z -> heads (basecolor, ks, rough) -> spec = ks * basecolor,
albedo = (1 - ks) * basecolor -> GGX BRDF -> render equation with the
trainable light (and the learned gamma for real data) -> MSE in linear
space (the ground truth through srgb2linear for CG data).
"""

import torch

from ..ops.colorspace import linear2srgb, srgb2linear
from ..ops.microfacet import microfacet_brdf
from ..ops.render import render_equation
from . import decomp_common as dc

__all__ = ["NfrUnit", "init_nfr_unit", "nfr_unit_forward", "nfr_unit_loss",
           "nfr_unit_row_sums", "nfr_unit_loss_from_sums"]


class NfrUnit(dc.ParamModule):
    """fine_enc, bottleneck, diff_out, spec_out, rough_out, light
    [Lh, Lw, 3], and gamma_bias/gamma_index for real data."""


def init_nfr_unit(generator, cfg: dc.DecompConfig) -> NfrUnit:
    parts = {
        **dc.init_encoder(generator, cfg),
        "diff_out": dc.init_head(generator, cfg.z_dim, 3),
        "spec_out": dc.init_head(generator, cfg.z_dim, 1),
        "rough_out": dc.init_head(generator, cfg.z_dim, 1),
        "light": torch.full(cfg.light_res + (3,), cfg.light_init_val),
    }
    if not cfg.is_nerf:
        parts["gamma_bias"] = torch.ones((1,))
        parts["gamma_index"] = torch.ones((1,))
    return NfrUnit(**parts)


def _decode_brdf(model, z, cfg):
    basecolor = cfg.albedo_slope * model.diff_out(z) + cfg.albedo_bias
    ks = model.spec_out(z)
    rough = model.rough_out(z)
    return basecolor, ks, rough, ks * basecolor, (1.0 - ks) * basecolor


def nfr_unit_forward(model, batch, cfg: dc.DecompConfig, lxyz, lareas,
                     mode="train", light_override=None):
    """batch: dict with rayo, rgb, alpha, xyz, normal, (lvis), all [N, ...].

    Returns (pred, aux): pred holds full-batch outputs with the background
    rows zeroed, aux the masked ingredients of the loss.
    """
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.float32)  # [N]
    xyz, normal, rayo = batch["xyz"], batch["normal"], batch["rayo"]
    lvis = batch.get("lvis") if cfg.is_nerf else None

    surf2c = dc.calc_vdir(rayo, xyz)
    surf2l = dc.calc_ldir(lxyz, xyz)
    normal_pred = dc.normal_correct(normal, surf2c)

    z = dc.apply_encoder(model, xyz, cfg)
    basecolor, ks, rough, spec, albedo = _decode_brdf(model, z, cfg)

    brdf, brdf_spec, brdf_diff = microfacet_brdf(
        surf2l, surf2c, normal_pred, albedo=albedo, rough=rough, f0=spec)

    light = dc.get_light(model) if light_override is None else light_override
    gamma = None if cfg.is_nerf else dc.get_gamma(model)
    rgb_pred = render_equation(
        brdf, surf2l, normal_pred, lareas, light, light_vis=lvis, gamma=gamma)

    aux = {
        "mask": mask,
        "rgb_pred_linear": rgb_pred,
        "rgb_gt": batch["rgb"],
        "spec": spec,
        "rough": rough,
        "z": z,
    }

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
        "z": z * m,
    }
    if mode != "train":
        # the component renders stay linear, also for CG scenes
        pred["rgb_diff"] = render_equation(
            brdf_diff, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
        pred["rgb_spec"] = render_equation(
            brdf_spec, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
    return pred, aux


def nfr_unit_row_sums(aux, cfg: dc.DecompConfig):
    """The loss's masked mean over ``aux``'s rows as partial sums {"rgb":
    (sum of the masked per-row MSE, sum of the mask)}: the sums of row
    blocks add up to those of their union."""
    mask = aux["mask"]
    gt = aux["rgb_gt"]
    linear_gt = srgb2linear(gt) if cfg.is_nerf else gt
    per_ray = torch.mean((linear_gt - aux["rgb_pred_linear"]) ** 2, dim=-1)
    return {"rgb": (torch.sum(per_ray * mask), torch.sum(mask))}


def nfr_unit_loss_from_sums(sums):
    """(loss, loss dict) from ``nfr_unit_row_sums``."""
    num, den = sums["rgb"]
    loss = num / torch.clamp(den, min=1.0)
    return loss, {"rgb": loss, "loss": loss}


def nfr_unit_loss(aux, cfg: dc.DecompConfig, mode="train"):
    """Masked-mean MSE in linear space; returns (loss, loss dict)."""
    return nfr_unit_loss_from_sums(nfr_unit_row_sums(aux, cfg))
