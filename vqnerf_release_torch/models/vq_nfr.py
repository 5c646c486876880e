"""vq_nfr: BRDF decomposition with an EMA vector-quantised material codebook
(counterpart of vqnerf_release_tpu/models/vq_nfr.py).

  * two decode paths: the continuous heads inherited from nfr_unit on
    z_enc, and fresh *_vq heads on the quantised z;
  * the codebook is read clipped to [0, 1] and column-normalised; its EMA
    update is assigned to the raw parameter outside the gradients;
  * the training loss: combine-weighted RGB, vq RGB, commitment,
    chromaticity, chroma-gated smoothness over jitter pairs, the codebook's
    log-min-distance term and the Lambert prior;
  * the fast render with edits, albedo scale and probe/OLAT relighting,
    the segmentation embed, and the drop-loss pass ``vq_test``.
"""

import copy

import torch

from ..ops.colorspace import linear2srgb, srgb2linear
from ..ops.math import (clip_preserve_gradient, rgb2chromaticity,
                        safe_l2_normalize)
from ..ops.microfacet import microfacet_brdf
from ..ops.render import (fused_render_equation, fused_render_maps,
                          render_equation)
from ..ops.vq import init_vq_ema_state, vq_ema_apply, vq_lookup
from ..utils import profiling
from . import decomp_common as dc

__all__ = ["VqNfr", "init_vq_nfr", "vq_encode", "vq_nfr_forward",
           "vq_nfr_rows", "vq_nfr_loss", "vq_nfr_row_sums",
           "vq_nfr_train_loss", "vq_fast_render", "vq_fast_embed",
           "vq_test"]


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


def _decode_vq(model, z_vq, cfg):
    vq_albedo = cfg.albedo_slope * model.diff_vq(z_vq) + cfg.albedo_bias
    return vq_albedo, model.spec_vq(z_vq), model.rough_vq(z_vq)


def _view_geom(batch, cfg):
    """What a render takes from the batch but the [N, L, 3] light
    directions, which the fused kernels form themselves."""
    mask = (batch["alpha"][:, 0] > 0).to(torch.float32)
    xyz, normal, rayo = batch["xyz"], batch["normal"], batch["rayo"]
    lvis = batch.get("lvis") if cfg.is_nerf else None
    surf2c = dc.calc_vdir(rayo, xyz)
    normal_pred = dc.normal_correct(normal, surf2c)
    return mask, xyz, surf2c, normal_pred, lvis


def _geom(batch, cfg, lxyz):
    mask, xyz, surf2c, normal_pred, lvis = _view_geom(batch, cfg)
    surf2l = dc.calc_ldir(lxyz, xyz)
    return mask, xyz, surf2c, surf2l, normal_pred, lvis


def vq_encode(model, xyz, cfg):
    """xyz -> (z_enc, z_norm)."""
    z_enc = dc.apply_encoder(model, xyz, cfg)
    return z_enc, safe_l2_normalize(z_enc, axis=1)


def vq_nfr_forward(model, ema_state, batch, cfg: dc.DecompConfig, lxyz,
                   lareas, mode="train", thres=None, rng=None, roll=None):
    """Training/validation forward.

    Returns (pred, aux, new_ema_state). In training mode
    ``aux["codebook_update"]`` holds the EMA-updated raw codebook; the
    caller assigns it to the model AFTER the gradient step. rng: a
    torch.Generator on the batch's device for the code dropout; roll:
    explicit [1, K] uniforms in its place.
    """
    train = mode == "train"
    mask = (batch["alpha"][:, 0] > 0).to(torch.float32)
    z_enc, z_norm = vq_encode(model, batch["xyz"], cfg)
    vq_outs, new_ema = vq_ema_apply(
        dc.get_codebook(model), z_norm, ema_state,
        commitment_cost=cfg.commitment_cost, decay=cfg.vq_decay,
        is_training=train, thres=thres, rng=rng, mask=mask, roll=roll,
        use_fused=train and dc.fused_vq_enabled(cfg, z_norm.device))
    pred, aux = vq_nfr_rows(model, batch, z_enc, vq_outs["quantize"],
                            vq_outs["encoding_indices"], cfg, lxyz, lareas,
                            mode=mode)
    # masked per-code usage; the fused path returns counts in place of the
    # [N, K] one-hot
    if "counts" in vq_outs:
        usage = vq_outs["counts"] > 0
    else:
        usage = torch.amax(vq_outs["encodings"], dim=0) > 0
    aux.update(vq_loss=vq_outs["loss"], perplexity=vq_outs["perplexity"],
               usage=usage.to(torch.float32))
    if train:
        aux["codebook_update"] = vq_outs["update"]
    return pred, aux, new_ema


def vq_nfr_rows(model, batch, z_enc, z_vq, encoding_indices,
                cfg: dc.DecompConfig, lxyz, lareas, mode="train"):
    """The per-row half of ``vq_nfr_forward`` after the VQ: both decodes,
    BRDFs and renders of ``batch``'s rows from their latents ``z_enc`` and
    quantised ``z_vq``. Returns (pred, aux) without the VQ's own entries,
    so that row blocks on several devices can run it on one VQ call's
    outputs."""
    mask, xyz, surf2c, surf2l, normal_pred, lvis = _geom(batch, cfg, lxyz)
    embed_ind = encoding_indices + 1  # 0 is the background

    basecolor, ks, rough, spec, albedo = _decode_main(model, z_enc, cfg)
    brdf, brdf_spec, brdf_diff = microfacet_brdf(
        surf2l, surf2c, normal_pred, albedo=albedo, rough=rough, f0=spec)

    light = dc.get_light(model)
    gamma = None if cfg.is_nerf else dc.get_gamma(model)
    rgb_pred = render_equation(
        brdf, surf2l, normal_pred, lareas, light, light_vis=lvis, gamma=gamma)

    vq_albedo, vq_spec, vq_rough = _decode_vq(model, z_vq, cfg)
    vq_brdf, _, _ = microfacet_brdf(
        surf2l, surf2c, normal_pred, albedo=vq_albedo, rough=vq_rough,
        f0=vq_spec)
    vq_rgb = render_equation(
        vq_brdf, surf2l, normal_pred, lareas, light, light_vis=lvis,
        gamma=gamma)

    aux = {
        "mask": mask,
        "rgb_gt": batch["rgb"],
        "rgb_pred_linear": rgb_pred,
        "vq_rgb_linear": vq_rgb,
        "z_vq": z_vq,
        "spec": spec,
        "rough": rough,
    }

    m = mask[:, None]
    pred = {
        "rgb": (linear2srgb(rgb_pred) if cfg.is_nerf else rgb_pred) * m,
        "normal": normal_pred * m,
        "albedo": albedo * m,
        "spec": spec * m,
        "rough": rough * m,
        "ks": ks * m,
        "alpha": batch.get("pred_alpha", batch["alpha"]),
        "embed": embed_ind.to(torch.int32) * mask.to(torch.int32),
    }
    if mode != "train":
        # the component renders stay linear, also for CG scenes
        pred["rgb_diff"] = render_equation(
            brdf_diff, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
        pred["rgb_spec"] = render_equation(
            brdf_spec, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma) * m
        pred["vq_rgb"] = (linear2srgb(vq_rgb) if cfg.is_nerf else vq_rgb) * m
        pred["vq_albedo"] = vq_albedo * m
        pred["vq_spec"] = vq_spec * m
        pred["vq_rough"] = vq_rough * m
    return pred, aux


def _masked_mean(per_ray, mask):
    return torch.sum(per_ray * mask) / torch.clamp(torch.sum(mask), min=1.0)


def _from_sums(sums):
    num, den = sums
    return num / torch.clamp(den, min=1.0)


def _mse(a, b):
    return torch.mean((a - b) ** 2, dim=-1)


def vq_nfr_loss(model, aux, cfg: dc.DecompConfig, mode="train"):
    """The seven-term training loss, or the three-term validation loss;
    returns (loss, loss dict)."""
    if mode == "train":
        return vq_nfr_train_loss(model, vq_nfr_row_sums(aux, cfg), aux, cfg)
    mask = aux["mask"]
    rgb_gt = aux["rgb_gt"]
    rgb_pred = aux["rgb_pred_linear"]
    vq_rgb = aux["vq_rgb_linear"]

    if cfg.is_nerf:
        linear_gt = srgb2linear(rgb_gt)
        srgb_pred = linear2srgb(rgb_pred)
    else:
        linear_gt, srgb_pred = rgb_gt, rgb_pred

    # sRGB-domain reconstruction, vq reconstruction and chromaticity
    loss_dict = {}
    loss_dict["rgb"] = _masked_mean(_mse(rgb_gt, srgb_pred), mask)
    vq_srgb = linear2srgb(vq_rgb) if cfg.is_nerf else vq_rgb
    loss_dict["vqrgb"] = _masked_mean(_mse(rgb_gt, vq_srgb), mask)
    loss_dict["chromaticity"] = _masked_mean(
        _mse(rgb2chromaticity(linear_gt), rgb2chromaticity(vq_rgb)), mask)
    loss = loss_dict["rgb"] + loss_dict["vqrgb"] + loss_dict["chromaticity"]
    loss_dict["loss"] = loss
    return loss, loss_dict


def vq_nfr_row_sums(aux, cfg: dc.DecompConfig):
    """The training loss's masked-mean terms over ``aux``'s rows as partial
    sums {name: (sum of the masked per-row values, sum of the mask)}: the
    sums of row blocks add up to those of their union."""
    mask = aux["mask"]
    rgb_gt = aux["rgb_gt"]
    rgb_pred = aux["rgb_pred_linear"]
    vq_rgb = aux["vq_rgb_linear"]
    linear_gt = srgb2linear(rgb_gt) if cfg.is_nerf else rgb_gt

    def sums(per_ray):
        return torch.sum(per_ray * mask), torch.sum(mask)

    out = {"rgb": sums(_mse(linear_gt, rgb_pred)),
           "vqrgb": sums(_mse(linear_gt, vq_rgb))}
    if cfg.chromaticity_loss_weight > 0:
        out["chromaticity"] = sums(_mse(rgb2chromaticity(linear_gt),
                                        rgb2chromaticity(vq_rgb)))
    # Lambert prior: penalise high spec where the (detached) rough is high
    if cfg.lambert_weight > 0:
        sg_rough = aux["rough"].detach()
        sg_rough = torch.where(sg_rough < 0.5, torch.zeros_like(sg_rough),
                               2.0 * sg_rough - 1.0)
        out["lambert"] = sums(torch.amax(aux["spec"], dim=-1)
                              * sg_rough[:, 0])
    return out


def vq_nfr_train_loss(model, sums, aux, cfg: dc.DecompConfig):
    """The seven-term training loss; returns (loss, loss dict). ``sums``:
    ``vq_nfr_row_sums`` of the batch (or of its row blocks, added up);
    ``aux``: the whole batch's mask, rgb_gt and z_vq (the smoothness
    pairs), and the VQ's vq_loss and codebook_update."""
    mask = aux["mask"]
    loss_dict = {}
    loss_dict["rgb"] = cfg.combine_weight * _from_sums(sums["rgb"])
    loss = loss_dict["rgb"]

    loss_dict["vqrgb"] = _from_sums(sums["vqrgb"])
    loss = loss + loss_dict["vqrgb"]

    loss_dict["vqloss"] = cfg.vq_loss_weight * aux["vq_loss"]
    loss = loss + loss_dict["vqloss"]

    if cfg.chromaticity_loss_weight > 0:
        loss_dict["chromaticity"] = (
            cfg.chromaticity_loss_weight * _from_sums(sums["chromaticity"]))
        loss = loss + loss_dict["chromaticity"]

    # Chroma-gated smoothness over the jitter pairs [p, p_jit, p, p_jit,
    # ...]; the GT chromaticity in the raw domain (sRGB for CG data).
    if cfg.mat_sloss_weight > 0:
        schr_gt = rgb2chromaticity(aux["rgb_gt"])
        chr1, chr2 = schr_gt[::2], schr_gt[1::2]
        chr_e = torch.sqrt(torch.sum(torch.square(chr1 - chr2), dim=-1))
        chr_e = torch.where(chr_e > cfg.chr_thres, chr_e,
                            torch.zeros_like(chr_e))
        w_chr = torch.exp(-cfg.chr_alpha * chr_e)
        z_vq = aux["z_vq"]
        mat1, mat2 = z_vq[::2], z_vq[1::2]
        pair_sl = w_chr * (1.0 - torch.sum(mat1 * mat2, dim=-1))
        pair_mask = mask[::2] * mask[1::2]
        loss_dict["chr_smooth"] = cfg.mat_sloss_weight * _masked_mean(
            pair_sl, pair_mask)
        loss = loss + loss_dict["chr_smooth"]

    # Codebook anti-collapse: -log(min pairwise distance). The reference
    # assigns the EMA update to the codebook DURING the forward, so this
    # term reads the UPDATED codebook, and the optimizer then applies its
    # gradient on top of that update. Both are kept: the term is evaluated
    # at aux["codebook_update"] while its gradient goes to the raw codebook
    # parameter.
    if cfg.sim_loss_weight > 0:
        raw_cb = model.codebook
        if "codebook_update" in aux:
            raw_cb = raw_cb + (aux["codebook_update"] - raw_cb).detach()
        cb = clip_preserve_gradient(raw_cb, 0.0, 1.0)
        codebook = safe_l2_normalize(cb, axis=0).T  # [K, D]
        diff = codebook[:, None, :] - codebook[None, :, :]
        dist = torch.sqrt(torch.sum(torch.square(diff), dim=-1) + 1e-12)
        eye = torch.eye(cfg.num_embed, device=dist.device)
        masked = dist * (1 - eye) + eye * torch.max(dist)
        loss_dict["sim_smooth"] = cfg.sim_loss_weight * (
            -torch.log(torch.min(masked)))
        loss = loss + loss_dict["sim_smooth"]

    if cfg.lambert_weight > 0:
        loss_dict["lambert"] = cfg.lambert_weight * _from_sums(
            sums["lambert"])
        loss = loss + loss_dict["lambert"]

    loss_dict["loss"] = loss
    return loss, loss_dict


def _edit(src, val, em):
    """src, or the edit value inside the mask; a negative first channel of
    the value means no edit."""
    val = torch.as_tensor(val, dtype=torch.float32, device=src.device)
    return torch.where(val[0] < 0, src, src * (1 - em) + em * val)


def _relit(rgb, cfg, m):
    """The output of renders [N, E, 3] under E maps."""
    return (linear2srgb(rgb) if cfg.is_nerf else rgb) * m[:, :, None]


def _relight(brdf, surf2l, normal_pred, lareas, envs, lvis, gamma, cfg, m):
    rgb = render_equation(brdf, surf2l, normal_pred, lareas, envs,
                          light_vis=lvis, gamma=gamma, probe_batch=True)
    return _relit(rgb, cfg, m)


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
    mask, xyz, surf2c, normal_pred, lvis = _view_geom(batch, cfg)
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
    m = mask[:, None]
    # the relight maps by output key, each [E, L, 3], and their outputs
    envs = {k: e for k, e in (("rgb_probes", novel_probes),
                              ("rgb_olat", novel_olat)) if e is not None}
    relit = {}
    fused = dc.fused_render_enabled(cfg, xyz.device)
    if fused and envs:
        # the learned light (or dst_env) and every map in one launch, the
        # output finished in one pass and split
        maps = torch.cat([light.reshape(1, -1, 3)]
                         + [e.reshape(e.shape[0], -1, 3)
                            for e in envs.values()])
        out = _relit(fused_render_maps(
            xyz, normal_pred, surf2c, s_albedo, rough, s_spec, lvis, lareas,
            lxyz, maps, gamma=gamma), cfg, m)
        rgb = out[:, 0]
        relit = dict(zip(envs, torch.split(
            out[:, 1:], [e.shape[0] for e in envs.values()], dim=1)))
    else:
        if fused:
            rgb_pred = fused_render_equation(
                xyz, normal_pred, surf2c, s_albedo, rough, s_spec, lvis,
                lareas, lxyz, light, gamma=gamma)
        else:
            surf2l = dc.calc_ldir(lxyz, xyz)
            brdf, _, _ = microfacet_brdf(
                surf2l, surf2c, normal_pred, albedo=s_albedo, rough=rough,
                f0=s_spec)
            rgb_pred = render_equation(
                brdf, surf2l, normal_pred, lareas, light, light_vis=lvis,
                gamma=gamma)
            relit = {k: _relight(brdf, surf2l, normal_pred, lareas, e, lvis,
                                 gamma, cfg, m) for k, e in envs.items()}
        rgb = (linear2srgb(rgb_pred) if cfg.is_nerf else rgb_pred) * m
    if envs:
        path = "render.relight_fused" if fused else "render.relight_plain"
        profiling.count(path)
        profiling.count(path + ".maps", 1 + sum(e.shape[0]
                                                for e in envs.values()))

    if opt_scale is not None and vis_scale:
        basecolor = linear2srgb(basecolor) * opt_scale
        spec = linear2srgb(spec) * opt_scale

    pred = {
        "alpha": batch.get("pred_alpha", batch["alpha"]),
        "basecolor": basecolor * m,
        "albedo": albedo * m,
        "spec": spec * m,
        "rough": rough * m,
        "rgb": rgb,
    }
    if embed_ind is not None:
        pred["embed"] = embed_ind.to(torch.int32) * mask.to(torch.int32)
    pred.update(relit)
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


def vq_test(model, batch, cfg: dc.DecompConfig, lxyz, lareas, thres=None,
            rng=None, render_chunk=None):
    """The drop-loss evaluation pass: render through the *vq heads* under a
    code-dropout threshold; the caller computes the validation loss on the
    result.

    The VQ lookup is ONE call over all rows, because the dropout fill is
    the largest distance of the call. The decode, BRDF and render after it
    are per row and run in chunks of ``render_chunk`` rows (None: all at
    once), with identical results.
    """
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.float32)
    _, z_norm = vq_encode(model, batch["xyz"], cfg)
    outs, _ = vq_ema_apply(
        dc.get_codebook(model), z_norm,
        init_vq_ema_state(cfg.z_dim, cfg.num_embed, z_norm.device),
        commitment_cost=cfg.commitment_cost, is_training=False,
        thres=thres, rng=rng, mask=mask)
    z_vq = outs["quantize"]
    light = dc.get_light(model)
    gamma = None if cfg.is_nerf else dc.get_gamma(model)

    n = z_vq.shape[0]
    step = n if render_chunk is None else render_chunk
    parts = []
    for i in range(0, n, step):
        chunk = {k: v[i:i + step] for k, v in batch.items()}
        _, _, surf2c, surf2l, normal_pred, lvis = _geom(chunk, cfg, lxyz)
        vq_albedo, vq_spec, vq_rough = _decode_vq(model, z_vq[i:i + step], cfg)
        vq_brdf, _, _ = microfacet_brdf(
            surf2l, surf2c, normal_pred, albedo=vq_albedo, rough=vq_rough,
            f0=vq_spec)
        parts.append(render_equation(
            vq_brdf, surf2l, normal_pred, lareas, light, light_vis=lvis,
            gamma=gamma))
    usage = (torch.amax(outs["encodings"], dim=0) > 0).to(torch.float32)
    return {
        "mask": mask,
        "rgb_gt": batch["rgb"],
        "vq_rgb_linear": parts[0] if len(parts) == 1 else torch.cat(parts),
        "usage": usage,
    }
