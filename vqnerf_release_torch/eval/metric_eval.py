"""Reconstruction, decomposition and relighting scores of a model's test
renders against GT (counterpart of vqnerf_release_tpu/eval/metric_eval.py,
whose docstring gives the reference lines): per dataset-family flags for
which GT exists, per-model path adapters, albedo scale matching, sRGB
conversions, white-bg alignment blending, and PSNR/SSIM/LPIPS per buffer.

  nerf: rgb + kd + relight (8 envs), scaled albedo, no ks/rough GT
  mat:  rgb + kd + ks + rough (no relight GT)
  dtu/ours/hw: rgb only, no scale, no sRGB re-encode

The reading, resizing (data/io.py::resize, cv2.INTER_AREA's weights), sRGB
curves (ops/colorspace.py in float32) and uint8 quantisation of ``_align``
run on the host for every device, so that the card and the CPU score the
same uint8 images; SSIM and LPIPS compute on ``device``. The ``nero``
adapter's JPEG files go through the port's decoder (data/jpeg.py, equal to
cv2.imread).
"""

import json
import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..ops.colorspace import linear2srgb as _l2s_t
from ..ops.colorspace import srgb2linear as _s2l_t
from ..utils.device import resolve_device
from . import metrics

__all__ = ["FAMILY_FLAGS", "ENV_LIGHTS_CG", "ENV_LIGHTS_REAL",
           "MODEL_ADAPTERS", "compute_scene_scales", "eval_scene",
           "eval_dataset", "resolve_scene_dirs"]

SPEC_SCENES = ("drums", "lego", "materials", "chair0", "machine1",
               "kitchen6")
ENV_LIGHTS_CG = ["city", "courtyard", "forest", "sunrise", "night",
                 "interior", "studio", "sunset"]
ENV_LIGHTS_REAL = ENV_LIGHTS_CG + [str(i) for i in range(1, 9)]

FAMILY_FLAGS = {
    "nerf": dict(with_kd=True, with_kskr=False, with_relight=True,
                 new_h=512, use_scale=True, k_to_srgb=True,
                 alpha_strict=0.8),
    "mat": dict(with_kd=True, with_kskr=True, with_relight=False,
                new_h=420, use_scale=True, k_to_srgb=True,
                alpha_strict=0.8),
    "dtu": dict(with_kd=False, with_kskr=False, with_relight=False,
                new_h=512, use_scale=False, k_to_srgb=False,
                alpha_strict=0.95),
    "ours": dict(with_kd=False, with_kskr=False, with_relight=False,
                 new_h=420, use_scale=False, k_to_srgb=False,
                 alpha_strict=0.95),
    "hw": dict(with_kd=False, with_kskr=False, with_relight=False,
               new_h=420, use_scale=False, k_to_srgb=False,
               alpha_strict=0.95),
}

# Per-model buffer/path adapters (metric_eval.py get_scene/load_*).
# Fields:
#   view_prefix: which pd_scene subdirs are views — "batch", "val", or
#     "numeric" (nero's bare ints, renamed batch%09d, :570-575)
#   albedo_add: second buffer summed (linear) into the albedo prediction
#   spec_mul: second buffer whose LAST channel multiplies the spec read
#   rough_channel: take this channel of the rough read (nv ORM green)
#   alpha_invert: white-bg buffer -> invert before thresholding
#   srgb_pred: albedo/spec reads are sRGB -> linearize (pil)
#   relit_own_alpha: relit images are RGBA, masked by their own alpha,
#     under val_NNN instead of batch names (nv)
#   eval_rgb/eval_kskr/eval_relight: model-level disables (:58-64)
#   use_scale/k_to_srgb False: our outputs are pre-scaled + sRGB (:67-69)
MODEL_ADAPTERS = {
    "ref_nfr": dict(view_prefix="batch", rgb="pred_rgb.png",
                    albedo="pred_basecolor.png", albedo_add=None,
                    kd_scale=("pred_albedo.png", "pred_spec.png"),
                    spec="pred_spec.png", spec_mul=None,
                    rough="pred_rough.png", rough_channel=None,
                    alpha="pred_alpha.png", alpha_invert=False,
                    relit="pred_rgb_probes_{env}.png",
                    relit_own_alpha=False, srgb_pred=False,
                    use_scale=False, k_to_srgb=False,
                    eval_rgb=True, eval_kskr=True, eval_relight=True),
    "base_nfr": dict(view_prefix="val", rgb="pred_rgb.png",
                     albedo="albedo.png", albedo_add="spec.png",
                     kd_scale=("albedo.png", "spec.png"),
                     spec="spec.png", spec_mul=None,
                     rough="rough.png", rough_channel=None,
                     alpha="pred_alpha.png", alpha_invert=False,
                     relit=None, relit_own_alpha=False, srgb_pred=False,
                     use_scale=False, k_to_srgb=False,
                     eval_rgb=False, eval_kskr=True, eval_relight=False),
    "nfr": dict(view_prefix="batch", rgb="pred_rgb.png",
                albedo="pred_albedo.png", albedo_add=None,
                kd_scale=("pred_albedo.png", None),
                spec=None, spec_mul=None, rough=None, rough_channel=None,
                alpha="gt_alpha.png", alpha_invert=False,
                relit="pred_rgb_probes_{env}.png",
                relit_own_alpha=False, srgb_pred=False,
                eval_rgb=True, eval_kskr=False, eval_relight=True),
    "nv": dict(view_prefix="batch", rgb="pred_opt.png",
               albedo="pred_kd.png", albedo_add=None,
               kd_scale=("pred_kd.png", None),
               spec="pred_kd.png", spec_mul="pred_ks.png",
               rough="pred_ks.png", rough_channel=1,
               alpha="pred_ks.png", alpha_invert=True,
               relit="rgba_{env}.png", relit_own_alpha=True,
               srgb_pred=False,
               eval_rgb=True, eval_kskr=True, eval_relight=True),
    "neilf": dict(view_prefix="batch", rgb="pred_rgb.png",
                  albedo="pred_albedo.png", albedo_add=None,
                  kd_scale=("pred_albedo.png", None),
                  spec="pred_albedo.png", spec_mul="pred_spec.png",
                  rough="pred_rough.png", rough_channel=None,
                  alpha="pred_albedo.png", alpha_invert=True,
                  relit=None, relit_own_alpha=False, srgb_pred=False,
                  eval_rgb=True, eval_kskr=True, eval_relight=False),
    "pil": dict(view_prefix="val", rgb="fine_rgb.png",
                albedo="fine_diffuse.png", albedo_add="fine_specular.png",
                kd_scale=("fine_diffuse.png", "fine_specular.png"),
                spec="fine_specular.png", spec_mul=None,
                rough="fine_roughness.png", rough_channel=None,
                alpha="fine_acc_alpha.png", alpha_invert=False,
                relit=None, relit_own_alpha=False, srgb_pred=True,
                eval_rgb=True, eval_kskr=True, eval_relight=False),
    "nero": dict(view_prefix="numeric", rgb="rgb_pr.jpg",
                 albedo="albedo.jpg", albedo_add=None,
                 kd_scale=("albedo.jpg", None),
                 spec="albedo.jpg", spec_mul="metallic.jpg",
                 rough="roughness.jpg", rough_channel=None,
                 alpha="depth.npy", alpha_invert=False,
                 relit=None, relit_own_alpha=False, srgb_pred=False,
                 eval_rgb=True, eval_kskr=True, eval_relight=False),
}

NERO_DEPTH_THRES = 10.0  # metric_eval.py:496


def _l2s(x):
    x = torch.from_numpy(np.clip(np.asarray(x, np.float32), 0, 1))
    return _l2s_t(x).numpy()


def _s2l(x):
    x = torch.from_numpy(np.clip(np.asarray(x, np.float32), 0, 1))
    return _s2l_t(x).numpy()


def _read3(path, srgb_pred=False):
    img = vio.load_img_f32(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    img = img[..., :3]
    return _s2l(img) if srgb_pred else img


def _resize_to(img, new_h, new_w):
    if img.shape[0] != new_h:
        img = vio.resize(img, new_h=new_h, new_w=new_w)
    return img


def _align(img, raw_mask, alpha_strict):
    """White-bg alignment blending (metric_eval.py alpha_blend)."""
    mask = np.where(raw_mask > alpha_strict, 1.0, 0.0)
    img = np.clip(img * mask + (1.0 - mask), 0, 1)
    return (img * 255).astype(np.uint8)


def _score(metric, key, gt_img, pd_img, device):
    metric[key]["psnr"].append(metrics.psnr(gt_img, pd_img))
    metric[key]["ssim"].append(metrics.ssim(gt_img, pd_img, device=device))
    metric[key]["lpips"].append(metrics.lpips(gt_img, pd_img,
                                              device=device))


def _iter_views(pd_scene, adapter):
    """Yield (dir_name, canonical_batch_name) per metric_eval.py:566-575:
    nero's views are bare ints renamed batch%09d; pil/base_nfr use val_*;
    everything else uses batch*."""
    prefix = adapter["view_prefix"]
    for view in sorted(os.listdir(pd_scene)):
        if not os.path.isdir(join(pd_scene, view)):
            continue
        if prefix == "numeric":
            if view.isdigit():
                yield view, "batch%09d" % int(view)
        elif view.startswith(prefix):
            yield view, view


def _load_pd_mask(pd_dir, adapter, new_h, new_w):
    """Prediction foreground mask (metric_eval.py load_mask). Returns
    (H,W,1) in {0,1} or None (use the GT mask)."""
    name = adapter["alpha"]
    if name is None:
        return None
    path = join(pd_dir, name)
    if name.endswith(".npy"):  # nero: depth buffer (:473-497)
        depth = np.load(path).astype(np.float32)
        if depth.ndim == 3:
            depth = depth[..., 0]
        depth = _resize_to(depth, new_h, new_w)
        return np.where((depth > 0.0) & (depth < NERO_DEPTH_THRES),
                        1.0, 0.0)[..., None]
    alpha = _read3(path)
    if adapter.get("alpha_invert"):
        alpha = 1.0 - alpha  # white-bg proxy buffers (:478)
    alpha = _resize_to(alpha, new_h, new_w)
    return np.where(np.mean(alpha, axis=-1, keepdims=True) > 0, 1.0, 0.0)


def compute_scene_scales(pd_scene, gt_scene, scene, flags, adapter):
    """Albedo+spec scale matching (compute_rgb_scales), on the host."""
    srgb_pred = adapter.get("srgb_pred", False)
    opt_scale = [[], [], []]
    for view_dir, view in _iter_views(pd_scene, adapter):
        gt_dir = join(gt_scene, "val_" + view[-3:])
        kd_path, spec_path = adapter["kd_scale"]
        pd = _read3(join(pd_scene, view_dir, kd_path), srgb_pred)
        if spec_path:
            pd = pd + _read3(join(pd_scene, view_dir, spec_path), srgb_pred)
        gt = _read3(join(gt_dir, "albedo.png"))
        if scene.split("_")[0] in SPEC_SCENES:
            gt = gt + _read3(join(gt_dir, "metal.png"))
        rgba = vio.load_img_f32(join(gt_dir, "rgba.png"))
        new_h = flags["new_h"]
        new_w = int(new_h * rgba.shape[1] / rgba.shape[0])
        gt = _resize_to(gt, new_h, new_w)
        pd = _resize_to(pd, new_h, new_w)
        rgba = _resize_to(rgba, new_h, new_w)
        alpha = rgba[..., 3]
        pd, gt = _l2s(pd), _l2s(gt)
        for i in range(3):
            p = np.sum(pd[..., i] * alpha) / np.sum(alpha)
            g = np.sum(gt[..., i] * alpha) / np.sum(alpha)
            opt_scale[i].append(g / max(p, 1e-8))
    return np.mean(np.array(opt_scale), axis=-1)


def eval_scene(scene, family, pd_scene, gt_scene, relight_dir=None,
               model_name="ref_nfr", env_lights=None, device="cuda"):
    """Per-scene metric dict (metric_eval.process_scene); SSIM and LPIPS
    on ``device``."""
    device = resolve_device(device)
    flags = FAMILY_FLAGS[family]
    adapter = MODEL_ADAPTERS[model_name]
    srgb_pred = adapter.get("srgb_pred", False)
    use_scale = flags["use_scale"] and adapter.get("use_scale", True)
    k_to_srgb = flags["k_to_srgb"] and adapter.get("k_to_srgb", True)
    do_rgb = adapter.get("eval_rgb", True)
    do_kskr = (flags["with_kskr"] and adapter.get("eval_kskr", True)
               and adapter["spec"] is not None)
    do_relight = (flags["with_relight"] and relight_dir
                  and adapter.get("eval_relight", True)
                  and adapter["relit"] is not None)
    if env_lights is None:
        env_lights = (ENV_LIGHTS_CG if family in ("nerf", "mat")
                      else ENV_LIGHTS_REAL)

    metric = {}
    if do_rgb:
        metric["rgb"] = {"psnr": [], "ssim": [], "lpips": []}
    if flags["with_kd"]:
        metric["kd"] = {"psnr": [], "ssim": [], "lpips": []}
    if do_kskr:
        metric["ks"] = {"psnr": [], "ssim": [], "lpips": []}
        metric["rough"] = {"psnr": [], "ssim": [], "lpips": []}
    if do_relight:
        metric["env"] = {"psnr": [], "ssim": [], "lpips": []}

    opt_scale = None
    if use_scale and flags["with_kd"]:
        opt_scale = compute_scene_scales(
            pd_scene, gt_scene, scene, flags, adapter)

    for view_dir, view in _iter_views(pd_scene, adapter):
        pd_dir = join(pd_scene, view_dir)
        gt_dir = join(gt_scene, "val_" + view[-3:])
        rgba = vio.load_img_f32(join(gt_dir, "rgba.png"))
        new_h = flags["new_h"]
        new_w = int(new_h * rgba.shape[1] / rgba.shape[0])
        rgba = _resize_to(rgba, new_h, new_w)
        raw_mask = rgba[..., 3:]
        thres = 0.1 if family in ("nerf", "mat") else 0.95
        gt_mask = np.where(raw_mask > thres, 1.0, 0.0)
        pd_mask = _load_pd_mask(pd_dir, adapter, new_h, new_w)
        if pd_mask is None:
            pd_mask = gt_mask
        strict = flags["alpha_strict"]

        # RGB
        if do_rgb:
            pd = _resize_to(
                _read3(join(pd_dir, adapter["rgb"])), new_h, new_w)
            pd = np.clip(pd * pd_mask + (1 - pd_mask), 0, 1)
            gt = np.clip(rgba[..., :3] * gt_mask + (1 - gt_mask), 0, 1)
            _score(metric, "rgb", _align(gt, raw_mask, strict),
                   _align(pd, raw_mask, strict), device)

        # kd
        if flags["with_kd"]:
            pd = _resize_to(
                _read3(join(pd_dir, adapter["albedo"]), srgb_pred),
                new_h, new_w)
            if adapter["albedo_add"]:
                pd = pd + _resize_to(
                    _read3(join(pd_dir, adapter["albedo_add"]), srgb_pred),
                    new_h, new_w)
            gt = _read3(join(gt_dir, "albedo.png"))
            if scene.split("_")[0] in SPEC_SCENES:
                gt = gt + _read3(join(gt_dir, "metal.png"))
            gt = _resize_to(gt, new_h, new_w)
            gt = _l2s(gt)
            if k_to_srgb:
                pd = _l2s(pd)
            if opt_scale is not None:
                pd = pd * opt_scale[None, None, :]
            pd = np.clip(pd * pd_mask + (1 - pd_mask), 0, 1)
            gt = np.clip(gt * gt_mask + (1 - gt_mask), 0, 1)
            _score(metric, "kd", _align(gt, raw_mask, strict),
                   _align(pd, raw_mask, strict), device)

        # ks + rough
        if do_kskr:
            pd = _resize_to(
                _read3(join(pd_dir, adapter["spec"]), srgb_pred),
                new_h, new_w)
            if adapter["spec_mul"]:  # ORM/metallic channel (:355-358)
                mul = _resize_to(
                    _read3(join(pd_dir, adapter["spec_mul"])),
                    new_h, new_w)
                pd = pd * mul[..., -1:]
            gt = _read3(join(gt_dir, "metal.png")) \
                if scene.split("_")[0] in SPEC_SCENES else np.zeros_like(pd)
            gt = _resize_to(gt, new_h, new_w)
            gt = _l2s(gt)
            if k_to_srgb:
                pd = _l2s(pd)
            if opt_scale is not None:
                pd = pd * opt_scale[None, None, :]
            pd = np.clip(pd * pd_mask + (1 - pd_mask), 0, 1)
            gt = np.clip(gt * gt_mask + (1 - gt_mask), 0, 1)
            _score(metric, "ks", _align(gt, raw_mask, strict),
                   _align(pd, raw_mask, strict), device)

            pd = _resize_to(
                _read3(join(pd_dir, adapter["rough"])), new_h, new_w)
            if adapter["rough_channel"] is not None:  # nv ORM green
                c = adapter["rough_channel"]
                pd = np.repeat(pd[..., c:c + 1], 3, axis=-1)
            gt = _resize_to(
                _read3(join(gt_dir, "rough.png")), new_h, new_w)
            pd = np.clip(pd * pd_mask, 0, 1)  # black bg for rough
            gt = np.clip(gt * gt_mask, 0, 1)
            _score(metric, "rough", _align(gt, raw_mask, strict),
                   _align(pd, raw_mask, strict), device)

        # Relighting
        if do_relight:
            for env in env_lights:
                relit_view = ("val_" + view[-3:]
                              if adapter["relit_own_alpha"] else view_dir)
                pd_path = join(relight_dir, relit_view,
                               adapter["relit"].format(env=env))
                gt_path = join(gt_dir, "rgba_%s.png" % env)
                if not (os.path.exists(pd_path)
                        and os.path.exists(gt_path)):
                    continue
                if adapter["relit_own_alpha"]:  # nv RGBA relights (:710)
                    pd_rgba = _resize_to(
                        vio.load_img_f32(pd_path), new_h, new_w)
                    m = pd_rgba[..., 3:] if pd_rgba.shape[-1] == 4 \
                        else pd_mask
                    pd = np.clip(pd_rgba[..., :3] * m + (1 - m), 0, 1)
                else:
                    pd = _resize_to(_read3(pd_path), new_h, new_w)
                    pd = np.clip(pd * pd_mask + (1 - pd_mask), 0, 1)
                gt_rgba = _resize_to(
                    vio.load_img_f32(gt_path), new_h, new_w)
                gt = np.clip(
                    gt_rgba[..., :3] * gt_mask + (1 - gt_mask), 0, 1)
                _score(metric, "env", _align(gt, raw_mask, strict),
                       _align(pd, raw_mask, strict), device)
    return metric


def _latest_subdir(base):
    subs = sorted(os.listdir(base)) if os.path.isdir(base) else []
    return join(base, subs[-1]) if subs else None


def resolve_scene_dirs(pred_root, scene, family, model_name,
                       lr="lr5e-4"):
    """Per-model (pd_scene, relight_dir) layout (metric_eval.get_scene,
    :210-257), with a fall-back to the newest checkpoint subdir in our
    layout instead of the reference's hardcoded ckpt-5/ckpt-10."""
    def _with_latest(base, fixed):
        path = join(base, fixed)
        if os.path.isdir(path):
            return path
        return _latest_subdir(base) or path

    if model_name == "ref_nfr":
        base = join(pred_root, f"{scene}_ref_nfr", lr)
        pd = _with_latest(join(base, "pd_test"), "ckpt-5")
        relit = join(base, "pd_relit", os.path.basename(pd))
        return pd, relit
    if model_name == "base_nfr":
        base = join(pred_root, f"{scene}_nfr_unit", lr)
        return _with_latest(join(base, "vis_z"), "ckpt-10"), None
    if model_name == "nfr":
        suffix = "_nerfactor_dtu" if family in ("ours", "dtu") \
            else "_nerfactor"
        base = join(pred_root, scene + suffix, "lr5e-3")
        pd = _with_latest(join(base, "vis_vali"), "epoch000000100")
        relit = _with_latest(join(base, "vis_test"), "ckpt-10")
        return pd, relit
    if model_name == "nero":
        prefix = scene.split("_")[0]
        return _with_latest(
            join(pred_root, prefix + "_material-val"), "100000"), None
    if model_name == "neilf":
        base = join(pred_root, scene)
        subs = sorted(os.listdir(base)) if os.path.isdir(base) else []
        if subs:
            return _with_latest(
                join(base, subs[0], "plots"), "30000"), None
        return join(base, "plots", "30000"), None
    if model_name in ("nv", "nvmc"):
        return (join(pred_root, scene, "validate"),
                join(pred_root, "relight", scene))
    if model_name == "pil":
        base = join(pred_root, scene)
        pd = join(base, "test_400000")
        if not os.path.isdir(pd) and os.path.isdir(base):
            for f in sorted(os.listdir(base)):
                if f.startswith("test_") and os.path.isdir(join(base, f)):
                    pd = join(base, f)
                    break
        return pd, None
    raise NotImplementedError(f"unknown model {model_name}")


def eval_dataset(scenes, family, pred_root, data_root, out_json=None,
                 model_name="ref_nfr", scene_dirs=None, device="cuda"):
    """Evaluate several scenes and write the per-scene score JSON
    (metric_eval.py main loop). scene_dirs optionally maps scene ->
    (pd_scene, relight_dir) to override the layout conventions."""
    device = resolve_device(device)
    model_score = {}
    for scene in scenes:
        if scene_dirs and scene in scene_dirs:
            pd_scene, relight_dir = scene_dirs[scene]
        else:
            pd_scene, relight_dir = resolve_scene_dirs(
                pred_root, scene, family, model_name)
        model_score[scene] = eval_scene(
            scene, family, pd_scene, join(data_root, scene),
            relight_dir=relight_dir, model_name=model_name, device=device)
    model_score["_lpips_impl"] = metrics.lpips_impl()
    if out_json:
        os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(model_score, f)
    return model_score
