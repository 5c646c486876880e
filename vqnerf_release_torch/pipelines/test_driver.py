"""The four-pass decomposition inference driver (counterpart of
vqnerf_release_tpu/pipelines/test_driver.py):

  raw_test: ref_fast_render (residual reconstruction) + vq_fast_render maps
  pd_test:  the same after compute_rgb_scales (albedo scale against GT)
  pd_relit: vq_fast_render under the test probes and 4 OLATs
  pd_vq:    vq_fast_embed segmentation with the main_<k>-pruned codebook

Outputs land in <outroot>/{raw_test,pd_test,pd_relit,pd_vq}/batch%09d/ as
the JAX driver writes them. Every forward runs in chunks of _RAY_CHUNK rays,
the JAX driver's chunk: the VQ dropout fill is the maximum distance of one
call, so pd_vq depends on the chunking.
"""

import os
import re
import time
from os.path import basename, join

import numpy as np
import torch

from ..ops.light import olat_envmaps

from ..data import io as vio
from ..models import decomp_common as dc
from ..models.ref_nfr import ref_fast_render
from ..models.vq_nfr import vq_fast_embed, vq_fast_render
from ..ops.colorspace import linear2srgb
from ..utils.device import check_model_device
from ..utils.vis import vis_view

__all__ = ["load_novel_lights", "find_vq", "compute_rgb_scales", "run_test"]

_RAY_CHUNK = 49152

SPEC_SCALE_SCENES = ("drums", "lego", "materials", "chair0", "kitchen6",
                     "machine1")


def load_novel_lights(test_envmap_dir, light_h, olat_inten=200.0,
                      ambient_inten=0.0, white_bg=True):
    """(probe_names, probes [E, L, 3], olat_names, olats [O, L, 3]) as
    numpy; probes is None when the directory holds no envmap."""
    probe_names, probes = [], []
    for path in vio.sortglob(test_envmap_dir, ext=("hdr", "exr")):
        probe_names.append(basename(path)[: -len(".hdr")])
        probes.append(vio.read_envmap(path, new_h=light_h).reshape(-1, 3))
    olat = olat_envmaps(
        light_h, olat_inten, ambient_inten if white_bg else 0.0)
    olats = np.stack([v.reshape(-1, 3) for v in olat.values()])
    return (probe_names, np.stack(probes) if probes else None,
            list(olat.keys()), olats)


def find_vq(vali_epoch_dir):
    """The selected code count from the main_<k> dir name."""
    for f in os.listdir(vali_epoch_dir):
        m = re.fullmatch(r"main_(\d+)", f)
        if m:
            return int(m.group(1))
    raise FileNotFoundError(f"no main_<k> dir under {vali_epoch_dir}")


def _srgb(x):
    return linear2srgb(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def compute_rgb_scales(raw_test_dir, data_root, vis_root=None,
                       scene_name=""):
    """Per-channel albedo scale matching predictions to GT over all
    batches under raw_test_dir; GT albedo (+ metal for the listed scenes)
    lives in the vis_comps mirror of data_root."""
    if vis_root is None:
        vis_root = data_root.replace("nfr_blender", "vis_comps")
    opt_scale = [[], [], []]
    batch_dirs = sorted(
        d for d in os.listdir(raw_test_dir) if d.startswith("batch"))
    for bd in batch_dirs:
        batch_dir = join(raw_test_dir, bd)
        view = "val_%03d" % int(bd[-9:])

        pred = vio.load_img_f32(join(batch_dir, "pred_albedo.png"))[..., :3]
        pred = pred + vio.load_img_f32(
            join(batch_dir, "pred_spec.png"))[..., :3]

        gt = vio.load_img_f32(join(vis_root, view, "albedo.png"))[..., :3]
        if scene_name.split("_")[0] in SPEC_SCALE_SCENES:
            gt = gt + vio.load_img_f32(
                join(vis_root, view, "metal.png"))[..., :3]
        if gt.shape[0] != pred.shape[0]:
            gt = vio.resize(gt, new_h=pred.shape[0])

        rgba = vio.load_img_f32(join(data_root, view, "rgba.png"))
        if rgba.shape[0] != pred.shape[0]:
            rgba = vio.resize(rgba, new_h=pred.shape[0])
        alpha = rgba[:, :, 3]

        gt = _srgb(gt)
        pred = _srgb(np.clip(pred, 0, 1))
        for i in range(3):
            pred_inten = np.sum(pred[:, :, i] * alpha) / np.sum(alpha)
            gt_inten = np.sum(gt[:, :, i] * alpha) / np.sum(alpha)
            opt_scale[i].append(gt_inten / max(pred_inten, 1e-8))
    return np.mean(np.array(opt_scale), axis=-1)


def _forward_chunked(forward, batch, chunk):
    """Run a per-ray forward over ``batch`` in row chunks and concatenate
    the pred dicts (every pred entry is [N, ...])."""
    n = next(iter(batch.values())).shape[0]
    if n <= chunk:
        return forward(batch)
    preds = [forward({k: v[i:i + chunk] for k, v in batch.items()})
             for i in range(0, n, chunk)]
    return {k: torch.cat([p[k] for p in preds]) for k in preds[0]}


@torch.inference_mode()
def run_test(ref_model, vq_model, cfg: dc.DecompConfig, dataset, outroot,
             test_envmap_dir, vali_epoch_dir=None, data_root=None,
             scene_name="", rng=None, *, device):
    """Run all four passes over the test dataset on ``device``.

    ref_model: a RefNfr; vq_model: a VqNfr, both already on ``device``;
    dataset: a ShapeDataset in test mode with with_ref; rng: a
    torch.Generator on ``device`` for the pd_vq code dropout (its roll
    decides nothing there, since the thresholds are 0 or 1).
    Returns {"opt_scale", "n_vq", "seconds": wall time of each pass}.
    """
    device = torch.device(device)
    check_model_device(ref_model, device, "run_test")
    check_model_device(vq_model, device, "run_test")

    def to_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lxyz, lareas = dc.light_constants(cfg, device)
    probe_names, probes, olat_names, olats = load_novel_lights(
        test_envmap_dir, cfg.light_h, white_bg=cfg.white_bg)
    probes_t = to_dev(probes) if probes is not None else None
    olats_t = to_dev(olats)

    views = [dataset.load_view(f) for f in dataset.files]

    def batches():
        for i, v in enumerate(views):
            b = {k: to_dev(x) for k, x in v.as_batch().items()}
            yield i, v, b, {k: x for k, x in b.items() if k != "ref"}

    def vis(to_vis, v, outdir, **kw):
        vis_view(to_vis, (v.h, v.w), outdir, v.id, white_bg=cfg.white_bg,
                 mode="test", **kw)

    seconds = {}

    # ---- PASS 1: raw_test -------------------------------------------------
    t0 = time.perf_counter()
    raw_dir = join(outroot, "raw_test")
    for i, v, b, b_vq in batches():
        outdir = join(raw_dir, "batch%09d" % i)
        pred_ref = _forward_chunked(
            lambda bb: ref_fast_render(ref_model, bb, cfg, lxyz, lareas),
            b, _RAY_CHUNK)
        vis({"pred_" + k: x for k, x in pred_ref.items()}
            | {"gt_rgb": b["rgb"], "gt_alpha": b["alpha"]}, v, outdir)
        pred_vq = _forward_chunked(
            lambda bb: vq_fast_render(vq_model, bb, cfg, lxyz, lareas),
            b_vq, _RAY_CHUNK)
        vis({"pred_" + k: x for k, x in pred_vq.items() if k != "rgb"},
            v, outdir)
    seconds["raw_test"] = time.perf_counter() - t0

    # ---- PASS 2: pd_test (scale-corrected decomposition) ------------------
    t0 = time.perf_counter()
    if cfg.is_nerf and data_root is not None:
        opt_scale = compute_rgb_scales(raw_dir, data_root,
                                       scene_name=scene_name)
        opt_scale_t = to_dev(opt_scale)
    else:
        opt_scale, opt_scale_t = None, None
    pd_dir = join(outroot, "pd_test")
    for i, v, b, b_vq in batches():
        outdir = join(pd_dir, "batch%09d" % i)
        pred_ref = _forward_chunked(
            lambda bb: ref_fast_render(ref_model, bb, cfg, lxyz, lareas),
            b, _RAY_CHUNK)
        vis({"pred_rgb": pred_ref["rgb"], "gt_rgb": b["rgb"],
             "gt_alpha": b["alpha"], "pred_alpha": pred_ref["alpha"]},
            v, outdir)
        # vis_scale: render unscaled, emit sRGB-then-scaled maps
        pred_vq = _forward_chunked(
            lambda bb: vq_fast_render(vq_model, bb, cfg, lxyz, lareas,
                                      opt_scale=opt_scale_t, vis_scale=True),
            b_vq, _RAY_CHUNK)
        vis({"pred_" + k: x for k, x in pred_vq.items() if k != "rgb"},
            v, outdir)
    seconds["pd_test"] = time.perf_counter() - t0

    # ---- PASS 3: pd_relit --------------------------------------------------
    t0 = time.perf_counter()
    relit_dir = join(outroot, "pd_relit")
    for i, v, b, b_vq in batches():
        pred = _forward_chunked(
            lambda bb: vq_fast_render(
                vq_model, bb, cfg, lxyz, lareas, novel_probes=probes_t,
                novel_olat=olats_t, opt_scale=opt_scale_t),
            b_vq, _RAY_CHUNK)
        vis({"pred_rgb_probes": pred["rgb_probes"],
             "pred_rgb_olat": pred["rgb_olat"],
             "gt_alpha": b["alpha"], "pred_alpha": pred["alpha"]},
            v, join(relit_dir, "batch%09d" % i),
            probe_names=probe_names, olat_names=olat_names)
    seconds["pd_relit"] = time.perf_counter() - t0

    # ---- PASS 4: pd_vq (segmentation) --------------------------------------
    t0 = time.perf_counter()
    vq_dir = join(outroot, "pd_vq")
    n_vq = find_vq(vali_epoch_dir) if vali_epoch_dir is not None \
        else cfg.num_embed
    thres = to_dev([0.0] * n_vq + [1.0] * (cfg.num_embed - n_vq))
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    for i, v, b, b_vq in batches():
        out = _forward_chunked(
            lambda bb: vq_fast_embed(vq_model, bb, cfg, thres=thres, rng=rng),
            b_vq, _RAY_CHUNK)
        vis({"pred_embed": out["embed"], "gt_alpha": b["alpha"],
             "pred_alpha": out["alpha"]}, v, join(vq_dir, "batch%09d" % i))
    seconds["pd_vq"] = time.perf_counter() - t0
    return {"opt_scale": None if opt_scale is None else list(opt_scale),
            "n_vq": n_vq, "seconds": seconds}
