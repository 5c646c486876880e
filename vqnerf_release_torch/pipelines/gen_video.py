"""Video over a test trajectory (counterpart of
vqnerf_release_tpu/pipelines/gen_video.py):

  * ``extract_trajectory``: stage-1 geometry buffers of every trajectory
    frame into <out_root>/test_NNN/, with the frame's metadata.json
    (GeoExtractor.compute_geo, then compute_vis unless ``no_vis``);
  * ``render_video``: the trajectory rendered by the trained models in one
    of five modes, recon / relight / edit / vq_dcomps / gen_comps, each
    frame in one call, as the JAX driver renders it;
  * ``compose_video``: the frames' PNGs, composited onto white or black
    through an alpha frame, stitched into an uncompressed AVI
    (``data/io.py::write_avi``; the JAX package writes MJPG through cv2).
"""

import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..models import decomp_common as dc
from ..models.ref_nfr import ref_fast_render
from ..models.vq_nfr import vq_fast_embed, vq_fast_render
from ..utils.device import check_model_device
from ..utils.vis import vis_view
from .gen_geo import check_finished

__all__ = ["MODES", "render_video", "compose_video", "extract_trajectory"]

MODES = ("recon", "relight", "edit", "vq_dcomps", "gen_comps")


@torch.inference_mode()
def render_video(mode, cfg: dc.DecompConfig, views, outroot, ref_model=None,
                 vq_model=None, n_vq=None, novel_probes=None,
                 probe_names=None, novel_olat=None, olat_names=None,
                 opt_scale=None, edit_material=None, edit_masks=None,
                 dst_env_name=None, rng=None, *, device):
    """Render ``views`` (ShapeViews of a VideoDataset) in ``mode`` into
    <outroot>/batch%09d/; returns the frame directories.

    ref_model / vq_model: a RefNfr / VqNfr on ``device`` (the modes that
    use them). n_vq: keep the first n_vq codes in the embeddings. Probes,
    OLATs, opt_scale and edit masks are arrays or tensors. rng: a
    torch.Generator on ``device`` for the code dropout (its roll decides
    nothing, since the thresholds are 0 or 1)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    device = torch.device(device)
    for model in (ref_model, vq_model):
        if model is not None:
            check_model_device(model, device, "render_video")

    def to_dev(x):
        return None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=device)

    lxyz, lareas = dc.light_constants(cfg, device)
    probes, olats, scale = (to_dev(novel_probes), to_dev(novel_olat),
                            to_dev(opt_scale))
    thres = None
    if n_vq is not None:
        thres = to_dev([0.0] * n_vq + [1.0] * (cfg.num_embed - n_vq))
    if rng is None:
        rng = torch.Generator(device=device).manual_seed(0)
    dst_env = None
    if mode == "edit" and dst_env_name not in (None, "original"):
        dst_env = probes[probe_names.index(dst_env_name)]

    outdirs = []
    for i, view in enumerate(views):
        b = {k: to_dev(v) for k, v in view.as_batch().items()}
        b_vq = {k: v for k, v in b.items() if k != "ref"}
        outdir = join(outroot, "batch%09d" % i)

        def vis(to_vis, **kw):
            vis_view(to_vis, (view.h, view.w), outdir, view.id,
                     white_bg=cfg.white_bg, mode="render", **kw)

        if mode in ("recon", "gen_comps"):
            pred = ref_fast_render(ref_model, b, cfg, lxyz, lareas)
            vis({"pred_rgb": pred["rgb"], "gt_alpha": b["alpha"],
                 "pred_alpha": pred["alpha"]})
        if mode == "relight":
            pred = vq_fast_render(vq_model, b_vq, cfg, lxyz, lareas,
                                  novel_probes=probes, novel_olat=olats,
                                  opt_scale=scale)
            vis({"pred_rgb_probes": pred["rgb_probes"],
                 "gt_alpha": b["alpha"], "pred_alpha": pred["alpha"]},
                probe_names=probe_names, olat_names=olat_names)
        elif mode == "edit":
            pred = vq_fast_render(vq_model, b_vq, cfg, lxyz, lareas,
                                  opt_scale=scale,
                                  edit_mask=to_dev(edit_masks[i]),
                                  edit_material=edit_material,
                                  dst_env=dst_env)
            vis({"pred_" + k: v for k, v in pred.items()}
                | {"gt_alpha": b["alpha"]})
        elif mode == "vq_dcomps":
            pred = vq_fast_render(vq_model, b_vq, cfg, lxyz, lareas,
                                  gen_embed=True, thres=thres, rng=rng)
            vis({"pred_" + k: v for k, v in pred.items()}
                | {"gt_alpha": b["alpha"]})
        elif mode == "gen_comps":
            emb = vq_fast_embed(vq_model, b_vq, cfg, thres=thres, rng=rng)
            vis({"pred_embed": emb["embed"], "gt_alpha": b["alpha"],
                 "pred_alpha": emb["alpha"]})
        outdirs.append(outdir)
    return outdirs


def compose_video(frame_dirs, img_name, out_path, fps=24, alpha_name=None,
                  white_bg=True):
    """Stitch each frame directory's ``img_name`` into an AVI at
    ``out_path``, composited onto white (or black) through ``alpha_name``
    where given; frames without the image are skipped. Returns the number
    of frames written."""
    frames = []
    for d in frame_dirs:
        img_path = join(d, img_name)
        if not os.path.exists(img_path):
            continue
        img = vio.load_img_f32(img_path)[..., :3]
        if alpha_name is not None:
            ap = join(d, alpha_name)
            if os.path.exists(ap):
                a = vio.load_img_f32(ap)
                if a.ndim == 3:
                    a = a[..., 0]
                bg = np.ones_like(img) if white_bg else np.zeros_like(img)
                img = vio.alpha_blend(img, a, bg)
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    if not frames:
        raise FileNotFoundError(f"no {img_name} frames in {frame_dirs}")
    return vio.write_avi(out_path, frames, fps=fps)


def extract_trajectory(extractor, traj_dataset, out_root, no_vis=False,
                       resume=True):
    """Geometry buffers of every frame of ``traj_dataset`` (a
    TrajectoryDataset or DtuTrajectoryDataset) through ``extractor`` (a
    GeoExtractor on it) into <out_root>/test_NNN/ with the frame's
    metadata.json; finished frames are skipped when ``resume``. Returns
    the frame directories."""
    done = []
    for idx in range(traj_dataset.n_images):
        view_dir = join(out_root, "test_%03d" % idx)
        if resume and check_finished(view_dir, with_lvis=not no_vis):
            done.append(view_dir)
            continue
        surf, normal, mask = extractor.compute_geo(
            idx, view_dir, alpha_thres=0.5)
        if not no_vis:
            extractor.compute_vis(view_dir, surf, normal, mask)
        vio.write_json(traj_dataset.frame_metadata(idx),
                       join(view_dir, "metadata.json"))
        done.append(view_dir)
    return done
