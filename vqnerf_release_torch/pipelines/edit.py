"""Material editing: the edit server and its headless render (counterpart
of vqnerf_release_tpu/pipelines/edit.py).

The server polls <root>/status/status.json. On status "uploaded" it sets
"running", reads edited/dst.json (the material: diff/spec/rough lists, a
negative first channel meaning keep), edited/illum.json ({"env":
"original" | a probe's name}) and one mask a view, edited/batch%09d.npy,
renders every view with the edit into pd_edited/batch%09d/ and sets
"finished". The files are the JAX server's, byte for byte in their JSON,
so that either package's client drives either server.

Each view renders in one call. Without a probe the raw reconstruction
comes from ref_fast_render and the maps from vq_fast_render; with a probe
as ``dst_env`` vq_fast_render relights the edited scene. Both take the
fused render kernel on the GPU.
"""

import json
import time
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..models import decomp_common as dc
from ..models.ref_nfr import ref_fast_render
from ..models.vq_nfr import vq_fast_render
from ..utils.device import check_model_device
from ..utils.vis import vis_view

__all__ = ["apply_edit", "edit_server_loop", "read_status"]


def _load_edit_mask(path, n_rays):
    """A mask .npy ([H, W] or [H, W, C], any dtype; nonzero = edit) ->
    float32 [n_rays, 1]."""
    m = np.load(path)
    m = np.where(m, 1.0, 0.0).astype(np.float32)
    if m.ndim == 3:
        m = m.reshape(-1, m.shape[-1])[:, :1]
    else:
        m = m.reshape(-1, 1)
    if m.shape[0] != n_rays:
        raise ValueError(f"{path}: {m.shape[0]} mask pixels for a view of "
                         f"{n_rays} rays")
    return m


@torch.inference_mode()
def apply_edit(ref_model, vq_model, cfg: dc.DecompConfig, views,
               edit_material, edit_masks, outroot, dst_env_name=None,
               novel_probes=None, probe_names=None, opt_scale=None, *,
               device):
    """Render every view with ``edit_material`` inside its mask into
    <outroot>/batch%09d/ (one "uploaded" round of the server); returns the
    directories.

    edit_material: {"diff": [3], "spec": [3], "rough": [1]}, a negative
    first element keeping that map. edit_masks: one [N, 1] array a view.
    dst_env_name: None or "original" keeps the learned light; else the
    probe of that name in ``probe_names`` / ``novel_probes`` ([E, L, 3])
    lights the edited scene. Models on ``device``."""
    device = torch.device(device)
    check_model_device(ref_model, device, "apply_edit")
    check_model_device(vq_model, device, "apply_edit")

    def to_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    lxyz, lareas = dc.light_constants(cfg, device)
    scale = None if opt_scale is None else to_dev(opt_scale)
    dst_env = None
    if dst_env_name not in (None, "original"):
        dst_env = to_dev(novel_probes[probe_names.index(dst_env_name)])

    outs = []
    for i, view in enumerate(views):
        b = {k: to_dev(v) for k, v in view.as_batch().items()}
        b_vq = {k: x for k, x in b.items() if k != "ref"}
        em = to_dev(edit_masks[i])
        outdir = join(outroot, "batch%09d" % i)

        def vis(to_vis):
            vis_view(to_vis, (view.h, view.w), outdir, view.id,
                     white_bg=cfg.white_bg, mode="test")

        if dst_env is None:
            pred_ref = ref_fast_render(
                ref_model, b, cfg, lxyz, lareas, opt_scale=scale,
                edit_mask=em, edit_material=edit_material)
            vis({"pred_rgb": pred_ref["rgb"], "gt_alpha": b["alpha"],
                 "pred_alpha": pred_ref["alpha"]})
            pred_vq = vq_fast_render(
                vq_model, b_vq, cfg, lxyz, lareas, opt_scale=scale,
                edit_mask=em, edit_material=edit_material)
            vis({"pred_" + k: x for k, x in pred_vq.items() if k != "rgb"})
        else:
            pred_vq = vq_fast_render(
                vq_model, b_vq, cfg, lxyz, lareas, opt_scale=scale,
                edit_mask=em, edit_material=edit_material, dst_env=dst_env)
            vis({"pred_" + k: x for k, x in pred_vq.items()})
        outs.append(outdir)
    return outs


def read_status(path):
    """The status dict at ``path``; None while the file is missing or
    half written (the other side writes it in place)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def edit_server_loop(ref_model, vq_model, cfg, views, root,
                     novel_probes=None, probe_names=None, opt_scale=None,
                     poll_interval=1.0, max_rounds=None, *, device):
    """Poll <root>/status/status.json and serve each uploaded edit with
    ``apply_edit``; returns the number of rounds served after
    ``max_rounds`` (None: forever)."""
    status_path = join(root, "status", "status.json")
    update_dir = join(root, "edited")
    outroot = join(root, "pd_edited")
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        time.sleep(poll_interval)
        status = read_status(status_path)
        if status is None or status.get("status") != "uploaded":
            continue
        status["status"] = "running"
        vio.write_json(status, status_path)

        dst = vio.read_json(join(update_dir, "dst.json"))
        illum = vio.read_json(join(update_dir, "illum.json"))
        masks = [
            _load_edit_mask(join(update_dir, "batch%09d.npy" % i), v.h * v.w)
            for i, v in enumerate(views)
        ]
        apply_edit(ref_model, vq_model, cfg, views, dst, masks, outroot,
                   dst_env_name=illum.get("env"), novel_probes=novel_probes,
                   probe_names=probe_names, opt_scale=opt_scale,
                   device=device)

        status["status"] = "finished"
        vio.write_json(status, status_path)
        rounds += 1
    return rounds
