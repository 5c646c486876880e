"""Epoch-level training loops of stage 2's three phases (counterpart of
train_nfr_unit / train_vq_nfr / train_ref_nfr in
vqnerf_release_tpu/train/loop.py).

  * ``train_nfr_unit``: per epoch one step per train view (one view = one
    jitter-pair batch), a checkpoint and a validation every
    ``cfg_ckpt_period`` epochs, per-view renders, the metas rollup.
  * ``train_vq_nfr``: the latent k-means init of the codebook, a fixed VQ
    evaluation set, and per validation the codebook-dropout sweep with the
    elbow selection that names the ``main_<k>`` directory, loss.json,
    vq_test_loss.json and vq_num.png.
  * ``train_ref_nfr``: the residual model on top of a trained vq_nfr and
    its converged light (vq_nfr's ``vis_vali/np_light.npy``), on views
    loaded with ``with_ref=True``; per validation the full-view renders.

All three run on ``device`` ("cuda" unless the caller says otherwise) and raise
when it is not there. Ray sampling stays on the host in numpy under a
seeded ``RandomState``, the stream the JAX package's tests pin; the code
dropout draws from a seeded ``torch.Generator`` on the device. A step never
waits for the device: losses stay there until the epoch ends. The JAX
package's scanned-epoch dispatch has no counterpart here; its config fields
are ignored with a notice.

A checkpoint also holds the states of both random streams, so that a
resumed run continues the uninterrupted run's stream of batches.
"""

import copy
import json
import os
import time
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..data.device_store import (DeviceViewStore, fits_device_memory,
                                 views_compatible)
from ..data.sampler import build_vq_eval_set, outer_sample, sample_pix
from ..eval.metrics import lpips_impl
from ..models import decomp_common as dc
from ..models.nfr_unit import init_nfr_unit, nfr_unit_forward
from ..models.ref_nfr import init_ref_nfr, ref_nfr_forward
from ..models.vq_nfr import init_vq_nfr, vq_nfr_forward, vq_test
from ..ops.colorspace import linear2srgb, srgb2linear
from ..ops.kmeans import kmeans
from ..ops.math import rgb2chromaticity
from ..ops.vq import VqEmaState, init_vq_ema_state
from ..utils import ckpt as ckpt_util
from ..utils.device import resolve_device
from ..utils.html import write_vali_index
from ..utils.vis import vis_view
from . import decomp_trainer as dt

__all__ = ["train_nfr_unit", "train_vq_nfr", "train_ref_nfr", "save_metas",
           "elbow_select", "cfg_ckpt_period", "phase_model"]

# Full-view validation forwards pass the WHOLE view (background rows too)
# through the model; at 512 lights the [N, L, 3] BRDF temporaries of a
# 262,144-ray view do not fit beside the staged views. The forwards are per
# ray, so chunking is exact for nfr_unit. For vq_nfr the dropout fill is the
# largest distance of each chunk, so the chunk is the JAX package's.
_VALI_RAY_CHUNK = 131072
# rows per BRDF/render chunk of the drop-loss sweep (its VQ lookup is one
# call over the whole evaluation set)
_VQ_TEST_RENDER_CHUNK = 65536


def _notice_ignored(cfg):
    set_fields = [name for name, default in (
        ("epoch_scan", None), ("epoch_scan_chunk", None),
        ("device_sampling", False)) if getattr(cfg, name) != default]
    if set_fields:
        print("[vqnerf-torch] %s: the scanned-epoch dispatch is not part of "
              "this package; training dispatches step by step"
              % ", ".join(set_fields))


def _device_batch(batch, device):
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items()}


def _make_batch_source(train_views, cfg, jitter_mode, device):
    """(epoch_batches, store). cfg.device_views: 'auto' stages the views on
    the device when they are of one shape and fit its memory budget, 'on'
    forces that, 'off' gathers every batch on the host and copies it over.
    The batches are equal bit for bit either way; store is None on the host
    path."""
    mode = cfg.device_views or "off"
    if mode not in ("auto", "on", "off"):
        raise ValueError("device_views must be 'auto', 'on' or 'off', got "
                         "%r (the 'u8' and 'shard' layouts are not part of "
                         "this package)" % mode)
    store = None
    if train_views and mode == "on":
        store = DeviceViewStore(train_views, device)
    elif train_views and mode == "auto":
        if not views_compatible(train_views):
            print("[vqnerf-torch] device_views=auto: heterogeneous views; "
                  "using the host-gather path")
        elif fits_device_memory(train_views, device):
            store = DeviceViewStore(train_views, device)
        else:
            print("[vqnerf-torch] device_views=auto: views exceed the "
                  "device-memory budget; using the host-gather path")

    def epoch_batches(rng):
        for vi, view in enumerate(train_views):
            if store is not None:
                yield store.gather(vi, sample_pix(
                    view, cfg.n_rays_per_step, rng, jitter_mode=jitter_mode))
            else:
                yield _device_batch(outer_sample(
                    view, cfg.n_rays_per_step, rng, jitter_mode=jitter_mode),
                    device)

    return epoch_batches, store


def _epoch_dir(outdir, epoch):
    return join(outdir, "vis_vali", "epoch%09d" % epoch)


def _log_scalars(outdir, epoch, scalars):
    """Append an epoch's scalars to train_log.jsonl."""
    os.makedirs(outdir, exist_ok=True)
    with open(join(outdir, "train_log.jsonl"), "a") as f:
        f.write(json.dumps({"epoch": epoch, **scalars}) + "\n")


def _sync_scalar_dicts(dicts):
    """A list of {name: 0-dim tensor} -> a list of {name: float}, with one
    copy from the device for the whole epoch."""
    if not dicts:
        return []
    keys = sorted(dicts[0])
    mat = torch.stack([torch.stack([d[k].to(torch.float32) for k in keys])
                       for d in dicts]).cpu().numpy().astype(np.float64)
    return [{k: float(mat[j, i]) for i, k in enumerate(keys)}
            for j in range(mat.shape[0])]


def _finite_mean(vals):
    """Mean over the healthy steps only: a step skipped by the non-finite
    guard carries a NaN loss but changed nothing. Returns (mean, n_skipped);
    the mean is NaN iff EVERY step was skipped."""
    arr = np.asarray(vals, np.float64)
    finite = np.isfinite(arr)
    mean = float(arr[finite].mean()) if finite.any() else float("nan")
    return mean, int((~finite).sum())


def _check_finite(outdir, phase, epoch, scalars, state):
    """Divergence guard: on a non-finite epoch loss, checkpoint the failing
    state under <outdir>/debug_failure/ and raise with context."""
    bad = {k: v for k, v in scalars.items()
           if not np.isfinite(np.asarray(v)).all()}
    if not bad:
        return
    dump = join(outdir, "debug_failure")
    ckpt_util.save_ckpt(dump, epoch, state)
    _log_scalars(dump, epoch, {"phase": phase, "non_finite": sorted(bad)})
    raise RuntimeError(
        f"{phase}: non-finite training loss at epoch {epoch}: {bad}; the "
        f"failing state is checkpointed under {dump}. Resume from the last "
        f"good checkpoint in {outdir} after lowering the LR or inspecting "
        "the data")


def save_metas(outdir):
    """Roll the per-epoch metadata.json metrics up into metas.json."""
    vali_root = join(outdir, "vis_vali")
    metrics = {k: [] for k in
               ("psnr", "ssim", "lpips", "psnr_luma", "ssim_luma", "mse")}
    if not os.path.isdir(vali_root):
        return metrics
    for e_dir in sorted(os.listdir(vali_root)):
        if not e_dir.startswith("epoch"):
            continue
        epoch_vals = {k: [] for k in metrics}
        for root, _, files in os.walk(join(vali_root, e_dir)):
            if "metadata.json" in files:
                for k, v in vio.read_json(join(root, "metadata.json")).items():
                    if k in epoch_vals:
                        epoch_vals[k].append(v)
        for k in metrics:
            metrics[k].append(
                float(np.mean(epoch_vals[k])) if epoch_vals[k] else None)
    metrics["lpips_impl"] = lpips_impl()
    with open(join(vali_root, "metas.json"), "w") as f:
        json.dump(metrics, f)
    return metrics


def elbow_select(drop_losses, best_thres):
    """The reference's elbow rule: the first i whose loss improves on i-1
    and is within best_thres of every later loss; else the last (all
    codes)."""
    n = len(drop_losses)
    for i in range(1, n - 1):
        if drop_losses[i - 1] > drop_losses[i]:
            if all(drop_losses[i] - drop_losses[j] <= best_thres
                   for j in range(i + 1, n)):
                return i
    return n - 1


def cfg_ckpt_period(cfg):
    return 30 if cfg.epochs >= 30 else max(1, cfg.epochs // 2)


def _forward_chunked(forward, batch, chunk=None):
    """Run a per-ray validation forward in ray chunks and concatenate the
    pred dicts on the host; ``forward(chunk_batch) -> pred`` with every
    entry [N, ...] aligned with the batch rows. Returns numpy arrays."""
    chunk = chunk or _VALI_RAY_CHUNK
    n = next(iter(batch.values())).shape[0]
    preds = [{k: v.cpu().numpy() for k, v in forward(
        {k: v[i:i + chunk] for k, v in batch.items()}).items()}
        for i in range(0, n, chunk)]
    if len(preds) == 1:
        return preds[0]
    return {k: np.concatenate([p[k] for p in preds]) for k in preds[0]}


def _rng_state(rng, gen=None):
    state = {"numpy": rng.get_state()}
    if gen is not None:
        state["torch"] = gen.get_state()
    return state


def _restore_rng(state, rng, gen=None):
    if not state:
        return
    rng.set_state(state["numpy"])
    if gen is not None and "torch" in state:
        gen.set_state(state["torch"])


def _keep(cfg):
    return cfg.keep_recent_epochs if cfg.keep_recent_epochs > 0 else None


def phase_model(cfg: dc.DecompConfig, kind, vq=None, light=None):
    """The blank model of a phase ("nfr_unit", "vq_nfr" or "ref_nfr") as
    its trainer builds it, on the CPU, to ``load_state_dict`` a checkpoint
    into: its parameters are in the order that the checkpoint's optimizer
    state follows. A RefNfr is built on ``vq`` (a VqNfr; a blank one when
    None) and ``light`` [Lh, Lw, 3] (zeros when None)."""
    gen = torch.Generator().manual_seed(cfg.random_seed)
    if kind == "nfr_unit":
        return init_nfr_unit(gen, cfg)
    if kind == "vq_nfr":
        centers = np.zeros((cfg.num_embed, cfg.z_dim), np.float32)
        return init_vq_nfr(gen, cfg, init_nfr_unit(gen, cfg), centers)[0]
    if kind == "ref_nfr":
        if vq is None:
            vq = phase_model(cfg, "vq_nfr")
        if light is None:
            light = np.zeros(cfg.light_res + (3,), np.float32)
        return init_ref_nfr(gen, cfg, vq, torch.as_tensor(light).cpu())
    raise ValueError(f"unknown phase {kind!r}")


def train_nfr_unit(cfg: dc.DecompConfig, train_views, vali_views, outdir,
                   epochs=None, seed=None, jitter_mode="contrast",
                   resume=True, device="cuda"):
    """Phase 1: train the warm-up model. Returns (model, history), the
    model on ``device`` and the history the mean loss of each epoch."""
    device = resolve_device(device)
    _notice_ignored(cfg)
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)
    model = init_nfr_unit(torch.Generator().manual_seed(seed), cfg).to(device)
    opt, step_fn = dt.make_nfr_unit_step(model, cfg, lxyz, lareas)
    start_epoch = 0

    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng)

    def state_dict(epoch):
        return {"params": model.state_dict(), "opt_state": opt.state,
                "epoch": epoch, "rng": _rng_state(rng)}

    step = start_epoch * max(len(train_views), 1)
    history = []
    period = cfg_ckpt_period(cfg)
    if start_epoch < epochs:  # don't stage the store for a no-op resume
        epoch_batches, _ = _make_batch_source(train_views, cfg, jitter_mode,
                                              device)
    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        losses = []
        for batch in epoch_batches(rng):
            losses.append(step_fn(batch, step))  # stays on the device
            step += 1
        losses = [d["loss"] for d in _sync_scalar_dicts(losses)]
        e1 = epoch + 1
        mean_loss, n_skipped = _finite_mean(losses)
        history.append(mean_loss)
        # the fetch above waits for the device, so wall_s is the whole epoch
        _log_scalars(outdir, e1, {"loss_train": mean_loss,
                                  "skipped_steps": n_skipped,
                                  "wall_s": round(time.time() - t_epoch, 4)})
        _check_finite(outdir, "nfr_unit", e1, {"loss_train": mean_loss},
                      state_dict(e1))
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1), keep=_keep(cfg))
            _nfr_vali(model, cfg, lxyz, lareas, vali_views,
                      _epoch_dir(outdir, e1), outdir, device)
    save_metas(outdir)
    return model, history


@torch.inference_mode()
def _nfr_vali(model, cfg, lxyz, lareas, vali_views, epoch_dir, outdir,
              device):
    os.makedirs(epoch_dir, exist_ok=True)
    light = dc.get_light(model).cpu().numpy()
    np.save(join(os.path.dirname(epoch_dir), "np_light.npy"), light)
    vio.vis_light(light, outpath=join(os.path.dirname(epoch_dir),
                                      "pred_light.png"), h=256)

    def forward(b):
        pred = nfr_unit_forward(model, b, cfg, lxyz, lareas, mode="vali")[0]
        del pred["z"]  # [N, z_dim], not written
        return pred

    for b_i, view in enumerate(vali_views):
        pred = _forward_chunked(forward,
                                _device_batch(view.as_batch(), device))
        vis = {"pred_" + k: v for k, v in pred.items()}
        vis["gt_rgb"] = view.rgb
        vis["gt_alpha"] = view.alpha
        vis_view(vis, (view.h, view.w), join(epoch_dir, "batch%09d" % b_i),
                 view.id, white_bg=cfg.white_bg, mode="vali")
    write_vali_index(outdir, white_bg=cfg.white_bg)


def _init_centers(cfg, nfr_model, train_views, rng, seed, device):
    """k-means centres [K, z_dim] of the warm-up model's latents over one
    random-jitter batch per train view (foreground rows)."""
    nfr_model = copy.deepcopy(nfr_model).to(device)
    zs = []
    with torch.inference_mode():
        for view in train_views:
            batch = outer_sample(view, cfg.n_rays_per_step, rng,
                                 jitter_mode="random")
            mask = batch["alpha"][:, 0] > 0
            xyz = torch.as_tensor(batch["xyz"][mask], device=device)
            zs.append(dc.apply_encoder(nfr_model, xyz, cfg))
        _, centers = kmeans(torch.cat(zs), cfg.num_embed, seed=seed)
    return centers.cpu().numpy()


def train_vq_nfr(cfg: dc.DecompConfig, nfr_model, train_views, vali_views,
                 outdir, epochs=None, seed=None, cluster_path=None,
                 resume=True, device="cuda"):
    """Phase 2: train the VQ model from a trained warm-up model. Returns
    (model, ema_state, history), model and state on ``device``."""
    device = resolve_device(device)
    _notice_ignored(cfg)
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)

    # epoch 0: the codebook starts at the k-means centres of the latents
    if cluster_path is None:
        cluster_path = join(outdir, "cluster_centers.npy")
    if os.path.exists(cluster_path):
        centers = np.load(cluster_path)
    else:
        centers = _init_centers(cfg, nfr_model, train_views, rng, seed,
                                device)
        os.makedirs(os.path.dirname(cluster_path) or ".", exist_ok=True)
        np.save(cluster_path, centers)

    model, ema_state = init_vq_nfr(torch.Generator().manual_seed(seed), cfg,
                                   nfr_model, centers)
    model = model.to(device)
    ema_state = VqEmaState(*(t.to(device) for t in ema_state))
    opt, step_fn = dt.make_vq_nfr_step(model, cfg, lxyz, lareas)

    # the fixed VQ evaluation set of the drop-loss sweep
    per_view = max(1, cfg.total_sample_vq // max(len(train_views), 1))
    vq_eval = _device_batch(build_vq_eval_set(
        train_views, per_view, cfg.n_rays_per_step, rng), device)

    gen = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            ema_state = VqEmaState(*(t.to(device) for t in state["ema"]))
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng, gen)

    def state_dict(epoch):
        return {"params": model.state_dict(), "ema": ema_state,
                "opt_state": opt.state, "epoch": epoch,
                "rng": _rng_state(rng, gen)}

    train_thres = torch.as_tensor(cfg.train_thres(), device=device)
    val_thres_list = cfg.val_thres_list()
    x_list = list(range(cfg.num_embed - cfg.num_drop, cfg.num_embed + 1))

    step = start_epoch * max(len(train_views), 1)
    history = []
    period = cfg_ckpt_period(cfg)
    if start_epoch < epochs:  # don't stage the store for a no-op resume
        epoch_batches, _ = _make_batch_source(train_views, cfg, "random",
                                              device)
    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        loss_dicts = []
        for batch in epoch_batches(rng):
            ema_state, ld = step_fn(ema_state, batch, train_thres, gen, step)
            loss_dicts.append(ld)  # stays on the device
            step += 1
        loss_dicts = _sync_scalar_dicts(loss_dicts)
        e1 = epoch + 1
        mean_loss, n_skipped = _finite_mean([d["loss"] for d in loss_dicts])
        history.append(mean_loss)
        _log_scalars(outdir, e1, {
            **{k: _finite_mean([d[k] for d in loss_dicts])[0]
               for k in loss_dicts[0]},
            "skipped_steps": n_skipped,
            "wall_s": round(time.time() - t_epoch, 4)})
        _check_finite(outdir, "vq_nfr", e1, {"loss": mean_loss},
                      state_dict(e1))
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1), keep=_keep(cfg))
            _vq_vali(model, cfg, lxyz, lareas, vali_views, vq_eval,
                     val_thres_list, x_list, loss_dicts,
                     _epoch_dir(outdir, e1), seed, device)
    save_metas(outdir)
    return model, ema_state, history


@torch.inference_mode()
def _vq_vali(model, cfg, lxyz, lareas, vali_views, vq_eval, val_thres_list,
             x_list, loss_dicts, epoch_dir, seed, device):
    os.makedirs(epoch_dir, exist_ok=True)
    # loss.json: the epoch's loss terms summed over its batches
    losses = {}
    for d in loss_dicts:
        for k, v in d.items():
            losses[k] = losses.get(k, 0.0) + v
    with open(join(epoch_dir, "loss.json"), "w") as f:
        json.dump(losses, f)

    # the light, which ref_nfr's init reads
    np.save(join(os.path.dirname(epoch_dir), "np_light.npy"),
            dc.get_light(model).cpu().numpy())

    # the dropout sweep on the fixed evaluation set
    gen = torch.Generator(device=device).manual_seed(seed)
    vq_scores = {"vqrgb": [], "chromaticity": []}
    for thres in val_thres_list:
        aux = vq_test(model, vq_eval, cfg, lxyz, lareas,
                      thres=torch.as_tensor(thres, device=device), rng=gen,
                      render_chunk=_VQ_TEST_RENDER_CHUNK)
        mask, gt, vq_rgb = aux["mask"], aux["rgb_gt"], aux["vq_rgb_linear"]
        if cfg.is_nerf:
            linear_gt, vq_srgb = srgb2linear(gt), linear2srgb(vq_rgb)
        else:
            linear_gt, vq_srgb = gt, vq_rgb
        denom = float(torch.clamp(torch.sum(mask), min=1.0))
        vq_scores["vqrgb"].append(float(torch.sum(
            torch.mean((gt - vq_srgb) ** 2, dim=-1) * mask)) / denom)
        vq_scores["chromaticity"].append(float(torch.sum(torch.mean(
            (rgb2chromaticity(linear_gt) - rgb2chromaticity(vq_rgb)) ** 2,
            dim=-1) * mask)) / denom)
    with open(join(epoch_dir, "vq_test_loss.json"), "w") as f:
        json.dump(vq_scores, f)

    drop_losses = np.array(vq_scores["chromaticity"])
    try:  # the elbow plot is optional: matplotlib may be absent
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.clf()
        plt.plot(x_list, drop_losses)
        plt.savefig(join(epoch_dir, "vq_num.png"))
    except Exception:
        pass

    main_vq = elbow_select(list(drop_losses), cfg.best_thres)

    # per-threshold renders into <epoch>/<k or main_k>/batch%09d
    ema0 = init_vq_ema_state(cfg.z_dim, cfg.num_embed, device)
    for i, thres in enumerate(val_thres_list):
        k_codes = cfg.num_embed - cfg.num_drop + i
        sub = ("main_%d" % k_codes) if i == main_vq else str(k_codes)
        thres_t = torch.as_tensor(thres, device=device)
        for b_i, view in enumerate(vali_views):
            # one roll for every chunk of a view: validation-mode dropout
            # masks the CODEBOOK, so the chunks must agree on it
            roll = torch.rand((1, cfg.num_embed), generator=gen,
                              device=device)
            pred = _forward_chunked(
                lambda b: vq_nfr_forward(
                    model, ema0, b, cfg, lxyz, lareas, mode="vali",
                    thres=thres_t, roll=roll)[0],
                _device_batch(view.as_batch(), device))
            vis = {"pred_" + k: v for k, v in pred.items()}
            vis["gt_rgb"] = view.rgb
            vis["gt_alpha"] = view.alpha
            vis_view(vis, (view.h, view.w),
                     join(epoch_dir, sub, "batch%09d" % b_i), view.id,
                     white_bg=cfg.white_bg, mode="vali")
    write_vali_index(os.path.dirname(os.path.dirname(epoch_dir)),
                     white_bg=cfg.white_bg)
    return main_vq


def train_ref_nfr(cfg: dc.DecompConfig, vq_model, light, train_views,
                  vali_views, outdir, epochs=None, seed=None, resume=True,
                  device="cuda"):
    """Phase 3: train the residual model on top of a trained VqNfr (not
    modified) and its converged light [Lh, Lw, 3]. The views must be loaded
    with ``with_ref=True``. Returns (model, history), the model on
    ``device``."""
    device = resolve_device(device)
    _notice_ignored(cfg)
    if any(v.ref is None for v in list(train_views) + list(vali_views)):
        raise ValueError("train_ref_nfr needs views loaded with "
                         "with_ref=True (the reference RGB buffer)")
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)
    model = init_ref_nfr(torch.Generator().manual_seed(seed), cfg,
                         vq_model, torch.as_tensor(light).detach().cpu()
                         ).to(device)
    opt, step_fn = dt.make_ref_nfr_step(model, cfg, lxyz, lareas)
    start_epoch = 0

    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng)

    def state_dict(epoch):
        return {"params": model.state_dict(), "opt_state": opt.state,
                "epoch": epoch, "rng": _rng_state(rng)}

    step = start_epoch * max(len(train_views), 1)
    history = []
    period = cfg_ckpt_period(cfg)
    if start_epoch < epochs:  # don't stage the store for a no-op resume
        epoch_batches, _ = _make_batch_source(train_views, cfg, "contrast",
                                              device)
    for epoch in range(start_epoch, epochs):
        t_epoch = time.time()
        losses = []
        for batch in epoch_batches(rng):
            losses.append(step_fn(batch, step))  # stays on the device
            step += 1
        losses = [d["loss"] for d in _sync_scalar_dicts(losses)]
        e1 = epoch + 1
        mean_loss, n_skipped = _finite_mean(losses)
        history.append(mean_loss)
        _log_scalars(outdir, e1, {"loss_train": mean_loss,
                                  "skipped_steps": n_skipped,
                                  "wall_s": round(time.time() - t_epoch, 4)})
        _check_finite(outdir, "ref_nfr", e1, {"loss_train": mean_loss},
                      state_dict(e1))
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1), keep=_keep(cfg))
            _ref_vali(model, cfg, lxyz, lareas, vali_views,
                      _epoch_dir(outdir, e1), outdir, device)
    save_metas(outdir)
    return model, history


@torch.inference_mode()
def _ref_vali(model, cfg, lxyz, lareas, vali_views, epoch_dir, outdir,
              device):
    for b_i, view in enumerate(vali_views):
        pred = _forward_chunked(
            lambda b: ref_nfr_forward(model, b, cfg, lxyz, lareas,
                                      mode="vali")[0],
            _device_batch(view.as_batch(), device))
        vis = {"pred_" + k: v for k, v in pred.items()}
        vis["gt_rgb"] = view.rgb
        vis["gt_alpha"] = view.alpha
        vis_view(vis, (view.h, view.w), join(epoch_dir, "batch%09d" % b_i),
                 view.id, white_bg=cfg.white_bg, mode="vali")
    write_vali_index(outdir, white_bg=cfg.white_bg)
