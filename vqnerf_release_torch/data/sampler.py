"""Jitter-pair ray sampling for decomposition training (the port's own copy
of vqnerf_release_tpu/data/sampler.py, numpy only; tests hold the two bit
for bit under the same RandomState).

For each interior foreground pixel, pick one 8-neighbourhood jitter (the
neighbour of largest RGB contrast for nfr_unit/ref_nfr, uniform-random for
vq_nfr), keep pixels where BOTH alphas > 0.9, draw n_rays pixels with
replacement, and emit interleaved [p1, p1_jit, p2, p2_jit, ...] rays (a
batch of 2 * n_rays). Sampling runs on the host; only the flat pixel indices
go to the device when the views are staged there (data/device_store.py).
"""

import numpy as np

__all__ = ["outer_sample", "sample_pix", "build_vq_eval_set"]

_JITTERS = np.array(
    [[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 1], [1, -1], [1, 0], [1, 1]],
    np.int64)


def _view_images(view):
    keys = ["rayo", "rayd", "rgb", "alpha", "pred_alpha", "xyz", "normal"]
    if view.lvis is not None:
        keys.append("lvis")
    if view.ref is not None:
        keys.append("ref")
    h, w = view.h, view.w
    return {k: getattr(view, k).reshape(h, w, -1) for k in keys}


def sample_pix(view, n_rays, rng, jitter_mode="random", alpha_thres=0.9):
    """Sample n_rays (pixel, jitter) pairs -> [2*n_rays] flat pixel
    indices (interleaved [p1, p1_jit, p2, p2_jit, ...]).

    jitter_mode: 'random' (train_nfr.py:415-417) or 'contrast'
    (trainvali.py:361 — neighbor with max channel-max |rgb delta|).

    This is outer_sample's index-selection half, split out so the
    device-resident path (data.device_store.DeviceViewStore) can gather
    on device from the SAME indices: the rng consumption order is
    identical to outer_sample's, so host-gathered and device-gathered
    batches match bit for bit."""
    h, w = view.h, view.w
    alpha = view.alpha.reshape(h, w, -1)[..., 0]
    rgb = view.rgb.reshape(h, w, 3)

    ys, xs = np.meshgrid(
        np.arange(1, h - 1), np.arange(1, w - 1), indexing="ij")
    coords = np.stack([ys, xs], axis=-1)  # [h-2, w-2, 2]

    if jitter_mode == "contrast":
        deltas = np.empty((8, h - 2, w - 2), np.float32)
        center = rgb[1:-1, 1:-1]
        for j, (dy, dx) in enumerate(_JITTERS):
            nb = rgb[1 + dy : h - 1 + dy, 1 + dx : w - 1 + dx]
            deltas[j] = np.max(np.abs(nb - center), axis=-1)
        jitter_inds = np.argmax(deltas, axis=0)
    else:
        jitter_inds = rng.randint(0, 8, size=(h - 2, w - 2))
    coords_jitter = coords + _JITTERS[jitter_inds]

    a_c = alpha[coords[..., 0], coords[..., 1]]
    a_j = alpha[coords_jitter[..., 0], coords_jitter[..., 1]]
    keep = (a_c > alpha_thres) & (a_j > alpha_thres)
    coords = coords[keep]
    coords_jitter = coords_jitter[keep]
    if coords.shape[0] == 0:
        raise ValueError("View has no foreground pixels above threshold")

    sel = rng.randint(0, coords.shape[0], size=(n_rays,))
    # interleave [p, p_jit, p, p_jit, ...]
    pix = np.empty((2 * n_rays, 2), np.int64)
    pix[0::2] = coords[sel]
    pix[1::2] = coords_jitter[sel]
    return pix[:, 0] * w + pix[:, 1]


def outer_sample(view, n_rays, rng, jitter_mode="random", alpha_thres=0.9):
    """Sample n_rays (pixel, jitter) pairs -> batch dict of [2*n_rays, ...]
    (sample_pix indices host-gathered from the view buffers)."""
    flat = sample_pix(view, n_rays, rng, jitter_mode=jitter_mode,
                      alpha_thres=alpha_thres)
    imgs = _view_images(view)
    h, w = view.h, view.w
    batch = {}
    for k, img in imgs.items():
        batch[k] = img.reshape(h * w, -1)[flat].astype(np.float32)
    return batch


def build_vq_eval_set(views, per_view_n, n_rays, rng, data_type="nerf"):
    """The fixed VQ drop-loss evaluation set (train_nfr.py:513-554):
    per view, outer_sample then draw per_view_n FOREGROUND rays with
    replacement; concatenate across views."""
    parts = []
    for view in views:
        batch = outer_sample(view, n_rays, rng, jitter_mode="random")
        mask = batch["alpha"][:, 0] > 0
        idx = np.nonzero(mask)[0]
        sel = idx[rng.randint(0, idx.shape[0], size=(per_view_n,))]
        parts.append({k: v[sel] for k, v in batch.items()})
    return {
        k: np.concatenate([p[k] for p in parts], axis=0)
        for k in parts[0]
    }
