"""Mean-shift clustering segmentation baseline (counterpart of
vqnerf_release_tpu/eval/meanshift.py), without sklearn: per-pixel
(albedo, spec, rough) features of the validation views clustered with a
flat-kernel mean shift, and label maps colored with the embed palette, as
an ablation against the VQ segmentation.

``mean_shift`` does what sklearn's ``MeanShift(bandwidth,
bin_seeding=True).fit`` does (sklearn/cluster/_mean_shift.py):

  * seeds: the points binned to round(x / bandwidth), every bin with a
    point (min_bin_freq 1), times bandwidth; where every point has a bin
    of its own, the points themselves;
  * each seed moves to the mean of the points within bandwidth (squared
    distance <= bandwidth**2) until it moves by at most 1e-3 * bandwidth
    or has moved 300 times; a seed whose ball holds no point stops there
    and is dropped; its intensity is the count of the last ball whose
    mean it took;
  * centres sorted by (intensity, centre) descending, and each one that
    lies within bandwidth of a kept one earlier in that order suppressed;
  * a point's label is its nearest centre, ties to the lower index.

Every seed runs at once, in float64, on ``device``; distances are sums of
squared differences, never the matmul form, which moves radius and
nearest-centre decisions.
"""

import os
from os.path import join

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.vis import vis_embed_map

__all__ = ["bin_seeds", "mean_shift", "nearest_center",
           "meanshift_segmentation"]

_BYTES_PER_CHUNK = 1 << 28  # of [rows, points, features] float64 differences


def bin_seeds(x, bandwidth):
    """sklearn's get_bin_seeds(x, bandwidth, 1) of a numpy array."""
    binned = np.round(x / bandwidth)
    bins = np.unique(binned, axis=0)
    if len(bins) == len(x):
        return x
    return bins.astype(np.float32) * bandwidth


def _sq_dist(a, b):
    """[len(a), len(b)] squared distances, in chunks of rows of a."""
    rows = max(1, _BYTES_PER_CHUNK // (8 * max(1, b.shape[0] * b.shape[1])))
    return torch.cat([((a[i:i + rows, None, :] - b[None]) ** 2).sum(-1)
                      for i in range(0, a.shape[0], rows)])


def nearest_center(x, centers):
    """Index of each row's nearest centre (ties to the lower index)."""
    rows = max(1, _BYTES_PER_CHUNK // (8 * max(1, centers.numel())))
    return torch.cat([_sq_dist(x[i:i + rows], centers).argmin(1)
                      for i in range(0, x.shape[0], rows)])


@torch.no_grad()
def mean_shift(x, bandwidth, max_iter=300, device="cuda"):
    """(centres [K, F] float64 numpy, sorted as sklearn's
    cluster_centers_) of the points ``x`` [N, F]."""
    device = resolve_device(device)
    seeds = bin_seeds(np.asarray(x), bandwidth)
    pts = torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)
    mean = torch.as_tensor(np.asarray(seeds), dtype=torch.float64,
                           device=device)
    r2 = float(bandwidth) ** 2
    stop = 1e-3 * bandwidth
    count = torch.zeros(len(mean), dtype=torch.int64, device=device)
    active = torch.arange(len(mean), device=device)
    for it in range(max_iter + 1):
        if not len(active):
            break
        inside = _sq_dist(mean[active], pts) <= r2
        n = inside.sum(1)
        count[active] = n
        empty = n == 0  # stops where it is, dropped below
        new = (inside.to(torch.float64) @ pts) / n.clamp(min=1)[:, None]
        moved = torch.linalg.vector_norm(new - mean[active], dim=1)
        keep = ~empty
        mean[active[keep]] = new[keep]
        done = empty | (moved <= stop) | (it == max_iter)
        active = active[~done]
    found = (count > 0).cpu().numpy()
    mean = mean.cpu().numpy()[found]
    count = count.cpu().numpy()[found]
    # one entry a centre, as sklearn's {centre: intensity} dict
    centers = {}
    for c, n in zip(map(tuple, mean), count):
        centers[c] = int(n)
    if not centers:
        raise ValueError(f"No point was within bandwidth={bandwidth:f} of "
                         "any seed")
    order = sorted(centers.items(), key=lambda t: (t[1], t[0]), reverse=True)
    ranked = torch.as_tensor(np.array([c for c, _ in order]),
                             dtype=torch.float64, device=device)
    near = (_sq_dist(ranked, ranked) <= r2).cpu().numpy()
    unique = np.ones(len(ranked), bool)
    for i in range(len(ranked)):
        if unique[i]:
            unique[near[i]] = False
            unique[i] = True
    return ranked[torch.as_tensor(unique, device=device)].cpu().numpy()


def meanshift_segmentation(mat_dirs, out_dirs, bandwidth=0.2,
                           alpha_thres=0.0, max_pixels=20000, seed=0,
                           device="cuda"):
    """mat_dirs: per-view dirs holding albedo/spec/rough .npy (gen_z
    export). Fits one mean shift over subsampled fg features of all views
    (the subsample drawn by np.random.RandomState(seed)), then labels each
    view and writes labels.png and labels.npy. Returns (number of
    centres, out_dirs)."""
    device = resolve_device(device)
    feats, metas = [], []
    for d in mat_dirs:
        albedo = np.load(join(d, "albedo.npy"))
        spec = np.load(join(d, "spec.npy"))
        rough = np.load(join(d, "rough.npy"))
        h, w = albedo.shape[:2]
        f = np.concatenate(
            [albedo.reshape(-1, 3), spec.reshape(-1, 3),
             rough.reshape(-1, 1)], axis=-1)
        fg = np.abs(f).sum(-1) > alpha_thres
        metas.append((h, w, f, fg))
        feats.append(f[fg])
    allf = np.concatenate(feats, axis=0)
    rs = np.random.RandomState(seed)
    if allf.shape[0] > max_pixels:
        allf = allf[rs.choice(allf.shape[0], max_pixels, replace=False)]
    centers = mean_shift(allf, bandwidth, device=device)
    centers_t = torch.as_tensor(centers, device=device)

    outs = []
    for (h, w, f, fg), out_dir in zip(metas, out_dirs):
        os.makedirs(out_dir, exist_ok=True)
        labels = np.zeros(f.shape[0], np.int32)
        if fg.any():
            pts = torch.as_tensor(f[fg], dtype=torch.float64, device=device)
            labels[fg] = nearest_center(pts, centers_t).cpu().numpy() + 1
        label_map = labels.reshape(h, w)
        vis_embed_map(label_map, join(out_dir, "labels.png"))
        np.save(join(out_dir, "labels.npy"), label_map)
        outs.append(out_dir)
    return centers.shape[0], outs
