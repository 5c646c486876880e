"""Segmentation scores: purity and micro/macro F1, precision and recall of
predicted embed maps against GT label maps over the validation views
(counterpart of vqnerf_release_tpu/eval/cluster_eval.py), without sklearn.

  * colour -> id decoding with the GT palette (SEL_COLORS, 127-based) and
    the prediction palette (EMBED_C, 128-based), id 0 = unmatched;
  * labels compacted (resort), the contingency matrix a bincount of
    gt * K + pd, each predicted label mapped to its majority GT label
    (correspond), purity = sum(column max) / sum;
  * the scores over the sorted union of labels, as sklearn computes them:
    F1 micro (here the accuracy), and the macro means of precision and
    recall (0 where a label has no prediction, or no GT: zero_division=0)
    and of F1 = 2 tp / (2 tp + fp + fn) (sklearn >= 1.3);
  * pixels restricted to alpha > 0.8 of the scene's rgba.

The bincount, the majority mapping and the per-label counts run on
``device``; the means are taken in numpy, so every device gives the same
floats.
"""

import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..utils.device import resolve_device

__all__ = ["SEL_COLORS", "EMBED_C", "img_embed", "purity", "resort",
           "correspond", "label_scores", "eval_scene_segmentation"]

_BASE = [
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)]


def _palette(half):
    cols = []
    for r, g, b in _BASE:
        cols.append(np.array([255 * r, 255 * g, 255 * b]))
    for r, g, b in _BASE:
        cols.append(np.array([half * r, half * g, half * b]))
    for r, g, b in _BASE:
        cols.append(np.array(
            [255 if r else half, 255 if g else half, 255 if b else half]))
    cols += [np.array([255, half, 0]), np.array([255, 0, half]),
             np.array([0, 255, half])]
    return cols


SEL_COLORS = _palette(127)  # GT label palette
EMBED_C = _palette(128)  # prediction palette


def img_embed(arr, colors):
    """[N, 3] colors -> [N] ids (1-based; 0 = no palette match)."""
    out = np.zeros(arr.shape[0], np.int64)
    for i, c in enumerate(colors):
        out[np.all(arr == c, axis=-1)] = i + 1
    return out


def purity(coo):
    coo = np.asarray(coo)
    return float(np.sum(np.max(coo, axis=0)) / np.sum(coo))


def resort(arr):
    """The labels of ``arr`` renumbered 0.. in sorted order."""
    arr = np.asarray(arr)
    return np.unique(arr, return_inverse=True)[1].reshape(arr.shape).astype(
        arr.dtype)


def correspond(gt, pd, replace=True, device="cuda"):
    """(contingency matrix [n_gt, n_pd], majority GT label of each
    predicted label, compacted gt, pd mapped through it) — sklearn's
    contingency_matrix as a bincount on ``device``; ties of the majority
    go to the lower GT label."""
    device = resolve_device(device)
    gt, pd = resort(gt), resort(pd)
    n_gt, n_pd = int(gt.max()) + 1, int(pd.max()) + 1
    g = torch.as_tensor(gt, device=device)
    p = torch.as_tensor(pd, device=device)
    coo = torch.bincount(g * n_pd + p, minlength=n_gt * n_pd).view(
        n_gt, n_pd)
    label_map = torch.argmax(coo, dim=0)
    replaced = label_map[p] if replace else p
    return (coo.cpu().numpy(), label_map.cpu().numpy(), gt,
            replaced.cpu().numpy())


def label_scores(gt, pd, device="cuda"):
    """{"f1-micro", "f1-macro", "p-macro", "r-macro"} of two label arrays
    over the sorted union of their labels, as sklearn's f1_score,
    precision_score and recall_score (zero_division=0) compute them."""
    device = resolve_device(device)
    labels = np.union1d(gt, pd)
    g = torch.as_tensor(np.searchsorted(labels, gt), device=device)
    p = torch.as_tensor(np.searchsorted(labels, pd), device=device)
    n = len(labels)
    tp = torch.bincount(g[g == p], minlength=n).cpu().numpy()
    true = torch.bincount(g, minlength=n).cpu().numpy()
    pred = torch.bincount(p, minlength=n).cpu().numpy()
    fp, fn = pred - tp, true - tp

    def ratio(num, den):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(den > 0, num / np.where(den > 0, den, 1), 0.0)

    micro = tp.sum()
    return {
        "f1-micro": float(2 * micro / (2 * micro + fp.sum() + fn.sum())),
        "f1-macro": float(np.mean(ratio(2 * tp, 2 * tp + fp + fn))),
        "p-macro": float(np.mean(ratio(tp, pred))),
        "r-macro": float(np.mean(ratio(tp, true))),
    }


def eval_scene_segmentation(rgba_scene, gt_scene, pd_scene, n_vals=8,
                            alpha_thres=0.8, device="cuda"):
    """Returns the metric dict of cluster_eval.process_scene."""
    device = resolve_device(device)
    gt_px, pd_px = [], []
    for i in range(n_vals):
        rgba_path = join(rgba_scene, "val_%03d" % i, "rgba.png")
        if not os.path.exists(rgba_path):
            continue
        mask = vio.load_img_f32(rgba_path)[..., -1]
        gt_img = np.asarray(
            vio.read_rgba16(join(gt_scene, "val_%03d" % i, "idx.png"),
                            longint=False))[..., :3]
        pd_img = np.asarray(
            vio.read_rgba16(join(pd_scene, "batch%09d" % i,
                                 "embed_map.png"), longint=False))[..., :3]
        alpha = mask > alpha_thres
        gt_px.append(gt_img[alpha])
        pd_px.append(pd_img[alpha])
    gt = img_embed(np.concatenate(gt_px), SEL_COLORS)
    pd = img_embed(np.concatenate(pd_px), EMBED_C)
    coo, _, gt, pd = correspond(gt, pd, device=device)
    return {"purity": purity(coo), **label_scores(gt, pd, device=device)}
