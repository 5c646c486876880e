"""Lloyd's k-means for the codebook initialisation (counterpart of
vqnerf_release_tpu/ops/kmeans.py).

Kept from the JAX package: the initial centres are a numpy
``RandomState(seed).choice`` of rows without replacement; assignment is a
distance matmul and an argmin; a centre becomes the mean of its rows, and an
empty cluster keeps its centre; the loop stops when the squared sum of the
centre shifts falls below ``tol``, or after ``max_iters``. The JAX package
runs the loop under ``lax.while_loop``; here it is a Python loop, which
reads one scalar from the device per iteration.
"""

import numpy as np
import torch

__all__ = ["kmeans", "kmeans_predict"]


def _pairwise_sq_dist(x, centers):
    # |x|^2 - 2 x c^T + |c|^2  -> [N, K]
    return (torch.sum(x**2, dim=1, keepdim=True) - 2.0 * x @ centers.T
            + torch.sum(centers**2, dim=1)[None, :])


@torch.no_grad()
def kmeans(x, num_clusters, seed=1, tol=1e-4, max_iters=1000):
    """x [N, D] tensor -> (assignments [N], centers [K, D]) on x's device."""
    x = x.to(torch.float32)
    rng = np.random.RandomState(seed)
    idx = rng.choice(x.shape[0], num_clusters, replace=False)
    centers = x[torch.as_tensor(idx, device=x.device)]
    for _ in range(max_iters):
        assign = torch.argmin(_pairwise_sq_dist(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, num_clusters).to(x.dtype)
        counts = torch.sum(onehot, dim=0)
        sums = onehot.T @ x
        new_centers = torch.where(
            (counts > 0)[:, None],
            sums / torch.clamp(counts, min=1.0)[:, None], centers)
        shift = torch.sum(torch.sqrt(
            torch.sum((new_centers - centers) ** 2, dim=1)))
        centers = new_centers
        if float(shift**2) < tol:
            break
    return torch.argmin(_pairwise_sq_dist(x, centers), dim=1), centers


@torch.no_grad()
def kmeans_predict(x, centers):
    return torch.argmin(_pairwise_sq_dist(x.to(torch.float32), centers),
                        dim=1)
