"""Inverse-transform (PDF) sampling along rays (counterpart of
vqnerf_release_tpu/ops/sampling.py).

Random draws are inputs: the caller passes its uniform numbers ``u`` (the
JAX function takes a key and draws them itself; the two streams differ).
"""

import torch

__all__ = ["sample_pdf"]


def sample_pdf(bins, weights, n_samples, u=None, eps_w=1e-5):
    """Draw n_samples per ray from the piecewise-constant PDF over bins.

    Args:
      bins:    [R, B] bin edges (z_vals)
      weights: [R, B-1] bin weights
      n_samples: int
      u: None for the deterministic midpoints in [0.5/n, 1-0.5/n], else
         uniform samples [R, n_samples].
    Returns [R, n_samples] sample positions.
    """
    r, b = bins.shape
    weights = weights + eps_w
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([cdf.new_zeros((r, 1)), cdf], dim=-1)  # [R, B]

    if u is None:
        u = torch.linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                           dtype=cdf.dtype, device=cdf.device)
        u = u.expand(r, n_samples)
    u = u.contiguous()

    # searchsorted(right=True): the number of cdf entries <= u
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=b - 1)

    cdf_below = torch.gather(cdf, 1, below)
    cdf_above = torch.gather(cdf, 1, above)
    bin_below = torch.gather(bins, 1, below)
    bin_above = torch.gather(bins, 1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bin_below + t * (bin_above - bin_below)
