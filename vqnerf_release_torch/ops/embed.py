"""Positional encoding (counterpart of vqnerf_release_tpu/ops/embed.py).

For input x of dim d and n frequencies the layout is
[x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...] with f_k = 2**k, the
channel order the weights were trained against.
"""

import torch

__all__ = ["posenc", "posenc_dim"]


def posenc_dim(in_dims, n_freqs, include_input=True):
    return (in_dims if include_input else 0) + 2 * n_freqs * in_dims


def posenc(x, n_freqs, include_input=True):
    """Positional-encode the last axis."""
    if n_freqs == 0:
        return x
    feats = [x] if include_input else []
    for k in range(n_freqs):
        freq = float(2**k)
        feats.append(torch.sin(x * freq))
        feats.append(torch.cos(x * freq))
    return torch.cat(feats, dim=-1)
