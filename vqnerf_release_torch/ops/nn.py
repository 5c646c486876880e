"""Dense layers: the stage-2 skip-MLP (counterpart of mlp_init/mlp_apply in
vqnerf_release_tpu/ops/nn.py) and, below it, stage 1's plain and
weight-normalised dense layers with the geometric SDF init.

Layer i in ``skip_at`` has the ORIGINAL input concatenated onto its
output, which widens layer i+1. Weights are ``nn.Linear``s, so they are
stored [d_out, d_in]; the JAX package stores [d_in, d_out]
(``interop/jax_params.py`` transposes). Init is Keras' default:
glorot-uniform weights and zero biases, drawn from an explicit
``torch.Generator``.
"""

import math

import numpy as np
import torch
from torch import nn

__all__ = ["ACTS", "SkipMLP", "mlp_init", "Dense", "WNDense", "wn_fold",
           "dense_init", "wn_dense_init", "geometric_sdf_init"]

ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
}


class SkipMLP(nn.Module):
    """Dense layers with per-layer activations and input skip concats.

    The parameters are allocated uninitialised; ``mlp_init`` fills them
    from a generator and ``interop.jax_params.from_jax`` copies them in.
    """

    def __init__(self, d_in, widths, acts, skip_at=()):
        super().__init__()
        if len(acts) != len(widths):
            raise ValueError(f"{len(widths)} layers but {len(acts)} acts")
        self.acts = list(acts)
        self.skip_at = tuple(skip_at)
        layers = []
        cur = d_in
        for i, w_out in enumerate(widths):
            layers.append(nn.utils.skip_init(nn.Linear, cur, w_out))
            cur = w_out + (d_in if i in self.skip_at else 0)
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        h = x
        for i, layer in enumerate(self.layers):
            y = ACTS[self.acts[i]](layer(h))
            if i in self.skip_at:
                y = torch.cat([y, x], dim=-1)
            h = y
        return h


@torch.no_grad()
def mlp_init(generator, d_in, widths, acts, skip_at=()):
    """A SkipMLP with glorot-uniform weights drawn from ``generator``."""
    mlp = SkipMLP(d_in, widths, acts, skip_at)
    for layer in mlp.layers:
        d_out, d_layer_in = layer.weight.shape
        lim = math.sqrt(6.0 / (d_layer_in + d_out))
        layer.weight.uniform_(-lim, lim, generator=generator)
        layer.bias.zero_()
    return mlp


# ---------------------------------------------------------------------------
# Stage 1 (counterpart of the weight-norm half of
# vqnerf_release_tpu/ops/nn.py). Parameters keep the JAX pytree's names and
# layouts: weights are [d_in, d_out] here, not nn.Linear's [d_out, d_in].


class Dense(nn.Module):
    """x @ w + b with ``w`` [d_in, d_out] and ``b`` [d_out], allocated
    uninitialised."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def forward(self, x):
        return x @ self.w + self.b


def wn_fold(v, g):
    """g * v / max(||v||, 1e-12), the norm over the input dim of each
    output unit: the plain weight of a weight-normalised layer."""
    v_norm = torch.linalg.norm(v, dim=0, keepdim=True)
    return g[None, :] * v / torch.clamp(v_norm, min=1e-12)


class WNDense(nn.Module):
    """Weight-normalised dense layer: w = g * v / max(||v||, 1e-12), the
    norm over the input dim of each output unit. ``v`` [d_in, d_out], ``g``
    [d_out], ``b`` [d_out], allocated uninitialised."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.v = nn.Parameter(torch.empty(d_in, d_out))
        self.g = nn.Parameter(torch.empty(d_out))
        self.b = nn.Parameter(torch.empty(d_out))

    def folded(self):
        """The plain weight [d_in, d_out] with the norm folded in."""
        return wn_fold(self.v, self.g)

    def forward(self, x):
        return x @ self.folded() + self.b


@torch.no_grad()
def dense_init(generator, d_in, d_out):
    """Glorot-uniform ``Dense`` with a zero bias."""
    layer = Dense(d_in, d_out)
    lim = math.sqrt(6.0 / (d_in + d_out))
    layer.w.uniform_(-lim, lim, generator=generator)
    layer.b.zero_()
    return layer


@torch.no_grad()
def wn_dense_init(generator, d_in, d_out, w=None, b=None):
    """A ``WNDense``, from a given dense (w [d_in, d_out], b) or, without
    one, uniform in +-1/sqrt(d_in) drawn from ``generator``; g starts as
    the norm of v, so the layer starts as the plain dense."""
    layer = WNDense(d_in, d_out)
    if w is None:
        std = 1.0 / math.sqrt(d_in)
        layer.v.uniform_(-std, std, generator=generator)
        layer.b.uniform_(-std, std, generator=generator)
    else:
        layer.v.copy_(torch.as_tensor(w, dtype=torch.float32))
        layer.b.copy_(torch.as_tensor(b, dtype=torch.float32))
    layer.g.copy_(torch.linalg.norm(layer.v, dim=0))
    return layer


def geometric_sdf_init(rng, dims, skip_in, d_in_embed, bias=0.5,
                       inside_outside=False):
    """Per-layer float32 (w, b) of the geometric-init SDF MLP, numpy on a
    ``RandomState`` (the JAX package's function, so one seed gives both the
    same weights).

    dims: full layer dims [d_embed, hidden..., d_out]; layers whose OUTPUT
    feeds a skip concat have out_dim reduced by dims[0]. ``d_in_embed`` is
    the embedded input width; raw xyz occupies its first 3 channels.
    """
    n_layers = len(dims) - 1
    params = []
    for l in range(n_layers):
        if l + 1 in skip_in:
            out_dim = dims[l + 1] - dims[0]
        else:
            out_dim = dims[l + 1]
        in_dim = dims[l]
        if l == n_layers - 1:
            mean = np.sqrt(np.pi) / np.sqrt(in_dim)
            if inside_outside:
                mean = -mean
            w = rng.normal(mean, 1e-4, size=(in_dim, out_dim))
            b = np.full((out_dim,), bias if inside_outside else -bias)
        elif l == 0:
            w = np.zeros((in_dim, out_dim))
            w[:3, :] = rng.normal(
                0.0, np.sqrt(2) / np.sqrt(out_dim), size=(3, out_dim))
            b = np.zeros((out_dim,))
        elif l in skip_in:
            w = rng.normal(
                0.0, np.sqrt(2) / np.sqrt(out_dim), size=(in_dim, out_dim))
            w[-(dims[0] - 3):, :] = 0.0
            b = np.zeros((out_dim,))
        else:
            w = rng.normal(
                0.0, np.sqrt(2) / np.sqrt(out_dim), size=(in_dim, out_dim))
            b = np.zeros((out_dim,))
        params.append((np.asarray(w, np.float32), np.asarray(b, np.float32)))
    return params
