"""The stage-2 skip-MLP (counterpart of mlp_init/mlp_apply in
vqnerf_release_tpu/ops/nn.py).

Layer i in ``skip_at`` has the ORIGINAL input concatenated onto its
output, which widens layer i+1. Weights are ``nn.Linear``s, so they are
stored [d_out, d_in]; the JAX package stores [d_in, d_out]
(``interop/jax_params.py`` transposes). Init is Keras' default:
glorot-uniform weights and zero biases, drawn from an explicit
``torch.Generator``.
"""

import math

import torch
from torch import nn

__all__ = ["ACTS", "SkipMLP", "mlp_init"]

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
