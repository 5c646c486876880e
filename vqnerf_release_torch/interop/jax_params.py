"""Convert between the JAX package's parameter pytrees and the port's
modules, for ``nfr_unit``, ``vq_nfr`` and ``ref_nfr``.

A pytree here is what the JAX ``init_*`` functions return, held as nested
dicts and lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``):
a skip-MLP is a list of {"w": [d_in, d_out], "b": [d_out]} dicts, every
other leaf is an array. ``nn.Linear`` stores its weight [d_out, d_in]; the
transposes happen here and nowhere else. The activations and skips of each
MLP are fixed by the model and named in ``_MLPS``.
"""

import numpy as np
import torch

from ..models import decomp_common as dc
from ..models.nfr_unit import NfrUnit
from ..models.ref_nfr import RGB_ENC_ACTS, RefNfr
from ..models.vq_nfr import VqNfr
from ..ops.nn import SkipMLP

__all__ = ["from_jax", "to_jax"]

_ENC = {"fine_enc": (dc.ENC_ACTS, dc.ENC_SKIP),
        "bottleneck": (dc.BOTTLENECK_ACTS, ())}
_HEAD = (dc.HEAD_ACTS, dc.HEAD_SKIP)
_MLPS = {
    "nfr_unit": {**_ENC, "diff_out": _HEAD, "spec_out": _HEAD,
                 "rough_out": _HEAD},
    "vq_nfr": {**_ENC, "diff_main": _HEAD, "spec_main": _HEAD,
               "rough_main": _HEAD, "diff_vq": _HEAD, "spec_vq": _HEAD,
               "rough_vq": _HEAD},
    "ref_nfr/frozen": {**_ENC, "spec_out": _HEAD},
    "ref_nfr/train": {"rgb_enc": (RGB_ENC_ACTS, ()), "diff_out": _HEAD,
                      "rough_out": _HEAD},
}


@torch.no_grad()
def _mlp_from_jax(layers, acts, skip_at):
    mlp = SkipMLP(np.shape(layers[0]["w"])[0],
                  [np.shape(p["w"])[1] for p in layers], acts, skip_at)
    for lin, p in zip(mlp.layers, layers):
        lin.weight.copy_(torch.as_tensor(np.asarray(p["w"]).T))
        lin.bias.copy_(torch.as_tensor(np.asarray(p["b"])))
    return mlp


def _parts_from_jax(tree, mlps):
    parts = {}
    for key, leaf in tree.items():
        if key in mlps:
            parts[key] = _mlp_from_jax(leaf, *mlps[key])
        elif isinstance(leaf, (list, dict)):
            raise ValueError(f"unexpected subtree {key!r}")
        else:
            parts[key] = np.asarray(leaf, np.float32)
    return parts


def _parts_to_jax(module):
    tree = {}
    for name, child in module.named_children():
        tree[name] = [{"w": lin.weight.detach().cpu().numpy().T.copy(),
                       "b": lin.bias.detach().cpu().numpy().copy()}
                      for lin in child.layers]
    for name, p in module.named_parameters(recurse=False):
        tree[name] = p.detach().cpu().numpy().copy()
    return tree


def from_jax(tree, kind):
    """JAX pytree -> NfrUnit / VqNfr / RefNfr (on the CPU)."""
    if kind == "nfr_unit":
        return NfrUnit(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "vq_nfr":
        return VqNfr(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "ref_nfr":
        return RefNfr(
            dc.ParamModule(**_parts_from_jax(tree["frozen"],
                                             _MLPS["ref_nfr/frozen"])),
            dc.ParamModule(**_parts_from_jax(tree["train"],
                                             _MLPS["ref_nfr/train"])))
    raise ValueError(f"unknown kind {kind!r}")


def to_jax(module, kind):
    """NfrUnit / VqNfr / RefNfr -> JAX pytree of numpy arrays."""
    if kind in ("nfr_unit", "vq_nfr"):
        return _parts_to_jax(module)
    if kind == "ref_nfr":
        return {"frozen": _parts_to_jax(module.frozen),
                "train": _parts_to_jax(module.trainable)}
    raise ValueError(f"unknown kind {kind!r}")
