"""Convert between the JAX package's pytrees and the port's state: the
parameters of ``nfr_unit``, ``vq_nfr``, ``ref_nfr``, ``neus`` and
``shape_refine``, the VQ EMA state, and the amsgrad optimizer state.

A pytree here is what the JAX ``init_*`` functions return, held as nested
dicts and lists of numpy arrays (``jax.tree_util.tree_map(np.asarray, p)``):
a skip-MLP is a list of {"w": [d_in, d_out], "b": [d_out]} dicts, every
other leaf is an array. ``nn.Linear`` stores its weight [d_out, d_in]; the
transposes happen here and nowhere else. The activations and skips of each
MLP are fixed by the model and named in ``_MLPS``. A NeuS tree is {"sdf":
[...], "color": [...], "variance": {"variance": x}} and, with a background
model, "bg": {"pts": [...], "views": [...], "feature", "alpha", "rgb"}; its
weight-norm layers are {"v", "g", "b"} and its background layers {"w", "b"},
all [d_in, d_out], and the port keeps those layouts (``ops.nn.WNDense``,
``ops.nn.Dense``), so nothing is transposed there.

The JAX optimizer state is {"count", "m", "v", "vhat"} with one tree like
the parameters under each of the last three (clipnorm and clipvalue off, as
shipped). The port's ``KerasAmsgrad`` keeps each as one flat vector in the
order of ``model.parameters()``, so the conversions take the model. NeuS
trains with optax's ``ScaleByAdamState(count, mu, nu)``, mu and nu trees
like the NeuS parameters; the port's ``NeuSAdam`` keeps mu and nu flat in
the same way.
"""

import copy

import numpy as np
import torch

from ..models import decomp_common as dc
from ..models import fields
from ..models.neus import NeuS
from ..models.nfr_unit import NfrUnit
from ..models.ref_nfr import RGB_ENC_ACTS, RefNfr
from ..models.shape_refine import ShapeRefine
from ..models.vq_nfr import VqNfr
from ..ops.nn import Dense, SkipMLP, WNDense
from ..ops.vq import VqEmaState

__all__ = ["from_jax", "to_jax", "ema_from_jax", "ema_to_jax",
           "opt_state_from_jax", "opt_state_to_jax", "adam_state_from_jax",
           "adam_state_to_jax"]

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
    "shape_refine": {"normal_mlp": (["relu"] * 4, (2,)),
                     "normal_out": (["relu", "relu", None], ())},
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


@torch.no_grad()
def _layer_from_jax(p):
    """{"v", "g", "b"} -> WNDense, {"w", "b"} -> Dense."""
    first = "v" if "v" in p else "w"
    layer = (WNDense if first == "v" else Dense)(*np.shape(p[first]))
    for name, param in layer.named_parameters():
        param.copy_(torch.as_tensor(np.array(p[name], np.float32)))
    return layer


def _layers_from_jax(layers):
    return torch.nn.ModuleList(_layer_from_jax(p) for p in layers)


def _layer_to_jax(layer):
    return {name: p.detach().cpu().numpy().copy()
            for name, p in layer.named_parameters()}


def _neus_from_jax(tree):
    bg = None
    if "bg" in tree:
        bg = torch.nn.Module()
        for key, leaf in tree["bg"].items():
            setattr(bg, key, _layers_from_jax(leaf) if isinstance(leaf, list)
                    else _layer_from_jax(leaf))
    return NeuS(_layers_from_jax(tree["sdf"]), _layers_from_jax(tree["color"]),
                fields.init_variance(float(tree["variance"]["variance"])), bg)


def _neus_to_jax(model):
    tree = {"sdf": [_layer_to_jax(p) for p in model.sdf],
            "color": [_layer_to_jax(p) for p in model.color],
            "variance": _layer_to_jax(model.variance)}
    if model.has_bg:
        tree["bg"] = {
            key: ([_layer_to_jax(p) for p in child]
                  if isinstance(child, torch.nn.ModuleList)
                  else _layer_to_jax(child))
            for key, child in model.bg.named_children()}
    return tree


def from_jax(tree, kind):
    """JAX pytree -> NfrUnit / VqNfr / RefNfr / NeuS / ShapeRefine (on the
    CPU); kind
    "ref_nfr/train" converts the ``train`` subtree alone, the tree of
    ref_nfr's optimizer state."""
    if kind == "neus":
        return _neus_from_jax(tree)
    if kind == "nfr_unit":
        return NfrUnit(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "vq_nfr":
        return VqNfr(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "shape_refine":  # at init_shape_refine's default depth
        return ShapeRefine(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "ref_nfr/train":  # the subtree ref_nfr's optimizer sees
        return dc.ParamModule(**_parts_from_jax(tree, _MLPS[kind]))
    if kind == "ref_nfr":
        return RefNfr(
            dc.ParamModule(**_parts_from_jax(tree["frozen"],
                                             _MLPS["ref_nfr/frozen"])),
            dc.ParamModule(**_parts_from_jax(tree["train"],
                                             _MLPS["ref_nfr/train"])))
    raise ValueError(f"unknown kind {kind!r}")


def to_jax(module, kind):
    """NfrUnit / VqNfr / RefNfr / NeuS / ShapeRefine -> JAX pytree of
    numpy arrays."""
    if kind == "neus":
        return _neus_to_jax(module)
    if kind in ("nfr_unit", "vq_nfr", "ref_nfr/train", "shape_refine"):
        return _parts_to_jax(module)
    if kind == "ref_nfr":
        return {"frozen": _parts_to_jax(module.frozen),
                "train": _parts_to_jax(module.trainable)}
    raise ValueError(f"unknown kind {kind!r}")


def ema_from_jax(state):
    """JAX VqEmaState (hidden_cluster_size, hidden_dw, counter) -> the
    port's, on the CPU."""
    hcs, hdw, counter = state
    return VqEmaState(
        torch.as_tensor(np.array(hcs, np.float32)),
        torch.as_tensor(np.array(hdw, np.float32)),
        torch.as_tensor(np.array(counter, np.int32)))


def ema_to_jax(state):
    """The port's VqEmaState -> {field: numpy array}, the keyword arguments
    of the JAX VqEmaState."""
    return {name: t.detach().cpu().numpy().copy()
            for name, t in zip(VqEmaState._fields, state)}


def _flat_from_jax(tree, model, kind):
    """A tree like the parameters -> one flat vector in the order of
    ``model.parameters()``, on the model's device."""
    by_name = dict(from_jax(tree, kind).named_parameters())
    device = next(model.parameters()).device
    return torch.cat([by_name[name].reshape(-1)
                      for name, _ in model.named_parameters()]).to(device)


def _tree_from_flat(flat, model, kind):
    """The inverse of ``_flat_from_jax``: numpy leaves."""
    holder = copy.deepcopy(model)
    sizes = [p.numel() for p in holder.parameters()]
    for p, part in zip(holder.parameters(), flat.split(sizes)):
        p.copy_(part.view_as(p))
    return to_jax(holder, kind)


@torch.no_grad()
def opt_state_from_jax(state, model, kind):
    """JAX amsgrad state -> ``KerasAmsgrad.state`` for ``model`` (tensors on
    the model's device)."""
    device = next(model.parameters()).device
    out = {"count": torch.as_tensor(np.array(state["count"], np.int32),
                                    device=device)}
    for key in ("m", "v", "vhat"):
        out[key] = _flat_from_jax(state[key], model, kind)
    return out


@torch.no_grad()
def opt_state_to_jax(state, model, kind):
    """``KerasAmsgrad.state`` of ``model`` -> the JAX amsgrad state, numpy
    leaves."""
    out = {"count": state["count"].cpu().numpy().copy()}
    for key in ("m", "v", "vhat"):
        out[key] = _tree_from_flat(state[key], model, kind)
    return out


@torch.no_grad()
def adam_state_from_jax(state, model):
    """optax ``ScaleByAdamState(count, mu, nu)`` over a NeuS tree ->
    ``NeuSAdam.state`` for the NeuS ``model`` (on its device)."""
    count, mu, nu = state
    device = next(model.parameters()).device
    return {"count": torch.as_tensor(np.array(count, np.int32),
                                     device=device),
            "mu": _flat_from_jax(mu, model, "neus"),
            "nu": _flat_from_jax(nu, model, "neus")}


@torch.no_grad()
def adam_state_to_jax(state, model):
    """``NeuSAdam.state`` of a NeuS ``model`` -> {"count", "mu", "nu"}, the
    keyword arguments of optax's ``ScaleByAdamState``, numpy leaves."""
    return {"count": state["count"].cpu().numpy().copy(),
            "mu": _tree_from_flat(state["mu"], model, "neus"),
            "nu": _tree_from_flat(state["nu"], model, "neus")}
