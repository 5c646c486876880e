"""Import a reference NeuS (stage-1) checkpoint into the port's ``NeuS``
(counterpart of vqnerf_release_tpu/interop/torch_import.py).

The reference saves geometry training as a torch pickle whose state dicts
sit under "sdf_network_fine", "color_network_fine",
"variance_network_fine" and "nerf", beside "optimizer" and "iter_step":

  * SDF and colour nets: ``lin{l}.weight_v`` [out, in], ``lin{l}.weight_g``
    [out, 1], ``lin{l}.bias`` (``nn.utils.weight_norm``); the port's
    ``WNDense`` keeps v as [in, out] with column norms, the same function;
  * background NeRF: ``pts_linears.{i}``, ``views_linears.0``,
    ``feature_linear``, ``alpha_linear``, ``rgb_linear``; their [out, in]
    weights become the port's [in, out];
  * variance: the scalar ``variance``.

The file is read with ``weights_only=True``, so a pickle cannot run code;
the optimizer state is dropped. Every tensor's shape is checked against the
configuration's.
"""

import os
import re

import numpy as np
import torch

from ..models.neus import NeuSConfig, init_neus
from ..utils.device import resolve_device

__all__ = ["import_neus"]


def _load(path):
    if os.path.isdir(path):
        ckptdir = path
        if os.path.isdir(os.path.join(path, "checkpoints")):
            ckptdir = os.path.join(path, "checkpoints")
        names = sorted(n for n in os.listdir(ckptdir) if n.endswith(".pth"))
        if not names:
            raise FileNotFoundError(f"no .pth checkpoints under {ckptdir}")
        path = os.path.join(ckptdir, names[-1])
    return torch.load(path, map_location="cpu", weights_only=True)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                      else t)


@torch.no_grad()
def _put(param, got, what):
    if tuple(param.shape) != tuple(np.shape(got)):
        raise ValueError(f"{what}: checkpoint shape {np.shape(got)} != "
                         f"expected {tuple(param.shape)} (config mismatch?)")
    param.copy_(torch.as_tensor(np.asarray(got, np.float32)))


def _wn_layers(sd, layers, what):
    """lin{l}.weight_v / weight_g / bias -> the WNDense layers."""
    n = max(int(m.group(1)) for k in sd
            if (m := re.fullmatch(r"lin(\d+)\.weight_v", k))) + 1
    if n != len(layers):
        raise ValueError(f"{what}: {n} layers in checkpoint, expected "
                         f"{len(layers)}")
    for l, layer in enumerate(layers):
        _put(layer.v, _np(sd[f"lin{l}.weight_v"]).T, f"{what}.lin{l}.v")
        _put(layer.g, _np(sd[f"lin{l}.weight_g"]).reshape(-1),
             f"{what}.lin{l}.g")
        _put(layer.b, _np(sd[f"lin{l}.bias"]), f"{what}.lin{l}.b")


def _dense(sd, name, layer, what):
    _put(layer.w, _np(sd[f"{name}.weight"]).T, f"{what}.w")
    _put(layer.b, _np(sd[f"{name}.bias"]), f"{what}.b")


def import_neus(path, cfg: NeuSConfig, device="cuda"):
    """Reference NeuS .pth checkpoint (or its exp dir) -> (NeuS on
    ``device``, iter_step). The background net is imported only when
    cfg.n_outside > 0."""
    device = resolve_device(device)
    ckpt = _load(path)
    model = init_neus(0, cfg)
    _wn_layers(ckpt["sdf_network_fine"], model.sdf, "sdf")
    _wn_layers(ckpt["color_network_fine"], model.color, "color")
    _put(model.variance.variance,
         _np(ckpt["variance_network_fine"]["variance"]).reshape(()),
         "variance")
    if model.has_bg:
        sd, bg = ckpt["nerf"], model.bg
        for i, layer in enumerate(bg.pts):
            _dense(sd, f"pts_linears.{i}", layer, f"bg.pts{i}")
        _dense(sd, "views_linears.0", bg.views[0], "bg.views0")
        _dense(sd, "feature_linear", bg.feature, "bg.feature")
        _dense(sd, "alpha_linear", bg.alpha, "bg.alpha")
        _dense(sd, "rgb_linear", bg.rgb, "bg.rgb")
    return model.to(device), int(ckpt.get("iter_step", 0))
