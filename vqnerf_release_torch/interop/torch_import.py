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

As a command (the port's scripts/import_torch_checkpoint.py), it writes the
checkpoint that ``NeuSRunner.try_resume`` and ``gen-geo`` read:

  python -m vqnerf_release_torch.interop.torch_import \
      --ckpt exp/lego/checkpoints/ckpt_300000.pth \
      --out output/exp/lego_3072/nerf [--scene lego_3072 | --no-bg]
"""

import argparse
import dataclasses
import json
import os
import re

import numpy as np
import torch

from ..models.neus import NeuSConfig, init_neus
from ..utils.device import resolve_device

__all__ = ["import_neus", "main"]


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


def main(argv=None):
    ap = argparse.ArgumentParser(
        "python -m vqnerf_release_torch.interop.torch_import",
        description="Write the port's NeuS checkpoint of a reference NeuS "
                    "(stage-1, torch .pth) checkpoint.")
    ap.add_argument("--ckpt", required=True,
                    help=".pth file or NeuS experiment dir")
    ap.add_argument("--out", required=True,
                    help="output base_exp_dir for NeuSRunner")
    ap.add_argument("--scene", default=None,
                    help="scene name: take the NeuS config from its "
                         "family preset (default: NeuSConfig())")
    ap.add_argument("--no-bg", action="store_true",
                    help="checkpoint trained without the background NeRF")
    ap.add_argument("--device", default="cuda",
                    help="the torch device to import on (default cuda; "
                         "'cpu' runs on the CPU); there is no fallback")
    args = ap.parse_args(argv)

    from ..train.neus_trainer import init_neus_opt_state
    from ..utils import ckpt as ckpt_util

    if args.scene:
        from ..config import neus_configs_for_scene
        cfg, _, _ = neus_configs_for_scene(args.scene)
    else:
        cfg = NeuSConfig()
    if args.no_bg:
        cfg = dataclasses.replace(cfg, n_outside=0)

    model, iter_step = import_neus(args.ckpt, cfg, device=args.device)
    state = {"params": model.state_dict(),
             "opt_state": init_neus_opt_state(model.parameters()),
             "iter_step": iter_step}
    path = ckpt_util.save_ckpt(args.out, iter_step, state)
    print(json.dumps({"source": args.ckpt, "written": path,
                      "iter_step": iter_step, "has_bg": model.has_bg}))
    return path


if __name__ == "__main__":
    main()
