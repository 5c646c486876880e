"""Per-view material and latent export from a trained nfr_unit
(counterpart of vqnerf_release_tpu/pipelines/gen_z.py).

For each view the encoder and the three heads of the NfrUnit give the
albedo, specular and roughness maps (and with ``gen_z`` the latent z), for
clustering ablations. Outputs land in <outroot>/<view>/{albedo,spec,
rough}.{npy,png} (+ z_bias.npy with gen_z=True), background pixels zeroed.
"""

import os
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..models import decomp_common as dc

__all__ = ["export_materials"]


@torch.inference_mode()
def export_materials(nfr_model, cfg: dc.DecompConfig, views, outroot,
                     gen_z=False):
    """Write the maps of every view with ``nfr_model`` (an NfrUnit, on the
    device it computes on); returns the view directories."""
    device = next(nfr_model.parameters()).device
    out = []
    for view in views:
        mask = (view.alpha[:, 0] > 0)
        xyz = torch.as_tensor(view.xyz, dtype=torch.float32, device=device)
        z = dc.apply_encoder(nfr_model, xyz, cfg)
        basecolor = (cfg.albedo_slope * nfr_model.diff_out(z)
                     + cfg.albedo_bias)
        ks = nfr_model.spec_out(z)
        rough = nfr_model.rough_out(z).cpu().numpy()
        spec = (ks * basecolor).cpu().numpy()
        albedo = ((1 - ks) * basecolor).cpu().numpy()
        z = z.cpu().numpy()
        m = mask[:, None].astype(np.float32)

        vdir = join(outroot, view.id)
        os.makedirs(vdir, exist_ok=True)
        h, w = view.h, view.w
        for name, arr, ch in (("albedo", albedo * m, 3),
                              ("spec", spec * m, 3),
                              ("rough", rough * m, 1)):
            img = arr.reshape(h, w, ch)
            np.save(join(vdir, name + ".npy"), img)
            vio.write_img(img if ch == 3 else img[..., 0],
                          join(vdir, name + ".png"))
        if gen_z:
            np.save(join(vdir, "z_bias.npy"), (z * m).reshape(h, w, -1))
        out.append(vdir)
    return out
