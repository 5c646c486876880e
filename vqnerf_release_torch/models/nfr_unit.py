"""nfr_unit, the continuous BRDF warm-up model (counterpart of
vqnerf_release_tpu/models/nfr_unit.py). Only its init is ported so far:
vq_nfr is built from it. Its forward comes with training."""

import torch

from . import decomp_common as dc

__all__ = ["NfrUnit", "init_nfr_unit"]


class NfrUnit(dc.ParamModule):
    """fine_enc, bottleneck, diff_out, spec_out, rough_out, light
    [Lh, Lw, 3], and gamma_bias/gamma_index for real data."""


def init_nfr_unit(generator, cfg: dc.DecompConfig) -> NfrUnit:
    parts = {
        **dc.init_encoder(generator, cfg),
        "diff_out": dc.init_head(generator, cfg.z_dim, 3),
        "spec_out": dc.init_head(generator, cfg.z_dim, 1),
        "rough_out": dc.init_head(generator, cfg.z_dim, 1),
        "light": torch.full(cfg.light_res + (3,), cfg.light_init_val),
    }
    if not cfg.is_nerf:
        parts["gamma_bias"] = torch.ones((1,))
        parts["gamma_index"] = torch.ones((1,))
    return NfrUnit(**parts)
