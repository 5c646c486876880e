"""Standalone normal-refinement ("shape") model (counterpart of
vqnerf_release_tpu/models/shape_refine.py): posenc(xyz) -> normal_mlp
(width x depth, relu, skip) -> concat(posenc(view)) -> normal_out (width,
width, 3) + eps, normalised; the loss is normal_loss_weight times the MSE
of the normals alpha-blended onto the background. The main pipeline runs
with shape_mode='finetune' (buffers used directly), so this is the legacy
pre-training path.
"""

import torch

from ..ops.embed import posenc, posenc_dim
from ..ops.math import safe_l2_normalize
from ..ops.nn import mlp_init
from . import decomp_common as dc

__all__ = ["ShapeRefine", "init_shape_refine", "shape_refine_forward",
           "shape_refine_loss", "N_FREQS_VDIR"]

N_FREQS_VDIR = 4


class ShapeRefine(dc.ParamModule):
    """normal_mlp and normal_out, SkipMLPs under the JAX keys' names."""


def init_shape_refine(generator, cfg: dc.DecompConfig, mlp_depth=4,
                      mlp_skip_at=2) -> ShapeRefine:
    d_embed = posenc_dim(3, cfg.n_freqs_xyz)
    d_view = posenc_dim(3, N_FREQS_VDIR)
    return ShapeRefine(
        normal_mlp=mlp_init(generator, d_embed, [cfg.mlp_width] * mlp_depth,
                            ["relu"] * mlp_depth, skip_at=(mlp_skip_at,)),
        normal_out=mlp_init(generator, cfg.mlp_width + d_view,
                            [cfg.mlp_width, cfg.mlp_width, 3],
                            ["relu", "relu", None]))


def shape_refine_forward(model, batch, cfg: dc.DecompConfig, eps=1e-6):
    """batch: alpha [N, 1], xyz [N, 3], rayd [N, 3] tensors on the model's
    device. Returns {"normal" [N, 3] (0 off the mask), "mask" [N]}."""
    alpha = batch["alpha"]
    mask = (alpha[:, 0] > 0).to(torch.float32)
    rayd = safe_l2_normalize(batch["rayd"], axis=1)
    h = model.normal_mlp(posenc(batch["xyz"], cfg.n_freqs_xyz))
    h = torch.cat([h, posenc(rayd, N_FREQS_VDIR)], dim=-1)
    normal = model.normal_out(h) + eps
    normal_pred = safe_l2_normalize(normal, axis=1)
    return {"normal": normal_pred * mask[:, None], "mask": mask}


def shape_refine_loss(pred, batch, cfg: dc.DecompConfig,
                      normal_loss_weight=1.0):
    """Alpha-blended MSE of the normals (shape.py:204-233)."""
    alpha = batch["alpha"]
    normal = batch["normal"]
    bg = torch.ones_like(normal) if cfg.white_bg else torch.zeros_like(normal)

    def blend(v):
        return v * alpha + bg * (1.0 - alpha)

    per_ray = torch.mean((blend(normal) - blend(pred["normal"])) ** 2, dim=-1)
    return normal_loss_weight * torch.mean(per_ray)
