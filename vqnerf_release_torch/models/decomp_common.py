"""Shared pieces of the decomposition models (counterpart of
vqnerf_release_tpu/models/decomp_common.py).

``DecompConfig`` is a copy of the JAX dataclass: the JAX one lives in a
module that imports jax. ``tests/test_torch_models.py`` pins the field
names and defaults to the JAX ones.

A model is an ``nn.Module`` whose attribute names are the keys of the JAX
parameter pytree (``fine_enc``, ``bottleneck``, heads, ``light``,
``codebook``, ``gamma_bias``/``gamma_index``), so the functions below read
``model.light`` where the JAX package reads ``params["light"]``.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from vqnerf_release_tpu.ops.light import gen_light_xyz  # numpy only

from ..ops.embed import posenc, posenc_dim
from ..ops.math import clip_preserve_gradient, safe_l2_normalize
from ..ops.nn import SkipMLP, mlp_init

__all__ = [
    "DecompConfig", "ParamModule", "fused_render_enabled", "light_constants",
    "init_encoder", "init_head", "apply_encoder",
    "calc_ldir", "calc_vdir", "normal_correct",
    "get_light", "get_gamma", "get_codebook",
]


@dataclass(frozen=True)
class DecompConfig:
    """Stage-2 configuration; fields and defaults as the JAX DecompConfig
    (see its field comments for the meaning of each)."""
    data_type: str = "nerf"  # 'nerf' | 'dtu' | 'hw'
    light_h: int = 16
    imh: int = 512
    white_bg: bool = True
    mlp_width: int = 128
    z_dim: int = 256
    n_freqs_xyz: int = 10
    albedo_slope: float = 1.0
    albedo_bias: float = 0.0
    light_init_val: float = 0.5
    num_embed: int = 15
    num_drop: int = 12
    commitment_cost: float = 0.1
    vq_decay: float = 0.999
    combine_weight: float = 0.2
    vq_loss_weight: float = 1.0
    chromaticity_loss_weight: float = 1.0
    mat_sloss_weight: float = 0.05
    sim_loss_weight: float = 1e-4
    lambert_weight: float = 1e-3
    chr_alpha: float = 60.0
    chr_thres: float = 0.1
    lr: float = 5e-4
    lr_decay_steps: int = 500_000
    lr_decay_rate: float = 0.1
    clipnorm: float = -1.0
    clipvalue: float = -1.0
    skip_nonfinite_updates: bool = True
    n_rays_per_step: int = 1024
    epochs: int = 150
    thres_str: str = "0.1;0.15;0.2;0.25;0.3;0.35;0.4;0.45;0.5;0.55;0.6;0.65"
    total_sample_vq: int = 200_000
    best_thres: float = 0.002
    random_seed: int = 2
    xyz_jitter_std: float = 0.01
    keep_recent_epochs: int = -1
    # Route the single-envmap render of vq_fast_render / ref_fast_render
    # through the fused CUDA kernel (kernels/render.py). None = auto: on
    # when the tensors are on CUDA, off on the CPU.
    use_fused_render: Optional[bool] = None
    # The remaining fields steer the JAX package's training paths; the port
    # keeps them so that configs convert field for field.
    use_fused_vq: Optional[bool] = None
    device_views: str = "auto"
    epoch_scan: Optional[bool] = None
    epoch_scan_chunk: Optional[int] = None
    device_sampling: bool = False

    @property
    def light_res(self) -> Tuple[int, int]:
        return (self.light_h, 2 * self.light_h)

    @property
    def is_nerf(self) -> bool:
        return self.data_type == "nerf"

    @property
    def n_lights(self) -> int:
        return self.light_h * 2 * self.light_h


def fused_render_enabled(cfg: DecompConfig, device: torch.device) -> bool:
    """Resolve use_fused_render: None -> on for CUDA tensors only."""
    if cfg.use_fused_render is None:
        return device.type == "cuda"
    return bool(cfg.use_fused_render)


def light_constants(cfg: DecompConfig, device):
    """(lxyz [L, 3], lareas [L]) float32 tensors on ``device``."""
    lxyz, lareas = gen_light_xyz(*cfg.light_res)
    return (torch.as_tensor(lxyz.reshape(-1, 3), dtype=torch.float32,
                            device=device),
            torch.as_tensor(lareas.reshape(-1), dtype=torch.float32,
                            device=device))


class ParamModule(nn.Module):
    """A model part built from named pieces, as a JAX pytree level is: each
    SkipMLP becomes a submodule and each tensor a Parameter, under the
    JAX key's name."""

    def __init__(self, **parts):
        super().__init__()
        for name, part in parts.items():
            if isinstance(part, nn.Module):
                self.add_module(name, part)
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.as_tensor(part, dtype=torch.float32).clone(
                        memory_format=torch.contiguous_format)))


# Network constants (nfr_unit.py:110-129 of the reference):
#   fine_enc:   [mlp_width]*4, relu, skip@2, input = posenc(xyz, 10) = 63
#   bottleneck: [mlp_width, z_dim, z_dim], [None, relu, sigmoid]
#   heads:      [z_dim, z_dim//2, out], [relu, relu, sigmoid], skip@1
ENC_ACTS = ["relu"] * 4
ENC_SKIP = (2,)
BOTTLENECK_ACTS = [None, "relu", "sigmoid"]
HEAD_ACTS = ["relu", "relu", "sigmoid"]
HEAD_SKIP = (1,)


def init_encoder(generator, cfg: DecompConfig):
    """{'fine_enc', 'bottleneck'} SkipMLPs."""
    d_embed = posenc_dim(3, cfg.n_freqs_xyz)
    return {
        "fine_enc": mlp_init(generator, d_embed, [cfg.mlp_width] * 4,
                             ENC_ACTS, ENC_SKIP),
        "bottleneck": mlp_init(generator, cfg.mlp_width,
                               [cfg.mlp_width, cfg.z_dim, cfg.z_dim],
                               BOTTLENECK_ACTS),
    }


def apply_encoder(model, xyz, cfg: DecompConfig):
    """posenc -> fine_enc -> bottleneck => z in [0,1]^z_dim."""
    h = posenc(xyz, cfg.n_freqs_xyz)
    return model.bottleneck(model.fine_enc(h))


def init_head(generator, d_in, d_out, width=None) -> SkipMLP:
    """Head decoder [width, width//2, d_out] with skip@1; apply it by
    calling it."""
    width = width or d_in
    return mlp_init(generator, d_in, [width, width // 2, d_out], HEAD_ACTS,
                    HEAD_SKIP)


def calc_ldir(lxyz, xyz):
    """Unit surface->light directions [N, L, 3]."""
    return safe_l2_normalize(lxyz[None, :, :] - xyz[:, None, :], axis=2)


def calc_vdir(rayo, xyz):
    """Unit surface->camera directions [N, 3]."""
    return safe_l2_normalize(rayo - xyz, axis=1)


def normal_correct(normal, surf2c):
    """Flip normals facing away from the camera."""
    cos = torch.sum(normal * surf2c, dim=-1, keepdim=True)
    return torch.where(cos >= 0, normal, -normal)


def get_light(model):
    """Non-negative light."""
    return clip_preserve_gradient(model.light, 0.0, float("inf"))


def get_gamma(model):
    """(bias, index) with the index clipped to [0, 5]."""
    return (model.gamma_bias,
            clip_preserve_gradient(model.gamma_index, 0.0, 5.0))


def get_codebook(model):
    """clip[0, 1] + column L2-normalize; [z_dim, K]."""
    cb = clip_preserve_gradient(model.codebook, 0.0, 1.0)
    return safe_l2_normalize(cb, axis=0)
