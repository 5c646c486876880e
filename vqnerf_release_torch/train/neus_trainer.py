"""NeuS geometry training: so far only its configuration (counterpart of
``NeuSTrainConfig`` in vqnerf_release_tpu/train/neus_trainer.py; a test pins
the fields and defaults to the JAX ones). The geometry extractor reads
``use_white_bkgd`` from it, and ``config.neus_configs_for_scene`` fills it
from the per-family presets. The training step is not ported yet.
"""

from dataclasses import dataclass

__all__ = ["NeuSTrainConfig"]


@dataclass(frozen=True)
class NeuSTrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300_000
    lr_end_iter: int = -1  # dtu: 300k while end_iter=100k
    warm_up_end: int = 5_000
    anneal_end: int = 0
    batch_size: int = 2560
    igr_weight: float = 0.1
    mask_weight: float = 0.1
    use_white_bkgd: bool = True
    save_freq: int = 10_000
    val_freq: int = 2_500
    mesh_freq: int = 10_000  # in-loop marching-cubes mesh dump; 0 = off
    # the JAX package's opt-in for its fused SDF kernel; the port's switch
    # is ``use_fused_sdf`` on the render functions (on for CUDA tensors)
    use_pallas: bool = False
    # occupancy-grid sampling (ops/occupancy.py): 0 = off
    occ_res: int = 0
    occ_update_freq: int = 250
    occ_margin: float = 3.0
    occ_floor: float = 0.05
    steps_per_dispatch: int = 1
    # per-ray-adaptive work (requires occ_res > 0): provably empty rays
    # render with a cheap empty_n_samples uniform tier
    adaptive_empty: bool = False
    empty_n_samples: int = 8
    # two-phase sampler schedule: after (1 - tail_frac) * end_iter steps,
    # training switches to tail_sampler (a "64+64r4"-style spec)
    tail_frac: float = 0.0
    tail_sampler: str = ""
    tail_occ: bool = False  # keep occupancy guidance on during the tail
    # auto carve-tier selection from the deep-interior fraction
    carve_auto: bool = False
    carve_alt_sampler: str = "24+16r2"
    carve_auto_thresh: float = 0.30
    carve_probe_res: int = 0
    skip_nonfinite_updates: bool = True
