"""Stage-1 configuration: scene families, per-family geometry presets, the
sampler-spec grammar and the output layout (counterpart of the stage-1 half
of vqnerf_release_tpu/config.py; the stage-2 ``DecompConfig`` lives in
``models/decomp_common.py``).
"""

import os
import re
import sys

from .models.neus import NeuSConfig
from .train.neus_trainer import NeuSTrainConfig

__all__ = ["SCENE_FAMILY", "CG_SCENES", "scene_family", "parse_sampler_spec",
           "neus_configs_for_scene", "surf_dir"]


def parse_sampler_spec(spec, what="sampler spec"):
    """'64+64r4' -> dict(n_samples=64, n_importance=64, up_sample_steps=4):
    the one place the sampler-spec grammar lives. Raises ValueError on
    anything else; ``what`` names the offending option in the message."""
    m = re.fullmatch(r"(\d+)\+(\d+)r(\d+)", spec.strip())
    if not m:
        raise ValueError(
            f"{what} must look like '64+64r4' "
            f"(<n_samples>+<n_importance>r<up_sample_steps>), "
            f"got {spec!r}")
    return dict(n_samples=int(m.group(1)), n_importance=int(m.group(2)),
                up_sample_steps=int(m.group(3)))


# scene -> dataset family
SCENE_FAMILY = {
    "drums_3072": "nerf", "lego_3072": "nerf", "hotdog_2163": "nerf",
    "materials_2163": "nerf", "ficus_2188": "nerf",
    "chair0_3072": "mat", "machine1_3072": "mat", "kitchen6_7095": "mat",
    "dtu_scan24": "dtu", "dtu_scan69": "dtu", "dtu_scan110": "dtu",
    "colmap_bottle": "ours", "colmap_tools2": "ours",
    "colmap_wshoes": "ours",
    "hwchair_-1": "hw", "rabbit_-1": "hw", "redcar_-1": "hw",
    "toyrabbit_-1": "hw",
}

CG_SCENES = {
    "drums_3072", "lego_3072", "hotdog_2163", "materials_2163",
    "ficus_2188", "chair0_3072", "machine1_3072", "kitchen6_7095",
}

# per-family geometry preset (confs/nerf.conf vs confs/dtu.conf)
_FAMILY_GEO = {
    "nerf": dict(end_iter=300_000, batch_size=2560, use_white_bkgd=True,
                 near=2.0, far=6.0, new_h=0, lr_end_iter=-1),
    "mat": dict(end_iter=300_000, batch_size=2560, use_white_bkgd=True,
                near=2.0, far=6.0, new_h=0, lr_end_iter=-1),
    "dtu": dict(end_iter=100_000, batch_size=512, use_white_bkgd=False,
                near=-1.0, far=-1.0, new_h=512, lr_end_iter=300_000),
    "ours": dict(end_iter=100_000, batch_size=512, use_white_bkgd=False,
                 near=-1.0, far=-1.0, new_h=420, lr_end_iter=300_000),
    "hw": dict(end_iter=300_000, batch_size=2560, use_white_bkgd=False,
               near=2.0, far=6.0, new_h=420, lr_end_iter=-1),
}

# Default stage-1 TRAINING sampler of every family: occupancy-placed 24+8
# samples / 2 up-sample rounds over a 128^3 grid for the first 75% of
# end_iter, then a dense occupancy-placed 64+32r2 tail. Extraction does not
# use it: it renders with the reference sampler 64+64r4 (see
# ``pipelines.gen_geo.run_gen_geo``).
_GEO_FAST_SAMPLER = dict(n_samples=24, n_importance=8, up_sample_steps=2,
                         occ_res=128, tail_frac=0.25,
                         tail_sampler="64+32r2", tail_occ=True)


def scene_family(scene):
    if scene in SCENE_FAMILY:
        return SCENE_FAMILY[scene]
    if scene.startswith("dtu_"):
        return "dtu"
    if scene.startswith("colmap_"):
        return "ours"
    return "nerf"


_FAST_SAMPLER_NOTICED = False


def neus_configs_for_scene(scene, **overrides):
    """(NeuSConfig, NeuSTrainConfig, {"near", "far", "new_h", "family"}) of
    a scene: its family's preset, the fast training sampler, then the
    overrides, each routed to the config that owns the key."""
    family = scene_family(scene)
    kw = dict(_FAMILY_GEO[family])
    near, far = kw.pop("near"), kw.pop("far")
    new_h = kw.pop("new_h")
    kw.update(_GEO_FAST_SAMPLER)
    kw.update(overrides)
    known = (set(NeuSTrainConfig.__dataclass_fields__)
             | set(NeuSConfig.__dataclass_fields__))
    unknown = sorted(set(kw) - known)
    if unknown:
        raise ValueError(
            "neus_configs_for_scene: unknown override keys %s — valid "
            "keys are the NeuSTrainConfig/NeuSConfig fields" % unknown)
    t_kw = {k: v for k, v in kw.items()
            if k in NeuSTrainConfig.__dataclass_fields__}
    m_kw = {k: v for k, v in kw.items()
            if k in NeuSConfig.__dataclass_fields__}
    tcfg = NeuSTrainConfig(**t_kw)
    cfg = NeuSConfig(**m_kw)
    global _FAST_SAMPLER_NOTICED
    if tcfg.occ_res > 0 and not _FAST_SAMPLER_NOTICED:
        _FAST_SAMPLER_NOTICED = True
        tail = ""
        if tcfg.tail_frac > 0.0 and tcfg.tail_sampler:
            kind = "dense occ" if tcfg.tail_occ else "parity"
            tail = (", %s %s tail for the final %d%% of steps"
                    % (tcfg.tail_sampler, kind,
                       round(100 * tcfg.tail_frac)))
        print(
            "[vqnerf-torch] stage-1 fast sampler default active "
            "(occupancy-placed %d+%d samples, %d up-sample rounds, "
            "occ_res=%d%s); reference-exact sampling: n_samples=64,"
            "n_importance=64,up_sample_steps=4,occ_res=0,tail_frac=0"
            % (cfg.n_samples, cfg.n_importance, cfg.up_sample_steps,
               tcfg.occ_res, tail), file=sys.stderr)
    return cfg, tcfg, {"near": near, "far": far, "new_h": new_h,
                       "family": family}


def surf_dir(output_root, scene):
    """surf/<family>_surf/<scene>."""
    return os.path.join(
        output_root, "%s_surf" % scene_family(scene), scene)
