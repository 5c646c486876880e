"""Typed configuration of both stages (counterpart of
vqnerf_release_tpu/config.py): scene families, the per-family geometry and
decomposition presets, the sampler-spec grammar, the output layout
(output/train/<scene>_<model>/lr<lr> and surf/<family>_surf/<scene>), and
reference-format INI files with their ``k=v,...`` overrides. The stage-2
presets build the port's ``models/decomp_common.DecompConfig``.
"""

import configparser
import os
import re
import sys

from .models.decomp_common import DecompConfig
from .models.neus import NeuSConfig
from .train.neus_trainer import NeuSTrainConfig

__all__ = [
    "SCENE_FAMILY", "CG_SCENES", "scene_family",
    "decomp_config_for_scene", "neus_configs_for_scene",
    "load_ini", "decomp_config_from_ini", "apply_overrides",
    "surf_dir", "train_outdir", "rewrite_ini_paths",
    "parse_sampler_spec",
]


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

# per-family decomposition preset
_FAMILY_DECOMP = {
    "nerf": dict(data_type="nerf", imh=512, num_embed=15, num_drop=12,
                 thres_str="0.1;0.15;0.2;0.25;0.3;0.35;0.4;0.45;0.5;"
                           "0.55;0.6;0.65",
                 light_init_val=0.5, white_bg=True),
    "mat": dict(data_type="nerf", imh=420, num_embed=15, num_drop=12,
                thres_str="0.1;0.15;0.2;0.25;0.3;0.35;0.4;0.45;0.5;"
                          "0.55;0.6;0.65",
                light_init_val=0.5, white_bg=True),
    "dtu": dict(data_type="dtu", imh=512, num_embed=8, num_drop=7,
                thres_str="0.1;0.2;0.3;0.4;0.5;0.6;0.7",
                light_init_val=0.7, white_bg=False),
    "ours": dict(data_type="dtu", imh=420, num_embed=8, num_drop=7,
                 thres_str="0.1;0.2;0.3;0.4;0.5;0.6;0.7",
                 light_init_val=1.0, white_bg=False),
    "hw": dict(data_type="hw", imh=420, num_embed=8, num_drop=7,
               thres_str="0.1;0.2;0.3;0.4;0.5;0.6;0.7",
               light_init_val=0.5, white_bg=False),
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


def decomp_config_for_scene(scene, **overrides):
    """(DecompConfig, light_init_val) of a scene's family preset with the
    overrides on top. The light's initial value is returned apart, as the
    JAX function returns it (the preset's own value, not an override's)."""
    family = scene_family(scene)
    kw = dict(_FAMILY_DECOMP[family])
    light_init = kw.pop("light_init_val")
    kw.update(overrides)
    return DecompConfig(**kw), light_init


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


def train_outdir(output_root, scene, model, lr="5e-4"):
    """output/train/<scene>_<model>/lr<lr>."""
    return os.path.join(
        output_root, "train", "%s_%s" % (scene, model), "lr%s" % lr)


# ---------------------------------------------------------------------------
# INI files in the reference's format


def load_ini(path):
    parser = configparser.ConfigParser()
    with open(path) as f:
        parser.read_string(f.read())
    return dict(parser["DEFAULT"])


def apply_overrides(ini_dict, override_str):
    """A ``k=v,k2=v2`` override string onto an INI dict."""
    out = dict(ini_dict)
    if override_str:
        for kv in override_str.split(","):
            k, v = kv.split("=", 1)
            out[k] = v
    return out


_INI_FIELDS = {
    "data_type": str, "light_h": int, "imh": int, "white_bg":
        lambda s: s.lower() == "true",
    "mlp_width": int, "conv_width": ("z_dim", int),
    "n_freqs_xyz": int, "albedo_slope": float, "albedo_bias": float,
    "light_init_val": float, "num_embed": int, "num_drop": int,
    "commitment_cost": float, "combine_weight": float,
    "vq_loss_weight": float,
    "chromaticity_loss_weight": float, "mat_sloss_weight": float,
    "sim_loss_weight": float, "lambert_weight": float,
    "chr_alpha": float, "chr_thres": float, "lr": float,
    "lr_decay_steps": lambda s: int(s.replace("_", "")),
    "lr_decay_rate": float,
    "clipnorm": float, "clipvalue": float,
    "n_rays_per_step": int, "epochs": int, "thres_str": str,
    "total_sample_vq": int, "best_thres": float,
    "random_seed": int, "xyz_jitter_std": float,
}


def decomp_config_from_ini(path, override_str=""):
    """(DecompConfig, the raw INI dict with the overrides) of a
    reference-format INI (config/*.ini)."""
    raw = apply_overrides(load_ini(path), override_str)
    kw = {}
    for ini_key, spec in _INI_FIELDS.items():
        if ini_key not in raw:
            continue
        if isinstance(spec, tuple):
            field, conv = spec
        else:
            field, conv = ini_key, spec
        kw[field] = conv(raw[ini_key])
    return DecompConfig(**kw), raw


def rewrite_ini_paths(ini_path, old_prefix, new_prefix, out_path=None):
    """Rewrite absolute path prefixes inside a dumped config INI (trained
    outputs carry the absolute paths of the machine that trained them);
    returns the path written."""
    with open(ini_path) as f:
        text = f.read()
    text = text.replace(old_prefix, new_prefix)
    with open(out_path or ini_path, "w") as f:
        f.write(text)
    return out_path or ini_path
