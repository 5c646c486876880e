#!/usr/bin/env python
"""Export the newest JAX (orbax) checkpoint of a phase as one .npz that the
PyTorch port imports (the JAX half of
vqnerf_release_torch/interop/jax_ckpt.py; run it where jax and orbax are
installed).

The checkpoint is restored against an example state built by the JAX
package's own init functions, so that the VQ EMA state and the optimizer
states come back as their NamedTuples and not as plain dicts and lists.
Every leaf is written under its path in the state tree, the parts joined
by "/" (dict keys, list indices, NamedTuple fields by name), beside
"epoch" (the decomposition phases) or "iter_step" (NeuS).

Example:
  python scripts/export_jax_ckpt.py output/train/lego_3072_vq_nfr/lr5e-4 \\
      vq_nfr.npz --kind vq_nfr --scene lego_3072
  # then, where the port runs:
  python -m vqnerf_release_torch.interop.jax_ckpt vq_nfr.npz \\
      output/train/lego_3072_vq_nfr/lr5e-4 --kind vq_nfr --scene lego_3072
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vqnerf_release_torch.interop.jax_ckpt import (KINDS,  # noqa: E402
                                                   write_npz)


def example_state(kind, cfg, seed=0):
    """The state tree that the JAX trainer of ``kind`` checkpoints, at its
    init values: the structure orbax restores into."""
    if kind == "neus":
        from vqnerf_release_tpu.models.neus import init_neus
        from vqnerf_release_tpu.train.neus_trainer import init_neus_opt_state
        params = init_neus(seed, cfg)
        return {"params": params, "opt_state": init_neus_opt_state(params),
                "iter_step": 0}
    from vqnerf_release_tpu.models import decomp_common as dc
    from vqnerf_release_tpu.models.nfr_unit import init_nfr_unit
    from vqnerf_release_tpu.models.ref_nfr import init_ref_nfr
    from vqnerf_release_tpu.models.vq_nfr import init_vq_nfr
    from vqnerf_release_tpu.train import decomp_trainer as dt

    lxyz, lareas = dc.light_constants(cfg)
    nfr = init_nfr_unit(seed, cfg)
    if kind == "nfr_unit":
        tx, _ = dt.make_nfr_unit_step(cfg, lxyz, lareas)
        return {"params": nfr, "opt_state": tx.init(nfr), "epoch": 0}
    centers = np.zeros((cfg.num_embed, cfg.z_dim), np.float32)
    vq, ema = init_vq_nfr(seed, cfg, nfr, centers)
    if kind == "vq_nfr":
        tx, _ = dt.make_vq_nfr_step(cfg, lxyz, lareas)
        return {"params": vq, "ema": ema, "opt_state": tx.init(vq),
                "epoch": 0}
    light = np.zeros(cfg.light_res + (3,), np.float32)
    ref = init_ref_nfr(seed, cfg, vq, light)
    tx, _ = dt.make_ref_nfr_step(cfg, lxyz, lareas)
    return {"params": ref, "opt_state": tx.init(ref["train"]), "epoch": 0}


def export(phase_dir, out_npz, kind, cfg):
    """Restore the newest checkpoint under ``phase_dir`` and write it to
    ``out_npz``; returns (the checkpoint's path, the .npz path)."""
    import jax

    from vqnerf_release_tpu.utils import ckpt as ckpt_util

    latest = ckpt_util.latest_ckpt(phase_dir)
    if latest is None:
        raise SystemExit(f"no checkpoint under {phase_dir}/checkpoints")
    state = ckpt_util.load_ckpt(latest, example_state(kind, cfg))
    write_npz(out_npz, jax.tree_util.tree_map(np.asarray, state))
    return latest, out_npz


def config(kind, scene=None, preset_override="", ini=None,
           config_override=""):
    from vqnerf_release_tpu import config as vcfg

    if kind == "neus":
        if not scene:
            raise SystemExit("--kind neus takes its config from --scene")
        return vcfg.neus_configs_for_scene(scene)[0]
    if ini:
        return vcfg.decomp_config_from_ini(ini, config_override)[0]
    if not scene:
        raise SystemExit("give --scene or --config")
    from vqnerf_release_tpu.cli import _apply_preset_overrides
    cfg, _ = vcfg.decomp_config_for_scene(scene)
    return _apply_preset_overrides(cfg, preset_override)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("phase_dir", help="the phase's output directory (the "
                    "one holding checkpoints/)")
    ap.add_argument("out_npz")
    ap.add_argument("--kind", required=True, choices=KINDS)
    ap.add_argument("--scene", default=None,
                    help="the config of the scene's family preset")
    ap.add_argument("--preset-override", default="",
                    help="k=v,... onto the scene's decomposition preset, "
                         "as decomp-train took it")
    ap.add_argument("--config", default=None,
                    help="the config of a reference-format INI (ini-train)")
    ap.add_argument("--config-override", default="")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")  # a host-side conversion

    cfg = config(args.kind, args.scene, args.preset_override, args.config,
                 args.config_override)
    latest, path = export(args.phase_dir, args.out_npz, args.kind, cfg)
    print(json.dumps({"source": latest, "written": path, "kind": args.kind}))


if __name__ == "__main__":
    main()
