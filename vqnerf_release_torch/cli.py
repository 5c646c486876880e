"""Command-line entry points of the port (counterpart of
vqnerf_release_tpu/cli.py), with its subcommands' names, arguments,
defaults and output tree:

  * geo-train     <scene>   NeuS geometry training (NeuSRunner)
  * gen-geo       <scene>   surface buffers and light visibility of every
                            view (pipelines/gen_geo.py::run_gen_geo)
  * decomp-train  <scene>   the three decomposition phases
  * test          <scene>   the four test passes (pipelines/test_driver.py)
  * ini-train               one phase from a reference-format INI
  * gen-z         <scene>   nfr_unit material maps (pipelines/gen_z.py)
  * reselect-main <scene>   the elbow selection again (pipelines/gen_main.py)

    python -m vqnerf_release_torch.cli <subcommand> ... [--device cuda]

Paths: --data-root (scene data) and --output-root (./output), under which
the tree is exp/<scene>/<family>/checkpoints (geometry),
surf/<family>_surf/<scene>/<view> (buffers) and
train/<scene>_<model>/lr5e-4 (each phase). Every subcommand runs on
--device, "cuda" unless it says otherwise, and exits with an error when
that device is not there: nothing falls back to the CPU. Checkpoints are
the port's ``torch.save`` files (utils/ckpt.py); a checkpoint of the JAX
package is brought over with ``python -m
vqnerf_release_torch.interop.jax_ckpt``.
"""

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np

from . import config as vcfg

__all__ = ["main"]

# where multi-device and multi-host runs stand in ROADMAP.md
_MULTI_DEVICE_ITEM = "ROADMAP.md, Queue 1, item 11 (profiling and multi-GPU)"


def _add_common(p):
    p.add_argument("scene")
    p.add_argument("--data-root", required=True)
    p.add_argument("--output-root", default="./output")
    p.add_argument("--seed", type=int, default=None)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="the torch device to run on (default cuda; 'cpu' "
                        "runs on the CPU); there is no fallback")


def _apply_preset_overrides(cfg, override_str):
    """k=v,... overrides onto a frozen config dataclass (typed by field)."""
    if not override_str:
        return cfg
    types = {f.name: f.type for f in dataclasses.fields(cfg)}
    kw = {}
    for kv in override_str.split(","):
        k, v = kv.split("=", 1)
        t = types[k]
        if t in (int, "int", Optional[int], "Optional[int]"):
            kw[k] = int(v)
        elif t in (float, "float"):
            kw[k] = float(v)
        elif t in (bool, "bool", Optional[bool], "Optional[bool]"):
            kw[k] = v.lower() == "true"
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def _geo_cfgs(args, extraction=False):
    """(NeuSConfig, NeuSTrainConfig, meta) of the scene with --geo-override
    and --n-samples on top; extraction starts from the reference sampler
    64+64r4 without the occupancy grid."""
    from .models.neus import NeuSConfig

    base = dict(n_samples=64, n_importance=64, up_sample_steps=4,
                occ_res=0) if extraction else {}
    cfg, tcfg, meta = vcfg.neus_configs_for_scene(args.scene, **base)
    # --geo-override keys route to the config that owns them
    override = getattr(args, "geo_override", "")
    if override:
        t_kvs, m_kvs = [], []
        for kv in override.split(","):
            k = kv.split("=", 1)[0]
            if k in type(tcfg).__dataclass_fields__:
                t_kvs.append(kv)
            elif k in type(cfg).__dataclass_fields__:
                m_kvs.append(kv)
            else:
                raise SystemExit(
                    f"--geo-override: unknown key {k!r} (not a "
                    "NeuSTrainConfig or NeuSConfig field)")
        tcfg = _apply_preset_overrides(tcfg, ",".join(t_kvs))
        cfg = _apply_preset_overrides(cfg, ",".join(m_kvs))
    if getattr(args, "n_samples", 0):
        cfg = NeuSConfig(
            sdf=cfg.sdf, color=cfg.color,
            n_samples=args.n_samples, n_importance=args.n_samples,
            up_sample_steps=min(cfg.up_sample_steps, 2),
            perturb=cfg.perturb)
    return cfg, tcfg, meta


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def cmd_geo_train(args):
    from .data.neus_dataset import DtuSceneDataset, NerfSceneDataset
    from .train.neus_loop import NeuSRunner
    from .utils.profiling import trace

    cfg, tcfg, meta = _geo_cfgs(args)
    if args.end_iter:
        tcfg = dataclasses.replace(tcfg, end_iter=args.end_iter)
    if meta["family"] in ("dtu", "ours"):
        ds = DtuSceneDataset(args.data_root, is_train=True,
                             new_h=meta["new_h"])
    else:
        ds = NerfSceneDataset(args.data_root, is_train=True,
                              near=meta["near"], far=meta["far"],
                              new_h=meta["new_h"])
    exp_dir = os.path.join(
        args.output_root, "exp", args.scene, meta["family"])
    runner = NeuSRunner(cfg, tcfg, ds, exp_dir, seed=args.seed or 0,
                        device=args.device)
    runner.try_resume()
    with trace(args.profile_dir):
        runner.train()
    runner.save_checkpoint()


def _single_device(args):
    """gen-geo's multi-device and multi-host flags are parsed, as the JAX
    CLI's are, but the port extracts on one device: exit on anything
    else."""
    n = 1
    if args.devices not in (None, "1"):
        if args.devices == "all":
            import torch
            n = (torch.cuda.device_count() if args.device.type == "cuda"
                 else 1)
        else:
            try:
                n = int(args.devices)
            except ValueError:
                raise SystemExit(
                    f"--devices must be 'all' or an integer, got "
                    f"{args.devices!r}")
    hosts = args.num_hosts not in (None, 1) or args.coordinator is not None \
        or args.host_id not in (None, 0)
    if n > 1 or hosts:
        raise SystemExit(
            "gen-geo: the port extracts on one device of one host (--devices "
            f"{args.devices}, --num-hosts {args.num_hosts}, --coordinator "
            f"{args.coordinator}, --host-id {args.host_id} ask for more); "
            f"multi-device extraction is {_MULTI_DEVICE_ITEM}. Shard the "
            "views over processes, one a device, with --num-p / --p-i")


def cmd_gen_geo(args):
    from .pipelines.gen_geo import run_gen_geo

    _single_device(args)
    if args.fast_vis and args.no_fast_vis:
        raise SystemExit("--fast-vis and --no-fast-vis are mutually "
                         "exclusive")
    cfg, tcfg, _ = _geo_cfgs(args, extraction=True)
    no_vis = args.no_vis or args.scene not in vcfg.CG_SCENES
    fast_vis = args.fast_vis or (not no_vis and not args.no_fast_vis)
    run_gen_geo(args.scene, args.data_root, args.output_root,
                seed=args.seed or 0, no_vis=no_vis, fast_vis=fast_vis,
                fast_vis_factor=args.fast_vis_factor,
                fast_vis_occluded=args.fast_vis_occluded,
                fast_vis_refine=args.fast_vis_refine,
                vis_sampler=args.vis_sampler, occ_vis=args.occ_vis,
                span_vis=args.span_vis, num_p=args.num_p, p_i=args.p_i,
                overrides={**_fields(tcfg), **_fields(cfg)},
                use_fused_sdf=True if args.pallas else None,
                device=args.device)


def _load_phase_model(outdir, cfg, kind, device, vq=None, light=None):
    """The model of a phase's latest checkpoint under ``outdir``, on
    ``device``: the blank NfrUnit, VqNfr or RefNfr of ``cfg`` with the
    checkpoint's state dict loaded (strict). A RefNfr is built on ``vq``
    (the phase's VqNfr) and ``light`` (``_np_light``); the checkpoint
    replaces its frozen part all the same."""
    from .train.loop import phase_model
    from .utils import ckpt as ckpt_util

    latest = ckpt_util.latest_ckpt(outdir)
    if latest is None:
        raise FileNotFoundError(f"no checkpoint under {outdir}")
    params = ckpt_util.load_ckpt(latest)["params"]
    model = phase_model(_ckpt_cfg(cfg, params), kind, vq=vq, light=light)
    model.load_state_dict(params)
    return model.to(device)


def _ckpt_cfg(cfg, params):
    """``cfg`` with the model's shape read from a checkpoint's state dict,
    as the JAX CLI restores whatever tree a checkpoint holds (gen-z and
    reselect-main take no preset override): the widths, the posenc
    frequencies, the light's size, the code count and, through the gamma's
    presence, whether the data are CG. For building the blank model
    only."""
    pre = "frozen." if "frozen.light" in params else ""
    enc = params[pre + "fine_enc.layers.0.weight"]  # [width, 3 + 6 freqs]
    kw = dict(mlp_width=enc.shape[0], n_freqs_xyz=(enc.shape[1] - 3) // 6,
              z_dim=params[pre + "bottleneck.layers.2.weight"].shape[0],
              light_h=params[pre + "light"].shape[0])
    if "codebook" in params:
        kw["num_embed"] = params["codebook"].shape[1]
    gamma = any(k.endswith("gamma_bias") for k in params)
    if gamma == cfg.is_nerf:
        kw["data_type"] = "hw" if gamma else "nerf"
    return dataclasses.replace(cfg, **kw)


def _np_light(vq_out):
    """The light that vq_nfr's validation wrote (ref_nfr's init reads
    it), or None where the directory has none."""
    path = os.path.join(vq_out, "vis_vali", "np_light.npy")
    return np.load(path) if os.path.exists(path) else None


def _views(data_root, surf_root, cfg, mode, with_ref=False):
    from .data.shape_dataset import ShapeDataset

    ds = ShapeDataset(data_root, surf_root, data_type=cfg.data_type,
                      imh=cfg.imh, white_bg=cfg.white_bg, mode=mode,
                      with_ref=with_ref)
    if not ds.files:
        raise SystemExit(
            f"no {mode} views: expected {data_root}/"
            f"{'train' if mode in ('train', 'render') else 'val'}_NNN/"
            f"metadata.json (stage-2 interface) with buffers under "
            f"{surf_root} — training on an empty dataset diverges "
            "silently")
    return [ds.load_view(f) for f in ds.files]


def _debug(cfg):
    """--debug: 1 epoch, one train view and one validation view. The port
    takes eager steps always, so that is all it changes."""
    print("[vqnerf-torch] --debug: 1 epoch, single train view and single "
          "validation view (steps are always eager here)", file=sys.stderr)
    return dataclasses.replace(cfg, epochs=1)


def cmd_decomp_train(args):
    from .train import loop
    from .utils.profiling import trace

    cfg, _ = vcfg.decomp_config_for_scene(args.scene)
    cfg = _apply_preset_overrides(cfg, args.preset_override)
    if args.seed is not None:
        cfg = dataclasses.replace(cfg, random_seed=args.seed)
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.debug:
        cfg = _debug(cfg)
    n = 1 if args.debug else None
    surf_root = args.surf_root or vcfg.surf_dir(
        os.path.join(args.output_root, "surf"), args.scene)
    phases = (["nfr_unit", "vq_nfr", "ref_nfr"]
              if args.phase == "all" else [args.phase])
    nfr_out = vcfg.train_outdir(args.output_root, args.scene, "nfr_unit")
    vq_out = vcfg.train_outdir(args.output_root, args.scene, "vq_nfr")
    ref_out = vcfg.train_outdir(args.output_root, args.scene, "ref_nfr")
    dev = args.device

    with trace(args.profile_dir):
        if phases != ["ref_nfr"]:
            train_views = _views(args.data_root, surf_root, cfg, "train")[:n]
            vali_views = _views(args.data_root, surf_root, cfg,
                                "vali")[:8][:n]
        nfr = vq = None
        if "nfr_unit" in phases:
            nfr, _ = loop.train_nfr_unit(cfg, train_views, vali_views,
                                         nfr_out, device=dev)
        if "vq_nfr" in phases:
            if nfr is None:
                nfr = _load_phase_model(nfr_out, cfg, "nfr_unit", dev)
            vq, _, _ = loop.train_vq_nfr(cfg, nfr, train_views, vali_views,
                                         vq_out, device=dev)
        del nfr  # each phase's staged views went with its trainer
        if "ref_nfr" in phases:
            if vq is None:
                vq = _load_phase_model(vq_out, cfg, "vq_nfr", dev)
            light = np.load(os.path.join(vq_out, "vis_vali", "np_light.npy"))
            loop.train_ref_nfr(
                cfg, vq, light,
                _views(args.data_root, surf_root, cfg, "train", True)[:n],
                _views(args.data_root, surf_root, cfg, "vali", True)[:8][:n],
                ref_out, device=dev)


def cmd_test(args):
    import glob

    from .data.shape_dataset import ShapeDataset
    from .pipelines.test_driver import run_test

    cfg, _ = vcfg.decomp_config_for_scene(args.scene)
    cfg = _apply_preset_overrides(cfg, args.preset_override)
    surf_root = args.surf_root or vcfg.surf_dir(
        os.path.join(args.output_root, "surf"), args.scene)
    vq_out = vcfg.train_outdir(args.output_root, args.scene, "vq_nfr")
    ref_out = vcfg.train_outdir(args.output_root, args.scene, "ref_nfr")
    vq = _load_phase_model(vq_out, cfg, "vq_nfr", args.device)
    ref = _load_phase_model(ref_out, cfg, "ref_nfr", args.device, vq=vq,
                            light=_np_light(vq_out))

    epoch_dirs = sorted(
        glob.glob(os.path.join(vq_out, "vis_vali", "epoch*")))
    ds = ShapeDataset(args.data_root, surf_root, data_type=cfg.data_type,
                      imh=cfg.imh, white_bg=cfg.white_bg, mode="test",
                      with_ref=True)
    if not ds.files:
        raise SystemExit(
            f"no test views: expected {args.data_root}/val_NNN/"
            f"metadata.json with buffers under {surf_root}")
    outroot = os.path.join(ref_out, "vis_test", "latest")
    run_test(ref, vq, cfg, ds, outroot, args.test_envmap_dir,
             vali_epoch_dir=epoch_dirs[-1] if epoch_dirs else None,
             data_root=args.data_root, scene_name=args.scene,
             device=args.device)


def cmd_ini_train(args):
    """One phase from a reference-format INI and its ``k=v,...``
    overrides: model, dataset and paths all come from the INI."""
    from .train import loop

    cfg, raw = vcfg.decomp_config_from_ini(args.config,
                                           args.config_override)
    model = raw.get("model", "nfr_unit")
    data_root = raw["data_root"]
    surf_root = raw["data_nerf_root"]
    outroot = raw.get("outroot", "./output/train/run")
    xname = raw.get("xname", "lr{lr}").format(**raw)
    outdir = os.path.join(outroot, xname)
    if args.debug:
        cfg = _debug(cfg)
    n = 1 if args.debug else None
    dev = args.device

    def views(mode, with_ref=False):
        from .data.shape_dataset import ShapeDataset
        ds = ShapeDataset(data_root, surf_root, data_type=cfg.data_type,
                          imh=cfg.imh, white_bg=cfg.white_bg, mode=mode,
                          with_ref=with_ref)
        return [ds.load_view(f) for f in ds.files][:n]

    if model not in ("nfr_unit", "vq_nfr", "ref_nfr"):
        raise NotImplementedError(model)
    if model == "nfr_unit":
        loop.train_nfr_unit(cfg, views("train"), views("vali")[:8], outdir,
                            device=dev)
        return
    # <prev outdir>/checkpoints/ckpt-<n>: the phase this one starts from
    prev_dir = os.path.dirname(os.path.dirname(raw["nfr_model_ckpt"]))
    if model == "vq_nfr":
        nfr = _load_phase_model(prev_dir, cfg, "nfr_unit", dev)
        loop.train_vq_nfr(cfg, nfr, views("train"), views("vali")[:8],
                          outdir, cluster_path=raw.get("cluster_center_path"),
                          device=dev)
    else:
        vq = _load_phase_model(prev_dir, cfg, "vq_nfr", dev)
        light = np.load(os.path.join(prev_dir, "vis_vali", "np_light.npy"))
        loop.train_ref_nfr(cfg, vq, light, views("train", with_ref=True),
                           views("vali", with_ref=True)[:8], outdir,
                           device=dev)


def cmd_gen_z(args):
    """Per-view albedo/spec/rough (+ latents) of a trained nfr_unit."""
    from .data.shape_dataset import ShapeDataset
    from .pipelines.gen_z import export_materials

    cfg, _ = vcfg.decomp_config_for_scene(args.scene)
    surf_root = args.surf_root or vcfg.surf_dir(
        os.path.join(args.output_root, "surf"), args.scene)
    nfr_out = vcfg.train_outdir(args.output_root, args.scene, "nfr_unit")
    nfr = _load_phase_model(nfr_out, cfg, "nfr_unit", args.device)
    ds = ShapeDataset(args.data_root, surf_root, data_type=cfg.data_type,
                      imh=cfg.imh, white_bg=cfg.white_bg, mode=args.mode)
    views = [ds.load_view(f) for f in ds.files]
    outroot = args.outdir or os.path.join(nfr_out, "gen_z")
    dirs = export_materials(nfr, cfg, views, outroot, gen_z=args.gen_z)
    print(f"gen-z: wrote {len(dirs)} views under {outroot}")


def cmd_reselect_main(args):
    """The elbow selection again over a finished vq_nfr validation epoch,
    and the main_<k> marker moved."""
    from .pipelines.gen_main import reselect_main

    cfg, _ = vcfg.decomp_config_for_scene(args.scene)
    if args.vali_epoch_dir:
        epoch_dir = args.vali_epoch_dir
    else:
        vq_out = vcfg.train_outdir(args.output_root, args.scene, "vq_nfr")
        vali = os.path.join(vq_out, "vis_vali")
        epochs = sorted(d for d in os.listdir(vali)
                        if d.startswith("epoch"))
        if not epochs:
            raise FileNotFoundError(f"no epoch dirs under {vali}")
        epoch_dir = os.path.join(vali, epochs[-1])
    best_thres = (args.best_thres if args.best_thres is not None
                  else cfg.best_thres)
    k = reselect_main(epoch_dir, cfg.num_embed, cfg.num_drop, best_thres,
                      apply=not args.dry_run)
    print(f"reselect-main: k={k} ({'dry run' if args.dry_run else 'applied'})"
          f" in {epoch_dir}")


def main(argv=None):
    ap = argparse.ArgumentParser("vqnerf-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("geo-train")
    _add_common(p)
    p.add_argument("--end-iter", type=int, default=0)
    p.add_argument("--geo-override", default="",
                   help="k=v,... overrides onto NeuSTrainConfig")
    p.add_argument("--n-samples", type=int, default=0,
                   help="shrink the sampler for smoke runs")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json, Chrome "
                        "trace format) and its operator table there")
    p.set_defaults(fn=cmd_geo_train)

    p = sub.add_parser("gen-geo")
    _add_common(p)
    p.add_argument("--num-p", type=int, default=None)
    p.add_argument("--p-i", type=int, default=None)
    p.add_argument("--no-vis", action="store_true")
    p.add_argument("--geo-override", default="")
    p.add_argument("--n-samples", type=int, default=0)
    p.add_argument("--fast-vis", action="store_true",
                   help="two-pass lvis: coarse SDF sweep certifies free "
                        "shadow rays; full render only on the rest "
                        "(DEFAULT for CG lvis extraction)")
    p.add_argument("--no-fast-vis", action="store_true",
                   help="force the full occlusion render on every "
                        "front-lit shadow ray")
    p.add_argument("--vis-sampler", default=None,
                   help="occlusion-render sampler for lvis, e.g. "
                        "'32+16r2' (default: the geometry render's "
                        "parity config)")
    p.add_argument("--occ-vis", action="store_true",
                   help="draw the occlusion render's initial samples "
                        "from the SDF-occupancy PDF (multi-interval)")
    p.add_argument("--span-vis", action="store_true",
                   help="tighten each shadow ray's [near,far] to its "
                        "occupancy-grid span and zero rays crossing no "
                        "occupied cell")
    p.add_argument("--fast-vis-factor", type=float, default=2.0,
                   help="safety factor on the coarse certification "
                        "margin (>= 1; higher = more conservative)")
    p.add_argument("--fast-vis-occluded", action="store_true",
                   help="also certify provably-OCCLUDED shadow rays "
                        "from the coarse sweep: lvis=0 without the fine "
                        "render")
    p.add_argument("--fast-vis-refine", type=int, default=64,
                   help="second-stage certification: sample count of "
                        "the finer sweep run on rays the coarse pass "
                        "leaves uncertain; 0 disables")
    p.add_argument("--devices", default=None,
                   help="'all' or a device count; the port extracts on one "
                        "device and exits on more")
    p.add_argument("--pallas", action="store_true",
                   help="the fused SDF kernels for the no-grad render "
                        "passes (use_fused_sdf=True; without the flag they "
                        "are on for CUDA and off on the CPU)")
    p.add_argument("--num-hosts", type=int, default=None,
                   help="a process group of this many hosts; the port runs "
                        "on one host and exits on more")
    p.add_argument("--coordinator", default=None,
                   help="host:port of a multi-host coordinator (not "
                        "supported by the port)")
    p.add_argument("--host-id", type=int, default=None,
                   help="this host's process index in the group")
    p.set_defaults(fn=cmd_gen_geo)

    p = sub.add_parser("decomp-train")
    _add_common(p)
    p.add_argument("--phase", default="all",
                   choices=["all", "nfr_unit", "vq_nfr", "ref_nfr"])
    p.add_argument("--surf-root", default=None)
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--preset-override", default="",
                   help="k=v,... overrides onto the family preset")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace (trace.json, Chrome "
                        "trace format) and its operator table there")
    p.add_argument("--debug", action="store_true",
                   help="1 epoch, single train view and single validation "
                        "view (the reference's trainvali.py --debug)")
    p.set_defaults(fn=cmd_decomp_train)

    p = sub.add_parser("test")
    _add_common(p)
    p.add_argument("--surf-root", default=None)
    p.add_argument("--test-envmap-dir", required=True)
    p.add_argument("--preset-override", default="")
    p.set_defaults(fn=cmd_test)

    p = sub.add_parser("ini-train")
    p.add_argument("--config", required=True)
    p.add_argument("--config-override", default="")
    p.add_argument("--debug", action="store_true",
                   help="1 epoch, single train view (trainvali.py --debug)")
    p.set_defaults(fn=cmd_ini_train)

    p = sub.add_parser("gen-z", help="export nfr_unit materials/latents")
    _add_common(p)
    p.add_argument("--surf-root", default=None)
    p.add_argument("--mode", default="train",
                   choices=["train", "vali", "test"])
    p.add_argument("--outdir", default=None)
    p.add_argument("--gen-z", action="store_true",
                   help="also dump the z_bias latents")
    p.set_defaults(fn=cmd_gen_z)

    p = sub.add_parser("reselect-main",
                       help="re-run elbow selection on a vq vali epoch")
    p.add_argument("scene")
    p.add_argument("--output-root", default="./output")
    p.add_argument("--vali-epoch-dir", default=None,
                   help="explicit epoch dir (default: latest)")
    p.add_argument("--best-thres", type=float, default=None)
    p.add_argument("--dry-run", action="store_true")
    p.set_defaults(fn=cmd_reselect_main)

    for p in sub.choices.values():
        _add_device(p)

    args = ap.parse_args(argv)
    from .utils.device import resolve_device
    try:
        args.device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"vqnerf-torch {args.cmd}: {e}")
    args.fn(args)


if __name__ == "__main__":
    main()
