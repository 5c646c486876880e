#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqnerf_release_torch) on one GPU.

    python3 chip_smoke.py [--profile]

(--profile adds torch.profiler tables of the training step and of the
fast-vis shadow pass.)

1. checks for a CUDA device and prints its name and power limit;
2. builds the three CUDA sources of csrc/ (three nvcc processes side by
   side; four kernels, the render kernel in four instances) and prints the
   build time, ptxas' register and spill counts, and the count of
   tensor-core instructions (HGMMA / HMMA) that cuobjdump -sass finds in
   the SDF library, which must not be 0;
3. writes a synthetic sphere scene in the reference layout to a temporary
   directory: 4 train and 2 val views of 512x512 rays with 512-light lvis,
   the vis_comps GT-albedo mirror and 16 probe .hdr files;
4. TRAINS on the GPU at the DecompConfig defaults for every width
   (mlp_width 128, z_dim 256, 512 lights, 15 codes, 2048 rows per step):
   train_nfr_unit for 2 epochs, then train_vq_nfr for 2 epochs, with a
   checkpoint and a validation on one val view after each epoch (k-means
   init, the staged views, the fused VQ step, the 13-threshold sweep over
   200,000 rows, the elbow selection and the main_<k> renders); the VQ
   kernel's launch count is reset just before and must equal the number of
   vq_nfr steps just after; losses finite, no skipped step, the codebook
   moved, the checkpoint reloads to equal tensors, the files exist;
5. SERVES the trained model: the port's four-pass run_test over the 2 val
   views with the trained vq_nfr, a ref_nfr initialised from it and the
   main_<k> directory the training wrote, with the render kernel's launch
   counts reset just before and read just after (every launch must be of
   the 16-byte instance: 512 lights, aligned lvis rows); every expected
   file exists, every written array is finite, embed ids lie in [0, n_vq];
6. EXTRACTS stage-1 geometry: writes a synthetic NeRF-convention scene
   (transforms_{train,val}.json, 16-bit rgba.png, cameras on a circle of
   radius 2 looking at the origin), takes init_neus(seed) at the default
   NeuSConfig widths (SDF 39 -> 256x8 -> 257, colour net 4x256), whose
   geometric init is a sphere of radius about 0.5, and runs the port's
   extraction entry run_gen_geo on the GPU with the defaults a user gets:
   sampler 64+64r4, 512 lights, fast_vis on, n_coarse 16, fast_vis_refine
   64, vis_point_batch 64. The SDF kernels' launch counts are reset just
   before and must both have risen just after. Checks: all 8 files of every
   view, finite, lvis in [0, 1]; on foreground pixels |sdf(xyz)| small and
   normals within a stated angle of xyz/|xyz|; lvis near 1 for front-lit,
   non-grazing lights and exactly 0 for back-facing ones. Then, on a few
   hundred foreground points x 512 lights, _lvis_full through the kernels
   against _lvis_fast and against _lvis_full with use_fused_sdf=False, and
   one neus_render with the up-sample chain through the kernel and without;
7. holds each kernel against its plain PyTorch version on the GPU, on
   inputs taken from the trained model:
     fused_brdf_render: a 49,152-ray chunk of a view with lvis, 1,000 rays
       without lvis, and the chunk again with lvis 4 bytes off a 16-byte
       boundary and with 510 lights (both must run the scalar instance);
       rtol 2e-4, atol 1e-5 (a 512-term fp32 sum taken in another order),
       and the fused vq_fast_render against the eager;
     vq_fused_train: N = 2,048, 65,536 and a ragged 1,000 rows of a train
       view (strided, so background rows are in), K = 15 and 8, with and
       without dropped codes, in two stages: (i) indices equal to the plain
       version's except on rows whose two smallest plain distances lie
       within 1e-5 of each other, which must be under 1% of the rows;
       (ii) quantized, counts, hidden_cs, hidden_dw and update against the
       plain version FED THE KERNEL'S INDICES and evaluated in float64, at
       rtol 1e-5 / atol 1e-6 (float64 so that the error of the plain
       version's own 65,536-term fp32 matmul does not enter);
8. times all four kernels and their plain versions: "ms" is one call on a
   busy queue (one pair of CUDA events around a run of calls, over their
   number), which is the host's time where the wrapper takes longer than
   the kernel; "device_ms" is the kernels' own durations as torch.profiler
   records them, over the calls, and every share of a bound is taken from
   it. The profiler also counts the CUDA launches of a call; vq_fused_train
   must be one. For the render kernel it adds the device time with
   lvis=None and, from cuobjdump -sass of the built library, the
   instructions of each instance's light loop and the issue floor they set
   (pairs / 32 x instructions a pair / (SMs x 4 schedulers x the highest SM
   clock)), and fails unless the vector instances hold 16-byte loads. Then
   one whole vq_nfr step with the kernel and with use_fused_vq=False (host
   clock around a synchronised step, median), and with --profile a
   torch.profiler table of a few steps;
9. prints the pass times, peak device memory of training, of serving and of
   extraction, a {"kernels": [...]} line with all four kernels (each with
   ms, device_ms, plain_ms, bound_ms), and as the last line
   {"ok": true, "device": {...}}.

Cuts, all of scale and none of width: 4 train views and 1 validation view
in place of a scene's 100 and 8, 2 epochs in place of 150, 2 served views;
for the extraction 2 train views and 1 val view of 256x256 in place of a
scene's 100 and 8 of 512x512 (or larger).

Any failure raises and exits non-zero; without CUDA it exits 1 before doing
anything.
"""

import copy
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vqnerf_release_torch.data import io as vio
from vqnerf_release_torch.data.device_store import DeviceViewStore
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.kernels import build as kbuild
from vqnerf_release_torch.kernels import render as render_kernel
from vqnerf_release_torch.kernels import sdf as sdf_kernel
from vqnerf_release_torch.kernels import vq as vq_kernel
from vqnerf_release_torch.models import decomp_common as dc
from vqnerf_release_torch.models import fields, vq_nfr
from vqnerf_release_torch.models.neus import (NeuSConfig, init_neus,
                                              neus_render)
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.models.ref_nfr import init_ref_nfr
from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
from vqnerf_release_torch.pipelines import gen_geo
from vqnerf_release_torch.pipelines.test_driver import (_RAY_CHUNK, find_vq,
                                                         load_novel_lights,
                                                         run_test)
from vqnerf_release_torch.train import decomp_trainer as dt
from vqnerf_release_torch.train import loop as train_loop
from vqnerf_release_torch.utils import ckpt as ckpt_util

SCENE = "sphere"
N_VIEWS = 2  # served val views
N_TRAIN_VIEWS = 4
N_VALI_VIEWS = 1
EPOCHS = 2
N_PROBES = 16
SEED = 0
RTOL, ATOL = 2e-4, 1e-5  # fused_brdf_render against its plain version
VQ_RTOL, VQ_ATOL = 1e-5, 1e-6  # vq_fused_train, stage (ii)
VQ_TIE_GAP = 1e-5  # stage (i): rows whose two nearest codes are this close
VQ_TIE_SHARE = 0.01
RAGGED_N = 1000
# stage-1 extraction: a CG scene's name (lvis is extracted for those), the
# cuts of scale, and the tolerances of its checks
GEO_SCENE = "lego_3072"
GEO_IMH = 256
GEO_TRAIN_VIEWS, GEO_VAL_VIEWS = 2, 1
GEO_NEAR, GEO_FAR = 0.5, 3.5
GEO_GT_RADIUS = 0.33  # silhouette of the train views' GT masks
SDF_RTOL, SDF_ATOL = 1e-4, 1e-5  # SDF kernels against their plain versions
SDF_AUTO_RTOL, SDF_AUTO_ATOL = 3e-3, 3e-4  # ... against autograd
SDF_RAYS = 8192  # vis_point_batch 64 x light_tile 128
SDF_RAGGED_N = 131072 + 77
LVIS_POINTS = 300
LVIS_KERNEL_ATOL = 2e-3  # lvis, kernel path against plain path
LVIS_FAST_ATOL = 0.05  # lvis, fast against full (the JAX test's own gate)
RENDER_FUSED_ATOL = 2e-3  # neus_render, up-sample chain fused against not
# the untrained SDF renders soft (inv_s = exp(3) = 20), so its composited
# surface point lies up to 0.12 inside the zero level and its normal up to
# 23 degrees off radial at grazing pixels (measured on the CPU at 32x32)
SURF_SDF_ATOL = 0.2  # |sdf(xyz)| on foreground pixels
NORMAL_MAX_DEG = 35.0  # angle between normal.npy and xyz/|xyz|
LIT_COS, LIT_MIN = 0.5, 0.9  # lights with cos > LIT_COS have lvis > LIT_MIN
# peaks of one H100 SXM: HBM bytes/s, fp32 operations/s outside the tensor
# cores (kernels 1 and 2, and the earlier design of kernels 3 and 4), and
# dense TF32 operations/s on the tensor cores. Kernels 3 and 4 split every
# product in three TF32 products to keep fp32's accuracy, so their peak is
# a third of the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
SDF_TF32_PRODUCTS = 3


def _look_at(eye):
    """NeRF-convention camera-to-world (camera looks down -z, y up)."""
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
    return c2w


def write_scene(root, imh, n_views, light_h, n_probes, n_vq, seed, n_train=0):
    """A unit sphere seen from n_views val cameras and n_train train
    cameras, in the reference layout.

    Returns dict(data_root, surf_root, env_dir, vali_dir). lvis is seeded
    uniform noise stored as float16 (the loader casts to float32). With
    n_vq, an empty vis_vali/epoch.../main_<n_vq> directory stands in for a
    training run's."""
    rs = np.random.default_rng(seed)
    n_lights = light_h * 2 * light_h
    data_root = os.path.join(root, "data", "nfr_blender", SCENE)
    vis_root = os.path.join(root, "data", "vis_comps", SCENE)
    surf_root = os.path.join(root, "surf", SCENE)
    angle_x = 0.6
    fl = 0.5 * imh / np.tan(0.5 * angle_x)
    xs, ys = np.meshgrid(np.arange(imh, dtype=np.float64),
                         np.arange(imh, dtype=np.float64))
    dirs = np.stack(((xs - 0.5 * imh) / fl, -(ys - 0.5 * imh) / fl,
                     -np.ones_like(xs)), axis=-1)
    views = [("val_%03d" % i, 2 * np.pi * i / n_views)
             for i in range(n_views)]
    views += [("train_%03d" % i, 2 * np.pi * (i + 0.5) / max(n_train, 1))
              for i in range(n_train)]
    for vid, phi in views:
        eye = 4.0 * np.array([np.cos(phi), np.sin(phi), 0.3])
        c2w = _look_at(eye)
        rayd = dirs @ c2w[:3, :3].T
        b = np.sum(rayd * eye, axis=-1)
        a = np.sum(rayd * rayd, axis=-1)
        disc = b * b - a * (eye @ eye - 1.0)
        hit = disc > 0
        t = (-b - np.sqrt(np.where(hit, disc, 0.0))) / a
        xyz = np.where(hit[..., None], eye + t[..., None] * rayd, eye)
        normal = np.where(hit[..., None], xyz, 0.0)
        shade = np.clip(0.2 + 0.8 * (normal @ (eye / np.linalg.norm(eye))),
                        0, 1)
        rgb = np.clip(shade[..., None] * np.array([0.8, 0.5, 0.3]), 0, 1)
        alpha = hit.astype(np.float64)

        vdir = os.path.join(data_root, vid)
        sdir = os.path.join(surf_root, vid)
        os.makedirs(vdir)
        os.makedirs(sdir)
        vio.write_json({"imh": imh, "imw": imh, "cam_angle_x": angle_x,
                        "cam_transform_mat": ",".join(
                            str(v) for v in c2w.reshape(-1))},
                       os.path.join(vdir, "metadata.json"))
        vio.write_img(np.dstack([rgb, alpha]),
                      os.path.join(vdir, "rgba.png"))
        vio.write_img(alpha, os.path.join(sdir, "alpha.png"))
        vio.write_img(rgb, os.path.join(sdir, "rgb.png"))
        vio.write_img(np.full((imh, imh, 3), [0.6, 0.4, 0.3]),
                      os.path.join(vis_root, vid, "albedo.png"))
        np.save(os.path.join(sdir, "xyz.npy"), xyz.astype(np.float32))
        np.save(os.path.join(sdir, "normal.npy"), normal.astype(np.float32))
        np.save(os.path.join(sdir, "lvis.npy"),
                rs.random((imh, imh, n_lights), np.float32).astype(
                    np.float16))

    env_dir = os.path.join(root, "test_envs")
    for j in range(n_probes):
        vio.write_hdr(os.path.join(env_dir, "probe%02d.hdr" % j),
                      2.0 * rs.random((light_h, 2 * light_h, 3)))
    vali_dir = os.path.join(root, "vis_vali", "epoch000000150")
    if n_vq is not None:
        os.makedirs(os.path.join(vali_dir, "main_%d" % n_vq))
    return {"data_root": data_root, "surf_root": surf_root,
            "env_dir": env_dir, "vali_dir": vali_dir}


def build_models(cfg, seed, device):
    """(ref_nfr, vq_nfr) with random weights from the port's init, chained
    as in training."""
    gen = torch.Generator().manual_seed(seed)
    nfr = init_nfr_unit(gen, cfg)
    centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
    vq, _ = vq_nfr.init_vq_nfr(gen, cfg, nfr, centers)
    ref = init_ref_nfr(gen, cfg, vq, vq.light.detach())
    return ref.to(device), vq.to(device)


def expected_files(cfg, env_dir):
    probe_names, _, olat_names, _ = load_novel_lights(env_dir, cfg.light_h)
    return {
        "raw_test": ["pred_rgb.png", "pred_albedo.png", "pred_albedo.npy",
                     "pred_spec.png", "pred_rough.png", "metadata.json"],
        "pd_test": ["pred_rgb.png", "pred_albedo.png"],
        "pd_relit": ["pred_rgb_probes_%s.png" % n for n in probe_names]
        + ["pred_rgb_olat_%s.png" % n for n in olat_names],
        "pd_vq": ["embed_map.png", "pred_embed.npy"],
    }


def check_outputs(outroot, files, n_views, n_vq):
    for phase, names in files.items():
        for i in range(n_views):
            d = os.path.join(outroot, phase, "batch%09d" % i)
            for f in names:
                if not os.path.exists(os.path.join(d, f)):
                    raise AssertionError(f"missing {phase}/{f} of view {i}")
    arrays = sorted(glob.glob(os.path.join(outroot, "*", "*", "*.npy")))
    for path in arrays:
        if not np.isfinite(np.load(path)).all():
            raise AssertionError(f"non-finite values in {path}")
    for i in range(n_views):
        embed = np.load(os.path.join(outroot, "pd_vq", "batch%09d" % i,
                                     "pred_embed.npy"))
        if embed.min() < 0 or embed.max() > n_vq:
            raise AssertionError(f"embed ids outside [0, {n_vq}]")
    return len(arrays)


def _time_ms(fn, reps=50):
    """Time of one call on a busy queue: one pair of CUDA events around
    ``reps`` calls on end, after a warm-up call. Where the host needs
    longer to issue a call than the card to run it, this is the host's
    time; ``_device_ms`` is the card's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _self_device_us(event):  # the attribute's name differs between versions
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0))


def _device_ms(fn, reps=50):
    """(device time of one call in ms, kernel launches a call): the sum of
    the durations torch.profiler records for the CUDA kernels that ``reps``
    calls of ``fn`` launch, over ``reps``. Host time between the launches
    does not enter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_us = sum(_self_device_us(e) for e in kernels)
    if not device_us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    return device_us / 1e3 / reps, sum(e.count for e in kernels) / reps


def _compare(got, want, what, rtol=RTOL, atol=ATOL):
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {got.numel()} values outside "
            f"rtol={rtol}, atol={atol}; max abs err {float(err.max())}")
    return float(err.max())


def kernel_inputs(vq, cfg, batch, lxyz, lareas):
    """The fused render's inputs as vq_fast_render forms them."""
    _, xyz, surf2c, _, normal_pred, lvis = vq_nfr._geom(batch, cfg, lxyz)
    z_enc, _ = vq_nfr.vq_encode(vq, xyz, cfg)
    _, _, rough, spec, albedo = vq_nfr._decode_main(vq, z_enc, cfg)
    packed = render_kernel.pack_lights(
        lxyz, lareas, dc.get_light(vq).reshape(-1, 3))
    return [t.contiguous() for t in (xyz, normal_pred, surf2c, albedo,
                                     rough, spec, lvis)] + [packed]


def build_kernels():
    """Build the three sources, one nvcc process each, side by side."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=3) as pool:
        jobs = {"render": pool.submit(render_kernel.build),
                "vq": pool.submit(vq_kernel.build),
                "sdf": pool.submit(sdf_kernel.build)}
        built = {name: job.result() for name, job in jobs.items()}
    print("kernel builds: %.3f s for all three sources"
          % (time.perf_counter() - t0))
    for name, (so, log) in built.items():
        print("  %s -> %s" % (name, so.name))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    n_mma = sdf_kernel.tensor_core_instructions(built["sdf"][0])
    print("  sdf: %d tensor-core instructions (HGMMA / HMMA) in cuobjdump "
          "-sass of %s" % (n_mma, built["sdf"][0].name))
    if n_mma <= 0:
        raise AssertionError("the SDF library holds no tensor-core "
                             "instruction")


def _read_log(outdir):
    with open(os.path.join(outdir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_log(outdir, what):
    rows = _read_log(outdir)
    if len(rows) != EPOCHS:
        raise AssertionError(f"{what}: {len(rows)} logged epochs")
    for row in rows:
        bad = [k for k, v in row.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{what}: non-finite {bad} in {row}")
        if row["skipped_steps"] != 0:
            raise AssertionError(f"{what}: skipped steps in {row}")
    return rows


def _check_ckpt(outdir, model, opt_count, ema=None):
    """The latest checkpoint reloads to the tensors of the returned state."""
    state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(outdir))
    if state["epoch"] != EPOCHS:
        raise AssertionError(f"checkpoint of epoch {state['epoch']}")
    for k, v in model.state_dict().items():
        if not torch.equal(state["params"][k], v.cpu()):
            raise AssertionError(f"checkpoint differs from the model at {k}")
    if int(state["opt_state"]["count"]) != opt_count:
        raise AssertionError("optimizer count %d != %d steps"
                             % (int(state["opt_state"]["count"]), opt_count))
    if ema is not None:
        for a, b in zip(state["ema"], ema):
            if not torch.equal(a, b.cpu()):
                raise AssertionError("checkpoint differs from the EMA state")


def train_phase(cfg, paths, root, device):
    """train_nfr_unit then train_vq_nfr; returns what the later phases
    need."""
    train_ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                            data_type="nerf", imh=cfg.imh, mode="train")
    vali_ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                           data_type="nerf", imh=cfg.imh, mode="vali")
    if len(train_ds) != N_TRAIN_VIEWS or len(vali_ds) < N_VALI_VIEWS:
        raise AssertionError("dataset has %d train and %d val views"
                             % (len(train_ds), len(vali_ds)))
    t0 = time.perf_counter()
    train_views = [train_ds.load_view(f) for f in train_ds.files]
    vali_views = [vali_ds.load_view(f)
                  for f in vali_ds.files[:N_VALI_VIEWS]]
    print("views loaded: %.3f s (%d train, %d vali)"
          % (time.perf_counter() - t0, len(train_views), len(vali_views)))
    n_steps = EPOCHS * len(train_views)
    nfr_dir, vq_dir = os.path.join(root, "nfr"), os.path.join(root, "vq")

    torch.cuda.reset_peak_memory_stats()
    vq_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    nfr, nfr_hist = train_loop.train_nfr_unit(
        cfg, train_views, vali_views, nfr_dir, epochs=EPOCHS, seed=SEED,
        device=device)
    torch.cuda.synchronize()
    t_nfr = time.perf_counter() - t0
    if vq_kernel.LAUNCHES != 0:
        raise AssertionError("nfr_unit launched the VQ kernel")
    t0 = time.perf_counter()
    vq, ema, vq_hist = train_loop.train_vq_nfr(
        cfg, nfr, train_views, vali_views, vq_dir, epochs=EPOCHS, seed=SEED,
        device=device)
    torch.cuda.synchronize()
    t_vq = time.perf_counter() - t0
    launches = vq_kernel.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    if launches != n_steps:
        raise AssertionError("the VQ kernel launched %d times in %d vq_nfr "
                             "steps" % (launches, n_steps))

    nfr_rows = _check_log(nfr_dir, "nfr_unit")
    vq_rows = _check_log(vq_dir, "vq_nfr")
    centers = np.load(os.path.join(vq_dir, "cluster_centers.npy"))
    moved = float((vq.codebook.detach().cpu()
                   - torch.from_numpy(centers).T).abs().max())
    if not moved > 0:
        raise AssertionError("the codebook did not move from its k-means "
                             "centres")
    if int(ema.counter) != n_steps:
        raise AssertionError(f"EMA counter {int(ema.counter)} != {n_steps}")
    _check_ckpt(nfr_dir, nfr, n_steps)
    _check_ckpt(vq_dir, vq, n_steps, ema)
    vali_dir = os.path.join(vq_dir, "vis_vali", "epoch%09d" % EPOCHS)
    n_vq = find_vq(vali_dir)
    need = [os.path.join(nfr_dir, "vis_vali", "np_light.npy"),
            os.path.join(nfr_dir, "vis_vali", "pred_light.png"),
            os.path.join(vq_dir, "vis_vali", "np_light.npy"),
            os.path.join(vali_dir, "vq_test_loss.json"),
            os.path.join(vali_dir, "loss.json"),
            os.path.join(vali_dir, "main_%d" % n_vq, "batch%09d" % 0,
                         "pred_vq_rgb.png"),
            os.path.join(vq_dir, "vis_vali", "metas.json")]
    for path in need:
        if not os.path.exists(path):
            raise AssertionError(f"missing {os.path.relpath(path, root)}")
    n_dirs = len(glob.glob(os.path.join(vali_dir, "*", "batch*")))
    if n_dirs != (cfg.num_drop + 1) * len(vali_views):
        raise AssertionError(f"{n_dirs} validation directories")
    sweep = vio.read_json(os.path.join(vali_dir, "vq_test_loss.json"))
    if not np.isfinite(sweep["chromaticity"] + sweep["vqrgb"]).all():
        raise AssertionError("non-finite drop losses")

    print("train_nfr_unit: %.3f s, %d steps, epoch losses %s; epoch wall %s s"
          % (t_nfr, n_steps, nfr_hist, [r["wall_s"] for r in nfr_rows]))
    print("train_vq_nfr: %.3f s, %d steps, epoch losses %s; epoch wall %s s"
          % (t_vq, n_steps, vq_hist, [r["wall_s"] for r in vq_rows]))
    print("  VQ kernel launches %d in %d steps; codebook moved by up to "
          "%.3e; elbow main_%d of %s" % (launches, n_steps, moved, n_vq,
                                         sweep["chromaticity"]))
    print("peak device memory in training: %d bytes (%.3f GiB)"
          % (peak, peak / 2**30))
    return {"vq": vq, "ema": ema, "vali_dir": vali_dir, "n_vq": n_vq,
            "launches": launches, "peak": peak, "train_views": train_views}


def _median_step_ms(step, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def time_steps(cfg, trained, lxyz, lareas, device, profile):
    """One whole vq_nfr step with the kernel and with use_fused_vq=False, on
    copies of the trained model (the trained one is served afterwards)."""
    store = DeviceViewStore(trained["train_views"], device)
    rng = np.random.RandomState(SEED)
    batch = store.gather(0, train_loop.sample_pix(
        trained["train_views"][0], cfg.n_rays_per_step, rng))
    # the host's share of a step before anything is launched: the sampler
    # of each phase, and the gather of the staged view's rows
    view = trained["train_views"][0]
    for mode in ("contrast", "random"):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            pix = train_loop.sample_pix(view, cfg.n_rays_per_step, rng,
                                        jitter_mode=mode)
            times.append(1e3 * (time.perf_counter() - t0))
        print("sample_pix, %s jitter (host, numpy), %dx%d view: %.3f ms "
              "(median of 5)" % (mode, view.h, view.w, np.median(times)))
    print("store.gather of %d rows: %.3f ms (host clock, synchronised, "
          "median of 10)" % (len(pix), _median_step_ms(
              lambda: store.gather(0, pix), 10)))
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    steps = {}
    for name, fused in (("kernel", None), ("eager", False)):
        c = dc.DecompConfig(epochs=EPOCHS, use_fused_vq=fused)
        model = copy.deepcopy(trained["vq"])
        _, fn = dt.make_vq_nfr_step(model, c, lxyz, lareas)
        state = {"ema": trained["ema"]}

        def step(fn=fn, state=state):
            state["ema"], _ = fn(state["ema"], batch, thres, gen, 8)
        for _ in range(3):
            step()
        steps[name] = step
    ms = {"kernel": [], "eager": []}
    for name in ("kernel", "eager", "eager", "kernel"):
        ms[name].append(_median_step_ms(steps[name], 10))
    print("one vq_nfr step (%d rows x %d lights, host clock, synchronised, "
          "medians of 10 in the order kernel, eager, eager, kernel): with "
          "the kernel %s ms, with use_fused_vq=False %s ms"
          % (2 * cfg.n_rays_per_step, cfg.n_lights,
             ["%.3f" % t for t in ms["kernel"]],
             ["%.3f" % t for t in ms["eager"]]))
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                steps["kernel"]()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print("profile of 10 vq_nfr steps with the kernel, %.3f s wall:"
              % wall)
        averages = prof.key_averages()
        print(averages.table(sort_by="cuda_time_total", row_limit=25,
                             max_name_column_width=60))
        from torch.autograd import DeviceType
        kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
        device_us = sum(_self_device_us(e) for e in kernels)
        print("device busy %.3f ms of %.3f ms wall under the profiler: idle "
              "share %.3f" % (device_us / 1e3, 1e3 * wall,
                              1 - device_us / 1e6 / wall))
        for e in kernels:
            if "vq_" in e.key:
                print("  %s: %d launches, %.2f us of device time each"
                      % (e.key[:60], e.count, _self_device_us(e) / e.count))
    return float(np.mean(ms["kernel"])), float(np.mean(ms["eager"]))


def vq_kernel_inputs(trained, cfg, n, k, drop, device):
    """vq_fused_train's arguments from the trained model: z_norm of n rows
    of a train view, strided over the whole view so that background rows
    are in, the model's codebook (its first k codes), the trained EMA
    state, and a usable-code mask with or without dropped codes."""
    view = trained["train_views"][0]
    rows = np.linspace(0, view.xyz.shape[0] - 1, n).astype(np.int64)
    xyz = torch.as_tensor(view.xyz[rows], device=device)
    rowmask = torch.as_tensor(view.alpha[rows, 0] > 0, device=device).to(
        torch.float32)
    vq, ema = trained["vq"], trained["ema"]
    _, z_norm = vq_nfr.vq_encode(vq, xyz, cfg)
    cb = dc.get_codebook(vq)[:, :k].contiguous()
    sel = torch.ones((k,), device=device)
    if drop:
        sel[k - k // 3:] = 0.0
    return [cb, z_norm.contiguous(), rowmask, sel,
            ema.hidden_cluster_size[:k].contiguous(),
            ema.hidden_dw[:, :k].contiguous(),
            (ema.counter + 1).to(torch.float32)]


def compare_vq_kernel(out, args, kw, what):
    """The two-stage comparison of vq_fused_train with its plain version
    (see the module docstring). Returns (max abs err of stage (ii), rows
    whose index differs, rows that are near-ties)."""
    cb, x, _, sel = args[:4]
    plain = vq_kernel.vq_fused_train_reference(*args, **kw)
    dist = (torch.sum(x * x, 1, keepdim=True) - 2.0 * (x @ cb)
            + torch.sum(cb * cb, 0, keepdim=True))
    dist = torch.where(sel[None] > 0, dist,
                       torch.full_like(dist, vq_kernel.BIG))
    two = torch.topk(dist, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) < VQ_TIE_GAP
    differ = out["indices"] != plain["indices"]
    n = x.shape[0]
    if (differ & ~near).any():
        raise AssertionError(
            f"{what}: {int((differ & ~near).sum())} of {n} indices differ "
            "from the plain version's on rows that are no near-tie")
    if int(near.sum()) > VQ_TIE_SHARE * n:
        raise AssertionError(f"{what}: {int(near.sum())} of {n} rows are "
                             "near-ties, too many for the comparison")
    if not 0 <= int(out["indices"].min()) <= int(out["indices"].max()) < \
            cb.shape[1]:
        raise AssertionError(f"{what}: index out of range")
    fed = vq_kernel.vq_fused_train_reference(
        *[a.double() for a in args], **kw, indices=out["indices"])
    worst = 0.0
    for key in ("quantized", "counts", "hidden_cs", "hidden_dw", "update"):
        got, want = out[key].double(), fed[key]
        err = (got - want).abs()
        if not torch.isfinite(got).all() or \
                (err > VQ_ATOL + VQ_RTOL * want.abs()).any():
            raise AssertionError(
                f"{what}: {key} outside rtol={VQ_RTOL}, atol={VQ_ATOL} of "
                f"the plain version fed the kernel's indices; max abs err "
                f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    return worst, int(differ.sum()), int(near.sum())


def check_render_kernel(vq, cfg, view, lxyz, lareas, device):
    """Kernel 1 against its plain version; returns the kernels-line entry
    without its launch count."""
    batch = {k: torch.as_tensor(x, device=device)
             for k, x in view.as_batch().items() if k != "ref"}
    # a chunk through the middle rows of the view, where the sphere is
    chunk = {k: v[2 * _RAY_CHUNK:3 * _RAY_CHUNK] for k, v in batch.items()}
    args = kernel_inputs(vq, cfg, chunk, lxyz, lareas)
    ragged = [a[:RAGGED_N] for a in args[:6]] + [None, args[7]]
    # the same chunk with an lvis whose base is 4 bytes off a 16-byte
    # boundary, and with 510 lights: both must take the scalar instance
    flat = torch.empty((args[6].numel() + 1,), device=device)
    shifted = args[:6] + [flat[1:].view_as(args[6]).copy_(args[6]), args[7]]
    fewer = args[:6] + [args[6][:, :510].contiguous(),
                        args[7][:, :510].contiguous()]
    err = 0.0
    for what, a, instance in (
            ("chunk %dx%d" % (_RAY_CHUNK, cfg.n_lights), args, "vector"),
            ("ragged %d, no lvis" % RAGGED_N, ragged, "vector"),
            ("chunk, lvis 4 bytes off alignment", shifted, "scalar"),
            ("chunk, 510 lights", fewer, "scalar")):
        before = dict(render_kernel.LAUNCHES_BY_INSTANCE)
        got = render_kernel.fused_brdf_render(*a)
        want = render_kernel.fused_brdf_render_reference(*a)
        torch.cuda.synchronize()
        before[instance] += 1
        if render_kernel.LAUNCHES_BY_INSTANCE != before:
            raise AssertionError(f"{what}: not the {instance} instance")
        e = _compare(got, want, what)
        print("fused_brdf_render vs plain version, %s (%s instance): max "
              "abs err %.3e" % (what, instance, e))
        err = max(err, e)
    del flat, shifted, fewer

    fused = vq_nfr.vq_fast_render(vq, chunk, cfg, lxyz, lareas)
    eager = vq_nfr.vq_fast_render(
        vq, chunk, dc.DecompConfig(use_fused_render=False), lxyz, lareas)
    e = _compare(fused["rgb"], eager["rgb"], "vq_fast_render fused/eager")
    print("vq_fast_render rgb, fused vs eager: max abs err %.3e" % e)

    n, l = _RAY_CHUNK, cfg.n_lights
    no_lvis = args[:6] + [None, args[7]]
    ms = _time_ms(lambda: render_kernel.fused_brdf_render(*args))
    device_ms, per_call = _device_ms(
        lambda: render_kernel.fused_brdf_render(*args))
    null_ms, _ = _device_ms(
        lambda: render_kernel.fused_brdf_render(*no_lvis))
    plain_ms = _time_ms(
        lambda: render_kernel.fused_brdf_render_reference(*args), reps=7)
    # every input read once, the output written once; about 60 fp32
    # operations per ray-light pair (the count in the kernel's source)
    nbytes = 4 * (n * (5 * 3 + 1) + n * l + 8 * l + n * 3)
    ops = 60 * n * l
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    print("fused_brdf_render at %d rays x %d lights: %.4f ms a call (events "
          "around 50 calls), %.4f ms of device time a call in %.1f launches "
          "(torch.profiler), %.4f ms of device time with lvis=None; plain "
          "version %.4f ms; bound %.4f ms (%d bytes: %.4f ms; %d operations: "
          "%.4f ms): %.1f%% of it by device time"
          % (n, l, ms, device_ms, per_call, null_ms, plain_ms, bound_ms,
             nbytes, bytes_ms, ops, ops_ms, 100 * bound_ms / device_ms))
    floors = render_issue_floors(n * l)
    floor_ms = floors[("vector", True)]
    print("  the main path's instance (vector, with lvis): %.1f%% of its "
          "issue floor of %.4f ms by device time"
          % (100 * floor_ms / device_ms, floor_ms))
    return {
        "name": "fused_brdf_render", "route": "cuda",
        "source": "vqnerf_release_torch/csrc/render_kernel.cu",
        "replaces": "vqnerf_release_tpu/ops/pallas/render_kernel.py:133",
        "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "device_ms_without_lvis": null_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "issue_floor_ms": floor_ms,
        "library_ms": None,  # no single PyTorch call computes it
    }


def render_issue_floors(pairs):
    """The issue floor of the render kernel's light loop, from the machine
    code of the built library: for each instance of the kernel, the
    instructions of its innermost loop that holds MUFU.RSQ, over the
    ray-light pairs of one pass of that loop (a pair takes five MUFU: two
    reciprocal square roots, a square root, two reciprocals), times
    pairs / 32 warp-instructions, over what the card's warp schedulers can
    issue: SMs x 4 a clock at the card's highest SM clock (which 20,000
    launches on end hold: tests/test_torch_cuda.py::
    test_render_kernel_clock_under_load). Returns {(instance, with lvis):
    ms}; fails unless the vector instances read lvis and the light table 16
    bytes at a time."""
    so, _ = render_kernel.build()
    props = torch.cuda.get_device_properties(0)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    issue_per_s = props.multi_processor_count * 4 * mhz * 1e6
    functions = kbuild.sass_functions(so)
    floors = {}
    for key, mangled in render_kernel.SASS_NAMES.items():
        (instructions,) = [ins for name, ins in functions.items()
                           if mangled in name]
        loop = kbuild.sass_inner_loop(instructions, "MUFU.RSQ")
        count = lambda pattern: sum(  # noqa: E731
            bool(re.search(pattern, text)) for text in loop)
        loop_pairs = count("MUFU") / render_kernel.MUFU_PER_PAIR
        if loop_pairs == 0:
            raise AssertionError(f"no light loop in the SASS of {mangled}")
        per_pair = len(loop) / loop_pairs
        floors[key] = 1e3 * pairs / 32 * per_pair / issue_per_s
        wide = (count(r"LDG\.E\.(\w+\.)*128"), count(r"LDS\.128"))
        print("  SASS of the %s instance, lvis %s: %d instructions in all; "
              "light loop %d instructions for %g pairs a lane (%.1f a pair; "
              "MUFU %d, LDG %d of which 16-byte %d, LDS %d of which 16-byte "
              "%d, FFMA %d); issue floor at %d SMs x 4 schedulers x %.0f "
              "MHz: %.4f ms"
              % (key[0], "given" if key[1] else "None", len(instructions),
                 len(loop), loop_pairs, per_pair, count("MUFU"),
                 count("LDG"), wide[0], count("LDS"), wide[1],
                 count("FFMA"), props.multi_processor_count, mhz,
                 floors[key]))
        if key[0] == "vector" and (wide[1] < 7 or (key[1] and wide[0] < 1)):
            raise AssertionError("the vector instance holds no 16-byte "
                                 "loads of lvis or of the light table")
    return floors


def check_vq_kernel(trained, cfg, device):
    """Kernel 2 against its plain version; returns the kernels-line entry
    without its launch count."""
    kw = dict(decay=cfg.vq_decay, epsilon=1e-5)
    err = 0.0
    n_step, k_all = 2 * cfg.n_rays_per_step, cfg.num_embed
    k_small = min(8, k_all)  # the reduced presets' codebook
    for n, k, drop in ((n_step, k_all, True), (n_step, k_all, False),
                       (65536, k_all, True), (RAGGED_N, k_all, True),
                       (n_step, k_small, True), (RAGGED_N, k_small, False)):
        args = vq_kernel_inputs(trained, cfg, n, k, drop, device)
        what = "N %d, K %d, %s" % (n, k, "dropped codes" if drop
                                   else "all codes")
        out = vq_kernel.vq_fused_train(*args, **kw)
        again = vq_kernel.vq_fused_train(*args, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(out[key], again[key]) for key in out):
            raise AssertionError(f"{what}: two launches disagree")
        e, differ, near = compare_vq_kernel(out, args, kw, what)
        print("vq_fused_train vs plain version, %s: (i) %d indices differ, "
              "%d of %d rows near-ties (gap < %g); (ii) max abs err %.3e "
              "(rtol %g, atol %g, float64 plain version fed the kernel's "
              "indices); foreground rows %d"
              % (what, differ, near, n, VQ_TIE_GAP, e, VQ_RTOL, VQ_ATOL,
                 int(args[2].sum())))
        err = max(err, e)

    n, d, k = n_step, cfg.z_dim, k_all
    args = vq_kernel_inputs(trained, cfg, n, k, True, device)
    ms = _time_ms(lambda: vq_kernel.vq_fused_train(*args, **kw), reps=200)
    device_ms, per_call = _device_ms(
        lambda: vq_kernel.vq_fused_train(*args, **kw), reps=200)
    plain_ms = _time_ms(
        lambda: vq_kernel.vq_fused_train_reference(*args, **kw), reps=31)
    # x, rowmask, sel, cb, hcs, hdw, counter read once; indices, quantized,
    # counts, hidden_cs, hidden_dw, update written once. Distances and dw
    # are 2 N D K operations each.
    nbytes = 4 * (n * d + n + k + d * k + k + d * k + 1
                  + n + n * d + k + k + 2 * d * k)
    ops = 4 * n * d * k
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / FP32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    if per_call != 1:
        raise AssertionError("vq_fused_train is %.2f CUDA launches a call"
                             % per_call)
    print("vq_fused_train at %d x %d x %d: %.4f ms a call (events around 200 "
          "calls), %.5f ms of device time a call in %.1f CUDA launches "
          "(torch.profiler); plain version %.4f ms; bound %.5f ms (%d bytes: "
          "%.5f ms; %d operations: %.5f ms): %.1f%% of it by device time"
          % (n, d, k, ms, device_ms, per_call, plain_ms, bound_ms, nbytes,
             bytes_ms, ops, ops_ms, 100 * bound_ms / device_ms))
    big = vq_kernel_inputs(trained, cfg, 65536, k, True, device)
    big_ms, _ = _device_ms(lambda: vq_kernel.vq_fused_train(*big, **kw),
                           reps=20)
    print("  at 65536 x %d x %d: %.5f ms of device time a call" % (d, k,
                                                                   big_ms))
    return {
        "name": "vq_fused_train", "route": "cuda",
        "source": "vqnerf_release_torch/csrc/vq_kernel.cu",
        "replaces": "vqnerf_release_tpu/ops/pallas/vq_kernel.py:136",
        "max_abs_err": err, "ms": ms, "device_ms": device_ms,
        "cuda_launches_per_call": per_call, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes it
    }


def write_stage1_scene(root, imh, n_train, n_val, seed):
    """A NeRF-convention stage-1 scene: transforms_{train,val}.json and a
    16-bit rgba.png per view, cameras on a circle of radius 2 (height 0.3)
    looking at the origin. The alpha channel is the silhouette of a sphere
    of radius GEO_GT_RADIUS, inside the rendered silhouette of the
    geometric-init SDF (whose soft density composites to a radius of about
    0.38)."""
    rs = np.random.default_rng(seed)
    angle_x = 0.8
    fl = 0.5 * imh / np.tan(0.5 * angle_x)
    xs, ys = np.meshgrid(np.arange(imh, dtype=np.float64),
                         np.arange(imh, dtype=np.float64))
    dirs = np.stack(((xs - imh // 2) / fl, -(ys - imh // 2) / fl,
                     -np.ones_like(xs)), axis=-1)
    for mode, n in (("train", n_train), ("val", n_val)):
        frames = []
        for i in range(n):
            ang = 2 * np.pi * (i + (0.5 if mode == "val" else 0.0)) / max(n, 1)
            eye = np.array([2.0 * np.sin(ang), 0.3, 2.0 * np.cos(ang)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
            c2w[:3, 2], c2w[:3, 3] = -fwd, eye
            frames.append({"transform_matrix": c2w.tolist()})
            rayd = dirs @ c2w[:3, :3].T
            rayd /= np.linalg.norm(rayd, axis=-1, keepdims=True)
            b = rayd @ eye
            hit = b * b - (eye @ eye - GEO_GT_RADIUS**2) > 0
            rgba = np.empty((imh, imh, 4))
            rgba[..., :3] = np.where(hit[..., None], [0.8, 0.5, 0.3], 1.0) \
                * (0.9 + 0.1 * rs.random((imh, imh, 1)))
            rgba[..., 3] = hit
            d = os.path.join(root, "%s_%03d" % (mode, i))
            os.makedirs(d)
            vio.write_png(os.path.join(d, "rgba.png"),
                          (rgba * 65535).astype(np.uint16))
        vio.write_json({"camera_angle_x": angle_x, "frames": frames},
                       os.path.join(root, "transforms_%s.json" % mode))
    return root


def check_geo_view(view_dir, model, cfg, lxyz, gt_mask, device):
    """The written buffers of one extracted view against the geometric-init
    sphere; returns a dict of what was measured."""
    for f in gen_geo.VIEW_FILES_CG:
        if not os.path.exists(os.path.join(view_dir, f)):
            raise AssertionError(f"missing {f} in {view_dir}")
    xyz = np.load(os.path.join(view_dir, "xyz.npy"))
    normal = np.load(os.path.join(view_dir, "normal.npy"))
    lvis = np.load(os.path.join(view_dir, "lvis.npy"))
    alpha = vio.read_png(os.path.join(view_dir, "alpha.png"))
    for name, arr in (("xyz", xyz), ("normal", normal), ("lvis", lvis)):
        if not np.isfinite(arr).all():
            raise AssertionError(f"non-finite {name} in {view_dir}")
    if lvis.shape != xyz.shape[:2] + (lxyz.shape[0],):
        raise AssertionError(f"lvis shape {lvis.shape}")
    if lvis.min() < 0.0 or lvis.max() > 1.0:
        raise AssertionError("lvis outside [0, 1]")
    fg = alpha > 0
    if gt_mask is not None:  # lvis of a train view covers the GT mask
        fg &= gt_mask > 0
    if fg.sum() < 0.1 * fg.size:
        raise AssertionError(f"only {int(fg.sum())} foreground pixels")
    p = xyz[fg]
    with torch.no_grad():
        sdf = fields.sdf_only(model.sdf, torch.as_tensor(p, device=device),
                              cfg.sdf).abs().cpu().numpy()
    radial = p / np.linalg.norm(p, axis=-1, keepdims=True)
    n = normal[fg]
    deg = np.degrees(np.arccos(np.clip(np.sum(n * radial, -1), -1, 1)))
    s2l = lxyz[None] - p[:, None]
    s2l /= np.linalg.norm(s2l, axis=-1, keepdims=True)
    cos = np.einsum("plk,pk->pl", s2l, n)
    lv = lvis[fg]
    lit = lv[cos > LIT_COS]
    if sdf.max() > SURF_SDF_ATOL:
        raise AssertionError(f"|sdf(xyz)| up to {sdf.max()} on foreground")
    if deg.max() > NORMAL_MAX_DEG:
        raise AssertionError(f"normals up to {deg.max()} deg off radial")
    if lit.min() < LIT_MIN:
        raise AssertionError(f"front-lit lvis down to {lit.min()}")
    if (lv[cos < -1e-4] != 0).any():
        raise AssertionError("lvis of a back-facing light is not 0")
    return {"fg": int(fg.sum()), "sdf_max": float(sdf.max()),
            "deg_max": float(deg.max()), "lit_min": float(lit.min()),
            "radius_mean": float(np.linalg.norm(p, axis=-1).mean())}


def extraction_phase(root, device, profile=False):
    """Stage-1 geometry extraction through run_gen_geo, its checks, and the
    lvis and render comparisons; returns what the kernel checks need."""
    data_root = write_stage1_scene(
        os.path.join(root, "stage1", GEO_SCENE), GEO_IMH, GEO_TRAIN_VIEWS,
        GEO_VAL_VIEWS, SEED)
    out_root = os.path.join(root, "stage1_out")
    print("extraction cuts: %d train + %d val views of %dx%d; widths, the "
          "64+64r4 sampler and the 512 lights are the defaults"
          % (GEO_TRAIN_VIEWS, GEO_VAL_VIEWS, GEO_IMH, GEO_IMH))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in sdf_kernel.LAUNCHES:
        sdf_kernel.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    done = gen_geo.run_gen_geo(GEO_SCENE, data_root, out_root, seed=SEED,
                               near=GEO_NEAR, far=GEO_FAR, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sdf_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if min(launches.values()) <= 0:
        raise AssertionError(f"extraction launched {launches}")
    if (len(done["train"]), len(done["val"])) != (GEO_TRAIN_VIEWS,
                                                  GEO_VAL_VIEWS):
        raise AssertionError(f"extracted {done}")

    # the model and dataset that run_gen_geo built, rebuilt for the checks
    cfg, tcfg, meta = gen_geo.vcfg.neus_configs_for_scene(
        GEO_SCENE, n_samples=64, n_importance=64, up_sample_steps=4,
        occ_res=0)
    if cfg != NeuSConfig(perturb=cfg.perturb):
        raise AssertionError(f"not the default NeuS widths: {cfg}")
    model = init_neus(SEED, cfg).to(device)
    ds = NerfSceneDataset(data_root, is_train=True, near=GEO_NEAR,
                          far=GEO_FAR)
    ex = gen_geo.GeoExtractor(model, cfg, ds, os.path.join(root, "unused"),
                              fast_vis=True, device=device)
    lxyz = ex.lxyz.cpu().numpy()
    n_fg = 0
    for mode in ("train", "val"):
        for i, view_dir in enumerate(done[mode]):
            gt = ds.masks[i][..., 0] if mode == "train" else None
            got = check_geo_view(view_dir, model, cfg, lxyz, gt, device)
            n_fg += got["fg"]
            print("  %s: %s" % (os.path.basename(view_dir), got))
    print("run_gen_geo: %.3f s for %d views (%.3f s a view), %d foreground "
          "pixels x %d lights = %d shadow rays; kernel launches %s; peak "
          "device memory %d bytes (%.3f GiB)"
          % (seconds, GEO_TRAIN_VIEWS + GEO_VAL_VIEWS,
             seconds / (GEO_TRAIN_VIEWS + GEO_VAL_VIEWS), n_fg, ex.n_lights,
             n_fg * ex.n_lights, launches, peak, peak / 2**30))
    print("  host-clock seconds by phase, each closed where the host waits "
          "for the device: %s"
          % {k: round(v, 3) for k, v in done["seconds"].items()})

    # lvis on a few hundred foreground points: full through the kernels,
    # fast, and full on the plain path
    xyz = np.load(os.path.join(done["val"][0], "xyz.npy"))
    normal = np.load(os.path.join(done["val"][0], "normal.npy"))
    fg = vio.read_png(os.path.join(done["val"][0], "alpha.png")) > 0
    pick = np.linspace(0, fg.sum() - 1, LVIS_POINTS).astype(np.int64)
    surf_fg, normal_fg = xyz[fg][pick], normal[fg][pick]
    before = dict(sdf_kernel.LAUNCHES)
    t0 = time.perf_counter()
    full = ex._lvis_full(surf_fg, normal_fg)
    t_full = time.perf_counter() - t0
    mid = dict(sdf_kernel.LAUNCHES)
    t0 = time.perf_counter()
    fast = ex._lvis_fast(surf_fg, normal_fg)
    t_fast = time.perf_counter() - t0
    ex_plain = gen_geo.GeoExtractor(
        model, cfg, ds, os.path.join(root, "unused"), use_fused_sdf=False,
        vis_point_batch=16, device=device)
    after = dict(sdf_kernel.LAUNCHES)
    t0 = time.perf_counter()
    plain = ex_plain._lvis_full(surf_fg, normal_fg)
    t_plain = time.perf_counter() - t0
    if sdf_kernel.LAUNCHES != after:
        raise AssertionError("use_fused_sdf=False launched an SDF kernel")
    n_batches = -(-LVIS_POINTS // ex.vis_point_batch) * (ex.n_lights
                                                         // ex.light_tile)
    want = {"sdf_fwd": before["sdf_fwd"] + 4 * n_batches,
            "sdf_fwdgrad": before["sdf_fwdgrad"] + n_batches}
    if mid != want:
        raise AssertionError(f"_lvis_full launched {mid}, expected {want}")
    e_kernel = float(np.abs(full - plain).max())
    e_fast = float(np.abs(fast - full).max())
    print("lvis of %d points x %d lights: kernel path against plain path max "
          "|diff| %.3e (tolerance %g); fast against full %.3e (tolerance "
          "%g); %.3f s full with the kernels, %.3f s fast, %.3f s full on "
          "the plain path"
          % (LVIS_POINTS, ex.n_lights, e_kernel, LVIS_KERNEL_ATOL, e_fast,
             LVIS_FAST_ATOL, t_full, t_fast, t_plain))
    print("  last_fast_vis_stats:", ex.last_fast_vis_stats)
    if e_kernel > LVIS_KERNEL_ATOL or e_fast > LVIS_FAST_ATOL:
        raise AssertionError("lvis paths disagree")

    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as tprofile
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex._lvis_fast(surf_fg, normal_fg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        averages = prof.key_averages()
        print("profile of _lvis_fast on %d points x %d lights, %.3f s wall:"
              % (LVIS_POINTS, ex.n_lights, wall))
        print(averages.table(sort_by="cuda_time_total", row_limit=12,
                             max_name_column_width=60))
        device_us = sum(_self_device_us(e) for e in averages
                        if e.device_type == DeviceType.CUDA)
        print("device busy %.3f ms of %.3f ms wall under the profiler: idle "
              "share %.3f" % (device_us / 1e3, 1e3 * wall,
                              1 - device_us / 1e6 / wall))

    # neus_render once with the up-sample chain through the kernel, once not
    ro, rd = ds.gen_rays_at(0)
    rows = slice(GEO_IMH // 2 * GEO_IMH, GEO_IMH // 2 * GEO_IMH + 2048)
    ro, rd = ro.reshape(-1, 3)[rows], rd.reshape(-1, 3)[rows]
    near, far = ds.near_far(ro, rd)
    args = [torch.as_tensor(x, device=device) for x in (ro, rd, near, far)]
    before = sdf_kernel.LAUNCHES["sdf_fwd"]
    with torch.no_grad():
        r_fused = neus_render(model, cfg, *args, ex.radius,
                              cos_anneal_ratio=1.0, use_fused_sdf=True)
        if sdf_kernel.LAUNCHES["sdf_fwd"] != before + cfg.up_sample_steps:
            raise AssertionError("neus_render did not launch sdf_fwd")
        r_plain = neus_render(model, cfg, *args, ex.radius,
                              cos_anneal_ratio=1.0, use_fused_sdf=False)
    errs = {k: float((r_fused[k] - r_plain[k]).abs().max())
            for k in ("color_fine", "weight_sum", "surf")}
    print("neus_render of 2048 rays, up-sample chain fused against plain: "
          "max |diff| %s (tolerance %g)" % (errs, RENDER_FUSED_ATOL))
    if max(errs.values()) > RENDER_FUSED_ATOL:
        raise AssertionError("neus_render fused / plain disagree")
    return {"ex": ex, "model": model, "cfg": cfg, "launches": launches,
            "seconds": seconds, "peak": peak,
            "surf_fg": xyz[fg], "normal_fg": normal[fg]}


def shadow_ray_points(ex, surf_fg, n_rays, n_samples, device):
    """The points that the shadow pass gives the SDF kernels: n_rays rays
    from foreground points toward the lights, n_samples uniform samples
    each between the pass's near and far."""
    rs = np.random.RandomState(SEED)
    o = torch.as_tensor(surf_fg[rs.randint(0, len(surf_fg), n_rays)],
                        device=device)
    d = ex.lxyz[torch.as_tensor(rs.randint(0, ex.n_lights, n_rays),
                                device=device)] - o
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    near, far = ex._near_far(o, d)
    z = near + (far - near) * torch.linspace(0.0, 1.0, n_samples,
                                             device=device)[None]
    return (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3).contiguous()


def _sdf_bound(packed, n, with_grad):
    """(bound ms, by what, bytes, operations, CUDA-core bound ms): points
    read once, the packed weights read once, outputs written once; the
    operations of flops_per_point, each product taken three times at the
    TF32 tensor-core peak, which is the route the kernel takes. The last
    value is the same operations once at the fp32 CUDA-core peak, the
    bound of the design before this one."""
    nbytes = 4 * (3 * n + packed.buffer.numel() + n * (4 if with_grad else 1))
    ops = sdf_kernel.flops_per_point(packed, with_grad) * n
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * SDF_TF32_PRODUCTS * ops / TF32_OPS_PER_S
    cuda_core_ms = max(bytes_ms, 1e3 * ops / FP32_OPS_PER_S)
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops,
            cuda_core_ms)


def check_sdf_kernels(geo, device):
    """Kernels 3 and 4 against their plain versions and autograd; returns
    their two kernels-line entries without the launch counts."""
    ex, model, cfg = geo["ex"], geo["model"], geo["cfg"]
    packed = ex._packed
    pts_fwd = shadow_ray_points(ex, geo["surf_fg"], SDF_RAYS, cfg.n_samples,
                                device)
    pts_grad = shadow_ray_points(ex, geo["surf_fg"], SDF_RAYS,
                                 cfg.n_samples + cfg.n_importance, device)
    scaled_cfg = fields.SDFConfig(scale=2.0)
    scaled = fields.init_sdf(SEED + 1, scaled_cfg).to(device)
    scaled_packed = sdf_kernel.pack_sdf(scaled, scaled_cfg)

    err_fwd = 0.0
    for what, pk, pts in (
            ("N %d" % len(pts_fwd), packed, pts_fwd),
            ("ragged N %d" % SDF_RAGGED_N, packed, pts_fwd[:SDF_RAGGED_N]),
            ("scale 2, N %d" % (4096 + 5), scaled_packed,
             pts_fwd[:4096 + 5])):
        got = sdf_kernel.sdf_fwd(pk, pts)
        again = sdf_kernel.sdf_fwd(pk, pts)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"sdf_fwd, {what}: two launches disagree")
        e = _compare(got, sdf_kernel.sdf_fwd_plain(pk, pts),
                     "sdf_fwd, " + what, SDF_RTOL, SDF_ATOL)
        print("sdf_fwd vs plain version, %s: max abs err %.3e (rtol %g, atol "
              "%g)" % (what, e, SDF_RTOL, SDF_ATOL))
        err_fwd = max(err_fwd, e)

    err_grad = 0.0
    for what, pk, net, net_cfg, pts in (
            ("N %d" % len(pts_grad), packed, model.sdf, cfg.sdf, pts_grad),
            ("ragged N %d" % SDF_RAGGED_N, packed, model.sdf, cfg.sdf,
             pts_grad[:SDF_RAGGED_N]),
            ("scale 2, N %d" % (4096 + 5), scaled_packed, scaled, scaled_cfg,
             pts_grad[:4096 + 5])):
        sdf, grad = sdf_kernel.sdf_fwdgrad(pk, pts)
        sdf2, grad2 = sdf_kernel.sdf_fwdgrad(pk, pts)
        torch.cuda.synchronize()
        if not (torch.equal(sdf, sdf2) and torch.equal(grad, grad2)):
            raise AssertionError(f"sdf_fwdgrad, {what}: two launches "
                                 "disagree")
        want_sdf, want_grad = sdf_kernel.sdf_fwdgrad_plain(pk, pts)
        e = max(_compare(sdf, want_sdf, "sdf_fwdgrad sdf, " + what,
                         SDF_RTOL, SDF_ATOL),
                _compare(grad, want_grad, "sdf_fwdgrad grad, " + what,
                         SDF_RTOL, SDF_ATOL))
        del want_sdf, want_grad
        auto = torch.cat([fields.sdf_gradient(net, chunk, net_cfg)
                          for chunk in torch.split(pts, 131072)])
        e_auto = _compare(grad, auto, "sdf_fwdgrad grad vs autograd, " + what,
                          SDF_AUTO_RTOL, SDF_AUTO_ATOL)
        print("sdf_fwdgrad vs plain version, %s: max abs err %.3e (rtol %g, "
              "atol %g); grad vs autograd fields.sdf_gradient %.3e (rtol %g, "
              "atol %g)" % (what, e, SDF_RTOL, SDF_ATOL, e_auto,
                            SDF_AUTO_RTOL, SDF_AUTO_ATOL))
        err_grad = max(err_grad, e)

    entries = []
    for name, with_grad, pts, err, line in (
            ("sdf_fwd", False, pts_fwd, err_fwd, 141),
            ("sdf_fwdgrad", True, pts_grad, err_grad, 236)):
        fn = sdf_kernel.sdf_fwdgrad if with_grad else sdf_kernel.sdf_fwd
        plain = (sdf_kernel.sdf_fwdgrad_plain if with_grad
                 else sdf_kernel.sdf_fwd_plain)
        n = len(pts)
        ms = _time_ms(lambda: fn(packed, pts), reps=5)
        device_ms, _ = _device_ms(lambda: fn(packed, pts), reps=5)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        plain_ms = _time_ms(lambda: plain(packed, pts), reps=5)
        plain_peak = torch.cuda.max_memory_allocated() - base
        bound_ms, by, nbytes, ops, cuda_core_ms = _sdf_bound(packed, n,
                                                             with_grad)
        print("%s at %d points: kernel %.4f ms a call, %.4f ms of device "
              "time, plain version %.4f ms (%.3f "
              "GiB of temporaries), bound %.4f ms by %s (%d bytes; %d "
              "operations, each product as %d TF32 products at %.0f "
              "TFLOP/s): %.1f%% of the split-TF32 tensor-core peak; the "
              "fp32 CUDA-core bound is %.4f ms (%.1f%% of that peak)"
              % (name, n, ms, device_ms, plain_ms, plain_peak / 2**30,
                 bound_ms, by, nbytes, ops, SDF_TF32_PRODUCTS,
                 TF32_OPS_PER_S / 1e12, 100 * bound_ms / device_ms,
                 cuda_core_ms, 100 * cuda_core_ms / device_ms))
        entries.append({
            "name": name, "route": "cuda",
            "source": "vqnerf_release_torch/csrc/sdf_kernel.cu",
            "replaces": "vqnerf_release_tpu/ops/pallas/sdf_kernel.py:%d"
            % line,
            "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "bound_peak": "tensor cores, TF32 / %d" % SDF_TF32_PRODUCTS,
            "bound_cuda_cores_ms": cuda_core_ms,
            "library_ms": None,  # no single PyTorch call computes it
        })
    return entries


def main():
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print("device:", name, flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("nvidia-smi:", smi, flush=True)

    build_kernels()

    cfg = dc.DecompConfig(epochs=EPOCHS)
    print("cuts: %d train views, %d validation view, %d epochs per phase, "
          "%d served views; every width is DecompConfig's default"
          % (N_TRAIN_VIEWS, N_VALI_VIEWS, EPOCHS, N_VIEWS))
    with tempfile.TemporaryDirectory(prefix="vqnerf_smoke_") as root:
        t0 = time.perf_counter()
        paths = write_scene(root, cfg.imh, N_VIEWS, cfg.light_h, N_PROBES,
                            None, SEED, n_train=N_TRAIN_VIEWS)
        print("scene written: %.3f s" % (time.perf_counter() - t0), flush=True)

        # ---- the training half of the main path ---------------------------
        trained = train_phase(cfg, paths, os.path.join(root, "train"), device)
        vq, n_vq = trained["vq"], trained["n_vq"]
        sys.stdout.flush()

        # ---- the serving half, with the trained model ---------------------
        ref = init_ref_nfr(torch.Generator().manual_seed(SEED), cfg,
                           copy.deepcopy(vq).cpu(),
                           vq.light.detach().cpu()).to(device)
        ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                          data_type="nerf", imh=cfg.imh, mode="test",
                          with_ref=True)
        if len(ds) != N_VIEWS:
            raise AssertionError(f"dataset has {len(ds)} views")
        outroot = os.path.join(root, "vis_test")

        torch.cuda.reset_peak_memory_stats()
        render_kernel.LAUNCHES = 0
        for key in render_kernel.LAUNCHES_BY_INSTANCE:
            render_kernel.LAUNCHES_BY_INSTANCE[key] = 0
        t0 = time.perf_counter()
        info = run_test(ref, vq, cfg, ds, outroot, paths["env_dir"],
                        vali_epoch_dir=trained["vali_dir"],
                        data_root=paths["data_root"], scene_name=SCENE,
                        device=device)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        render_launches = render_kernel.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        if render_launches <= 0:
            raise AssertionError("run_test never launched the render kernel")
        if render_kernel.LAUNCHES_BY_INSTANCE != {"vector": render_launches,
                                                  "scalar": 0}:
            raise AssertionError(
                "run_test at 512 lights left the 16-byte instance: %s"
                % render_kernel.LAUNCHES_BY_INSTANCE)
        if info["n_vq"] != n_vq:
            raise AssertionError(f"n_vq {info['n_vq']} != {n_vq}")
        n_arrays = check_outputs(
            outroot, expected_files(cfg, paths["env_dir"]), N_VIEWS, n_vq)
        print("run_test: %.3f s total, opt_scale %s, %d arrays checked; %d "
              "render-kernel launches, all of the 16-byte instance"
              % (total, info["opt_scale"], n_arrays, render_launches))
        for phase, sec in info["seconds"].items():
            print("  pass %-8s %.3f s (%.3f s per %dx%d view)"
                  % (phase, sec, sec / N_VIEWS, cfg.imh, cfg.imh))
        print("peak device memory in run_test: %d bytes (%.3f GiB)"
              % (peak, peak / 2**30), flush=True)

        view = ds.load_view(ds.files[0])
        sys.stdout.flush()

        # ---- stage-1 geometry extraction ----------------------------------
        geo = extraction_phase(root, device, profile)
        sys.stdout.flush()

    # ---- each kernel against its plain version, and the timings ----------
    lxyz, lareas = dc.light_constants(cfg, device)
    with torch.inference_mode():
        render_entry = check_render_kernel(vq, cfg, view, lxyz, lareas, device)
        vq_entry = check_vq_kernel(trained, cfg, device)
    fwd_entry, fwdgrad_entry = check_sdf_kernels(geo, device)
    time_steps(cfg, trained, lxyz, lareas, device, profile)

    render_entry["launches"] = render_launches
    vq_entry["launches"] = trained["launches"]
    fwd_entry["launches"] = geo["launches"]["sdf_fwd"]
    fwdgrad_entry["launches"] = geo["launches"]["sdf_fwdgrad"]
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [render_entry, vq_entry, fwd_entry,
                                  fwdgrad_entry]}))
    print("nvidia-smi:", smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
