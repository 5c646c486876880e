#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqnerf_release_torch) on one GPU.

    python3 chip_smoke.py [--profile]

(--profile adds torch.profiler tables of the training step and of the
fast-vis shadow pass.)

1. checks for a CUDA device and prints its name and power limit;
2. builds the three CUDA sources of csrc/ and the SDF source once more as
   the design before (one accumulator; for a reading in 8), four nvcc
   processes side by side (four kernels, the render kernel in four
   instances), and prints the
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
   moved, the checkpoint reloads to equal tensors, the files exist. It
   replays the same vq_nfr steps (same state, batches and dropout draws,
   no validation) with the kernel and with use_fused_vq=False and prints
   how far the final codebooks and the codes of the evaluation rows lie
   apart. Then train_ref_nfr for 2 epochs from the trained VqNfr and the
   light its validation wrote: log, checkpoint, the frozen subtree bit for
   bit unchanged, and the time of one synchronised step;
5. SERVES the trained models: the port's four-pass run_test over the 2 val
   views with the trained vq_nfr, the trained ref_nfr and the main_<k>
   directory the training wrote, with the render kernel's launch counts
   reset just before and read just after (every launch must be of the
   16-byte instance: 512 lights, aligned lvis rows); every expected file
   exists, every written array is finite, embed ids lie in [0, n_vq];
6. TRAINS stage-1 geometry: writes a synthetic NeRF-convention scene
   (transforms_{train,val}.json, 16-bit rgba.png, cameras spread over a
   circle of radius 2 looking at the origin, a textured sphere of radius
   GEO_GT_RADIUS) and trains NeuSRunner on it under the shipped training
   config of a CG scene (config.neus_configs_for_scene: SDF 39 -> 256x8 ->
   257, colour net 4x256, 2560 rays a step, the 24+8r2 carve sampler over a
   128^3 occupancy grid, then the dense 64+32r2 tail with the grid on), cut
   to NEUS_ITERS steps; kernel 3's launch count is reset just before and
   must equal up_sample_steps a step (and a validation render's) just
   after; losses finite, no skipped step. It times one step with and
   without kernel 3 in the carve phase and in the tail, and pack_sdf;
7. EXTRACTS stage-1 geometry from THAT checkpoint with the port's entry
   run_gen_geo and the defaults a user gets: sampler 64+64r4, 512 lights,
   fast_vis on, n_coarse 16, fast_vis_refine 64, vis_point_batch 64. The
   SDF kernels' launch counts are reset just before and must both have
   risen just after. Checks, each view printed before any failure raises:
   all 8 files of every view, finite, lvis in [0, 1]; each view's GT mask
   inside its silhouette; on the foreground pixels (inside the GT mask too
   for a train view) the GT sphere's SDF at the mean point along the ray
   (xyz over a weight_sum rendered again) within the band a soft, briefly
   trained density implies, normals within NORMAL_MAX_DEG of radial; at
   opaque pixels lvis near 1 for front-lit, non-grazing lights, and exactly
   0 for back-facing ones everywhere; the fast-vis certified fraction of
   the trained scene. Then, on a few hundred foreground points x 512
   lights, _lvis_full through the kernels against _lvis_full with
   use_fused_sdf=False and against _lvis_fast (equal on the rays fast-vis
   renders; on the rays it certifies free no crossing of the zero level,
   so at least half the light under the soft density); the normals of a
   geometry render and GeoExtractor._certificates through the kernels
   against the plain path; one neus_render with the up-sample chain
   through the kernel and without;
8. holds each kernel against its plain PyTorch version on the GPU, on
   inputs taken from the trained models:
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
     sdf_fwd, sdf_fwdgrad: shadow-ray points of the trained scene, a ragged
       count and a scale-2 net, rtol 1e-4 / atol 1e-5 on sdf and on every
       gradient component (the gradient's error over its vector's norm is
       printed beside), the gradient also against autograd; and, as a
       reading, both kernels built as the design before (the three TF32
       products in one accumulator) on the same net and points;
9. times all four kernels and their plain versions, kernel 3 also at the
   point counts of the NeuS training step's chain: "ms" is one call on a
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
10. runs the port from its command line, cli.main(argv) in-process, on a
   scene of its own (write_cli_scene: the textured sphere at CLI_IMH with 3
   train and 1 val views from CLI_EYE_DIST, the stage-2 metadata and a
   vis_comps mirror), every width the family preset's: geo-train for
   CLI_GEO_ITERS steps -> gen-geo at its defaults -> decomp-train --phase
   all --epochs 1 -> test with the probes of step 3 -> gen-z ->
   reselect-main --dry-run. Every kernel's launch count is set to 0 just
   before each subcommand and read just after: kernel 3 exactly
   up_sample_steps a geo-train step, kernels 3 and 4 in gen-geo, kernel 2
   exactly once a vq_nfr step in decomp-train, kernel 1 in test. The JAX
   CLI's file tree for these subcommands exists and its arrays are finite.
   Then the trained vq_nfr and ref_nfr go out as the .npz that
   scripts/export_jax_ckpt.py writes (made with the port's to_jax: there
   is no jax on the card), come back through interop/jax_ckpt into a fresh
   tree and are served again by `test`, every array within rtol 2e-4 /
   atol 1e-5 of the directly served one; last, `python -m
   vqnerf_release_torch.cli test` in a fresh process exits 0 and writes the
   same files;
11. prints the pass times, peak device memory of each path, each
   subcommand's seconds, the script's total, a {"kernels": [...]} line with
   all four kernels (each with ms, device_ms, plain_ms, bound_ms; kernel
   3's launches are those of NeuS training and extraction, given apart on
   an earlier line; cli_launches, the launches of step 10, and
   cli_launches_by_subcommand), and as the last line {"ok": true,
   "device": {...}}.

Cuts, all of scale and none of width: 4 train views and 1 validation view
in place of a scene's 100 and 8, 2 epochs in place of 150, 2 served views;
for stage 1 6 train views and 1 val view of 256x256 in place of a scene's
100 and 8 of 512x512 (or larger), and NEUS_ITERS training steps in place of
300,000, with the warm-up cut in proportion and the checkpoint, validation
and mesh at the last step; for the command line 3 train views and 1 val
view of 128x128, CLI_GEO_ITERS geometry steps, 1 epoch a phase and a VQ
evaluation set of CLI_VQ_SAMPLES rows, printed in its "cli cuts" line.

Any failure raises and exits non-zero; without CUDA it exits 1 before doing
anything.
"""

import copy
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vqnerf_release_torch import cli
from vqnerf_release_torch import config as vcfg
from vqnerf_release_torch.data import io as vio
from vqnerf_release_torch.data.device_store import DeviceViewStore
from vqnerf_release_torch.data.sampler import build_vq_eval_set
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
from vqnerf_release_torch.interop import jax_ckpt
from vqnerf_release_torch.interop import jax_params
from vqnerf_release_torch.ops.vq import VqEmaState, vq_lookup
from vqnerf_release_torch.pipelines import gen_geo
from vqnerf_release_torch.pipelines.test_driver import (_RAY_CHUNK, find_vq,
                                                         load_novel_lights,
                                                         run_test)
from vqnerf_release_torch.train import decomp_trainer as dt
from vqnerf_release_torch.train import loop as train_loop
from vqnerf_release_torch.train.neus_loop import NeuSRunner
from vqnerf_release_torch.train.neus_trainer import make_neus_train_step
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
GEO_TRAIN_VIEWS, GEO_VAL_VIEWS = 6, 1
GEO_NEAR, GEO_FAR = 0.5, 3.5
# the scene's sphere: inside the geometric init's zero level (radius 0.5),
# near enough for NEUS_ITERS steps of the shipped learning rate to reach
GEO_GT_RADIUS = 0.4
SDF_RTOL, SDF_ATOL = 1e-4, 1e-5  # SDF kernels against their plain versions
SDF_AUTO_RTOL, SDF_AUTO_ATOL = 3e-3, 3e-4  # ... against autograd
SDF_RAYS = 8192  # vis_point_batch 64 x light_tile 128
SDF_RAGGED_N = 131072 + 77
SDF_ONE_ACC_FLAGS = ("-DSDF_ONE_ACCUMULATOR",)
LVIS_POINTS = 300
LVIS_KERNEL_ATOL = 2e-3  # lvis, kernel path against plain path
RENDER_FUSED_ATOL = 2e-3  # neus_render, up-sample chain fused against not
# NeuS training: the shipped config's 300,000 steps cut to this many; the
# warm-up keeps its share of the run (5,000 of 300,000)
NEUS_ITERS = 400
# The extracted buffers of the trained scene against the GT sphere, on a
# train view's pixels inside both its silhouette and its GT mask (its lvis
# covers the GT mask) and on a val view's whole silhouette. xyz.npy is the
# weights' sum of the samples, sum_i w_i x_i, as the reference writes it:
# where weight_sum W is below 1 (W > 0.5 on the silhouette) the point lies
# inside the object, at W times the mean point along the ray. The checks
# render W again with the same extractor (its silhouette must be
# alpha.png's) and hold the mean point, xyz / W, to the sphere. NEUS_ITERS
# steps leave the density soft (s_val, its scale, about 0.03 where a
# scene's full training ends near 0.002), and the shipped loss takes the
# colour only inside the GT mask, where it asks for full opacity up to the
# silhouette's edge: the zero level settles outside the GT sphere, by up to
# the width in which the density's sigmoid goes from 1% to 99%, ln(99)
# s_val. So:
SOFT_WIDTH = math.log(99.0)  # times the trained s_val
SURF_SLACK = 0.05  # beyond that, inward and outward
NORMAL_MAX_DEG = 35.0  # angle between normal.npy and the mean point's radial
GT_COVERED = 0.95  # share of a view's GT mask inside its silhouette
OPAQUE = 0.99  # W above which xyz is the surface point (the lvis checks)
LIT_COS, LIT_MIN = 0.5, 0.9  # lights with cos > LIT_COS have lvis > LIT_MIN
# the "cli" phase: a scene of its own under the CG scene's name, with the
# cameras of a NeRF-synthetic scene (distance 4, inside the nerf family's
# fixed near 2 and far 6); its cuts, all of data and depth
CLI_IMH = 128
CLI_TRAIN_VIEWS, CLI_VAL_VIEWS = 3, 1
CLI_EYE_DIST = 4.0
CLI_GEO_ITERS = 100
CLI_VQ_SAMPLES = 20_000  # total_sample_vq, 200,000 in the preset
CLI_TIMEOUT_S = 600  # the python -m subprocess
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


def _norm_relative(got, want):
    """The worst row's error over the norm of its vector (rows of
    3-vectors, gradients): a reading printed beside the component-wise
    gate, not a gate."""
    err = (got - want).abs().amax(dim=-1)
    return float((err / torch.linalg.norm(want, dim=-1).clamp_min(
        1e-30)).max())


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
    """Build the three sources and the SDF kernels' one-accumulator
    variant, one nvcc process each, side by side."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        jobs = {"render": pool.submit(render_kernel.build),
                "vq": pool.submit(vq_kernel.build),
                "sdf": pool.submit(sdf_kernel.build),
                # the SDF kernels' design before, for the accuracy reading
                "sdf, one accumulator": pool.submit(sdf_kernel.build,
                                                    SDF_ONE_ACC_FLAGS)}
        built = {name: job.result() for name, job in jobs.items()}
    print("kernel builds: %.3f s for the three sources and a variant"
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
            "launches": launches, "peak": peak, "train_views": train_views,
            "nfr": nfr, "vq_dir": vq_dir}


def ref_phase(cfg, paths, trained, root, device):
    """Phase 3: train_ref_nfr for EPOCHS epochs from the trained VqNfr and
    the light its last validation wrote, on views loaded with their
    reference RGB; its log, checkpoint and files, the frozen subtree bit for
    bit the VqNfr's and the light's, the VqNfr untouched; and the time of
    one synchronised step. Returns the trained RefNfr."""
    load = {}
    for mode, n in (("train", N_TRAIN_VIEWS), ("vali", N_VALI_VIEWS)):
        ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                          data_type="nerf", imh=cfg.imh, mode=mode,
                          with_ref=True)
        load[mode] = [ds.load_view(f) for f in ds.files[:n]]
    light = np.load(os.path.join(trained["vq_dir"], "vis_vali",
                                 "np_light.npy"))
    vq = trained["vq"]
    vq_before = {k: v.clone() for k, v in vq.state_dict().items()}
    ref_dir = os.path.join(root, "ref")
    n_steps = EPOCHS * N_TRAIN_VIEWS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref, hist = train_loop.train_ref_nfr(
        cfg, vq, light, load["train"], load["vali"], ref_dir, epochs=EPOCHS,
        seed=SEED, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rows = _check_log(ref_dir, "ref_nfr")
    _check_ckpt(ref_dir, ref, n_steps)
    for k, v in vq.state_dict().items():
        if not torch.equal(v, vq_before[k]):
            raise AssertionError(f"train_ref_nfr changed the VqNfr at {k}")
    frozen = ref.frozen
    for mine, theirs in ((frozen.fine_enc, vq.fine_enc),
                         (frozen.bottleneck, vq.bottleneck),
                         (frozen.spec_out, vq.spec_main)):
        for a, b in zip(mine.parameters(), theirs.parameters()):
            if not torch.equal(a, b):
                raise AssertionError("the frozen subtree moved")
    if not torch.equal(frozen.light.cpu(), torch.from_numpy(light)):
        raise AssertionError("the frozen light moved")
    epoch_dir = os.path.join(ref_dir, "vis_vali", "epoch%09d" % EPOCHS)
    for name in ("pred_rgb.png", "pred_rgb_diff.png", "pred_rgb_spec.png",
                 "pred_basecolor.png"):
        path = os.path.join(epoch_dir, "batch%09d" % 0, name)
        if not os.path.exists(path):
            raise AssertionError(f"missing {os.path.relpath(path, root)}")

    # one synchronised step on a copy (the trained model is served next)
    lxyz, lareas = dc.light_constants(cfg, device)
    store = DeviceViewStore(load["train"][:1], device)
    batch = store.gather(0, train_loop.sample_pix(
        load["train"][0], cfg.n_rays_per_step, np.random.RandomState(SEED),
        jitter_mode="contrast"))
    _, step = dt.make_ref_nfr_step(copy.deepcopy(ref), cfg, lxyz, lareas)
    for _ in range(3):
        step(batch, 8)
    step_ms = _median_step_ms(lambda: step(batch, 8), 10)
    del store, batch
    print("train_ref_nfr: %.3f s, %d steps, epoch losses %s; epoch wall %s "
          "s; the frozen encoder, spec head and light bit for bit the "
          "VqNfr's; peak device memory %d bytes (%.3f GiB)"
          % (seconds, n_steps, hist, [r["wall_s"] for r in rows], peak,
             peak / 2**30))
    print("one ref_nfr step (%d rows x %d lights, host clock, synchronised, "
          "median of 10): %.3f ms" % (2 * cfg.n_rays_per_step, cfg.n_lights,
                                      step_ms))
    return ref


def vq_replay(cfg, trained, device):
    """train_vq_nfr's steps once more, from the same state, batches and
    dropout draws, with the VQ kernel (use_fused_vq=None) and with
    use_fused_vq=False, without validation. Fails unless the kernel run
    gives the trained model bit for bit (every launch is deterministic, so
    anything else means the replay left train_vq_nfr's draw order). Prints
    how far the two paths' final codebooks lie apart, and the share of the
    VQ evaluation set's foreground rows whose code differs between them."""
    views, nfr = trained["train_views"], trained["nfr"]
    lxyz, lareas = dc.light_constants(cfg, device)
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    # the random stream of train_vq_nfr: the k-means batches, then the
    # evaluation set, then the epochs' batches
    rng = np.random.RandomState(SEED)
    centers = np.load(os.path.join(trained["vq_dir"], "cluster_centers.npy"))
    again = train_loop._init_centers(cfg, nfr, views, rng, SEED, device)
    per_view = max(1, cfg.total_sample_vq // len(views))
    vq_eval = train_loop._device_batch(build_vq_eval_set(
        views, per_view, cfg.n_rays_per_step, rng), device)
    state0 = rng.get_state()
    models = {}
    t0 = time.perf_counter()
    for name, fused in (("kernel", None), ("eager", False)):
        rng.set_state(state0)
        c = dataclasses.replace(cfg, use_fused_vq=fused)
        model, ema = vq_nfr.init_vq_nfr(torch.Generator().manual_seed(SEED),
                                        c, nfr, centers)
        model = model.to(device)
        ema = VqEmaState(*(t.to(device) for t in ema))
        _, step_fn = dt.make_vq_nfr_step(model, c, lxyz, lareas)
        gen = torch.Generator(device=device).manual_seed(SEED)
        batches, _ = train_loop._make_batch_source(views, c, "random",
                                                   device)
        step = 0
        for _ in range(EPOCHS):
            for batch in batches(rng):
                ema, _ = step_fn(ema, batch, thres, gen, step)
                step += 1
        models[name] = model
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    vq, kernel, eager = trained["vq"], models["kernel"], models["eager"]
    replay = max(float((a - b).abs().max()) for a, b in zip(
        kernel.state_dict().values(), vq.state_dict().values()))
    # the replay holds train_vq_nfr's draw order: the kernel path must give
    # the trained model's bits, or the replay is not of its trajectory
    if replay != 0 or not np.array_equal(again, centers):
        raise AssertionError(
            f"the replay left train_vq_nfr's trajectory: parameters up to "
            f"{replay} apart, k-means centres equal: "
            f"{np.array_equal(again, centers)}")
    drift = float((kernel.codebook - eager.codebook).detach().abs().max())
    with torch.inference_mode():
        fg = vq_eval["alpha"][:, 0] > 0
        codes = {}
        for name, model in models.items():
            _, z = vq_nfr.vq_encode(model, vq_eval["xyz"][fg], cfg)
            codes[name] = vq_lookup(dc.get_codebook(model),
                                    z)["encoding_indices"]
        differ = float((codes["kernel"] != codes["eager"]).float().mean())
    print("vq_nfr replay of %d steps a path (%.3f s for both): the kernel "
          "path against the trained model max |diff| %.3e over all "
          "parameters (k-means centres recomputed equal: %s); "
          "use_fused_vq=False against the kernel after %d epochs: final "
          "codebook max |diff| %.3e; %.4f%% of %d foreground evaluation rows "
          "take another code"
          % (step, seconds, replay, np.array_equal(again, centers), EPOCHS,
             drift, 100 * differ, int(fg.sum())))
    if not np.isfinite(drift):
        raise AssertionError("non-finite replay")
    return {"codebook_drift": drift, "code_differ_share": differ,
            "replay_noise": replay}


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


def write_stage1_scene(root, imh, n_train, n_val, seed, eye_dist=2.0):
    """A NeRF-convention stage-1 scene: transforms_{train,val}.json and a
    16-bit rgba.png per view. The cameras lie on a circle of radius
    eye_dist (height 0.15 eye_dist) and look at the origin, the train views
    evenly spaced and the val views between them. The object is a sphere of
    radius
    GEO_GT_RADIUS with a texture fixed to its surface (smooth blobs of its
    base colour), so that the views agree on where each surface point lies;
    the background is white. Both carry 3% of per-pixel noise."""
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
            ang = 2 * np.pi * (i + (0.5 if mode == "val" else 0.0)) \
                / max(n_train, 1)
            eye = eye_dist * np.array([np.sin(ang), 0.15, np.cos(ang)])
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
            disc = b * b - (eye @ eye - GEO_GT_RADIUS**2)
            hit = disc > 0
            p = eye + (-b - np.sqrt(np.maximum(disc, 0.0)))[..., None] * rayd
            blobs = np.prod(np.sin(9.0 * p), axis=-1)
            rgba = np.empty((imh, imh, 4))
            rgba[..., :3] = np.where(
                hit[..., None],
                np.array([0.8, 0.5, 0.3]) * (0.55 + 0.45 * blobs[..., None]),
                1.0) * (0.97 + 0.03 * rs.random((imh, imh, 1)))
            rgba[..., 3] = hit
            d = os.path.join(root, "%s_%03d" % (mode, i))
            os.makedirs(d)
            vio.write_png(os.path.join(d, "rgba.png"),
                          (rgba * 65535).astype(np.uint16))
        vio.write_json({"camera_angle_x": angle_x, "frames": frames},
                       os.path.join(root, "transforms_%s.json" % mode))
    return root


def neus_train_phase(root, device, profile=False):
    """Stage 1's training: NeuSRunner on the written stage-1 scene under the
    shipped training config of GEO_SCENE (config.neus_configs_for_scene:
    the default widths, 2560 rays a step, the 24+8r2 carve sampler over a
    128^3 occupancy grid, then the dense 64+32r2 tail with the grid on),
    cut to NEUS_ITERS steps. Kernel 3 must launch up_sample_steps times in
    every step and in the closing validation render; losses finite, no step
    skipped, the checkpoint where run_gen_geo looks. Then the step's time
    with and without kernel 3 in both phases, and pack_sdf's."""
    data_root = write_stage1_scene(
        os.path.join(root, "stage1", GEO_SCENE), GEO_IMH, GEO_TRAIN_VIEWS,
        GEO_VAL_VIEWS, SEED)
    out_root = os.path.join(root, "stage1_out")
    _, shipped, _ = gen_geo.vcfg.neus_configs_for_scene(GEO_SCENE)
    warm = round(shipped.warm_up_end * NEUS_ITERS / shipped.end_iter)
    cfg, tcfg, meta = gen_geo.vcfg.neus_configs_for_scene(
        GEO_SCENE, end_iter=NEUS_ITERS, warm_up_end=warm,
        save_freq=NEUS_ITERS, val_freq=NEUS_ITERS, mesh_freq=NEUS_ITERS)
    if (cfg.sdf, cfg.color) != (fields.SDFConfig(), fields.ColorConfig()) \
            or tcfg.batch_size != 2560:
        raise AssertionError(f"not the default widths: {cfg}, {tcfg}")
    if (cfg.n_samples, cfg.n_importance, cfg.up_sample_steps, tcfg.occ_res,
            tcfg.tail_sampler, tcfg.tail_occ) != (24, 8, 2, 128, "64+32r2",
                                                  True):
        raise AssertionError(f"not the shipped sampler schedule: {tcfg}")
    ds = NerfSceneDataset(data_root, is_train=True, near=GEO_NEAR,
                          far=GEO_FAR)
    val_ds = NerfSceneDataset(data_root, is_train=False, near=GEO_NEAR,
                              far=GEO_FAR)
    exp_dir = os.path.join(out_root, "exp", GEO_SCENE, meta["family"])
    runner = NeuSRunner(cfg, tcfg, ds, exp_dir, val_dataset=val_ds,
                        seed=SEED, device=device)
    tail_start = runner.tail_start()
    print("NeuS training cuts: %d train + %d val views of %dx%d; end_iter "
          "%d for the shipped %d and warm_up_end %d for %d (the same share); "
          "save, validation and mesh once, at the last step; widths, batch "
          "%d, the carve sampler %d+%dr%d over a %d^3 grid rebuilt every %d "
          "steps and the %s tail from step %d (tail_frac %g) are the "
          "shipped config's"
          % (GEO_TRAIN_VIEWS, GEO_VAL_VIEWS, GEO_IMH, GEO_IMH, NEUS_ITERS,
             shipped.end_iter, warm, shipped.warm_up_end, tcfg.batch_size,
             cfg.n_samples, cfg.n_importance, cfg.up_sample_steps,
             tcfg.occ_res, tcfg.occ_update_freq, tcfg.tail_sampler,
             tail_start, tcfg.tail_frac))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in sdf_kernel.LAUNCHES:
        sdf_kernel.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    hist = runner.train(log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(sdf_kernel.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    tail_cfg = runner._tail_cfg
    val_batches = math.ceil(GEO_IMH * GEO_IMH / 4096)
    want = (cfg.up_sample_steps * tail_start
            + tail_cfg.up_sample_steps * (NEUS_ITERS - tail_start)
            + cfg.up_sample_steps * val_batches)
    if launches != {"sdf_fwd": want, "sdf_fwdgrad": 0}:
        raise AssertionError(f"NeuS training launched {launches}, expected "
                             f"sdf_fwd {want}: kernel 3 in every step")
    if len(hist) != NEUS_ITERS or runner.iter_step != NEUS_ITERS:
        raise AssertionError(f"{len(hist)} logged of {runner.iter_step} steps")
    losses = np.array([h["loss"] for h in hist])
    skipped = int(sum(h["nonfinite_grads"] for h in hist))
    if not np.isfinite(losses).all() or skipped:
        raise AssertionError(f"NeuS: {skipped} skipped steps, losses "
                             f"finite: {np.isfinite(losses).all()}")
    if len(runner.occ_builds) < 2 or runner.occ_builds[0] != 0:
        raise AssertionError(f"occupancy rebuilt at {runner.occ_builds}")
    latest = ckpt_util.latest_ckpt(exp_dir)
    if os.path.basename(latest) != "ckpt-%d" % NEUS_ITERS:
        raise AssertionError(f"latest checkpoint {latest}")
    state = ckpt_util.load_ckpt(latest)
    for k, v in runner.params.state_dict().items():
        if not torch.equal(state["params"][k], v.cpu()):
            raise AssertionError(f"the checkpoint differs from the model at "
                                 f"{k}")
    for path in (os.path.join(exp_dir, "validations_fine",
                              "%08d_0.png" % NEUS_ITERS),
                 os.path.join(exp_dir, "meshes", "%08d.ply" % NEUS_ITERS)):
        if not os.path.exists(path):
            raise AssertionError(f"missing {os.path.relpath(path, root)}")
    psnr = np.array([h["psnr"] for h in hist])
    print("NeuSRunner.train: %.3f s for %d steps (%.2f ms a step on "
          "average, the occupancy rebuilds at %s, the validation render and "
          "the mesh included); loss %.5f -> %.5f (first / last step; means "
          "of the first and last 20: %.5f -> %.5f), PSNR %.2f -> %.2f dB "
          "(means of 20: %.2f -> %.2f), s_val %.5f -> %.5f, lr %.3e at the "
          "end; %d steps skipped; kernel 3 launched %d times (%d a step and "
          "%d in the validation render); peak device memory %d bytes "
          "(%.3f GiB)"
          % (seconds, NEUS_ITERS, 1e3 * seconds / NEUS_ITERS,
             runner.occ_builds, losses[0], losses[-1], losses[:20].mean(),
             losses[-20:].mean(), psnr[0], psnr[-1], psnr[:20].mean(),
             psnr[-20:].mean(), hist[0]["s_val"], hist[-1]["s_val"],
             hist[-1]["lr"], skipped, launches["sdf_fwd"],
             cfg.up_sample_steps, cfg.up_sample_steps * val_batches, peak,
             peak / 2**30))
    time_neus_steps(runner, device, profile)
    return {"data_root": data_root, "out_root": out_root,
            "model": runner.params, "launches": launches["sdf_fwd"],
            "runner": runner, "s_val": float(hist[-1]["s_val"])}


def time_neus_steps(runner, device, profile):
    """The synchronised time of one NeuS training step with the up-sample
    chain through kernel 3 and without it (use_fused_sdf=False), medians of
    10 steps each on copies of the trained model, in the carve phase and in
    the tail; kernel 3's launches a step; one pack_sdf."""
    cfg, tcfg = runner.cfg, runner.tcfg
    grid = runner._build_occ()
    batch = runner._host_batch()
    for phase, c in (("carve", cfg), ("tail", runner._tail_cfg)):
        ms, per_step = {}, {}
        for name, fused in (("kernel", None), ("plain", False)):
            model = copy.deepcopy(runner.params)
            _, step = make_neus_train_step(model, c, tcfg, runner.radius,
                                           with_occ=True,
                                           use_fused_sdf=fused)
            gen = torch.Generator(device=device).manual_seed(SEED)

            def run(step=step, gen=gen):
                step(batch, NEUS_ITERS - 1, occ_grid=grid, generator=gen)
            run()
            run()
            before = sdf_kernel.LAUNCHES["sdf_fwd"]
            ms[name] = _median_step_ms(run, 10)
            per_step[name] = (sdf_kernel.LAUNCHES["sdf_fwd"] - before) / 10
            if profile and name == "kernel" and phase == "carve":
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity
                from torch.profiler import profile as tprofile
                with tprofile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(10):
                        run()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                averages = prof.key_averages()
                print(averages.table(sort_by="cuda_time_total", row_limit=15,
                                     max_name_column_width=60))
                device_us = sum(_self_device_us(e) for e in averages
                                if e.device_type == DeviceType.CUDA)
                print("profile of 10 NeuS carve steps with kernel 3: device "
                      "busy %.3f ms of %.3f ms wall: idle share %.3f"
                      % (device_us / 1e3, 1e3 * wall,
                         1 - device_us / 1e6 / wall))
        if per_step != {"kernel": c.up_sample_steps, "plain": 0}:
            raise AssertionError(f"{phase}: kernel 3 launches a step "
                                 f"{per_step}")
        print("one NeuS training step, %s phase (%d rays, %d+%dr%d, the "
              "occupancy grid on; host clock, synchronised, median of 10): "
              "%.3f ms with the up-sample chain through kernel 3 (%d "
              "launches a step), %.3f ms with use_fused_sdf=False"
              % (phase, tcfg.batch_size, c.n_samples, c.n_importance,
                 c.up_sample_steps, ms["kernel"], per_step["kernel"],
                 ms["plain"]))
    pack_ms = _median_step_ms(
        lambda: sdf_kernel.pack_sdf(runner.params.sdf, cfg.sdf), 10)
    print("pack_sdf of the default SDF net: %.3f ms (host clock, "
          "synchronised, median of 10), once a training step" % pack_ms)


def check_geo_view(view_dir, lxyz, gt_mask, weight_sum, is_train, s_val):
    """The written buffers of one extracted view against the GT sphere and
    the lights, for a NeuS whose trained density scale is ``s_val`` and
    whose render of the view has ``weight_sum`` [h, w]; returns a dict of
    what was measured, with the names of the checks that failed under
    "failed" (the caller raises once every view is printed)."""
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
    gt, sil = gt_mask > 0, alpha > 0
    got = {"iou": float((sil & gt).sum() / max((sil | gt).sum(), 1)),
           "gt_covered": float((sil & gt).sum() / max(gt.sum(), 1))}
    fg = sil & gt if is_train else sil  # lvis of a train view covers gt
    if fg.sum() < 0.1 * fg.size:
        raise AssertionError(f"only {int(fg.sum())} foreground pixels")
    x, w, n = xyz[fg], weight_sum[fg], normal[fg]
    p = x / w[:, None]  # the mean point along the ray
    radius = np.linalg.norm(p, axis=-1)
    sdf_gt = radius - GEO_GT_RADIUS  # the GT sphere's SDF at that point
    deg = np.degrees(np.arccos(np.clip(
        np.sum(n * p, -1) / np.maximum(radius, 1e-12), -1, 1)))
    s2l = lxyz[None] - x[:, None]
    s2l /= np.linalg.norm(s2l, axis=-1, keepdims=True)
    cos = np.einsum("plk,pk->pl", s2l, n)
    lv = lvis[fg]
    # front-lit lights see the surface point of a convex object: xyz where
    # the pixel is opaque
    lit = lv[(cos > LIT_COS) & (w[:, None] > OPAQUE)]
    outward = SOFT_WIDTH * s_val + SURF_SLACK
    got.update({"fg": int(fg.sum()),
                "opaque": float(np.mean(w > OPAQUE)),
                "sdf_gt": [float(sdf_gt.min()), float(np.median(sdf_gt)),
                           float(sdf_gt.max())],
                "sdf_gt_limits": [-SURF_SLACK, outward],
                "radial_deg_median": float(np.median(deg)),
                "radial_deg_max": float(deg.max()),
                "lit_min": float(lit.min()),
                "back_lit_max": float(lv[cos < -1e-4].max(initial=0.0))})
    got["failed"] = [what for bad, what in (
        ((sil != (weight_sum > 0.5)).any(),
         "the render again gives another silhouette"),
        (got["gt_covered"] < GT_COVERED, "GT mask outside the silhouette"),
        (sdf_gt.min() < -SURF_SLACK or sdf_gt.max() > outward,
         "surface off the GT sphere"),
        (got["radial_deg_max"] > NORMAL_MAX_DEG, "normals off radial"),
        (got["lit_min"] < LIT_MIN, "front-lit lvis"),
        (got["back_lit_max"] != 0, "lvis of a back-facing light")) if bad]
    return got


def extraction_phase(root, device, neus, profile=False):
    """Stage-1 geometry extraction through run_gen_geo from the checkpoint
    that neus_train_phase wrote, its checks, and the lvis and render
    comparisons; returns what the kernel checks need."""
    data_root, out_root = neus["data_root"], neus["out_root"]
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

    # the model and dataset that run_gen_geo built, rebuilt for the checks:
    # the trained checkpoint
    cfg, tcfg, meta = gen_geo.vcfg.neus_configs_for_scene(
        GEO_SCENE, n_samples=64, n_importance=64, up_sample_steps=4,
        occ_res=0)
    if cfg != NeuSConfig(perturb=cfg.perturb):
        raise AssertionError(f"not the default NeuS widths: {cfg}")
    model = init_neus(SEED, cfg).to(device)
    exp_dir = os.path.join(out_root, "exp", GEO_SCENE, meta["family"])
    model.load_state_dict(ckpt_util.load_ckpt(
        ckpt_util.latest_ckpt(exp_dir))["params"])
    for k, v in neus["model"].state_dict().items():
        if not torch.equal(model.state_dict()[k], v):
            raise AssertionError(f"run_gen_geo's checkpoint is not the "
                                 f"trained model at {k}")
    ds = NerfSceneDataset(data_root, is_train=True, near=GEO_NEAR,
                          far=GEO_FAR)
    masks = {"train": ds.masks,
             "val": NerfSceneDataset(data_root, is_train=False, near=GEO_NEAR,
                                     far=GEO_FAR).masks}
    ex = gen_geo.GeoExtractor(model, cfg, ds, os.path.join(root, "unused"),
                              fast_vis=True, device=device)
    lxyz = ex.lxyz.cpu().numpy()
    n_fg, failed = 0, []
    for mode in ("train", "val"):
        view_ds = ds if mode == "train" else NerfSceneDataset(
            data_root, is_train=False, near=GEO_NEAR, far=GEO_FAR)
        for i, view_dir in enumerate(done[mode]):
            ro, rd = view_ds.gen_rays_at(i)
            weight_sum = ex._render_full(
                ro.reshape(-1, 3), rd.reshape(-1, 3))["weight_sum"].reshape(
                    ro.shape[:2])
            got = check_geo_view(view_dir, lxyz, masks[mode][i][..., 0],
                                 weight_sum, mode == "train", neus["s_val"])
            n_fg += got["fg"]
            failed += ["%s: %s" % (os.path.basename(view_dir), what)
                       for what in got["failed"]]
            print("  %s: %s" % (os.path.basename(view_dir), got), flush=True)
    if failed:
        raise AssertionError(f"extracted buffers: {failed}")
    print("run_gen_geo: %.3f s for %d views (%.3f s a view), %d foreground "
          "pixels x %d lights = %d shadow rays; kernel launches %s; peak "
          "device memory %d bytes (%.3f GiB)"
          % (seconds, GEO_TRAIN_VIEWS + GEO_VAL_VIEWS,
             seconds / (GEO_TRAIN_VIEWS + GEO_VAL_VIEWS), n_fg, ex.n_lights,
             n_fg * ex.n_lights, launches, peak, peak / 2**30))
    print("  host-clock seconds by phase, each closed where the host waits "
          "for the device: %s"
          % {k: round(v, 3) for k, v in done["seconds"].items()})
    vis_stats = done["fast_vis"]
    if len(vis_stats) != GEO_TRAIN_VIEWS + GEO_VAL_VIEWS:
        raise AssertionError(f"fast-vis statistics of {len(vis_stats)} views")
    front = sum(st["front_lit_rays"] for st in vis_stats)
    uncertain = sum(st["uncertain_rays"] for st in vis_stats)
    print("  fast-vis on the trained scene: %.2f%% of %d front-lit shadow "
          "rays certified (the geometric init's untrained sphere certified "
          "42%% on an H100), %d left to the occlusion render; by view %s"
          % (100.0 * (1 - uncertain / max(front, 1)), front, uncertain,
             ["%.4f" % st["certified_frac"] for st in vis_stats]))

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
    # fast against full, by what fast-vis promises: a ray it certified free
    # (lvis exactly 1) does not cross the SDF's zero level, so under the
    # soft density the full render keeps at least half its light (the leak
    # is 1 - sigmoid(inv_s x the ray's smallest SDF)); a ray it rendered
    # went through the same occlusion math as the full path
    certified = fast == 1.0
    e_rendered = float(np.abs(fast - full)[~certified].max(initial=0.0))
    leak = 1.0 - full[certified]
    print("lvis of %d points x %d lights: kernel path against plain path max "
          "|diff| %.3e (tolerance %g); fast against full max |diff| %.3e: on "
          "the %d rays fast-vis rendered %.3e (tolerance %g), on the %d it "
          "certified free a leak of up to %.3e (tolerance 0.5; %d above "
          "0.05); %.3f s full with the kernels, %.3f s fast, %.3f s full on "
          "the plain path"
          % (LVIS_POINTS, ex.n_lights, e_kernel, LVIS_KERNEL_ATOL,
             float(np.abs(fast - full).max()), int((~certified).sum()),
             e_rendered, LVIS_KERNEL_ATOL, int(certified.sum()),
             leak.max(initial=0.0), int((leak > 0.05).sum()), t_full, t_fast,
             t_plain))
    print("  last_fast_vis_stats:", ex.last_fast_vis_stats)
    if e_kernel > LVIS_KERNEL_ATOL or e_rendered > LVIS_KERNEL_ATOL \
            or leak.max(initial=0.0) >= 0.5:
        raise AssertionError("lvis paths disagree")
    compare_sdf_paths(ex, ex_plain, full, plain, surf_fg, device)

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


def compare_sdf_paths(ex, ex_plain, full, plain, surf_fg, device):
    """Kernels 3 and 4 against the plain path on the trained scene: the
    lvis of LVIS_POINTS points x all lights (computed by the caller), the
    normals and surface points of the geometry render of train view 0, and
    how many of GeoExtractor._certificates' answers flip on the same shadow
    rays in the coarse and in the refine sweep."""
    lv = np.abs(full - plain)
    print("kernels 3+4 against the plain path on the trained scene, lvis of "
          "%d points x %d lights: max |diff| %.3e, mean %.3e, %d of %d values "
          "differ" % (LVIS_POINTS, ex.n_lights, lv.max(), lv.mean(),
                      int((lv > 0).sum()), lv.size))
    ro, rd = ex.dataset.gen_rays_at(0)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    fused, eager = ex._render_full(ro, rd), ex_plain._render_full(ro, rd)
    fg = (fused["weight_sum"][:, 0] > 0.5) & (eager["weight_sum"][:, 0] > 0.5)
    unit = [r["normal"][fg] / np.maximum(np.linalg.norm(
        r["normal"][fg], axis=-1, keepdims=True), 1e-12)
        for r in (fused, eager)]
    deg = np.degrees(np.arccos(np.clip(np.sum(unit[0] * unit[1], -1),
                                       -1, 1)))
    print("  geometry render of %d rays (up-sample chain through kernel 3 "
          "against plain): normals of %d foreground pixels up to %.3e deg "
          "apart (mean %.3e), surface points up to %.3e apart, weight_sum "
          "up to %.3e"
          % (len(ro), int(fg.sum()), deg.max(), deg.mean(),
             np.abs(fused["surf"] - eager["surf"])[fg].max(),
             np.abs(fused["weight_sum"] - eager["weight_sum"]).max()))
    surf_d = torch.as_tensor(surf_fg, device=device)
    n_rays = len(surf_fg) * ex.n_lights
    flips = {}
    with torch.no_grad():
        for name, n_sweep in (("coarse", ex.n_coarse),
                              ("refine", ex.fast_vis_refine)):
            counts = np.zeros(4, np.int64)
            for i in range(0, n_rays, 16384):
                o, d = ex._rays_of(surf_d, torch.arange(
                    i, min(i + 16384, n_rays), device=device))
                a = ex._certificates(o, d, n_sweep)
                b = ex_plain._certificates(o, d, n_sweep)
                counts += [int((a[0] != b[0]).sum()), int((a[1] != b[1]).sum()),
                           int(a[0].sum()), int(a[1].sum())]
            flips[name] = counts
    print("  GeoExtractor._certificates on the same %d shadow rays, kernel "
          "3 against plain: %s" % (n_rays, "; ".join(
              "%s sweep (%d samples): below-margin flips %d (of %d rays "
              "below), deep-chord flips %d (of %d)"
              % (name, n, c[0], c[2], c[1], c[3]) for (name, c), n in zip(
                  flips.items(), (ex.n_coarse, ex.fast_vis_refine)))))


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


def check_sdf_kernels(geo, runner, device):
    """Kernels 3 and 4 against their plain versions and autograd, and kernel
    3 at the point counts of the NeuS training step's chain; returns their
    two kernels-line entries without the launch counts."""
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
        if pts is pts_grad:
            one_acc_reading(pk, pts, want_sdf, want_grad, pts_fwd)
        rel = _norm_relative(grad, want_grad)
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
              "atol %g, sdf and each gradient component; the gradient's "
              "error at most %.3e of its vector's norm); grad vs autograd "
              "fields.sdf_gradient %.3e (rtol %g, atol %g)"
              % (what, e, SDF_RTOL, SDF_ATOL, rel, e_auto, SDF_AUTO_RTOL,
                 SDF_AUTO_ATOL))
        err_grad = max(err_grad, e)

    training = sdf_training_counts(packed, runner, pts_fwd)
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
    entries[0]["training_counts"] = training
    return entries


def one_acc_reading(packed, pts, want_sdf, want_grad, pts_fwd):
    """A reading, not a gate: both SDF kernels as the design before this
    one built them (the three products of a depth-8 step in one
    accumulator), on the same trained net and points, against the plain
    versions: the error the second accumulator took away."""
    saved = sdf_kernel._lib
    sdf_kernel._lib = sdf_kernel.load(sdf_kernel.build(SDF_ONE_ACC_FLAGS)[0])
    try:
        sdf, grad = sdf_kernel.sdf_fwdgrad(packed, pts)
        fwd = sdf_kernel.sdf_fwd(packed, pts_fwd)
    finally:
        sdf_kernel._lib = saved
    fwd_err = float((fwd - sdf_kernel.sdf_fwd_plain(packed, pts_fwd)).abs()
                    .max())
    err = (grad - want_grad).abs()
    past = int((err > SDF_ATOL + SDF_RTOL * want_grad.abs()).sum())
    print("the design before (one accumulator) on the same net: sdf_fwd at "
          "%d points max abs err %.3e; sdf_fwdgrad at %d points sdf %.3e, "
          "gradient %.3e (%d of %d components past rtol %g x |component| + "
          "atol %g)"
          % (len(pts_fwd), fwd_err, len(pts),
             float((sdf - want_sdf).abs().max()), float(err.max()), past,
             grad.numel(), SDF_RTOL, SDF_ATOL))


def sdf_training_counts(packed, runner, pts):
    """Kernel 3 at the point counts of one NeuS training step's up-sample
    chain (batch x n_samples, then batch x n_importance / up_sample_steps
    each later round) in the carve phase and in the tail: device time,
    plain version, bound."""
    out = {}
    rays = runner.tcfg.batch_size
    for phase, c in (("carve", runner.cfg), ("tail", runner._tail_cfg)):
        for n in (rays * c.n_samples,
                  rays * c.n_importance // c.up_sample_steps):
            p = pts[:n]
            device_ms, _ = _device_ms(lambda: sdf_kernel.sdf_fwd(packed, p),
                                      reps=20)
            plain_ms = _time_ms(lambda: sdf_kernel.sdf_fwd_plain(packed, p),
                                reps=10)
            bound_ms, by, _, _, _ = _sdf_bound(packed, n, False)
            print("sdf_fwd at %d points (%s phase of NeuS training, %d rays x "
                  "%d): %.4f ms of device time, plain version %.4f ms, bound "
                  "%.4f ms by %s: %.1f%% of it"
                  % (n, phase, rays, n // rays, device_ms, plain_ms,
                     bound_ms, by, 100 * bound_ms / device_ms))
            out[str(n)] = {"phase": phase, "device_ms": device_ms,
                           "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": by}
    return out


def write_cli_scene(root):
    """The "cli" phase's scene: write_stage1_scene's textured sphere at
    CLI_IMH with CLI_TRAIN_VIEWS + CLI_VAL_VIEWS views from CLI_EYE_DIST,
    under <root>/data/nfr_blender/<scene>, with the stage-2 interface (a
    metadata.json a view) and the GT albedo and metal of the val views in
    the vis_comps mirror that run_test's albedo scale reads."""
    data_root = os.path.join(root, "data", "nfr_blender", GEO_SCENE)
    write_stage1_scene(data_root, CLI_IMH, CLI_TRAIN_VIEWS, CLI_VAL_VIEWS,
                       SEED, eye_dist=CLI_EYE_DIST)
    for mode in ("train", "val"):
        tj = vio.read_json(os.path.join(data_root,
                                        "transforms_%s.json" % mode))
        for i, frame in enumerate(tj["frames"]):
            vid = "%s_%03d" % (mode, i)
            vio.write_json({"imh": CLI_IMH, "imw": CLI_IMH,
                            "cam_angle_x": tj["camera_angle_x"],
                            "cam_transform_mat": ",".join(
                                str(v) for v in np.reshape(
                                    frame["transform_matrix"], -1))},
                           os.path.join(data_root, vid, "metadata.json"))
            if mode == "val":
                vis = data_root.replace("nfr_blender", "vis_comps")
                vio.write_img(np.full((CLI_IMH, CLI_IMH, 3), [0.8, 0.5, 0.3]),
                              os.path.join(vis, vid, "albedo.png"))
                vio.write_img(np.zeros((CLI_IMH, CLI_IMH, 3)),
                              os.path.join(vis, vid, "metal.png"))
    return data_root


def _launch_counts():
    return {"fused_brdf_render": render_kernel.LAUNCHES,
            "vq_fused_train": vq_kernel.LAUNCHES,
            "sdf_fwd": sdf_kernel.LAUNCHES["sdf_fwd"],
            "sdf_fwdgrad": sdf_kernel.LAUNCHES["sdf_fwdgrad"]}


def _run_cli(argv):
    """cli.main(argv) with every kernel's launch count set to 0 just before
    and read just after; returns (seconds, launches)."""
    render_kernel.LAUNCHES = 0
    vq_kernel.LAUNCHES = 0
    for key in sdf_kernel.LAUNCHES:
        sdf_kernel.LAUNCHES[key] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, _launch_counts()


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def _check_finite_npy(root):
    arrays = [f for f in _files(root) if f.endswith(".npy")]
    for rel in arrays:
        if not np.isfinite(np.load(os.path.join(root, rel))).all():
            raise AssertionError(f"non-finite values in {rel}")
    return len(arrays)


def _export_like_jax(phase_dir, cfg, kind, path):
    """The .npz that scripts/export_jax_ckpt.py writes for a JAX
    checkpoint, made from the port's checkpoint with the port's own
    converters (there is no jax on the card)."""
    state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(phase_dir))
    model = cli._load_phase_model(phase_dir, cfg, kind, "cpu")
    opt_model, opt_kind = ((model.trainable, "ref_nfr/train")
                           if kind == "ref_nfr" else (model, kind))
    tree = {"params": jax_params.to_jax(model, kind),
            "opt_state": jax_params.opt_state_to_jax(
                state["opt_state"], opt_model, opt_kind),
            "epoch": np.asarray(state["epoch"], np.int32)}
    if kind == "vq_nfr":
        tree["ema"] = jax_params.ema_to_jax(state["ema"])
    return jax_ckpt.write_npz(path, tree)


def cli_phase(root, env_dir, device="cuda"):
    """The port run from a shell's entry point, cli.main(argv), in-process
    so that the kernels' launch counts can be read: geo-train ->
    gen-geo -> decomp-train -> test -> gen-z -> reselect-main on a scene
    of its own, every width the family preset's. Each subcommand's files
    exist and are finite; kernel 3 runs in geo-train, kernels 3 and 4 in
    gen-geo, kernel 2 once a vq_nfr step in decomp-train and kernel 1 in
    test. Then the trained vq_nfr and ref_nfr go out in the JAX exporter's
    format, come back through interop/jax_ckpt into a fresh tree and are
    served again, every array within the render kernel's tolerance of the
    directly served one; and `python -m vqnerf_release_torch.cli test` in a
    fresh process writes the same files. Returns (launches by subcommand,
    seconds by subcommand)."""
    data_root = write_cli_scene(os.path.join(root, "cli"))
    out = os.path.join(root, "cli", "output")
    dev = ["--device", str(device)]
    common = ["--data-root", data_root, "--output-root", out, *dev]
    shipped_cfg, shipped, _ = vcfg.neus_configs_for_scene(GEO_SCENE)
    warm = round(shipped.warm_up_end * CLI_GEO_ITERS / shipped.end_iter)
    preset = "imh=%d,total_sample_vq=%d" % (CLI_IMH, CLI_VQ_SAMPLES)
    print("cli cuts: %d train + %d val views of %dx%d (cameras at distance "
          "%g); geo-train --end-iter %d for the shipped %d, warm_up_end %d "
          "for %d through --geo-override; gen-geo at its defaults; "
          "decomp-train --epochs 1 for 150, --preset-override %s (the "
          "views' size, and the VQ evaluation set of %d rows for 200,000); "
          "every width the family preset's"
          % (CLI_TRAIN_VIEWS, CLI_VAL_VIEWS, CLI_IMH, CLI_IMH, CLI_EYE_DIST,
             CLI_GEO_ITERS, shipped.end_iter, warm, shipped.warm_up_end,
             preset, CLI_VQ_SAMPLES))
    runs = [
        ("geo-train", ["geo-train", GEO_SCENE, *common, "--end-iter",
                       str(CLI_GEO_ITERS), "--geo-override",
                       "warm_up_end=%d" % warm]),
        ("gen-geo", ["gen-geo", GEO_SCENE, *common]),
        ("decomp-train", ["decomp-train", GEO_SCENE, *common, "--phase",
                          "all", "--epochs", "1", "--preset-override",
                          preset]),
        ("test", ["test", GEO_SCENE, *common, "--test-envmap-dir", env_dir,
                  "--preset-override", "imh=%d" % CLI_IMH]),
        ("gen-z", ["gen-z", GEO_SCENE, *common, "--mode", "vali",
                   "--gen-z"]),
        ("reselect-main", ["reselect-main", GEO_SCENE, "--output-root", out,
                           "--dry-run", *dev]),
    ]
    seconds, launches = {}, {}
    for name, argv in runs:
        seconds[name], launches[name] = _run_cli(argv)
        print("cli %s: %.3f s, kernel launches %s"
              % (name, seconds[name], launches[name]), flush=True)

    # kernel 3 in every geo-train step's up-sample chain (no validation:
    # the command gives the runner no validation set)
    tail_start = CLI_GEO_ITERS - int(round(shipped.tail_frac
                                           * CLI_GEO_ITERS))
    want = (shipped_cfg.up_sample_steps * tail_start
            + vcfg.parse_sampler_spec(shipped.tail_sampler)["up_sample_steps"]
            * (CLI_GEO_ITERS - tail_start))
    if launches["geo-train"]["sdf_fwd"] != want:
        raise AssertionError(f"geo-train launched kernel 3 "
                             f"{launches['geo-train']['sdf_fwd']} times, "
                             f"not {want}")
    if min(launches["gen-geo"]["sdf_fwd"],
           launches["gen-geo"]["sdf_fwdgrad"]) <= 0:
        raise AssertionError(f"gen-geo launched {launches['gen-geo']}")
    n_vq_steps = CLI_TRAIN_VIEWS  # 1 epoch, a step a train view
    if launches["decomp-train"]["vq_fused_train"] != n_vq_steps:
        raise AssertionError(
            f"decomp-train launched kernel 2 "
            f"{launches['decomp-train']['vq_fused_train']} times in "
            f"{n_vq_steps} vq_nfr steps")
    if launches["test"]["fused_brdf_render"] <= 0:
        raise AssertionError(f"test launched {launches['test']}")

    # the JAX CLI's tree for these subcommands
    exp = os.path.join(out, "exp", GEO_SCENE, "nerf", "checkpoints")
    if os.listdir(exp) != ["ckpt-%d" % CLI_GEO_ITERS]:
        raise AssertionError(f"geo-train wrote {os.listdir(exp)}")
    surf = vcfg.surf_dir(os.path.join(out, "surf"), GEO_SCENE)
    views = ["train_%03d" % i for i in range(CLI_TRAIN_VIEWS)] + \
        ["val_%03d" % i for i in range(CLI_VAL_VIEWS)]
    if sorted(os.listdir(surf)) != views or not all(
            gen_geo.check_finished(os.path.join(surf, v)) for v in views):
        raise AssertionError(f"gen-geo wrote {_files(surf)}")
    n_arrays = _check_finite_npy(surf)
    train = {m: vcfg.train_outdir(out, GEO_SCENE, m)
             for m in ("nfr_unit", "vq_nfr", "ref_nfr")}
    for m, d in train.items():
        need = [os.path.join("checkpoints", "ckpt-1"), "train_log.jsonl",
                os.path.join("vis_vali", "metas.json"),
                os.path.join("vis_vali", "epoch%09d" % 1)]
        for rel in need:
            if not os.path.exists(os.path.join(d, rel)):
                raise AssertionError(f"decomp-train: no {m}/{rel}")
        for row in _read_log(d):
            if not all(np.isfinite(v) for v in row.values()
                       if isinstance(v, float)) or row["skipped_steps"]:
                raise AssertionError(f"decomp-train {m}: {row}")
    vali = os.path.join(train["vq_nfr"], "vis_vali", "epoch%09d" % 1)
    n_vq = find_vq(vali)
    cfg, _ = vcfg.decomp_config_for_scene(GEO_SCENE, imh=CLI_IMH)
    served = os.path.join(train["ref_nfr"], "vis_test", "latest")
    n_arrays += check_outputs(served, expected_files(cfg, env_dir),
                              CLI_VAL_VIEWS, n_vq)
    gz = os.path.join(train["nfr_unit"], "gen_z")
    want_gz = sorted(os.path.join("val_%03d" % i, f)
                     for i in range(CLI_VAL_VIEWS)
                     for f in ("albedo.npy", "albedo.png", "spec.npy",
                               "spec.png", "rough.npy", "rough.png",
                               "z_bias.npy"))
    if _files(gz) != want_gz:
        raise AssertionError(f"gen-z wrote {_files(gz)}")
    n_arrays += _check_finite_npy(gz) + _check_finite_npy(
        os.path.join(train["nfr_unit"], "vis_vali"))
    print("cli: the JAX CLI's tree is there (exp/%s/nerf/checkpoints, "
          "surf/nerf_surf/%s/{%s}, train/%s_{nfr_unit,vq_nfr,ref_nfr}/"
          "lr5e-4, vis_test/latest, gen_z), %d arrays finite; main_%d"
          % (GEO_SCENE, GEO_SCENE, ",".join(views), GEO_SCENE, n_arrays,
             n_vq))

    # the trained models out in the exporter's format and back in
    fresh = os.path.join(root, "cli", "imported")
    for kind in ("vq_nfr", "ref_nfr"):
        npz = _export_like_jax(train[kind], cfg, kind,
                               os.path.join(root, "cli", kind + ".npz"))
        jax_ckpt.main([npz, vcfg.train_outdir(fresh, GEO_SCENE, kind),
                       "--kind", kind, "--scene", GEO_SCENE])
    # the validation tree travels with a trained scene (main_<k>, the light)
    for sub in ("epoch%09d" % 1, "np_light.npy"):
        src = os.path.join(train["vq_nfr"], "vis_vali", sub)
        dst = os.path.join(vcfg.train_outdir(fresh, GEO_SCENE, "vq_nfr"),
                           "vis_vali", sub)
        if os.path.isdir(src):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            subprocess.run(["cp", "-r", src, dst], check=True)
    test_argv = ["test", GEO_SCENE, "--data-root", data_root,
                 "--output-root", fresh, "--surf-root", surf,
                 "--test-envmap-dir", env_dir, "--preset-override",
                 "imh=%d" % CLI_IMH, *dev]
    seconds["test (imported)"], launches["test (imported)"] = \
        _run_cli(test_argv)
    again = os.path.join(vcfg.train_outdir(fresh, GEO_SCENE, "ref_nfr"),
                         "vis_test", "latest")
    if _files(again) != _files(served):
        raise AssertionError("the imported models wrote other files")
    err, n_cmp, same_png = 0.0, 0, 0
    for rel in _files(served):
        a, b = os.path.join(again, rel), os.path.join(served, rel)
        if rel.endswith(".npy"):
            err = max(err, _compare(torch.from_numpy(np.load(a)).double(),
                                    torch.from_numpy(np.load(b)).double(),
                                    "imported against direct, " + rel))
            n_cmp += 1
        elif rel.endswith(".png"):
            same_png += open(a, "rb").read() == open(b, "rb").read()
    print("cli test (imported): %.3f s, %d arrays within rtol %g / atol %g "
          "of the directly served ones (max abs err %.3e), %d of %d PNGs "
          "equal byte for byte"
          % (seconds["test (imported)"], n_cmp, RTOL, ATOL, err, same_png,
             sum(f.endswith(".png") for f in _files(served))))

    # the module entry in a fresh process
    moved = again + "_in_process"
    os.rename(again, moved)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vqnerf_release_torch.cli", *test_argv],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=CLI_TIMEOUT_S)
    seconds["python -m cli test"] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError("python -m vqnerf_release_torch.cli test exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    if _files(again) != _files(moved):
        raise AssertionError("python -m vqnerf_release_torch.cli test wrote "
                             "other files")
    print("cli: python -m vqnerf_release_torch.cli test in a fresh process: "
          "exit 0 in %.3f s, the same %d files"
          % (seconds["python -m cli test"], len(_files(again))))
    return launches, seconds


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
        vq_replay(cfg, trained, device)
        ref = ref_phase(cfg, paths, trained, os.path.join(root, "train"),
                        device)
        sys.stdout.flush()

        # ---- the serving half, with the trained models --------------------
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

        # ---- stage 1: geometry training, then extraction from it ---------
        neus = neus_train_phase(root, device, profile)
        sys.stdout.flush()
        geo = extraction_phase(root, device, neus, profile)
        sys.stdout.flush()

        # ---- each kernel against its plain version, and the timings ------
        lxyz, lareas = dc.light_constants(cfg, device)
        with torch.inference_mode():
            render_entry = check_render_kernel(vq, cfg, view, lxyz, lareas,
                                               device)
            vq_entry = check_vq_kernel(trained, cfg, device)
        fwd_entry, fwdgrad_entry = check_sdf_kernels(geo, neus["runner"],
                                                     device)
        time_steps(cfg, trained, lxyz, lareas, device, profile)
        render_entry["launches"] = render_launches
        vq_entry["launches"] = trained["launches"]
        fwd_entry["launches"] = neus["launches"] + geo["launches"]["sdf_fwd"]
        fwdgrad_entry["launches"] = geo["launches"]["sdf_fwdgrad"]
        print("kernel 3 (sdf_fwd) launches on the main path: %d in NeuS "
              "training + %d in extraction = %d; kernel 4 (sdf_fwdgrad) %d, "
              "all in extraction"
              % (neus["launches"], geo["launches"]["sdf_fwd"],
                 fwd_entry["launches"], fwdgrad_entry["launches"]))
        del geo, neus, trained, vq, ref  # the card for the CLI's chain
        sys.stdout.flush()

        # ---- the CLI: the chain a user runs from a shell ------------------
        t0 = time.perf_counter()
        cli_launches, cli_seconds = cli_phase(root, paths["env_dir"], device)
        print("cli phase: %.1f s; seconds by subcommand %s"
              % (time.perf_counter() - t0, json.dumps(cli_seconds)),
              flush=True)

    for entry in (render_entry, vq_entry, fwd_entry, fwdgrad_entry):
        by_sub = {sub: n[entry["name"]] for sub, n in cli_launches.items()}
        entry["cli_launches"] = sum(by_sub.values())
        entry["cli_launches_by_subcommand"] = by_sub
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [render_entry, vq_entry, fwd_entry,
                                  fwdgrad_entry]}))
    print("nvidia-smi:", smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
