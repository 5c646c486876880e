#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqnerf_release_torch) on one GPU.

    python3 chip_smoke.py [--profile]

(--profile adds torch.profiler tables of the training step and of the
fast-vis shadow pass.)

1. checks for a CUDA device and prints its name and power limit;
2. builds the three CUDA sources of csrc/ and the SDF source once more as
   the design before (one accumulator; for a reading in 8), four nvcc
   processes side by side (four kernels, the render kernel in four
   instances), and the host sampler's library (csrc/fastloader.cpp, the
   host compiler) beside them, and prints the
   build time, ptxas' register and spill counts, and the count of
   tensor-core instructions (HGMMA / HMMA) that cuobjdump -sass finds in
   the SDF library, which must not be 0, and the host library's build
   seconds, compiler and version and its OpenMP thread count;
3. writes a synthetic sphere scene in the reference layout to a temporary
   directory: 4 train and 2 val views of 512x512 rays with 512-light lvis,
   the vis_comps GT-albedo mirror and 16 probe .hdr files (the first 8
   named by metric_eval.ENV_LIGHTS_CG);
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
       boundary and with 510 lights (both must run the scalar instance),
       and a whole 512x512 view in one call (as apply_edit launches it);
       rtol 2e-4, atol 1e-5 (a 512-term fp32 sum taken in another order),
       and the fused vq_fast_render against the eager;
     fused_brdf_render_maps: the relight pass's maps (the learned light,
       the probes, the OLATs) over a 49,152-ray chunk of a view and over
       its ragged last chunk, lvis given, one launch of the vector
       instance each, at the same tolerance; timed beside its plain twin,
       a view's device time the chunks' sum;
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
   then models/sdf_manual.py ("sdf_manual" lines, sdf_manual_phase) on
   the trained NeuS's SDF at the point counts the training step's render
   passes to fields.sdf_value_feature_gradient in the carve and in the
   tail: sdf and feature equal to it, grad within rtol 1e-4 / atol 1e-5;
   the gradients of a loss over all three outputs against nested autograd
   (each scaled by its max, within SDF_MANUAL_GRAD_TOL); sdf and grad
   against kernel 4 at its tolerance; forward+backward of both paths
   timed (events, median; device_ms) with their peak memory;
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
   torch.profiler table of a few steps. Then the scanned dispatch ("scan"
   lines, scan_phase): nfr_unit and vq_nfr trained scanned (chunks of 2)
   and step by step, held bit for bit, with kernel 2 once a vq_nfr step and
   the graph replays counted; a chunk of vq_nfr steps timed as replays and
   eager; device_sampling for SCAN_EPOCHS epochs; the u8 store against
   float32; NeuSRunner.train from the trained checkpoint with
   steps_per_dispatch SCAN_K and with 1, across two occupancy rebuilds and
   into the tail, held bit for bit, with its peak memory; and the k-step
   dispatch of each phase timed against single steps. Then the scanned
   dispatch over a device list ("mesh" lines, mesh_scan_phase, over
   MESH_SCAN: two entries on the one card, each on a stream of its own):
   nfr_unit, vq_nfr and ref_nfr for MESH_EPOCHS epochs scanned in chunks
   of 2 against step by step over the mesh, and vq_nfr over the
   row-sharded store (device_views='shard') against 'on', each bit for bit
   with kernel 2 once a vq_nfr step and the replays counted; kernel 2
   inside a replay of the mesh step against its plain version; a chunk of
   vq_nfr steps timed as mesh replays, eager over the mesh and as replays
   on one device, the idle share of mesh replays, the peak memory and the
   store's bytes per mesh entry. Then the host sampler ("host sampler"
   lines, host_sampler_phase; stage 2 samples natively by default,
   VQNERF_NATIVE_SAMPLER unset): a 512x512 view's 1,024 pairs sampled in
   both jitter modes in numpy, natively and over the pool, timed;
   sample_view_pix_many against the serial native calls and the native
   host gather against the store's gather at the same indices, bit for
   bit; nfr_unit and vq_nfr for 2 epochs on the host-gather path
   (device_views='off') with the numpy sampler and natively with the
   prefetch, each with its epoch walls and its idle share under
   torch.profiler, kernel 2 once a vq_nfr step, finite losses and
   checkpoints equal to the returned state; nfr_unit for 4 epochs
   natively sampled, scanned against step by step, bit for bit;
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
11. edits and renders video ("edit and video"; every kernel's launch
   count set to 0 just before each step and read just after, each step's
   seconds and peak memory printed): right after step 5, apply_edit with
   MATERIAL_DB["gold"] on the 2 served 512x512 views, a view a call, inside
   the segment of the pd_vq pass's most common code with its right half
   erased, under the learned light and under a probe of step 3 (kernel 1
   launched, every launch of the 16-byte instance; outside the mask every
   map and the rgb PNG equal an unedited render's bit for bit, and so do
   the rgb tensors of both renders; inside, albedo, spec and rough are
   gold's exactly; every array finite); one edit_server_loop round in a
   thread, driven by submit_edit and wait_finished; the web UI on a
   loopback port, a GET of a view and a POST of a painted mask that comes
   back as painted. After step 10, on its scene and trained tree: a
   trajectory of VIDEO_FRAMES frames (transforms_test.json), geo-video at
   its defaults (kernels 3 and 4 launched; each frame's 8 files and
   metadata finite), gen-video in the five modes with the probes and an
   edit workspace written with edit_client (kernel 1 in recon, gen_comps,
   edit and vq_dcomps; in relight, whose learned light and probes are
   rendered together, the multi-map kernel alone; video.avi of recon and
   gen_comps held to its header's frame
   count, size and rate), and `python -m vqnerf_release_torch.cli
   edit-server` as a subprocess (SERVER_LAUNCHER), sent one edit, waited
   for and terminated, which reports its own launch counts and peak memory
   (kernel 1 launched, every launch of the 16-byte instance). Then video
   frames ("frame phase"; no kernel on its path, every launch count set to
   0 just before and read as 0 just after): utils/vis.py's make_frame on
   step 5's 512x512 raw_test view dirs, the layout FRAME_LAYOUT with a
   uint8 thumbnail of a probe on each view and FRAME_MISSING on one, each
   equal bit for bit to a numpy composition written in the script, None
   for an empty dir, and a two-frame make_anim read back with the port's
   PNG reader (frames, count, loop, delays); its ms per frame printed
   with the card's name and power limit;
12. evaluates and imports ("eval and import"; every kernel's launch count
   set to 0 just before each step and read just after): metric-eval
   (family nerf: rgb, kd with the albedo scale, relights under the 8
   ENV_LIGHTS_CG probes of step 3) through cli.main on step 10's trained
   tree, bridged to resolve_scene_dirs' layout by ckpt-1 links, with
   LPIPS from random weights of AlexNet's shapes; eval_dataset (family
   mat: 512 -> 420, ks and rough) and cluster-eval on step 5's served
   views; mean shift on step 10's gen-z materials and on seeded
   materials of 5 clusters over two 512x512 views (at least 3 centres);
   the CSV tables; each on the card and again on the CPU (JSONs and CSV
   float cells within 1e-9 relative, label maps equal, other CSV cells
   equal; no kernel launched), and the SSIM and LPIPS times of one
   512x512 view. Then step 10's trained vq_nfr and ref_nfr written as
   reference-layout TF checkpoints (write_tf_checkpoint: there is no
   TensorFlow on the card), imported by tf_import.main into a fresh tree
   (every tensor equal to the trained one bit for bit) and served by
   `test` (kernel 1, every launch of the 16-byte instance; every array
   within rtol 2e-4 / atol 1e-5 of the direct serve); the ref_nfr import
   again through `python -m vqnerf_release_torch.interop.tf_import`,
   its checkpoint equal to the in-process one;
13. turns a capture into a scene and reads the remaining file formats
   ("capture and formats"; every kernel's launch count set to 0 just
   before each step and read just after, each step's seconds and peak
   memory printed; a kernel launched where none should be fails): right
   after step 11's edits, step 3's probes rewritten as float32 ZIP EXRs
   (and HALF_PROBES as half EXRs, ZIPS and NONE) and `test`'s run_test
   over one served 512x512 view with each probe directory (kernel 1
   launched, all of the 16-byte instance; the float32 EXRs' pd_relit PNGs
   equal the .hdr run's bit for bit, the half probes' difference
   printed). After step 12: the textured sphere rendered as a capture
   (CAPTURE_TRAIN + CAPTURE_VAL 8-bit views of CAPTURE_IMH), a binary
   COLMAP model of its cameras (PINHOLE, qvec / tvec, points with tracks
   on the sphere and on the table it stands on), imgs2poses(run_sfm=False)
   (every world_mat K.w2c, 99% of the points inside scale_mat's unit
   sphere), the colmap_* scene layout ({train,val}.json, 16-bit rgba.png),
   the DtuSceneDataset's rays against the frames' alpha (99% of the pixels
   agree), then cli.main geo-train (CAPTURE_GEO_ITERS steps at the "ours"
   preset: 512 rays, new_h 420, kernel 3 exactly up_sample_steps a step)
   and gen-geo (kernel 3, no lvis so no kernel 4); the same views through
   the ArUco conversion (convert_cameras with a crop: world mats with the
   principal point shifted, the crops equal the frames') and
   make_real_dataset at CAPTURE_REAL_IMH (the rays of NerfSceneDataset and
   NerfRaysDataset equal nerf_rays of the capture's c2w); the committed
   JPEG fixtures (tests/data/torch_jpeg) equal to cv2's decodes committed
   beside them, with the decode seconds on the host; a seeded 35 MB MERL
   .binary through merl_to_npz and read_merl; render_brdf_sphere at its
   defaults and ShapeRefine's forward, loss and backward at DecompConfig
   widths over CAPTURE_SHAPE_RAYS rays, each on the card and on the CPU
   (rtol 1e-5);
14. runs the last of the port ("import, acceptance and parallel"; every
   kernel's launch count set to 0 just before each step and read just
   after): stage 1's trained NeuS written as a reference .pth and imported
   by interop/torch_import.main (params equal bit for bit), one view
   extracted from it equal to step 7's byte for byte (kernels 3 and 4);
   scripts/torch_acceptance.py on the cli tree against the eval phase's
   own scores (every row PASS, kernel 1 in its test) and against a copy
   with rgb raised by 10 dB (that row FAIL, exit 1); two `python -m
   vqnerf_release_torch.cli gen-geo --num-hosts 2` processes on the one
   card (gloo), each reporting its own launches, their trees' union equal
   to step 10's gen-geo tree, and one such process alone; the mesh
   PAR_MESH (two replicas on the card): one view extracted over it, and
   PAR_VQ_STEPS vq_nfr steps equal to one device's at rtol 2e-4 / atol
   1e-5 with kernel 2 once a step, each step's time beside one device's;
15. prints the pass times, peak device memory of each path, each
   subcommand's seconds, the script's total, a {"kernels": [...]} line with
   all five kernels (each with ms, device_ms, plain_ms, bound_ms; the
   multi-map kernel's launches are run_test's and, by step, those its
   render_instances record in the edit, eval, capture and final steps; kernel
   3's launches are those of NeuS training and extraction, given apart on
   an earlier line; cli_launches, the launches of step 10, and
   cli_launches_by_subcommand; edit_video_launches and
   edit_video_launches_by_step, those of step 11; eval_import_launches
   and eval_import_launches_by_step, those of step 12; capture_launches
   and capture_launches_by_step, those of step 13; final_launches and
   final_launches_by_step, those of step 14; host_sampler_launches and
   host_sampler_launches_by_step, those of the host sampler lines of step
   9; sdf_manual_launches and sdf_manual_launches_by_step, kernel 4's in
   the sdf_manual lines of step 8), and as the last line
   {"ok": true, "device": {...}}.

Cuts, all of scale and none of width: 4 train views and 1 validation view
in place of a scene's 100 and 8, 2 epochs in place of 150, 2 served views;
for stage 1 6 train views and 1 val view of 256x256 in place of a scene's
100 and 8 of 512x512 (or larger), and NEUS_ITERS training steps in place of
300,000, with the warm-up cut in proportion and the checkpoint, validation
and mesh at the last step; for the command line 3 train views and 1 val
view of 128x128, CLI_GEO_ITERS geometry steps, 1 epoch a phase and a VQ
evaluation set of CLI_VQ_SAMPLES rows, printed in its "cli cuts" line; for
video VIDEO_FRAMES trajectory frames of 128x128 in place of a test
trajectory's 200 or more, and 2 edited views; for evaluation 1 view of
128x128 (the cli tree) and 2 of 512x512 in place of a scene's 8 at
800x800, 1 view's materials for gen-z's mean shift; for the capture 6
train and 2 val views of 560x560 in place of a capture's tens of
photographs at several megapixels, CAPTURE_GEO_ITERS geometry steps in
place of 100,000, and one served view a probe directory.

Any failure raises and exits non-zero; without CUDA it exits 1 before doing
anything.
"""

import contextlib
import copy
import csv
import dataclasses
import functools
import gc
import glob
import io
import json
import math
import os
import re
import shutil
import struct
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
from vqnerf_release_torch.data import native
from vqnerf_release_torch.data.device_store import DeviceViewStore
from vqnerf_release_torch.data.sampler import build_vq_eval_set, outer_sample
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
from vqnerf_release_torch.eval import (cluster_eval, meanshift, metric_eval,
                                       metrics, vis_csv)
from vqnerf_release_torch.interop import jax_ckpt
from vqnerf_release_torch.interop import jax_params
from vqnerf_release_torch.interop import tf_bundle, tf_import, torch_import
from vqnerf_release_torch.ops.vq import VqEmaState, vq_lookup
from vqnerf_release_torch.parallel.mesh import pad_rows
from vqnerf_release_torch.pipelines import (edit, edit_client, edit_web,
                                            gen_geo)
from vqnerf_release_torch.pipelines.test_driver import (_RAY_CHUNK, find_vq,
                                                         load_novel_lights,
                                                         run_test)
from vqnerf_release_torch.train import decomp_trainer as dt
from vqnerf_release_torch.train import graphed
from vqnerf_release_torch.train import loop as train_loop
from vqnerf_release_torch.train.neus_loop import NeuSRunner
from vqnerf_release_torch.train.neus_trainer import (make_neus_multi_step,
                                                     make_neus_train_step)
from vqnerf_release_torch.utils import ckpt as ckpt_util
from vqnerf_release_torch.utils.vis import make_anim, make_frame

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
# models/sdf_manual.py against nested autograd: the largest gradient error
# over each gradient's max. Both are fp32 sums over the phase's 10^5 points
# in two orders (the JAX test's 2e-5 is for 64 points)
SDF_MANUAL_GRAD_TOL = 1e-4
SDF_MANUAL_REPS = 10
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
CLI_TIMEOUT_S = 600  # the python -m subprocesses
# the "edit and video" phase: the trajectory's frames, and the time an edit
# round may take
VIDEO_FRAMES = 4
# `python -m vqnerf_release_torch.cli` as the edit server's process runs it
# (runpy, run_name "__main__"), which on SIGTERM exits and writes its own
# kernel launch counts and peak device memory to the JSON file named by its
# first argument: the parent's counters cannot see that process.
SERVER_LAUNCHER = """
import json, runpy, signal, sys
import torch
from vqnerf_release_torch.kernels import render, sdf, vq
report = sys.argv.pop(1)
def stop(signum, frame):
    raise SystemExit(0)
signal.signal(signal.SIGTERM, stop)
try:
    runpy.run_module("vqnerf_release_torch.cli", run_name="__main__",
                     alter_sys=True)
finally:
    with open(report, "w") as f:
        json.dump({"launches": {"fused_brdf_render": render.LAUNCHES,
                                "vq_fused_train": vq.LAUNCHES, **sdf.LAUNCHES},
                   "render_instances": render.LAUNCHES_BY_INSTANCE,
                   "peak_bytes": torch.cuda.max_memory_allocated()}, f)
"""
EDIT_TIMEOUT_S = 300
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


def probe_names(n_probes):
    """The probes' names: metric_eval.ENV_LIGHTS_CG first (metric-eval
    scores the relights of those names), then probe<NN>."""
    names = list(metric_eval.ENV_LIGHTS_CG)
    names += ["probe%02d" % j for j in range(len(names), n_probes)]
    return names[:n_probes]


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
    for name in probe_names(n_probes):
        vio.write_hdr(os.path.join(env_dir, name + ".hdr"),
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


def _build_host_sampler():
    """(the host sampler's library, its build's seconds), loaded."""
    t0 = time.perf_counter()
    so, _ = kbuild.build_host(kbuild.CSRC_DIR / "fastloader.cpp",
                              "fastloader")
    seconds = time.perf_counter() - t0
    native.native_available()
    return so, seconds


def build_kernels():
    """Build the three sources and the SDF kernels' one-accumulator
    variant, one nvcc process each, and the host sampler's library, side
    by side."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        jobs = {"render": pool.submit(render_kernel.build),
                "vq": pool.submit(vq_kernel.build),
                "sdf": pool.submit(sdf_kernel.build),
                # the SDF kernels' design before, for the accuracy reading
                "sdf, one accumulator": pool.submit(sdf_kernel.build,
                                                    SDF_ONE_ACC_FLAGS),
                "host sampler": pool.submit(_build_host_sampler)}
        built = {name: job.result() for name, job in jobs.items()}
    host = built.pop("host sampler")
    print("kernel builds: %.3f s for the three sources, a variant and the "
          "host library"
          % (time.perf_counter() - t0))
    for name, (so, log) in built.items():
        print("  %s -> %s" % (name, so.name))
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    cxx = kbuild.host_compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout.splitlines()[0]
    print("  host sampler (csrc/fastloader.cpp) -> %s: %.3f s by %s (%s); "
          "OpenMP threads %s (omp_get_max_threads of its runtime), torch "
          "intra-op threads %d"
          % (host[0].name, host[1], cxx, version, native.openmp_threads(),
             torch.get_num_threads()))
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


SCAN_EPOCHS = 4  # 2 chunks of 2 (the checkpoint period of 4 epochs is 2)
SCAN_VQ_SAMPLES = 4096  # total_sample_vq of the phase's sweeps (200,000)
SCAN_STEPS = 8  # steps of each timed or compared run
SCAN_K = 4  # steps_per_dispatch of the NeuS comparison
SCAN_RUNNER_STEPS = 24  # NeuSRunner.train past the trained checkpoint
SCAN_VIEWS_FOR_BYTES = 100  # the scene store_nbytes prices


def _max_abs(pairs):
    return max((float((a.float() - b.float()).abs().max()) for a, b in pairs),
               default=0.0)


def _held(err_pairs, what):
    """Equal bit for bit, or within the mesh tolerance (rtol 2e-4 / atol
    1e-5) with the max abs err printed; raises otherwise."""
    pairs = list(err_pairs)
    if all(torch.equal(a, b) for a, b in pairs):
        return "equal bit for bit"
    for a, b in pairs:
        _compare(a.float(), b.float(), what, rtol=2e-4, atol=1e-5)
    return "within rtol 2e-4 / atol 1e-5, max abs err %.3e" % _max_abs(pairs)


def _busy_us(events):
    """Microseconds in which the device ran anything: the union of the
    device events' intervals (kernels on concurrent streams overlap, and a
    sum of their times counts the overlap twice)."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profiled_idle(fn, reps):
    """(wall ms, device-busy ms, idle share, summed kernel ms) of reps calls
    of fn under torch.profiler; device-busy is the union of the intervals
    of every CUDA event it saw (graph replays' kernels included), the sum
    their summed times (above the union where streams overlap); None where
    it saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summed = sum(_self_device_us(e) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA) / 1e3
    busy = _busy_us([e for e in prof.events()
                     if e.device_type == DeviceType.CUDA]) / 1e3
    if busy <= 0:
        return 1e3 * wall, None, None, None
    return 1e3 * wall, busy, 1 - busy / (1e3 * wall), summed


def _scan_train(cfg, trained, root, name, steps, device):
    """nfr_unit then vq_nfr for SCAN_EPOCHS on the train views, without
    validation views; the launches and seconds of each go into steps."""
    views = trained["train_views"]
    out = os.path.join(root, "scan", name)
    nfr, h1 = _step(name + " nfr_unit", lambda: train_loop.train_nfr_unit(
        cfg, views, [], out + "/nfr", device=device), steps, label="scan")
    vq, ema, h2 = _step(name + " vq_nfr", lambda: train_loop.train_vq_nfr(
        cfg, nfr, views, [], out + "/vq", device=device,
        cluster_path=os.path.join(trained["vq_dir"], "cluster_centers.npy")),
        steps, label="scan")
    states = [ckpt_util.load_ckpt(ckpt_util.latest_ckpt(out + "/" + ph))
              for ph in ("nfr", "vq")]
    walls = [[r["wall_s"] for r in _read_log(out + "/" + ph)]
             for ph in ("nfr", "vq")]
    return {"models": (nfr, vq), "ema": ema, "hist": (h1, h2),
            "states": states, "walls": walls}


def neus_runner_pair(neus, root, device, steps):
    """NeuSRunner.train resumed from the trained checkpoint (step
    NEUS_ITERS) for SCAN_RUNNER_STEPS more steps, with steps_per_dispatch
    SCAN_K and with 1: the grid rebuilt every 8 steps and the tail moved to
    6 steps before the end, so that the run crosses two rebuilds and the
    carve-to-tail boundary (from 400: the carve's first 16 steps in 4
    dispatches, 2 single steps, the tail's first 4 steps in one dispatch, 2
    single steps). Parameters, Adam
    state and random streams must agree bit for bit (or within the mesh
    tolerance, printed), kernel 3 launch up_sample_steps a step and the
    replays be those of the plan; the runner must hold the tail's graph
    alone at the end. Prints each run's seconds, peak device memory and the
    memory it still holds (reserved, after emptying the cache)."""
    runner = neus["runner"]
    end = NEUS_ITERS + SCAN_RUNNER_STEPS
    tcfg = dataclasses.replace(
        runner.tcfg, end_iter=end, tail_frac=6 / end, occ_update_freq=8,
        save_freq=end, val_freq=end, mesh_freq=0)
    src = ckpt_util.latest_ckpt(runner.base_exp_dir)
    runs = {}
    for k in (SCAN_K, 1):
        exp_dir = os.path.join(root, "scan", "neus_k%d" % k)
        dst = os.path.join(exp_dir, os.path.relpath(src, runner.base_exp_dir))
        os.makedirs(os.path.dirname(dst))
        shutil.copy(src, dst)
        run = NeuSRunner(runner.cfg, dataclasses.replace(
            tcfg, steps_per_dispatch=k), runner.dataset, exp_dir, seed=SEED,
            device=device)
        if run.try_resume() != NEUS_ITERS:
            raise AssertionError(f"resumed at {run.iter_step}")
        if run.tail_start() != end - 6:
            raise AssertionError(f"the tail starts at {run.tail_start()}")
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        replays = graphed.REPLAYS
        hist = _step("neus runner x%d" % k, lambda: run.train(log_every=1),
                     steps, label="scan")
        torch.cuda.empty_cache()  # what stays reserved is held by the run
        runs[k] = {"run": run, "hist": hist,
                   "replays": graphed.REPLAYS - replays,
                   "peak": steps["neus runner x%d" % k]["peak_bytes"],
                   "held": torch.cuda.memory_reserved() - reserved}
    a, b = runs[SCAN_K]["run"], runs[1]["run"]
    held = _held(
        [(x, y) for x, y in zip(a.params.state_dict().values(),
                                b.params.state_dict().values())]
        + [(a.opt.state[k], b.opt.state[k]) for k in b.opt.state]
        + [(a.generator.get_state(), b.generator.get_state())],
        "NeuSRunner.train, steps_per_dispatch %d against 1" % SCAN_K)
    if a.rng.get_state()[2] != b.rng.get_state()[2] or not np.array_equal(
            a.rng.get_state()[1], b.rng.get_state()[1]):
        raise AssertionError("the host ray streams differ")
    if a.occ_builds != b.occ_builds or a.occ_builds != [
            NEUS_ITERS, NEUS_ITERS + 8, NEUS_ITERS + 16]:
        raise AssertionError(f"rebuilds at {a.occ_builds}, {b.occ_builds}")
    want_launches = (runner.cfg.up_sample_steps * (SCAN_RUNNER_STEPS - 6)
                     + runner._tail_cfg.up_sample_steps * 6)
    want_replays = (4 * SCAN_K - 1) + (SCAN_K - 1)  # carve, tail
    for k, r in runs.items():
        got = steps["neus runner x%d" % k]["launches"]["sdf_fwd"]
        if got != want_launches:
            raise AssertionError(f"steps_per_dispatch {k}: kernel 3 "
                                 f"launched {got}, not {want_launches}")
        if not all(np.isfinite(h["loss"]) for h in r["hist"]):
            raise AssertionError(f"steps_per_dispatch {k}: a loss not "
                                 "finite")
    if (runs[SCAN_K]["replays"], runs[1]["replays"]) != (want_replays, 0):
        raise AssertionError(f"graph replays {runs[SCAN_K]['replays']} "
                             f"and {runs[1]['replays']}")
    graphs = [key for key in a._fn_cache if len(key) == 4]
    if graphs != [(SCAN_K, None, True, False)]:
        raise AssertionError(f"the runner holds the graphs of {graphs}")
    print("scan: NeuSRunner.train from the trained checkpoint, steps %d to "
          "%d (rebuilds at %s, the %s tail from %d), steps_per_dispatch %d "
          "against 1: parameters, Adam state and random streams %s; %d "
          "graph replays (a capture in the carve and one in the tail, the "
          "carve's graph freed when the tail began); kernel 3 launched %d "
          "times each way; seconds (capture and host rays included) %.3f "
          "dispatched, %.3f single; peak device memory %d B (%.3f GiB) "
          "dispatched, %d B (%.3f GiB) single; held by the runner after "
          "the run (its model, optimizer, grid and, dispatched, the tail's "
          "graph pool) %.3f and %.3f GiB"
          % (NEUS_ITERS, end, a.occ_builds, runner.tcfg.tail_sampler,
             end - 6, SCAN_K, held, runs[SCAN_K]["replays"], want_launches,
             steps["neus runner x%d" % SCAN_K]["seconds"],
             steps["neus runner x1"]["seconds"], runs[SCAN_K]["peak"],
             runs[SCAN_K]["peak"] / 2**30, runs[1]["peak"],
             runs[1]["peak"] / 2**30, runs[SCAN_K]["held"] / 2**30,
             runs[1]["held"] / 2**30))
    del a, b, runs
    gc.collect()


def scan_phase(cfg, trained, neus, root, device):
    """The scanned dispatch: stage 2 trained scanned (chunks of 2) against
    step by step, bit for bit; a chunk of vq_nfr steps timed as graph
    replays and as eager steps; device sampling; the u8 store;
    NeuSRunner.train with steps_per_dispatch SCAN_K against 1
    (neus_runner_pair); the NeuS k-step dispatch against single steps in
    both phases, timed. Returns the launch counts by step."""
    steps = {}
    views = trained["train_views"]
    k_views = len(views)
    base = dataclasses.replace(cfg, epochs=SCAN_EPOCHS, device_views="on",
                               total_sample_vq=SCAN_VQ_SAMPLES)
    replays0 = graphed.REPLAYS
    runs = {"scanned": _scan_train(dataclasses.replace(
                base, epoch_scan_chunk=2), trained, root, "scanned", steps,
                device)}
    replays = graphed.REPLAYS - replays0
    runs["per-step"] = _scan_train(dataclasses.replace(
        base, epoch_scan=False), trained, root, "per-step", steps, device)
    a, b = runs["scanned"], runs["per-step"]
    pairs = [(x, y) for m_a, m_b in zip(a["models"], b["models"])
             for x, y in zip(m_a.state_dict().values(),
                             m_b.state_dict().values())]
    pairs += list(zip(a["ema"], b["ema"]))
    pairs += [(sa["opt_state"][k], sb["opt_state"][k])
              for sa, sb in zip(a["states"], b["states"])
              for k in sa["opt_state"]]
    held = _held(pairs, "scanned against per-step training")
    hist_held = _held([(torch.tensor(a["hist"]), torch.tensor(b["hist"]))],
                      "per-epoch losses")
    n_steps = SCAN_EPOCHS * k_views
    for name in ("scanned", "per-step"):
        got = steps[name + " vq_nfr"]["launches"]["vq_fused_train"]
        if got != n_steps or steps[name + " nfr_unit"]["launches"][
                "vq_fused_train"]:
            raise AssertionError(f"{name}: kernel 2 launched {got} times in "
                                 f"{n_steps} vq_nfr steps")
    if replays != 2 * (n_steps - 1):
        raise AssertionError(f"{replays} graph replays, expected "
                             f"{2 * (n_steps - 1)}")
    print("scan: nfr_unit + vq_nfr, %d epochs of %d views, scanned in "
          "chunks of 2 against step by step: parameters, EMA and optimizer "
          "states %s; per-epoch losses %s (%s | %s); %d graph replays (one "
          "captured step a phase, its first step eager); kernel 2 launched "
          "%d times a run, one a vq_nfr step (replays counted)"
          % (SCAN_EPOCHS, k_views, held, hist_held, a["hist"], b["hist"],
             replays, n_steps))
    for name, run in runs.items():
        print("  %s epoch wall (s): nfr_unit %s (%.4f in all), vq_nfr %s "
              "(%.4f in all)" % (name, run["walls"][0], sum(run["walls"][0]),
                                 run["walls"][1], sum(run["walls"][1])))

    # ---- a chunk of vq_nfr steps: graph replays against eager steps -----
    lxyz, lareas = dc.light_constants(cfg, device)
    store = DeviceViewStore(views, device)
    rng = np.random.RandomState(SEED)
    vi = [j % k_views for j in range(SCAN_STEPS)]
    pix = np.stack([train_loop.sample_pix(views[v], cfg.n_rays_per_step, rng)
                    for v in vi])
    lrs = [dt.decomp_lr(j, cfg) for j in range(SCAN_STEPS)]
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    models = [copy.deepcopy(trained["vq"]) for _ in range(2)]
    gens = [torch.Generator(device=device).manual_seed(SEED)
            for _ in range(2)]
    _, eager_fn = dt.make_vq_nfr_step(models[0], cfg, lxyz, lareas)
    _, scan_fn = dt.make_vq_nfr_step(models[1], cfg, lxyz, lareas)
    scan = dt.make_vq_epoch_scan(scan_fn, store, SCAN_STEPS,
                                 cfg.n_rays_per_step, trained["ema"], thres)
    state = {"ema": VqEmaState(*(t.clone() for t in trained["ema"]))}

    def eager_chunk():
        for j in range(SCAN_STEPS):
            state["ema"], _ = eager_fn(state["ema"], store.gather(
                vi[j], pix[j]), thres, gens[0], j)

    def scan_chunk():
        scan.stage(vi, lrs, pix=pix, roll_gen=gens[1])
        scan.run(SCAN_STEPS)

    eager_chunk()
    scan_chunk()  # the capture
    step_held = _held(
        [(x, y) for x, y in zip(models[0].state_dict().values(),
                                models[1].state_dict().values())]
        + list(zip(state["ema"], scan.ema)), "a chunk of vq_nfr steps")
    ms = {"graph": [], "eager": []}
    for name in ("graph", "eager", "eager", "graph"):
        fn = scan_chunk if name == "graph" else eager_chunk
        ms[name].append(_median_step_ms(fn, 3) / SCAN_STEPS)
    idle = {name: _profiled_idle(fn, 2) for name, fn in (
        ("graph", scan_chunk), ("eager", eager_chunk))}
    print("scan: a chunk of %d vq_nfr steps (%d rows x %d lights, trained "
          "weights, indices sampled beforehand; host clock, synchronised, "
          "median of 3 chunks, in the order graph, eager, eager, graph): "
          "%s ms a step as graph replays, %s ms a step eager; after the "
          "first chunk each way: %s" % (
              SCAN_STEPS, 2 * cfg.n_rays_per_step, cfg.n_lights,
              ["%.3f" % t for t in ms["graph"]],
              ["%.3f" % t for t in ms["eager"]], step_held))
    for name, (wall, busy, share, _) in idle.items():
        print("  %s, 2 chunks under torch.profiler: %.3f ms wall, %s" % (
            name, wall, "not measured (no device time seen)" if busy is None
            else "device busy %.3f ms, idle share %.3f" % (busy, share)))

    # ---- device sampling ------------------------------------------------
    ds_cfg = dataclasses.replace(base, epoch_scan_chunk=2,
                                 device_sampling=True)
    ds_dir = os.path.join(root, "scan", "ds")
    _, hist = _step("device_sampling nfr_unit", lambda:
                    train_loop.train_nfr_unit(ds_cfg, views, [], ds_dir,
                                              device=device),
                    steps, label="scan")
    if not np.isfinite(hist).all():
        raise AssertionError(f"device sampling: losses {hist}")
    ds_walls = [r["wall_s"] for r in _read_log(ds_dir)]
    from vqnerf_release_torch.data.device_sampler import make_device_sampler
    n_pairs = 0
    for mode in ("random", "contrast"):
        sampler = make_device_sampler(store, views, cfg.n_rays_per_step,
                                      jitter_mode=mode)
        gen = torch.Generator(device=device)
        for v, view in enumerate(views):
            gen.manual_seed(train_loop._sampling_base_key(SEED) + v)
            p = sampler(torch.tensor(v, device=device),
                        *sampler.draw(gen)).cpu().numpy()
            c, j = p[0::2], p[1::2]
            dy, dx = j // view.w - c // view.w, j % view.w - c % view.w
            alpha = view.alpha.reshape(-1)
            if not ((np.abs(dy) <= 1) & (np.abs(dx) <= 1)
                    & ((dy != 0) | (dx != 0))).all():
                raise AssertionError(f"device sampling ({mode}): a pair "
                                     "that is not 8-neighbours")
            if not ((alpha[c] > 0.9) & (alpha[j] > 0.9)).all():
                raise AssertionError(f"device sampling ({mode}): a pair "
                                     "off the foreground")
            n_pairs += len(c)
    print("scan: device_sampling=True, nfr_unit for %d epochs in chunks of "
          "2: losses %s, epoch wall (s) %s (%.4f in all; host-sampled above: "
          "scanned %.4f, step by step %.4f); %d sampled pairs (both jitter "
          "modes, every view): every pair two foreground 8-neighbours"
          % (SCAN_EPOCHS, hist, ds_walls, sum(ds_walls),
             sum(runs["scanned"]["walls"][0]),
             sum(runs["per-step"]["walls"][0]), n_pairs))

    # ---- the u8 store ---------------------------------------------------
    u8 = DeviceViewStore(views, device, quant=True)
    lv_err, others = 0.0, 0
    for v in range(k_views):
        want, got = store.gather(v, pix[v]), u8.gather(v, pix[v])
        for k in want:
            if k == "lvis":
                lv_err = max(lv_err, float((got[k] - want[k]).abs().max()))
            elif not torch.equal(got[k], want[k]):
                raise AssertionError(f"u8 store: {k} differs")
            else:
                others += 1
    if lv_err > 1 / 510 + 1e-7:
        raise AssertionError(f"u8 store: lvis off by {lv_err}")
    from vqnerf_release_torch.data.device_store import store_nbytes
    scene = [views[0]] * SCAN_VIEWS_FOR_BYTES
    print("scan: u8 store against float32: lvis within %.6f (1/510 = "
          "%.6f), %d other buffers bit for bit; store_nbytes of %d views of "
          "%dx%d with %d lights: %d B float32, %d B u8"
          % (lv_err, 1 / 510, others, SCAN_VIEWS_FOR_BYTES, views[0].h,
             views[0].w, cfg.n_lights, store_nbytes(scene),
             store_nbytes(scene, quant=True)))
    del store, u8

    # ---- NeuS through its entry point: NeuSRunner.train ------------------
    neus_runner_pair(neus, root, device, steps)

    # ---- NeuS: SCAN_K steps a dispatch against single steps --------------
    runner = neus["runner"]
    grid = runner._build_occ()
    batches = [runner._host_batch() for _ in range(2 * SCAN_STEPS)]
    for phase, c in (("carve", runner.cfg), ("tail", runner._tail_cfg)):
        models = [copy.deepcopy(runner.params) for _ in range(2)]
        gens = [torch.Generator(device=device).manual_seed(SEED)
                for _ in range(2)]
        opts_fns = [make_neus_train_step(models[0], c, runner.tcfg,
                                         runner.radius, with_occ=True),
                    make_neus_multi_step(models[1], c, runner.tcfg,
                                         runner.radius, SCAN_K,
                                         with_occ=True)]
        it0 = NEUS_ITERS - 2 * SCAN_STEPS

        def singles(part):
            for j in range(SCAN_STEPS):
                opts_fns[0][1](batches[part * SCAN_STEPS + j],
                               it0 + part * SCAN_STEPS + j, occ_grid=grid,
                               generator=gens[0])

        def multis(part):
            for d in range(SCAN_STEPS // SCAN_K):
                lo = part * SCAN_STEPS + d * SCAN_K
                opts_fns[1][1](batches[lo:lo + SCAN_K], it0 + lo,
                               occ_grid=grid, generator=gens[1])

        singles(0)
        name = "neus %s x%d" % (phase, SCAN_K)
        _step(name, lambda: multis(0), steps, label="scan")
        launches = steps[name]["launches"]["sdf_fwd"]
        held = _held([(x, y) for x, y in zip(
            models[0].state_dict().values(), models[1].state_dict().values())]
            + [(opts_fns[0][0].state[k], opts_fns[1][0].state[k])
               for k in opts_fns[0][0].state], "NeuS %s" % phase)
        if launches != c.up_sample_steps * SCAN_STEPS:
            raise AssertionError(f"NeuS {phase}: kernel 3 launched "
                                 f"{launches} times in {SCAN_STEPS} steps")
        t = {"dispatched": [], "single": []}
        for way in ("single", "dispatched", "dispatched", "single"):
            fn = (lambda: singles(1)) if way == "single" else (
                lambda: multis(1))
            t[way].append(_median_step_ms(fn, 1) / SCAN_STEPS)
        wall, busy, share, _ = _profiled_idle(lambda: multis(1), 1)
        print("scan: NeuS %s phase, %d steps as %d dispatches of %d "
              "against %d single steps (trained weights, the occupancy grid "
              "on): parameters and Adam state %s; kernel 3 launched %d "
              "times (%d a step, replays counted); ms a step (host clock, "
              "synchronised, runs of %d steps in the order single, "
              "dispatched, dispatched, single): %s dispatched, %s single; a "
              "dispatched run under torch.profiler: %s"
              % (phase, SCAN_STEPS, SCAN_STEPS // SCAN_K, SCAN_K, SCAN_STEPS,
                 held, launches, c.up_sample_steps, SCAN_STEPS,
                 ["%.3f" % x for x in t["dispatched"]],
                 ["%.3f" % x for x in t["single"]],
                 "not measured" if busy is None else
                 "%.3f ms wall, device busy %.3f ms, idle share %.3f"
                 % (wall, busy, share)))
    return steps


MESH_SCAN = ("cuda:0", "cuda:0")  # two mesh entries, each on its stream
MESH_EPOCHS = 2


def _same_bits(pairs, what):
    """Raises unless every pair is equal bit for bit."""
    for i, (a, b) in enumerate(pairs):
        if not torch.equal(a, b):
            raise AssertionError(
                f"{what}: pair {i} differs, max abs err "
                f"{_max_abs([(a, b)])}")
    return "equal bit for bit (%d tensors)" % len(pairs)


def _mesh_train(cfg, views, trained, root, name, steps, device, nfr=None):
    """nfr_unit (unless ``nfr`` is given), vq_nfr and, with ``nfr`` None,
    ref_nfr, for MESH_EPOCHS over MESH_SCAN without validation views, each
    a step of its own in ``steps``. Returns {phase: (model, final state,
    per-epoch losses)} and the EMA state."""
    out = os.path.join(root, "mesh", name)
    mesh = list(MESH_SCAN)
    got = {}
    if nfr is None:
        nfr, hist = _step(name + " nfr_unit", lambda: train_loop.train_nfr_unit(
            cfg, views, [], out + "/nfr", device=device, devices=mesh),
            steps, label="mesh")
        got["nfr"] = (nfr, hist)
    vq, ema, hist = _step(name + " vq_nfr", lambda: train_loop.train_vq_nfr(
        cfg, nfr, views, [], out + "/vq", device=device, devices=mesh,
        cluster_path=os.path.join(trained["vq_dir"], "cluster_centers.npy")),
        steps, label="mesh")
    got["vq"] = (vq, hist)
    if "nfr" in got:
        light = np.load(os.path.join(out, "vq", "vis_vali", "np_light.npy"))
        got["ref"] = _step(name + " ref_nfr", lambda: train_loop.train_ref_nfr(
            cfg, vq, light, views, [], out + "/ref", device=device,
            devices=mesh), steps, label="mesh")
    for ph, (model, hist) in got.items():
        state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(
            os.path.join(out, ph)))
        got[ph] = (model, state, hist)
    gc.collect()
    torch.cuda.empty_cache()
    return got, ema


def _phase_pairs(a, b, ph):
    (ma, sa, _), (mb, sb, _) = a[ph], b[ph]
    pairs = [(x, y) for x, y in zip(ma.state_dict().values(),
                                    mb.state_dict().values())]
    return pairs + [(sa["opt_state"][k], sb["opt_state"][k])
                    for k in sa["opt_state"]]


def _stashing_vq(stash):
    """ops.vq's kernel 2, stashing its arguments and outputs as clones
    recorded in the capturing graph (so that every replay refreshes them);
    eager calls stash nothing."""
    real = vq_kernel.vq_fused_train

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        if torch.cuda.is_current_stream_capturing():
            stash["args"] = [a.detach().clone() for a in args]
            stash["out"] = {k: v.clone() for k, v in out.items()}
            stash["kw"] = kw
        return out
    return wrapped


def mesh_scan_phase(cfg, trained, paths, root, device):
    """The scanned dispatch over the device list MESH_SCAN (two entries on
    the one card, each on a stream of its own): nfr_unit, vq_nfr and
    ref_nfr for MESH_EPOCHS epochs scanned in chunks of 2 against the same
    runs step by step over the mesh, and vq_nfr over the row-sharded store
    ('shard') against 'on', each bit for bit and each a step of its own
    (launch counts set to 0 before, read after); kernel 2 inside a replay
    of the mesh step against its plain version; a chunk of vq_nfr steps
    timed as mesh replays, eager over the mesh and as replays on one
    device, with the idle share of mesh replays under torch.profiler; the
    store's bytes per mesh entry. Returns the steps."""
    steps = {}
    ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                      data_type="nerf", imh=cfg.imh, mode="train",
                      with_ref=True)
    views = [ds.load_view(f) for f in ds.files]
    k_views = len(views)
    base = dataclasses.replace(cfg, epochs=MESH_EPOCHS, device_views="on",
                               total_sample_vq=SCAN_VQ_SAMPLES)
    replays0 = graphed.REPLAYS
    runs, emas = {}, {}
    runs["scanned"], emas["scanned"] = _mesh_train(
        dataclasses.replace(base, epoch_scan_chunk=2), views, trained, root,
        "scanned", steps, device)
    replays = graphed.REPLAYS - replays0
    runs["per-step"], emas["per-step"] = _mesh_train(
        dataclasses.replace(base, epoch_scan=False), views, trained, root,
        "per-step", steps, device)
    a, b = runs["scanned"], runs["per-step"]
    verdicts = {ph: _same_bits(_phase_pairs(a, b, ph)
                               + (list(zip(emas["scanned"], emas["per-step"]))
                                  if ph == "vq" else []),
                               "mesh %s scanned against step by step" % ph)
                for ph in a}
    for ph in a:
        if a[ph][2] != b[ph][2]:
            raise AssertionError(f"mesh {ph}: per-epoch losses {a[ph][2]} "
                                 f"scanned, {b[ph][2]} step by step")
    n_steps = MESH_EPOCHS * k_views
    for name in ("scanned", "per-step"):
        for ph, want in (("nfr_unit", 0), ("vq_nfr", n_steps),
                         ("ref_nfr", 0)):
            got = steps["%s %s" % (name, ph)]["launches"]["vq_fused_train"]
            if got != want:
                raise AssertionError(f"mesh {name} {ph}: kernel 2 launched "
                                     f"{got} times, not {want}")
    if replays != 3 * (n_steps - 1):
        raise AssertionError(f"{replays} graph replays over the mesh, "
                             f"expected {3 * (n_steps - 1)}")
    print("mesh: nfr_unit, vq_nfr and ref_nfr over %s, %d epochs of %d "
          "views (%d rows a step), scanned in chunks of 2 against step by "
          "step over the mesh: %s; per-epoch losses equal (%s); %d graph "
          "replays (one captured mesh step a phase, its first step eager); "
          "kernel 2 launched %d times a vq_nfr run, one a step (replays "
          "counted)" % (list(MESH_SCAN), MESH_EPOCHS, k_views,
                        2 * cfg.n_rays_per_step,
                        "; ".join("%s %s" % kv for kv in verdicts.items()),
                        {ph: a[ph][2] for ph in a}, replays, n_steps))
    print("  seconds (synchronised, the store staged, checkpoints and the "
          "vq_nfr sweep included): %s; peak device memory %s GiB" % (
              {k: round(v["seconds"], 3) for k, v in steps.items()},
              {k: round(v["peak_bytes"] / 2**30, 3)
               for k, v in steps.items()}), flush=True)

    # ---- 'shard' against 'on' -------------------------------------------
    shard, ema_sh = _mesh_train(
        dataclasses.replace(base, epoch_scan_chunk=2, device_views="shard"),
        views, trained, root, "shard", steps, device,
        nfr=a["nfr"][0])
    sh_held = _same_bits(_phase_pairs(shard, a, "vq")
                         + list(zip(ema_sh, emas["scanned"])),
                         "mesh vq_nfr, 'shard' against 'on'")
    if shard["vq"][2] != a["vq"][2]:
        raise AssertionError("mesh vq_nfr 'shard': per-epoch losses differ")
    if steps["shard vq_nfr"]["launches"]["vq_fused_train"] != n_steps:
        raise AssertionError("mesh vq_nfr 'shard': kernel 2 launched %d "
                             "times" % steps["shard vq_nfr"]["launches"][
                                 "vq_fused_train"])
    from vqnerf_release_torch.data.device_store import store_nbytes
    mesh = [torch.device(d) for d in MESH_SCAN]
    sharded = DeviceViewStore(views, device, mesh=mesh, shard=True)
    per_entry = [sum(bl[s].numel() * bl[s].element_size()
                     for bl in sharded.shards.values())
                 for s in range(len(mesh))]
    whole = store_nbytes(views)
    if per_entry != [store_nbytes(views, shards=len(mesh))] * len(mesh):
        raise AssertionError(f"shard bytes {per_entry}")
    scene = [views[0]] * SCAN_VIEWS_FOR_BYTES
    print("mesh: vq_nfr over %s with device_views='shard' against 'on', "
          "scanned: %s; per-epoch losses equal; the store's bytes per mesh "
          "entry: 'shard' %s, 'on' %d on the first entry (the replicated "
          "store lives there alone; the copies read their row blocks); "
          "%d views of %dx%d with %d lights: %d B whole, %d B a card over 2, "
          "%d B over 4" % (list(MESH_SCAN), sh_held, per_entry, whole,
                           SCAN_VIEWS_FOR_BYTES, views[0].h, views[0].w,
                           cfg.n_lights, store_nbytes(scene),
                           store_nbytes(scene, shards=2),
                           store_nbytes(scene, shards=4)), flush=True)
    del sharded, shard, runs, emas, a, b
    gc.collect()
    torch.cuda.empty_cache()

    # ---- kernel 2 inside a replay of the mesh step ------------------------
    lxyz, lareas = dc.light_constants(cfg, device)
    store = DeviceViewStore(views, device)
    rng = np.random.RandomState(SEED)
    vi = [j % k_views for j in range(SCAN_STEPS)]
    pix = np.stack([train_loop.sample_pix(views[v], cfg.n_rays_per_step, rng)
                    for v in vi])
    lrs = [dt.decomp_lr(j, cfg) for j in range(SCAN_STEPS)]
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    from vqnerf_release_torch.ops import vq as ops_vq
    stash = {}
    ops_vq.vq_fused_train = _stashing_vq(stash)
    try:
        _, fn = dt.make_vq_nfr_step(copy.deepcopy(trained["vq"]), cfg, lxyz,
                                    lareas, mesh=mesh)
        scan = dt.make_vq_epoch_scan(fn, store, 2, cfg.n_rays_per_step,
                                     trained["ema"], thres)
        scan.stage(vi[:2], lrs[:2], pix=pix[:2],
                   roll_gen=torch.Generator(device=device).manual_seed(SEED))
        scan.run(2)  # one eager step, the capture, one replay
    finally:
        ops_vq.vq_fused_train = vq_kernel.vq_fused_train
    torch.cuda.synchronize()
    if scan.graph.replays != 1 or \
            scan.graph.launches_per_replay["vq_fused_train"] != 1:
        raise AssertionError("the mesh replay: %d replays, kernel 2 %d a "
                             "replay" % (scan.graph.replays,
                                         scan.graph.launches_per_replay[
                                             "vq_fused_train"]))
    err, differ, near = compare_vq_kernel(stash["out"], stash["args"],
                                          stash["kw"], "kernel 2 in a mesh "
                                          "replay")
    print("mesh: kernel 2 inside a replay of the mesh vq_nfr step (%d rows "
          "of both entries, gathered on the first) against its plain "
          "version: (i) %d indices differ, %d rows near-ties; (ii) max abs "
          "err %.3e (rtol %g, atol %g)" % (
              stash["args"][1].shape[0], differ, near, err, VQ_RTOL,
              VQ_ATOL), flush=True)
    del scan, fn, stash

    # ---- a chunk of vq_nfr steps: mesh replays, mesh eager, one device --
    models, fns = {}, {}
    for name, m in (("mesh graph", mesh), ("mesh eager", mesh),
                    ("one graph", None)):
        models[name] = copy.deepcopy(trained["vq"])
        _, fns[name] = dt.make_vq_nfr_step(models[name], cfg, lxyz, lareas,
                                           mesh=m)
    scans = {name: dt.make_vq_epoch_scan(fns[name], store, SCAN_STEPS,
                                         cfg.n_rays_per_step, trained["ema"],
                                         thres)
             for name in ("mesh graph", "one graph")}
    gens = {name: torch.Generator(device=device).manual_seed(SEED)
            for name in fns}
    state = {"ema": VqEmaState(*(t.clone() for t in trained["ema"]))}

    def eager_chunk():
        for j in range(SCAN_STEPS):
            state["ema"], _ = fns["mesh eager"](
                state["ema"], store.gather(vi[j], pix[j]), thres,
                gens["mesh eager"], j)

    def scan_chunk(name):
        scans[name].stage(vi, lrs, pix=pix, roll_gen=gens[name])
        scans[name].run(SCAN_STEPS)

    chunks = {"mesh graph": lambda: scan_chunk("mesh graph"),
              "mesh eager": eager_chunk,
              "one graph": lambda: scan_chunk("one graph")}
    torch.cuda.reset_peak_memory_stats()
    replays0 = graphed.REPLAYS
    for fn_ in chunks.values():
        fn_()  # the captures, and the eager chunk's first
    step_held = _same_bits(
        [(x, y) for x, y in zip(models["mesh graph"].state_dict().values(),
                                models["mesh eager"].state_dict().values())]
        + list(zip(scans["mesh graph"].ema, state["ema"])),
        "a chunk of mesh vq_nfr steps, replayed against eager")
    ms = {name: [] for name in chunks}
    for name in ("mesh graph", "mesh eager", "one graph", "one graph",
                 "mesh eager", "mesh graph"):
        ms[name].append(_median_step_ms(chunks[name], 3) / SCAN_STEPS)
    wall, busy, share, summed = _profiled_idle(chunks["mesh graph"], 2)
    peak = torch.cuda.max_memory_allocated()
    n_replays = graphed.REPLAYS - replays0
    print("mesh: a chunk of %d vq_nfr steps (%d rows x %d lights, trained "
          "weights, indices sampled beforehand; host clock, synchronised, "
          "median of 3 chunks, in the order mesh graph, mesh eager, one "
          "graph, one graph, mesh eager, mesh graph): %s ms a step replayed "
          "over the mesh, %s ms eager over the mesh, %s ms replayed on one "
          "device; EMA after the first chunk, replayed against eager over "
          "the mesh: %s; 2 chunks of mesh replays under torch.profiler: %s; "
          "%d replays in these chunks; peak device memory %d B (%.3f GiB)"
          % (SCAN_STEPS, 2 * cfg.n_rays_per_step, cfg.n_lights,
             ["%.3f" % t for t in ms["mesh graph"]],
             ["%.3f" % t for t in ms["mesh eager"]],
             ["%.3f" % t for t in ms["one graph"]], step_held,
             "not measured (no device time seen)" if busy is None else
             "%.3f ms wall, device busy %.3f ms (the union of the kernels' "
             "intervals; their times summed %.3f ms: the two entries' "
             "streams overlap), idle share %.3f"
             % (wall, busy, summed, share), n_replays, peak, peak / 2**30),
          flush=True)
    del scans, fns, models, store
    gc.collect()
    torch.cuda.empty_cache()
    return steps


HOST_SCAN_EPOCHS = 4  # the native scanned run against step by step
HOST_REPS = 5  # timed sampling calls, the median taken


@contextlib.contextmanager
def _sampler_env(value):
    """VQNERF_NATIVE_SAMPLER set to ``value`` (None: unset, the default
    native route) for the block, restored after."""
    old = os.environ.get("VQNERF_NATIVE_SAMPLER")
    if value is None:
        os.environ.pop("VQNERF_NATIVE_SAMPLER", None)
    else:
        os.environ["VQNERF_NATIVE_SAMPLER"] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("VQNERF_NATIVE_SAMPLER", None)
        else:
            os.environ["VQNERF_NATIVE_SAMPLER"] = old


def _median_host_ms(fn, reps=HOST_REPS):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def _host_gather_train(name, fn, out, steps):
    """fn() (a trainer of EPOCHS epochs on the host-gather path, writing to
    ``out``) as the step ``name``, under torch.profiler; returns (fn's
    result, the epoch walls of its log, the profiler's reading)."""
    got = {}
    _step(name, lambda: got.__setitem__(
        "idle", _profiled_idle(lambda: got.__setitem__("out", fn()), 1)),
        steps, label="host sampler")
    return got["out"], [r["wall_s"] for r in _check_log(out, name)], \
        got["idle"]


def host_sampler_phase(cfg, trained, root, device):
    """The host sampler (data/native.py over csrc/fastloader.cpp, the JAX
    package's default stage-2 data path) on the train views at DecompConfig
    widths: a view's sampling timed in both jitter modes in numpy, natively
    and over the pool; the pool against serial native calls and the native
    host gather against the store's gather at the same indices, bit for
    bit; nfr_unit and vq_nfr for EPOCHS on the host-gather path
    (device_views='off'), with the numpy sampler and natively with the
    prefetch, each a step (launch counts set to 0 before, read after) with
    its epoch walls and idle share; nfr_unit for HOST_SCAN_EPOCHS scanned
    with native sampling against step by step, bit for bit. Returns the
    steps."""
    steps = {}
    views = trained["train_views"]
    n = cfg.n_rays_per_step
    view = views[0]
    for mode in ("contrast", "random"):
        rs = np.random.RandomState(SEED)
        ms = {"numpy": _median_host_ms(lambda: train_loop.sample_pix(
            view, n, rs, jitter_mode=mode))}
        with _sampler_env(None):
            ms["native"] = _median_host_ms(lambda: train_loop.sample_view_pix(
                view, n, rs, jitter_mode=mode))
            ms["pool"] = _median_host_ms(
                lambda: train_loop.sample_view_pix_many(
                    views, n, rs, jitter_mode=mode)) / len(views)
        print("host sampler, %s jitter, %dx%d view, %d pairs (host clock, "
              "median of %d): numpy sample_pix %.3f ms, native serial %.3f "
              "ms, sample_view_pix_many over %d views %.3f ms a view"
              % (mode, view.h, view.w, n, HOST_REPS, ms["numpy"],
                 ms["native"], len(views), ms["pool"]), flush=True)

    # the pool and the native gather against their references, bit for bit
    store = DeviceViewStore(views, device)
    with _sampler_env(None):
        for mode in ("contrast", "random"):
            rs_a, rs_b = (np.random.RandomState(SEED + 1) for _ in range(2))
            many = train_loop.sample_view_pix_many(views, n, rs_a,
                                                   jitter_mode=mode)
            serial = [train_loop.sample_view_pix(v, n, rs_b, jitter_mode=mode)
                      for v in views]
            if not all(np.array_equal(a, b) for a, b in zip(many, serial)) \
                    or not np.array_equal(rs_a.get_state()[1],
                                          rs_b.get_state()[1]):
                raise AssertionError(f"sample_view_pix_many ({mode}) left "
                                     "the serial native calls")
        rs_a, rs_b = (np.random.RandomState(SEED + 2) for _ in range(2))
        flat = train_loop.sample_view_pix(view, n, rs_b)
        host = train_loop.outer_sample(view, n, rs_a)
        gather_ms = {"native": _median_host_ms(
            lambda: native.gather_batch(view, flat))}
    on_card = store.gather(0, flat)
    if set(host) != set(on_card) or not all(
            np.array_equal(host[k], on_card[k].cpu().numpy()) for k in host):
        raise AssertionError("the native outer_sample batch differs from the "
                             "store's gather at the same indices")
    gather_ms["numpy"] = _median_host_ms(lambda: {
        k: getattr(view, k).reshape(view.h * view.w, -1)[flat]
        for k in host})
    print("host sampler: sample_view_pix_many equals the serial native calls "
          "in both modes and leaves the same RandomState; the native "
          "outer_sample batch (%d rows, %d buffers, %d floats a row) equals "
          "store.gather at the same indices bit for bit; the host gather of "
          "those rows %.3f ms native, %.3f ms numpy indexing (median of %d)"
          % (len(flat), len(host), sum(v.shape[1] for v in host.values()),
             gather_ms["native"], gather_ms["numpy"], HOST_REPS), flush=True)
    del store, on_card
    torch.cuda.empty_cache()

    # stage 2 on the host-gather path: numpy sampling, then native with the
    # prefetch thread
    off = dataclasses.replace(cfg, epochs=EPOCHS, device_views="off",
                              total_sample_vq=SCAN_VQ_SAMPLES)
    n_steps = EPOCHS * len(views)
    for name, env in (("numpy", "0"), ("native", None)):
        out = os.path.join(root, "host", name)
        with _sampler_env(env):
            (nfr, h1), walls1, idle1 = _host_gather_train(
                name + " nfr_unit", lambda: train_loop.train_nfr_unit(
                    off, views, [], out + "/nfr_unit", device=device),
                out + "/nfr_unit", steps)
            (vq, ema, h2), walls2, idle2 = _host_gather_train(
                name + " vq_nfr", lambda: train_loop.train_vq_nfr(
                    off, nfr, views, [], out + "/vq_nfr", device=device),
                out + "/vq_nfr", steps)
        got = [steps[name + ph]["launches"]["vq_fused_train"]
               for ph in (" nfr_unit", " vq_nfr")]
        if got != [0, n_steps]:
            raise AssertionError("%s host-gather runs: kernel 2 launched %s "
                                 "times, want [0, %d]" % (name, got, n_steps))
        if not np.isfinite(h1 + h2).all():
            raise AssertionError(f"{name} host-gather runs: losses {h1} {h2}")
        _check_ckpt(out + "/nfr_unit", nfr, n_steps)
        _check_ckpt(out + "/vq_nfr", vq, n_steps, ema)
        for ph, walls, (wall, busy, share, _) in (
                ("nfr_unit", walls1, idle1), ("vq_nfr", walls2, idle2)):
            print("host sampler, %s sampling, %s on the host-gather path "
                  "(device_views='off'), %d epochs of %d steps: epoch wall %s "
                  "s; the whole call under torch.profiler %.3f ms wall, %s"
                  % (name, ph, EPOCHS, len(views), walls, wall,
                     "device busy not measured (no device time seen)"
                     if busy is None else "device busy %.3f ms, idle share "
                     "%.3f" % (busy, share)), flush=True)
        del nfr, vq, ema

    # the native scanned dispatch against the native per-step one
    models = {}
    for name, kw in (("scanned", dict(epoch_scan_chunk=2)),
                     ("per-step", dict(epoch_scan=False))):
        c = dataclasses.replace(cfg, epochs=HOST_SCAN_EPOCHS,
                                device_views="on", **kw)
        out = os.path.join(root, "host", "scan_" + name)
        with _sampler_env(None):
            models[name] = _step("nfr_unit native " + name,
                                 lambda: train_loop.train_nfr_unit(
                                     c, views, [], out, device=device),
                                 steps, label="host sampler")
    (a, ha), (b, hb) = models["scanned"], models["per-step"]
    same = ha == hb and all(torch.equal(x, y) for x, y in zip(
        a.state_dict().values(), b.state_dict().values()))
    print("host sampler: nfr_unit for %d epochs, natively sampled, scanned "
          "(the pool) against step by step (the prefetch): equal bit for "
          "bit %s; epoch losses %s" % (HOST_SCAN_EPOCHS, same, ha),
          flush=True)
    if not same:
        raise AssertionError("the native scanned nfr_unit run left the "
                             "native per-step run")
    gc.collect()
    torch.cuda.empty_cache()
    return steps


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
    # a whole view in one call, as apply_edit and render_video launch it
    whole = kernel_inputs(vq, cfg, batch, lxyz, lareas)
    n_view = whole[0].shape[0]
    before = render_kernel.LAUNCHES_BY_INSTANCE["vector"]
    e = _compare(render_kernel.fused_brdf_render(*whole),
                 render_kernel.fused_brdf_render_reference(*whole),
                 "whole view")
    if render_kernel.LAUNCHES_BY_INSTANCE["vector"] != before + 1:
        raise AssertionError("whole view: not the vector instance")
    print("fused_brdf_render vs plain version, whole view %dx%d (vector "
          "instance): max abs err %.3e" % (n_view, cfg.n_lights, e))
    err = max(err, e)

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
    view_ms = _time_ms(lambda: render_kernel.fused_brdf_render(*whole))
    view_device_ms, _ = _device_ms(
        lambda: render_kernel.fused_brdf_render(*whole))
    view_plain_ms = _time_ms(
        lambda: render_kernel.fused_brdf_render_reference(*whole), reps=3)
    view_bytes = 4 * (n_view * (5 * 3 + 1) + n_view * l + 8 * l + n_view * 3)
    view_bytes_ms = 1e3 * view_bytes / HBM_BYTES_PER_S
    view_ops_ms = 1e3 * 60 * n_view * l / FP32_OPS_PER_S
    view_bound_ms = max(view_bytes_ms, view_ops_ms)
    print("fused_brdf_render at a whole view, %d rays x %d lights: %.4f ms "
          "a call (events), %.4f ms of device time; plain version %.4f ms; "
          "bound %.4f ms (%d bytes): %.1f%% of it by device time"
          % (n_view, l, view_ms, view_device_ms, view_plain_ms,
             view_bound_ms, view_bytes,
             100 * view_bound_ms / view_device_ms))
    del whole
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
        "whole_view": {"rays": n_view, "ms": view_ms,
                       "device_ms": view_device_ms, "plain_ms": view_plain_ms,
                       "bound_ms": view_bound_ms,
                       "bound_by": ("bytes" if view_bytes_ms >= view_ops_ms
                                    else "operations")},
    }


def check_render_maps_kernel(vq, cfg, view, lxyz, lareas, env_dir, device):
    """The multi-map kernel against its plain twin at the relight pass's
    chunks of a served view (49,152 rows through the sphere, and the view's
    ragged last chunk), lvis given, under the pass's maps: the learned
    light, the probes and the OLATs; returns the kernels-line entry without
    its launch count."""
    batch = {k: torch.as_tensor(x, device=device)
             for k, x in view.as_batch().items() if k != "ref"}
    _, probes, _, olats = load_novel_lights(env_dir, cfg.light_h)
    maps = torch.cat([dc.get_light(vq).reshape(1, -1, 3)] + [
        torch.as_tensor(m, dtype=torch.float32, device=device)
        for m in (probes, olats)])
    e, l = maps.shape[0], cfg.n_lights
    table = render_kernel.pack_light_maps(lxyz, lareas, maps)
    n_view = batch["xyz"].shape[0]
    first_ragged = (n_view - 1) // _RAY_CHUNK * _RAY_CHUNK
    runs = {}
    for what, rows in (("chunk", slice(2 * _RAY_CHUNK, 3 * _RAY_CHUNK)),
                       ("ragged last chunk", slice(first_ragged, n_view))):
        args = kernel_inputs(vq, cfg, {k: v[rows] for k, v in batch.items()},
                             lxyz, lareas)[:7] + [table]
        before = dict(render_kernel.LAUNCHES_BY_INSTANCE)
        got = render_kernel.fused_brdf_render_maps(*args)
        want = render_kernel.fused_brdf_render_maps_reference(*args)
        torch.cuda.synchronize()
        before["maps_vector"] += 1
        if render_kernel.LAUNCHES_BY_INSTANCE != before:
            raise AssertionError(f"multi-map {what}: not one launch of the "
                                 "vector instance")
        err = _compare(got, want, "fused_brdf_render_maps, " + what)
        n = args[0].shape[0]
        print("fused_brdf_render_maps vs plain version, %s %dx%dx%d: max abs "
              "err %.3e" % (what, n, l, e, err))
        runs[what] = (args, n, err)

    # every input read once, the outputs written once; per pair the
    # benchmark's count (benchmark/counts/decomp.py): the light direction
    # 12 operations, the GGX BRDF 75, the weight 12, and 6 a map
    def bound(n):
        nbytes = 4 * (n * (5 * 3 + 1) + n * l + (4 + 3 * e) * l + n * 3 * e)
        ops = (12 + 75 + 12 + 6 * e) * n * l
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        ops_ms = 1e3 * ops / FP32_OPS_PER_S
        return max(bytes_ms, ops_ms), bytes_ms, ops_ms, nbytes, ops

    args, n, _ = runs["chunk"]
    ms = _time_ms(lambda: render_kernel.fused_brdf_render_maps(*args))
    device_ms, per_call = _device_ms(
        lambda: render_kernel.fused_brdf_render_maps(*args))
    plain_ms = _time_ms(
        lambda: render_kernel.fused_brdf_render_maps_reference(*args), reps=3)
    bound_ms, bytes_ms, ops_ms, nbytes, ops = bound(n)
    print("fused_brdf_render_maps at %d rays x %d lights x %d maps: %.4f ms a "
          "call (events around 50 calls), %.4f ms of device time a call in "
          "%.1f launches (torch.profiler); plain version %.4f ms; bound %.4f "
          "ms (%d bytes: %.4f ms; %d operations: %.4f ms): %.1f%% of it by "
          "device time" % (n, l, e, ms, device_ms, per_call, plain_ms,
                           bound_ms, nbytes, bytes_ms, ops, ops_ms,
                           100 * bound_ms / device_ms))
    ragged, n_ragged, _ = runs["ragged last chunk"]
    ragged_device_ms, _ = _device_ms(
        lambda: render_kernel.fused_brdf_render_maps(*ragged))
    ragged_plain_ms = _time_ms(
        lambda: render_kernel.fused_brdf_render_maps_reference(*ragged),
        reps=3)
    ragged_bound_ms = bound(n_ragged)[0]
    # a view is its full chunks and the ragged one
    full = first_ragged // _RAY_CHUNK
    view_device_ms = full * device_ms + ragged_device_ms
    view_bound_ms, view_bytes_ms, view_ops_ms, _, _ = bound(n_view)
    print("fused_brdf_render_maps at the ragged %d rays: %.4f ms of device "
          "time; plain version %.4f ms; bound %.4f ms. A %d-row view (%d "
          "chunks and the ragged one): %.4f ms of device time against a bound "
          "of %.4f ms (bytes %.4f ms, operations %.4f ms)"
          % (n_ragged, ragged_device_ms, ragged_plain_ms, ragged_bound_ms,
             n_view, full, view_device_ms, view_bound_ms, view_bytes_ms,
             view_ops_ms))
    return {
        "name": "fused_brdf_render_maps", "route": "cuda",
        "source": "vqnerf_release_torch/csrc/render_kernel.cu",
        "replaces": None,  # the JAX package relights through plain ops
        "maps": e,
        "max_abs_err": max(err for _, _, err in runs.values()),
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes it
        "ragged": {"rays": n_ragged, "device_ms": ragged_device_ms,
                   "plain_ms": ragged_plain_ms, "bound_ms": ragged_bound_ms},
        "whole_view": {"rays": n_view, "device_ms": view_device_ms,
                       "bound_ms": view_bound_ms,
                       "bound_by": ("bytes" if view_bytes_ms >= view_ops_ms
                                    else "operations")},
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


def circle_c2w(i, n_train, mode, eye_dist=2.0):
    """The c2w (NeRF convention) of write_stage1_scene's view i: on a
    circle of radius eye_dist at height 0.15 eye_dist, looking at the
    origin, the train views evenly spaced and the val views between
    them."""
    ang = 2 * np.pi * (i + (0.5 if mode == "val" else 0.0)) \
        / max(n_train, 1)
    eye = eye_dist * np.array([np.sin(ang), 0.15, np.cos(ang)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
    c2w[:3, 2], c2w[:3, 3] = -fwd, eye
    return c2w


def sphere_rgba(c2w, imh, angle_x, rs):
    """A view [imh, imh, 4] in [0, 1] of the textured sphere of radius
    GEO_GT_RADIUS at the origin from ``c2w``: pixel (x, y) looks along
    ((x - imh // 2) / f, -(y - imh // 2) / f, -1); the texture is fixed to
    the surface (smooth blobs of its base colour), the background white,
    both with 3% of per-pixel noise from ``rs``; alpha is the hit mask."""
    fl = 0.5 * imh / np.tan(0.5 * angle_x)
    xs, ys = np.meshgrid(np.arange(imh, dtype=np.float64),
                         np.arange(imh, dtype=np.float64))
    dirs = np.stack(((xs - imh // 2) / fl, -(ys - imh // 2) / fl,
                     -np.ones_like(xs)), axis=-1)
    eye = c2w[:3, 3]
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
    return rgba


def write_stage1_scene(root, imh, n_train, n_val, seed, eye_dist=2.0):
    """A NeRF-convention stage-1 scene: transforms_{train,val}.json and a
    16-bit rgba.png per view of ``sphere_rgba``'s textured sphere, from the
    cameras of ``circle_c2w``."""
    rs = np.random.default_rng(seed)
    angle_x = 0.8
    for mode, n in (("train", n_train), ("val", n_val)):
        frames = []
        for i in range(n):
            c2w = circle_c2w(i, n_train, mode, eye_dist)
            frames.append({"transform_matrix": c2w.tolist()})
            rgba = sphere_rgba(c2w, imh, angle_x, rs)
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


def _median_event_ms(fn, reps):
    """Median over reps calls of fn of one pair of CUDA events around each
    call, the calls on end, after a warm-up call."""
    fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _peak_bytes(fn):
    """Peak device memory of one call of fn above what was allocated
    before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _nested_vfg(params, x, cfg):
    """(sdf, feature, grad) by nested autograd, differentiable in the leaf
    x as well as in the parameters."""
    out = fields.sdf_apply(params, x, cfg)
    (grad,) = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    return out[:, :1], out[:, 1:], grad


def _sdf_manual_loss(sdf, feature, grad):
    """A loss over all three outputs (an Eikonal term and a grad x feature
    cross term among them): every cotangent is nonzero."""
    eik = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    return (torch.sum(torch.sin(sdf)) * 0.3 + eik
            + torch.sum(feature**2) * 0.01
            + torch.sum(grad * torch.cos(feature[:, :3])))


def _ray_points(runner, n_per_ray, device):
    """batch_size rays of train view 0 (their own RandomState, so the
    runner's draws stay as they were), n_per_ray points each uniform
    between the ray's near and far: [batch_size * n_per_ray, 3]."""
    rng = np.random.RandomState(SEED)
    ds = runner.dataset
    rays = ds.gen_random_rays(0, runner.tcfg.batch_size, rng)
    near, far = ds.near_far(rays["rays_o"], rays["rays_d"])
    z = near + (far - near) * rng.rand(len(near), n_per_ray)
    pts = rays["rays_o"][:, None] + rays["rays_d"][:, None] * z[..., None]
    return torch.as_tensor(pts.reshape(-1, 3), dtype=torch.float32,
                           device=device)


def sdf_manual_phase(neus, device):
    """models/sdf_manual.py on the trained NeuS's SDF, at the point counts
    the training step's render passes to sdf_value_feature_gradient in the
    carve and in the tail (batch_size x (n_samples + n_importance)): the
    checks as the module docstring's item 8 says, each a step whose launch
    counts are read (kernel 4 once); then forward+backward of the manual
    path and of nested autograd (sdf_value_feature_gradient with
    create_graph, the training step's), each the gradient of
    _sdf_manual_loss in every parameter, timed and measured. Returns the
    steps."""
    from vqnerf_release_torch.models.sdf_manual import sdf_vfg_manual
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("sdf_manual: TF32 matmuls are on")
    runner = neus["runner"]
    params, cfg = neus["model"].sdf, runner.cfg.sdf
    packed = sdf_kernel.pack_sdf(params, cfg)
    wrt = list(params.parameters())
    names = [n for n, _ in params.named_parameters()] + ["x"]
    steps = {}
    for phase, c in (("carve", runner.cfg), ("tail", runner._tail_cfg)):
        if c.n_outside:
            raise AssertionError("sdf_manual: a background net")
        pts = _ray_points(runner, c.n_samples + c.n_importance, device)
        what = "sdf_manual %s, %d rays x %d+%d = %d points" % (
            phase, runner.tcfg.batch_size, c.n_samples, c.n_importance,
            len(pts))

        def check(pts=pts, what=what):
            xm = pts.clone().requires_grad_(True)
            sdf, feat, grad = sdf_vfg_manual(params, xm, cfg)
            want = fields.sdf_value_feature_gradient(params, pts, cfg)
            if not (torch.equal(sdf.detach(), want[0])
                    and torch.equal(feat.detach(), want[1])):
                raise AssertionError(f"{what}: sdf or feature differs from "
                                     "sdf_value_feature_gradient's")
            e_grad = _compare(grad.detach(), want[2], what + ", grad",
                              SDF_RTOL, SDF_ATOL)
            del want
            k_sdf, k_grad = sdf_kernel.sdf_fwdgrad(packed, pts)
            e_k = max(_compare(k_sdf, sdf.detach()[:, 0],
                               what + ", kernel 4 sdf", SDF_RTOL, SDF_ATOL),
                      _compare(k_grad, grad.detach(),
                               what + ", kernel 4 grad", SDF_RTOL, SDF_ATOL))
            got = torch.autograd.grad(_sdf_manual_loss(sdf, feat, grad),
                                      wrt + [xm])
            del sdf, feat, grad
            xn = pts.clone().requires_grad_(True)
            ref = torch.autograd.grad(
                _sdf_manual_loss(*_nested_vfg(params, xn, cfg)), wrt + [xn])
            errs = [float((m - a).abs().max() / (a.abs().max() + 1e-8))
                    for m, a in zip(got, ref)]
            worst = int(np.argmax(errs))
            if not all(torch.isfinite(g).all() for g in got) or \
                    errs[worst] > SDF_MANUAL_GRAD_TOL:
                raise AssertionError(
                    f"{what}: gradients against nested autograd, largest "
                    f"scaled error {errs[worst]:.3e} in {names[worst]} "
                    f"(limit {SDF_MANUAL_GRAD_TOL})")
            print("%s (fp32, TF32 off): sdf and feature equal to "
                  "sdf_value_feature_gradient's; grad max abs err %.3e "
                  "(rtol %g, atol %g); the gradients of a loss over all "
                  "three outputs against nested autograd: largest error "
                  "over the gradient's max %.3e in %s (limit %g); against "
                  "kernel 4 (sdf_fwdgrad): max abs err %.3e (rtol %g, atol "
                  "%g)" % (what, e_grad, SDF_RTOL, SDF_ATOL, errs[worst],
                           names[worst], SDF_MANUAL_GRAD_TOL, e_k, SDF_RTOL,
                           SDF_ATOL), flush=True)

        _step(phase, check, steps, label="sdf_manual")
        if steps[phase]["launches"]["sdf_fwdgrad"] != 1:
            raise AssertionError(f"{what}: launches "
                                 f"{steps[phase]['launches']}")
        for name, vfg in (
                ("manual", lambda pts=pts: sdf_vfg_manual(params, pts, cfg)),
                ("nested", lambda pts=pts: fields.sdf_value_feature_gradient(
                    params, pts, cfg, create_graph=True))):
            def run(vfg=vfg):
                torch.autograd.grad(_sdf_manual_loss(*vfg()), wrt)
            ms = _median_event_ms(run, SDF_MANUAL_REPS)
            dev_ms, kernels = _device_ms(run, 3)
            peak = _peak_bytes(run)
            steps[phase][name] = {"ms": ms, "device_ms": dev_ms,
                                  "peak_bytes": peak}
            print("%s, forward+backward %s: %.3f ms (events, median of %d), "
                  "%.3f ms device (torch.profiler, %d kernels a call), peak "
                  "%d bytes (%.3f GiB) above the inputs"
                  % (what, "hand-derived (sdf_vfg_manual)" if name == "manual"
                     else "nested autograd (sdf_value_feature_gradient, "
                     "create_graph)", ms, SDF_MANUAL_REPS, dev_ms, kernels,
                     peak, peak / 2**30), flush=True)
        st = steps[phase]
        print("%s: manual / nested %.3f in ms, %.3f in device ms, %.3f in "
              "peak memory" % (what, st["manual"]["ms"] / st["nested"]["ms"],
                               st["manual"]["device_ms"]
                               / st["nested"]["device_ms"],
                               st["manual"]["peak_bytes"]
                               / st["nested"]["peak_bytes"]), flush=True)
    return steps


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


def _reset_counts():
    render_kernel.LAUNCHES = 0
    for key in render_kernel.LAUNCHES_BY_INSTANCE:
        render_kernel.LAUNCHES_BY_INSTANCE[key] = 0
    vq_kernel.LAUNCHES = 0
    for key in sdf_kernel.LAUNCHES:
        sdf_kernel.LAUNCHES[key] = 0


def _run_cli(argv):
    """cli.main(argv) with every kernel's launch count set to 0 just before
    and read just after; returns (seconds, launches)."""
    _reset_counts()
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


# ---- edit and video ---------------------------------------------------------


def _step(name, fn, steps, label="edit/video"):
    """fn() with every kernel's launch count set to 0 just before and read
    just after; its seconds (synchronised) and peak device memory go into
    ``steps[name]``. Returns fn's result."""
    _reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    steps[name] = {"seconds": time.perf_counter() - t0,
                   "peak_bytes": torch.cuda.max_memory_allocated(),
                   "launches": _launch_counts(),
                   "render_instances": dict(
                       render_kernel.LAUNCHES_BY_INSTANCE)}
    print("%s %s: %.3f s, peak %.3f GiB, kernel launches %s"
          % (label, name, steps[name]["seconds"],
             steps[name]["peak_bytes"] / 2**30, steps[name]["launches"]),
          flush=True)
    return out


def _assert_vector_render(step, name, relit=False):
    """Kernel 1 launched, and with ``relit`` the multi-map kernel too (a
    relight pass), every launch of their 16-byte instances; without
    ``relit`` no multi-map launch."""
    n = step["launches"]["fused_brdf_render"]
    inst = step["render_instances"]
    if n <= 0 or inst["vector"] != n or inst["scalar"] \
            or inst.get("maps_scalar") \
            or (inst.get("maps_vector", 0) > 0) != relit:
        raise AssertionError(f"{name}: render kernel launches {n}, by "
                             f"instance {inst}; every launch must be of the "
                             "16-byte instances, the multi-map kernel's "
                             + ("in a relight pass" if relit else "none"))


def _most_common_code(embed):
    ids, counts = np.unique(embed[embed > 0], return_counts=True)
    if not len(ids):
        raise AssertionError("the pd_vq embed map has no foreground code")
    return int(ids[np.argmax(counts)])


def _check_edit_dirs(edited, plain, masks, views, material):
    """Outside each view's mask the edited maps and rgb PNG equal the
    unedited ones bit for bit; inside it (and inside the object) the
    maps are the material's; every array is finite. Returns the number of
    edited foreground pixels."""
    n_inside = 0
    for i, (ed, pl) in enumerate(zip(edited, plain)):
        v = views[i]
        inside = masks[i]
        fg = v.alpha.reshape(v.h, v.w) > 0
        names = sorted(os.listdir(ed))
        if names != sorted(os.listdir(pl)) or "pred_rgb.png" not in names:
            raise AssertionError(f"apply_edit wrote {names} and {pl}")
        for name in names:
            if name.endswith(".npy"):
                a = np.load(os.path.join(pl, name))
                b = np.load(os.path.join(ed, name))
                if not np.isfinite(b).all():
                    raise AssertionError(f"non-finite {ed}/{name}")
                if not np.array_equal(b[~inside], a[~inside]):
                    raise AssertionError(
                        f"{ed}/{name} differs from the unedited render "
                        "outside the mask")
            elif name.endswith(".png"):
                a = vio.read_png(os.path.join(pl, name))
                b = vio.read_png(os.path.join(ed, name))
                if not np.array_equal(b[~inside], a[~inside]):
                    raise AssertionError(
                        f"{ed}/{name} differs from the unedited render "
                        "outside the mask")
        sel = inside & fg
        n_inside += int(sel.sum())
        for key in ("diff", "spec", "rough"):
            name = {"diff": "albedo", "spec": "spec", "rough": "rough"}[key]
            got = np.load(os.path.join(ed, "pred_%s.npy" % name))[sel]
            want = np.broadcast_to(np.float32(material[key]), got.shape)
            if not np.array_equal(got, want):
                raise AssertionError(
                    f"{ed}/pred_{name}.npy inside the mask: "
                    f"{np.unique(got)[:5]} for {material[key]}")
    return n_inside


def _rgb_outside_mask(ref, vq, cfg, view, mask, probe, device):
    """The rgb of the two renders apply_edit makes (ref_fast_render without
    a probe, vq_fast_render with one), edited and unedited, equal outside
    the mask bit for bit as tensors. Not on the main path."""
    from vqnerf_release_torch.models.ref_nfr import ref_fast_render
    lxyz, lareas = dc.light_constants(cfg, device)
    b = {k: torch.as_tensor(x, dtype=torch.float32, device=device)
         for k, x in view.as_batch().items()}
    b_vq = {k: x for k, x in b.items() if k != "ref"}
    em = torch.as_tensor(mask.reshape(-1, 1), dtype=torch.float32,
                         device=device)
    gold = edit_client.MATERIAL_DB["gold"]
    out = {}
    with torch.inference_mode():
        for what, fn in (
                ("ref_fast_render", lambda m: ref_fast_render(
                    ref, b, cfg, lxyz, lareas, edit_mask=m,
                    edit_material=gold)["rgb"]),
                ("vq_fast_render with a probe", lambda m: vq_nfr.vq_fast_render(
                    vq, b_vq, cfg, lxyz, lareas, edit_mask=m,
                    edit_material=gold, dst_env=probe)["rgb"])):
            edited, plain = fn(em), fn(torch.zeros_like(em))
            keep = em[:, 0] == 0
            if not torch.equal(edited[keep], plain[keep]):
                raise AssertionError(f"{what}: the edited rgb differs "
                                     "outside the mask")
            out[what] = int((edited[~keep] != plain[~keep]).any(-1).sum())
    return out


def _http(port, path, body=None):
    import urllib.request
    data = json.dumps(body).encode() if body is not None else None
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", data=data,
                                timeout=60) as r:
        payload = r.read()
        return (json.loads(payload)
                if "json" in r.headers.get("Content-Type", "") else payload)


def edit_phase(cfg, vq, ref, ds, serve_root, env_dir, root, device):
    """Material editing at serving's full width, on the trained models and
    the served val views (512x512 x 512 lights): apply_edit with gold
    inside the segment of the pd_vq pass's most common code, under the
    learned light and under a probe; one edit_server_loop round driven by
    the client; the web UI's GET and POST on a loopback port. Returns the
    steps' seconds, peak memory and launches."""
    import base64
    import threading

    views = [ds.load_view(f) for f in ds.files]
    pd_vq = os.path.join(serve_root, "pd_vq")
    embeds = [np.load(os.path.join(pd_vq, "batch%09d" % i, "pred_embed.npy"))
              for i in range(len(views))]
    code = _most_common_code(embeds[0])
    # the segment with its right half erased, as a user erases in the UI:
    # the object's rays then lie on both sides of the mask
    masks = [edit_client.auto_select_mask(e, code)
             & (np.arange(e.shape[1]) < e.shape[1] // 2)[None, :]
             for e in embeds]
    flat = [m.reshape(-1, 1).astype(np.float32) for m in masks]
    probe_names, probes, _, _ = load_novel_lights(env_dir, cfg.light_h)
    gold = edit_client.MATERIAL_DB["gold"]
    out = os.path.join(root, "edit")
    steps = {}
    print("edit and video cuts: the %d served views edited (a scene serves "
          "8 or more); %d trajectory frames of %dx%d for a test "
          "trajectory's 200 or more; every width the preset's"
          % (len(views), VIDEO_FRAMES, CLI_IMH, CLI_IMH), flush=True)
    print("edit: gold inside code %d of pd_vq, its right half erased (%s "
          "pixels), on %d views of %dx%d x %d lights, a view a call"
          % (code, [int(m.sum()) for m in masks], len(views), views[0].h,
             views[0].w, cfg.n_lights), flush=True)
    for env, tag in ((None, "learned light"), (probe_names[0],
                                               "probe " + probe_names[0])):
        name = "apply_edit gold, " + tag
        edited = _step(name, lambda: edit.apply_edit(
            ref, vq, cfg, views, gold, flat,
            os.path.join(out, tag, "edited"), dst_env_name=env,
            novel_probes=probes, probe_names=probe_names, device=device),
            steps)
        _assert_vector_render(steps[name], name)
        plain = edit.apply_edit(
            ref, vq, cfg, views, gold, [np.zeros_like(m) for m in flat],
            os.path.join(out, tag, "plain"), dst_env_name=env,
            novel_probes=probes, probe_names=probe_names, device=device)
        n_in = _check_edit_dirs(edited, plain, masks, views, gold)
        print("edit %s: outside the mask every map and the rgb PNG equal "
              "the unedited render's bit for bit; inside (%d foreground "
              "pixels) albedo, spec and rough are gold's exactly"
              % (tag, n_in), flush=True)
    changed = _rgb_outside_mask(
        ref, vq, cfg, views[0], masks[0],
        torch.as_tensor(probes[0], dtype=torch.float32, device=device),
        device)
    print("edit: rgb tensors of view 0 equal the unedited ones outside the "
          "mask, bit for bit; changed inside: %s" % changed, flush=True)

    # one round of the server, in a thread, driven by the client
    srv = os.path.join(out, "server")
    edit_client.submit_edit(srv, "gold", masks, env="original")
    rounds = []

    def serve():
        rounds.append(edit.edit_server_loop(
            ref, vq, cfg, views, srv, novel_probes=probes,
            probe_names=probe_names, poll_interval=0.05, max_rounds=1,
            device=device))

    def server_round():
        th = threading.Thread(target=serve, name="edit-server")
        th.start()
        done = edit_client.wait_finished(srv, timeout=EDIT_TIMEOUT_S,
                                         poll=0.05)
        th.join(timeout=EDIT_TIMEOUT_S)
        if th.is_alive() or rounds != [1]:
            raise AssertionError(f"edit_server_loop: rounds {rounds}")
        return done

    done = _step("edit_server_loop round", server_round, steps)
    _assert_vector_render(steps["edit_server_loop round"],
                          "edit_server_loop")
    same = _files(done) == _files(os.path.join(out, "learned light",
                                               "edited"))
    n_equal = sum(
        open(os.path.join(done, f), "rb").read()
        == open(os.path.join(out, "learned light", "edited", f), "rb").read()
        for f in _files(done)) if same else 0
    if not same:
        raise AssertionError(f"the server wrote {_files(done)}")
    print("edit server: status uploaded -> finished, %d of %d files equal "
          "byte for byte to apply_edit's" % (n_equal, len(_files(done))))

    # the web UI: a GET of a view and a POST of a painted mask
    ui = os.path.join(out, "ui")

    def web_ui():
        httpd = edit_web.serve_edit_ui(ui, pd_vq, port=0,
                                       envs=["original"] + probe_names[:1],
                                       serve_forever=False)
        th = threading.Thread(target=httpd.serve_forever, name="edit-ui")
        th.start()
        try:
            port = httpd.server_address[1]
            info = _http(port, "/api/views")
            if info["views"] != list(range(len(views))):
                raise AssertionError(f"/api/views: {info}")
            page = vio.decode_png(_http(port, "/view/0/embed_map.png"))
            if page.shape != (views[0].h, views[0].w, 3):
                raise AssertionError(f"embed_map.png of {page.shape}")
            h, w = views[0].h, views[0].w
            yy, xx = np.mgrid[:h, :w]
            painted = ((yy - 0.4 * h) ** 2 + (xx - 0.6 * w) ** 2
                       < (0.12 * h) ** 2)
            rgba = np.zeros(painted.shape + (4,), np.uint8)
            rgba[painted] = (255, 0, 255, 255)
            url = "data:image/png;base64," + base64.b64encode(
                vio.encode_png(rgba)).decode()
            said = _http(port, "/api/mask", {"view": 0, "mask_png": url})
            if said != {"count": int(painted.sum())}:
                raise AssertionError(f"/api/mask: {said}")
            _http(port, "/api/submit", {"material": "gold",
                                        "env": "original"})
            got = np.load(os.path.join(ui, "edited", "batch%09d.npy" % 0))
            if not np.array_equal(got, painted):
                raise AssertionError("the submitted mask is not the "
                                     "painted one")
            return int(painted.sum())
        finally:
            httpd.shutdown()
            httpd.server_close()
            th.join(timeout=60)

    n = _step("web UI GET + POST", web_ui, steps)
    print("edit UI: GET /api/views and /view/0/embed_map.png, POST "
          "/api/mask of a painted disc (%d pixels) decoded to it, POST "
          "/api/submit wrote it" % n, flush=True)
    return steps


def write_trajectory(data_root, n_frames):
    """transforms_test.json: n_frames cameras of the "cli" scene's circle
    at CLI_EYE_DIST, each between two train cameras, at CLI_IMH."""
    tj = vio.read_json(os.path.join(data_root, "transforms_train.json"))
    frames = []
    for i in range(n_frames):
        ang = 2 * np.pi * (i + 0.25) / n_frames
        eye = CLI_EYE_DIST * np.array([np.sin(ang), 0.15, np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(right, fwd)
        c2w[:3, 2], c2w[:3, 3] = -fwd, eye
        frames.append({"transform_matrix": c2w.tolist()})
    vio.write_json({"camera_angle_x": tj["camera_angle_x"],
                    "frames": frames},
                   os.path.join(data_root, "transforms_test.json"))


def avi_header(path):
    """(frames, width, height, fps) of an AVI of uncompressed 24-bit DIB
    frames, from its avih and strf headers; raises unless the file holds
    exactly that many frame chunks of that size."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise AssertionError(f"{path}: not a RIFF AVI file")
    a = data.index(b"avih") + 8
    usec, _, _, _, n = struct.unpack("<5I", data[a:a + 20])
    s = data.index(b"strf") + 8
    _, w, h, _, bits, comp = struct.unpack("<IiiHHI", data[s:s + 20])
    size = ((3 * w + 3) & ~3) * abs(h)
    i = data.rindex(b"idx1") + 4
    (index,) = struct.unpack("<I", data[i:i + 4])
    if (bits, comp, index) != (24, 0, 16 * n) or data.count(
            b"00db" + struct.pack("<I", size)) != n:
        raise AssertionError(f"{path}: {bits}-bit frames, compression "
                             f"{comp}, an index of {index} B, not {n} "
                             f"frame chunks of {size} B")
    return n, w, abs(h), round(1e6 / usec)


def video_cli_phase(root, env_dir, device):
    """The video and edit subcommands on the "cli" phase's scene and
    trained tree: geo-video at its defaults on a trajectory of
    VIDEO_FRAMES, gen-video in each of the five modes (the probes, and an
    edit workspace of dst.json and test_NNN.npy masks written with
    edit_client), and `python -m vqnerf_release_torch.cli edit-server` as a
    subprocess, sent one edit and terminated, its step the launches and
    peak memory that the subprocess reports. Returns the steps."""
    data_root = os.path.join(root, "cli", "data", "nfr_blender", GEO_SCENE)
    out = os.path.join(root, "cli", "output")
    dev = ["--device", str(device)]
    common = ["--data-root", data_root, "--output-root", out, *dev]
    write_trajectory(data_root, VIDEO_FRAMES)
    steps = {}
    _step("geo-video", lambda: cli.main(["geo-video", GEO_SCENE, *common]),
          steps)
    n = steps["geo-video"]["launches"]
    if min(n["sdf_fwd"], n["sdf_fwdgrad"]) <= 0:
        raise AssertionError(f"geo-video launched {n}")
    video_root = os.path.join(vcfg.surf_dir(os.path.join(out, "surf"),
                                            GEO_SCENE), "video")
    frames = ["test_%03d" % i for i in range(VIDEO_FRAMES)]
    if sorted(os.listdir(video_root)) != frames or not all(
            gen_geo.check_finished(os.path.join(video_root, f))
            and os.path.exists(os.path.join(video_root, f, "metadata.json"))
            for f in frames):
        raise AssertionError(f"geo-video wrote {_files(video_root)}")
    n_arrays = _check_finite_npy(video_root)
    print("geo-video: %d frames of %dx%d, all 8 files and metadata.json, "
          "%d arrays finite" % (VIDEO_FRAMES, CLI_IMH, CLI_IMH, n_arrays))

    ref_out = vcfg.train_outdir(out, GEO_SCENE, "ref_nfr")
    video = ["gen-video", GEO_SCENE, *common, "--video-root", video_root,
             "--preset-override", "imh=%d" % CLI_IMH, "--test-envmap-dir",
             env_dir]
    n_vq = find_vq(os.path.join(vcfg.train_outdir(out, GEO_SCENE, "vq_nfr"),
                                "vis_vali", "epoch%09d" % 1))
    _step("gen-video gen_comps", lambda: cli.main(
        [*video, "--mode", "gen_comps", "--n-vq", str(n_vq)]), steps)
    comps = os.path.join(ref_out, "vis_video", "gen_comps")
    embeds = [np.load(os.path.join(comps, "batch%09d" % i, "pred_embed.npy"))
              for i in range(VIDEO_FRAMES)]
    code = _most_common_code(embeds[0])
    edit_root = os.path.join(root, "video_edit")
    vio.write_json(edit_client.MATERIAL_DB["gold"],
                   os.path.join(edit_root, "dst.json"))
    for i, e in enumerate(embeds):
        m = edit_client.auto_select_mask(e, code, dilate=1)
        np.save(os.path.join(edit_root, "test_%03d.npy" % i),
                np.repeat(m[..., None], 3, axis=-1))
    modes = {"recon": [], "relight": [], "vq_dcomps": ["--n-vq", str(n_vq)],
             "edit": ["--edit-root", edit_root, "--dst-env",
                      probe_names(1)[0]]}
    for mode, extra in modes.items():
        _step("gen-video " + mode,
              lambda: cli.main([*video, "--mode", mode, *extra]), steps)
    for mode in ("recon", "gen_comps", "edit", "vq_dcomps", "relight"):
        name = "gen-video " + mode
        n = steps[name]["launches"]["fused_brdf_render"]
        # the ref_fast_render of recon and gen_comps and the vq_fast_render
        # of edit and vq_dcomps take kernel 1; relight's learned light and
        # probes the multi-map kernel alone
        if mode == "relight":
            inst = steps[name]["render_instances"]
            if n or inst["maps_scalar"] or not inst["maps_vector"]:
                raise AssertionError(f"{name}: kernel 1 launched {n} times, "
                                     f"the multi-map kernel {inst}")
        else:
            _assert_vector_render(steps[name], name)
        d = os.path.join(ref_out, "vis_video", mode)
        if sorted(f for f in os.listdir(d) if f.startswith("batch")) != \
                ["batch%09d" % i for i in range(VIDEO_FRAMES)]:
            raise AssertionError(f"{name} wrote {os.listdir(d)}")
        n_arrays = _check_finite_npy(d)
        if mode in ("recon", "gen_comps"):
            got = avi_header(os.path.join(d, "video.avi"))
            if got != (VIDEO_FRAMES, CLI_IMH, CLI_IMH, 24):
                raise AssertionError(f"{name}: video.avi of (frames, width, "
                                     f"height, fps) {got}")
        print("%s: %d frames, %d arrays finite%s" % (
            name, VIDEO_FRAMES, n_arrays,
            ", video.avi's header: %d frames of %dx%d at 24 fps"
            % (VIDEO_FRAMES, CLI_IMH, CLI_IMH)
            if mode in ("recon", "gen_comps") else ""), flush=True)

    # the edit server from a shell, sent one edit, then terminated
    ws = os.path.join(root, "server_ws")
    test_dir = os.path.join(ref_out, "vis_test", "latest", "pd_vq",
                            "batch%09d" % 0)
    emb = np.load(os.path.join(test_dir, "pred_embed.npy"))
    cfg, _ = vcfg.decomp_config_for_scene(GEO_SCENE)
    k = cfg.imh // emb.shape[0]  # the server loads the preset's 512x512
    mask = edit_client.auto_select_mask(
        np.repeat(np.repeat(emb, k, axis=0), k, axis=1),
        _most_common_code(emb))

    report = os.path.join(root, "edit_server_launches.json")

    def server_subprocess():
        proc = subprocess.Popen(
            [sys.executable, "-c", SERVER_LAUNCHER, report, "edit-server",
             GEO_SCENE, *common, "--root", ws, "--test-envmap-dir", env_dir],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            edit_client.submit_edit(ws, "gold", [mask],
                                    env=probe_names(1)[0])
            t0 = time.perf_counter()
            while True:
                status = edit.read_status(os.path.join(ws, "status",
                                                       "status.json"))
                if status == {"status": "finished"}:
                    break
                if proc.poll() is not None:
                    raise AssertionError(
                        f"edit-server exited {proc.returncode}: "
                        f"{proc.stderr.read()[-2000:]}")
                if time.perf_counter() - t0 > CLI_TIMEOUT_S:
                    raise AssertionError("edit-server did not finish")
                time.sleep(0.1)
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        return proc.returncode

    name = "python -m cli edit-server"
    t0 = time.perf_counter()
    rc = server_subprocess()
    seconds = time.perf_counter() - t0
    if rc != 0 or not os.path.exists(report):
        raise AssertionError(f"edit-server exited {rc} on SIGTERM without "
                             "its launch counts")
    # the process's own counts and peak memory, from start to SIGTERM
    steps[name] = dict(vio.read_json(report), seconds=seconds)
    print("edit/video %s: %.3f s, peak %.3f GiB, kernel launches %s (the "
          "subprocess's own)" % (name, seconds,
                                 steps[name]["peak_bytes"] / 2**30,
                                 steps[name]["launches"]), flush=True)
    _assert_vector_render(steps[name], name)
    served = os.path.join(ws, "pd_edited", "batch%09d" % 0)
    if not os.path.exists(os.path.join(served, "pred_rgb.png")):
        raise AssertionError(f"edit-server wrote {_files(ws)}")
    n_arrays = _check_finite_npy(served)
    print("edit-server (python -m, a subprocess): uploaded -> finished, "
          "%d arrays finite in pd_edited, terminated (exit %s)"
          % (n_arrays, rc), flush=True)
    return steps


# ---- video frames composed from the served view dirs ---------------------

FRAME_LAYOUT = (("normal", "nn"), ("albedo", "rgb"))
FRAME_MISSING = (("rgb", "albedo"), ("spec", "no_such_buffer"))
FRAME_REPS = 5


def _compose_reference(batch_dir, layout, light, pad=2):
    """make_frame's result where every cell found has one size, built
    independently: a white canvas, each cell read with imread_color and
    pasted by slicing, blank cells black, the thumbnail in the bottom-left
    corner of the rgb* cells."""
    grid = []
    for row in layout:
        cells = []
        for name in row:
            paths = [os.path.join(batch_dir, f)
                     for f in (name + ".png", "pred_" + name + ".png")]
            found = [q for q in paths if name != "nn" and os.path.exists(q)]
            cells.append(vio.imread_color(found[0]) if found else None)
        grid.append(cells)
    sizes = {c.shape for row in grid for c in row if c is not None}
    if len(sizes) != 1:
        raise AssertionError(f"{batch_dir}: cells of sizes {sizes}")
    h, w, _ = sizes.pop()
    rows, cols = len(grid), len(grid[0])
    canvas = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3),
                     255, np.uint8)
    lh, lw = light.shape[:2]
    for r, row in enumerate(grid):
        for c, cell in enumerate(row):
            y, x = r * (h + pad), c * (w + pad)
            canvas[y:y + h, x:x + w] = 0 if cell is None else cell
            if layout[r][c].startswith("rgb") and lh < h and lw < w:
                canvas[y + h - lh:y + h, x:x + lw] = light[..., :3]
    return canvas


def _apng_frames(path):
    """Every frame of an APNG that write_apng made (one IHDR, the first
    frame in IDAT, the others in fdAT), each decoded by the port's PNG
    reader, with acTL's (frame count, plays) and the fcTL delays in ms."""
    with open(path, "rb") as f:
        data = f.read()
    chunks = list(vio._png_chunks(data))
    ihdr = [d for k, d in chunks if k == b"IHDR"][0]
    actl = struct.unpack(">II", [d for k, d in chunks if k == b"acTL"][0])
    delays = [1000 * num / den for num, den in (
        struct.unpack(">HH", d[20:24]) for k, d in chunks if k == b"fcTL")]
    bodies = [d for k, d in chunks if k == b"IDAT"] + [
        d[4:] for k, d in chunks if k == b"fdAT"]
    frames = [vio.decode_png(
        vio._PNG_SIG + vio._png_chunk(b"IHDR", ihdr)
        + vio._png_chunk(b"IDAT", body) + vio._png_chunk(b"IEND", b""))
        for body in bodies]
    return frames, actl, delays


def frame_phase(outroot, env_dir, root, smi):
    """utils/vis.py's make_frame on the served `test` pass's 512x512 view
    dirs (raw_test): the 2x2 layout with a uint8 light thumbnail (the first
    probe, tonemapped) on every view, and a layout with a missing name,
    each held bit for bit against an independent numpy composition; None
    for an empty dir; a two-frame make_anim read back with the port's PNG
    reader. No kernel lies on this path: the counts, set to 0 just before,
    must read 0 just after. Prints frame shapes and ms per frame."""
    views = sorted(glob.glob(os.path.join(outroot, "raw_test", "batch*")))
    if len(views) != N_VIEWS:
        raise AssertionError(f"raw_test holds {views}")
    probe = vio.sortglob(env_dir, ext=("hdr", "exr"))[0]
    light = vio.vis_light(vio.read_envmap(probe), h=64)
    if light.dtype != np.uint8 or light.shape != (64, 128, 3):
        raise AssertionError(f"thumbnail {light.dtype} {light.shape}")
    _reset_counts()
    frames = []
    for d in views:
        got = make_frame(d, FRAME_LAYOUT, rgb_embed_light=light)
        want = _compose_reference(d, FRAME_LAYOUT, light)
        if got is None or got.dtype != np.uint8 \
                or not np.array_equal(got, want):
            raise AssertionError(f"make_frame of {d} differs from numpy's")
        frames.append(got)
    missing = make_frame(views[0], FRAME_MISSING, rgb_embed_light=light)
    if missing is None or not np.array_equal(
            missing, _compose_reference(views[0], FRAME_MISSING, light)):
        raise AssertionError("make_frame with a missing name differs")
    empty = os.path.join(root, "frame_empty")
    os.makedirs(empty)
    if make_frame(empty, FRAME_LAYOUT, rgb_embed_light=light) is not None:
        raise AssertionError("make_frame of an empty dir is not None")
    t0 = time.perf_counter()
    for _ in range(FRAME_REPS):
        make_frame(views[0], FRAME_LAYOUT, rgb_embed_light=light)
    frame_ms = (time.perf_counter() - t0) * 1e3 / FRAME_REPS
    anim = os.path.join(root, "frames", "anim.apng")
    if make_anim(frames, anim, duration=250) != anim:
        raise AssertionError("make_anim returned another path")
    back, actl, delays = _apng_frames(anim)
    if actl != (2, 0) or delays != [250.0, 250.0] or len(back) != 2 \
            or not all(np.array_equal(a, b) for a, b in zip(back, frames)) \
            or not np.array_equal(vio.read_png(anim), frames[0]):
        raise AssertionError(f"make_anim read back: acTL {actl}, delays "
                             f"{delays}, {len(back)} frames")
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"the frame phase launched {launches}")
    found = sorted(n for row in FRAME_LAYOUT for n in row if n != "nn"
                   and any(os.path.exists(os.path.join(views[0], f)) for f in
                           (n + ".png", "pred_" + n + ".png")))
    print("frame phase: %d frames of %s (cells %s found) and one of %s with "
          "a missing name, equal to numpy's bit for bit; None for an empty "
          "dir; make_anim of 2 frames read back; %.3f ms per frame (%d "
          "reps, 4 cells of %dx%d); kernel launches %s; %s"
          % (len(frames), frames[0].shape, found, missing.shape, frame_ms,
             FRAME_REPS, *vio.imread_color(os.path.join(
                 views[0], "pred_rgb.png")).shape[:2], launches, smi),
          flush=True)
    return {"frame_ms": frame_ms, "shape": frames[0].shape}


# ---- reference TF checkpoints, written without TensorFlow ----------------

TF_DTYPES = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
             np.dtype(np.int32): 3, np.dtype(np.int64): 9,
             np.dtype(np.bool_): 10, np.dtype(np.float16): 19}


def _pb_varint(n):
    out = bytearray()
    while True:
        low, n = n & 0x7F, n >> 7
        out.append(low | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb_field(num, kind, value):
    """One protobuf field: kind 0 a varint, 2 bytes, 5 a fixed32."""
    tag = _pb_varint(num << 3 | kind)
    if kind == 0:
        return tag + _pb_varint(value)
    if kind == 2:
        return tag + _pb_varint(len(value)) + value
    return tag + struct.pack("<I", value)


def tf_bundle_entry(dtype, shape, offset, size, crc):
    """A BundleEntryProto (shard 0), zero fields left out as proto3 does."""
    dims = b"".join(_pb_field(2, 2, _pb_field(1, 0, d) if d else b"")
                    for d in shape)
    out = _pb_field(1, 0, dtype) + _pb_field(2, 2, dims)
    if offset:
        out += _pb_field(4, 0, offset)
    if size:
        out += _pb_field(5, 0, size)
    if crc:
        out += _pb_field(6, 5, crc)
    return out


def tf_table_block(items):
    """A LevelDB table block of (key, value) bytes in key order, every
    entry a restart point (no shared prefixes), with its 5-byte trailer:
    type 0 (uncompressed) and the masked CRC-32C."""
    body, restarts = bytearray(), []
    for key, value in items:
        restarts.append(len(body))
        body += (_pb_varint(0) + _pb_varint(len(key)) + _pb_varint(len(value))
                 + key + value)
    restarts = restarts or [0]
    body += struct.pack("<%dI" % (len(restarts) + 1), *restarts,
                        len(restarts))
    body += b"\x00"
    return bytes(body) + struct.pack("<I", tf_bundle.masked_crc32c(body))


def tf_index_file(entries):
    """The .index table of {key: BundleEntryProto bytes}: one data block
    (the header under "" first), an empty meta-index, the index block and
    the footer with the table magic."""
    header = _pb_field(1, 0, 1) + _pb_field(3, 2, _pb_field(1, 0, 1))
    items = [(b"", header)] + sorted((k.encode(), v)
                                     for k, v in entries.items())
    data = tf_table_block(items)
    meta = tf_table_block([])
    index = tf_table_block([(items[-1][0], _pb_varint(0)
                             + _pb_varint(len(data) - 5))])
    footer = (_pb_varint(len(data)) + _pb_varint(len(meta) - 5)
              + _pb_varint(len(data) + len(meta)) + _pb_varint(len(index) - 5))
    footer = footer.ljust(40, b"\x00") + struct.pack(
        "<Q", tf_bundle.TABLE_MAGIC)
    return data + meta + index + footer


def write_tf_checkpoint(directory, tensors, step=1):
    """A TensorFlow 2 checkpoint <directory>/ckpt-<step> (one shard) of
    {key: numpy array} and the "checkpoint" file naming it, as
    tf.train.CheckpointManager leaves them; returns the prefix."""
    os.makedirs(directory, exist_ok=True)
    prefix = os.path.join(directory, "ckpt-%d" % step)
    entries, offset = {}, 0
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        for key in sorted(tensors, key=str.encode):
            arr = np.asarray(tensors[key])
            buf = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")) \
                .tobytes()
            f.write(buf)
            entries[key] = tf_bundle_entry(
                TF_DTYPES[arr.dtype.newbyteorder("=")], arr.shape, offset,
                len(buf), tf_bundle.masked_crc32c(buf))
            offset += len(buf)
    with open(prefix + ".index", "wb") as f:
        f.write(tf_index_file(entries))
    with open(os.path.join(directory, "checkpoint"), "w") as f:
        f.write('model_checkpoint_path: "ckpt-%d"\n'
                'all_model_checkpoint_paths: "ckpt-%d"\n' % (step, step))
    return prefix


def reference_tf_tensors(model, kind, ema=None, vq_decay=0.999, step=1):
    """{object-graph key: array} of a trained model as the reference's
    tf.train.Checkpoint(step, net=model) names them (the keys
    tests/test_tf_import.py's tf.Module mimic gives): every MLP layer of
    the JAX tree as net/net_<name>_layer<i>/{kernel,bias}, the light,
    codebook and gamma as net/_<name>, the VQ EMA (kind "vq_nfr") under
    net/vq_layer/ema_{cluster_size,dw}/{_hidden,average,_counter}. A
    ref_nfr checkpoint holds only its trainable part, as the reference's
    does."""
    tree = jax_params.to_jax(model, kind)
    if kind == "ref_nfr":
        tree = dict(tree["train"], light=tree["frozen"]["light"])
    value = "/.ATTRIBUTES/VARIABLE_VALUE"
    out = {"step" + value: np.asarray(step, np.int64),
           "save_counter" + value: np.asarray(1, np.int64)}
    for name, leaf in tree.items():
        if isinstance(leaf, list):
            for i, layer in enumerate(leaf):
                for part, key in (("w", "kernel"), ("b", "bias")):
                    out["net/net_%s_layer%d/%s%s" % (name, i, key, value)] = \
                        np.asarray(layer[part], np.float32)
        else:
            out["net/_%s%s" % (name, value)] = np.asarray(leaf, np.float32)
    if ema is not None:
        ema = jax_params.ema_to_jax(ema)
        counter = int(ema["counter"])
        for which, hidden in (("cluster_size", ema["hidden_cluster_size"]),
                              ("dw", ema["hidden_dw"])):
            base = "net/vq_layer/ema_%s/" % which
            out[base + "_hidden" + value] = hidden
            out[base + "average" + value] = (
                hidden / (1.0 - vq_decay ** max(counter, 1))).astype(
                    np.float32)
            out[base + "_counter" + value] = np.asarray(counter, np.int64)
    return out


# ---- evaluation and reference checkpoints -----------------------------------


def _alexnet_weights(path, seed):
    """Random LPIPS weights at AlexNet's shapes (conv 64, 192, 384, 256,
    256, kernels 11, 5, 3, 3, 3, and the five linear heads): the trained
    ones cannot be fetched."""
    rs = np.random.RandomState(seed)
    widths, ks = [3, 64, 192, 384, 256, 256], [11, 5, 3, 3, 3]
    w = {}
    for i in range(5):
        fan_in = ks[i] * ks[i] * widths[i]
        w["conv%d/kernel" % (i + 1)] = (rs.randn(
            ks[i], ks[i], widths[i], widths[i + 1])
            / np.sqrt(fan_in)).astype(np.float32)
        w["conv%d/bias" % (i + 1)] = (0.01 * rs.randn(widths[i + 1])).astype(
            np.float32)
        w["lin%d/kernel" % i] = rs.rand(1, 1, widths[i + 1], 1).astype(
            np.float32)
    np.savez(path, **w)
    return path


def _eval_step(name, fn, steps):
    """fn() timed (synchronised), its peak device memory and kernel
    launches in ``steps[name]``; no kernel may run in an evaluation step."""
    out = _step(name, fn, steps, "eval and import")
    if any(steps[name]["launches"].values()):
        raise AssertionError(f"{name} launched {steps[name]['launches']}")
    return out


def _same_scores(got, want, what, rel=1e-9):
    """Two score JSONs (nested dicts of lists of floats, or of floats) with
    the same keys and every value within ``rel`` relative."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{what}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        return max([0.0] + [_same_scores(got[k], want[k], f"{what}/{k}", rel)
                            for k in want])
    if isinstance(want, list):
        if len(got) != len(want):
            raise AssertionError(f"{what}: {len(got)} != {len(want)} values")
        return max([0.0] + [_same_scores(g, w, what, rel)
                            for g, w in zip(got, want)])
    if isinstance(want, str):
        if got != want:
            raise AssertionError(f"{what}: {got!r} != {want!r}")
        return 0.0
    if not (np.isfinite(got) and np.isfinite(want)):
        raise AssertionError(f"{what}: {got} / {want} not finite")
    err = abs(got - want) / max(abs(want), 1e-300)
    if err > rel:
        raise AssertionError(f"{what}: {got} != {want} (relative {err:.3e})")
    return err


def _float(cell):
    try:
        return float(cell)
    except ValueError:
        return None


def _same_csv(a, b, what, rel=1e-9):
    """Two CSV files with the same rows and columns, every float cell
    within ``rel`` relative (as the score JSONs: the convolutions of SSIM
    and LPIPS sum in cuDNN's order on the card and in another on the CPU)
    and every other cell equal. Returns (cells that differ, cells)."""
    rows_a = list(csv.reader(io.StringIO(a.decode())))
    rows_b = list(csv.reader(io.StringIO(b.decode())))
    if not a or len(rows_a) != len(rows_b) or rows_a[:1] != rows_b[:1]:
        raise AssertionError(f"{what}.csv: the card's and the CPU's differ")
    n_diff = n_cells = 0
    for ra, rb in zip(rows_a[1:], rows_b[1:]):
        if len(ra) != len(rb):
            raise AssertionError(f"{what}.csv: rows {ra} and {rb}")
        for x, y in zip(ra, rb):
            n_cells += 1
            if x == y:
                continue
            fx, fy = _float(x), _float(y)
            if fx is None or fy is None or not (
                    abs(fx - fy) <= rel * abs(fy)):
                raise AssertionError(f"{what}.csv: {x} on the card, {y} "
                                     "on the CPU")
            n_diff += 1
    return n_diff, n_cells


def _link_bridge(ref_out, epoch):
    """metric_eval.resolve_scene_dirs reads ref_nfr renders from
    <ref_out>/pd_test/<ckpt-5 or the newest dir> and pd_relit/<the same>,
    where `test` writes vis_test/latest/{pd_test,pd_relit} (the JAX
    package does the same): a ckpt-<epoch> link in each bridges the two."""
    for sub in ("pd_test", "pd_relit"):
        os.makedirs(os.path.join(ref_out, sub), exist_ok=True)
        os.symlink(os.path.join(ref_out, "vis_test", "latest", sub),
                   os.path.join(ref_out, sub, "ckpt-%d" % epoch))


def _write_eval_gt(gt_scene, data_scene, views, albedo, envs, with_rough):
    """GT trees of metric_eval: per view rgba.png (the scene's own),
    albedo.png, metal.png (zeros), rough.png (with_rough) and
    rgba_<env>.png (the rgb tinted per env, the scene's alpha)."""
    for i, view in enumerate(views):
        rgba = vio.load_img_f32(os.path.join(data_scene, view, "rgba.png"))
        d = os.path.join(gt_scene, view)
        os.makedirs(d)
        shutil.copy(os.path.join(data_scene, view, "rgba.png"), d)
        h, w = rgba.shape[:2]
        vio.write_img(np.broadcast_to(albedo, (h, w, 3)),
                      os.path.join(d, "albedo.png"))
        vio.write_img(np.zeros((h, w, 3)), os.path.join(d, "metal.png"))
        if with_rough:
            vio.write_img(np.full((h, w, 3), 0.45),
                          os.path.join(d, "rough.png"))
        for j, env in enumerate(envs):
            tint = 0.6 + 0.4 * np.array([j % 2, (j // 2) % 2, j / 8.0])
            vio.write_img(np.dstack([rgba[..., :3] * tint, rgba[..., 3]]),
                          os.path.join(d, "rgba_%s.png" % env))


def _write_idx(label_dir, rgba_path):
    """A GT label map in cluster_eval.SEL_COLORS: the image split in four
    quadrants (labels 1-4), background label 0 (black)."""
    alpha = vio.load_img_f32(rgba_path)[..., 3]
    h, w = alpha.shape
    yy, xx = np.mgrid[:h, :w]
    lab = 1 + (yy >= h // 2) * 2 + (xx >= w // 2)
    lab[alpha <= 0.5] = 0
    pal = np.array([[0, 0, 0]] + [list(c) for c in
                                  cluster_eval.SEL_COLORS[:4]], np.uint8)
    os.makedirs(label_dir)
    vio.write_png(os.path.join(label_dir, "idx.png"), pal[lab])


# albedo (3), spec (3), rough (1) of the planted materials, 0.85 or more
# apart, far beyond mean shift's bandwidth of 0.2
MS_MATERIALS = np.array([
    [0.8, 0.2, 0.2, 0.1, 0.1, 0.1, 0.3],
    [0.2, 0.8, 0.2, 0.1, 0.1, 0.1, 0.6],
    [0.2, 0.2, 0.8, 0.5, 0.5, 0.5, 0.2],
    [0.9, 0.9, 0.9, 0.1, 0.1, 0.1, 0.9],
    [0.1, 0.1, 0.1, 0.8, 0.8, 0.8, 0.1]])


def _write_clustered_materials(mat_dirs, size, seed):
    """gen-z's per-view albedo/spec/rough .npy of the planted materials: a
    disc of radius 0.4 * size cut into sectors of unequal angles, material
    k in sector k, float32 with noise of sigma 0.03, zero outside (the
    background mean shift skips). Returns each view's [size, size] map of
    the planted material (-1 outside)."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size] - (size - 1) / 2.0
    edges = np.cumsum([0.0, 0.9, 1.1, 1.2, 1.35, 1.45]) * 2 * np.pi / 6.0
    sector = np.searchsorted(edges, np.arctan2(yy, xx) + np.pi) - 1
    truth = np.where(np.hypot(yy, xx) < 0.4 * size, sector, -1)
    maps = []
    for d in mat_dirs:
        f = MS_MATERIALS[np.clip(truth, 0, None)] + 0.03 * rs.randn(
            size, size, 7)
        f = np.where(truth[..., None] >= 0, f, 0.0).astype(np.float32)
        os.makedirs(d)
        for name, sl in (("albedo", slice(0, 3)), ("spec", slice(3, 6)),
                         ("rough", slice(6, 7))):
            np.save(os.path.join(d, name + ".npy"), f[..., sl])
        maps.append(truth)
    return maps


def _cluster_table_json(cluster_json, path):
    """cluster-eval's {"vq": {scene: scores}} as vis_csv's per-method
    {"vq": {score: [a value a scene]}}."""
    scores = vio.read_json(cluster_json)["vq"]
    keys = next(iter(scores.values())).keys()
    vio.write_json({"vq": {k: [s[k] for s in scores.values()]
                           for k in keys}}, path)
    return path


def eval_import_phase(root, paths, serve_root, device):
    """Evaluation and reference TF checkpoints ("eval and import"), each
    step on the card and again on the CPU, every kernel's launch count set
    to 0 just before and read just after:

    * metric-eval (family nerf: rgb, kd with the albedo scale, relights
      under the eight ENV_LIGHTS_CG probes) through cli.main on the "cli"
      phase's trained tree, bridged to resolve_scene_dirs's layout, with
      LPIPS from random weights of AlexNet's shapes;
    * eval_dataset (family mat, scene_dirs) on step 5's two served
      512x512 views: the 512 -> 420 area downscale, ks and rough;
    * cluster-eval of the same views' pd_vq embed maps against GT labels;
    * meanshift_segmentation of gen-z's exported materials, and of planted
      ones (_write_clustered_materials), whose 5 materials it must find;
    * the CSV tables of both score JSONs;
    the card's JSONs and CSV float cells within 1e-9 relative of the
    CPU's, the label maps and the other CSV cells equal; no kernel
    launched. Then the trained vq_nfr and ref_nfr written as
    reference-layout TF checkpoints (write_tf_checkpoint), imported by
    tf_import.main into a fresh tree, equal to the trained ones bit for
    bit, and served by `test` (kernel 1, all of the 16-byte instance)
    within rtol 2e-4 / atol 1e-5 of the direct serve; `python -m
    vqnerf_release_torch.interop.tf_import` writes the same ref_nfr
    checkpoint. Returns the steps."""
    cli_out = os.path.join(root, "cli", "output")
    cli_data = os.path.join(root, "cli", "data", "nfr_blender", GEO_SCENE)
    ev = os.path.join(root, "eval")
    os.makedirs(ev)
    lpips_npz = _alexnet_weights(os.path.join(ev, "alexnet_random.npz"),
                                 SEED)
    old_env = os.environ.get("VQNERF_LPIPS_WEIGHTS")
    os.environ["VQNERF_LPIPS_WEIGHTS"] = lpips_npz
    steps, out = {}, {}
    try:
        # metric-eval on the "cli" tree
        ref_out = vcfg.train_outdir(cli_out, GEO_SCENE, "ref_nfr")
        _link_bridge(ref_out, 1)
        gt_cli = os.path.join(ev, "gt_cli")
        cli_views = ["val_%03d" % i for i in range(CLI_VAL_VIEWS)]
        _write_eval_gt(os.path.join(gt_cli, GEO_SCENE), cli_data, cli_views,
                       [0.8, 0.5, 0.3], metric_eval.ENV_LIGHTS_CG, False)
        for dev in (str(device), "cpu"):
            js = os.path.join(ev, "metric_cli_%s.json" % dev)
            _eval_step("metric-eval (%s)" % dev, lambda: cli.main(
                ["metric-eval", "--family", "nerf", "--scenes", GEO_SCENE,
                 "--pred-root", os.path.join(cli_out, "train"),
                 "--gt-root", gt_cli, "--out-json", js, "--device", dev]),
                steps)
            out.setdefault("metric_cli", []).append(vio.read_json(js))
        got, want = out["metric_cli"]
        bufs = got[GEO_SCENE]
        if set(bufs) != {"rgb", "kd", "env"} or got["_lpips_impl"] != \
                "alexnet" or len(bufs["env"]["psnr"]) != \
                len(metric_eval.ENV_LIGHTS_CG) * CLI_VAL_VIEWS:
            raise AssertionError(f"metric-eval scored {bufs.keys()}, "
                                 f"{len(bufs.get('env', {}).get('psnr', []))}"
                                 f" relights, lpips {got['_lpips_impl']}")
        err = _same_scores(got, want, "metric-eval, card against CPU")

        # eval_dataset, family mat, on step 5's served views
        gt_mat = os.path.join(ev, "gt_mat")
        views = ["val_%03d" % i for i in range(N_VIEWS)]
        _write_eval_gt(os.path.join(gt_mat, SCENE), paths["data_root"],
                       views, [0.6, 0.4, 0.3], [], True)
        scene_dirs = {SCENE: (os.path.join(serve_root, "pd_test"), None)}
        for dev in (str(device), "cpu"):
            js = os.path.join(ev, "metric_mat_%s.json" % dev)
            out.setdefault("metric_mat", []).append(_eval_step(
                "eval_dataset mat (%s)" % dev,
                lambda: metric_eval.eval_dataset(
                    [SCENE], "mat", None, gt_mat, out_json=js,
                    scene_dirs=scene_dirs, device=dev), steps))
        got, want = out["metric_mat"]
        if set(got[SCENE]) != {"rgb", "kd", "ks", "rough"}:
            raise AssertionError(f"eval_dataset mat scored {got[SCENE]}")
        err = max(err, _same_scores(got, want, "eval_dataset, card "
                                    "against CPU"))

        # cluster-eval of the served pd_vq maps
        labels = os.path.join(ev, "labels")
        pred = os.path.join(ev, "pred")
        os.makedirs(pred)
        os.symlink(os.path.join(serve_root, "pd_vq"),
                   os.path.join(pred, SCENE))
        for view in views:
            _write_idx(os.path.join(labels, SCENE, view),
                       os.path.join(paths["data_root"], view, "rgba.png"))
        for dev in (str(device), "cpu"):
            js = os.path.join(ev, "cluster_%s.json" % dev)
            _eval_step("cluster-eval (%s)" % dev, lambda: cli.main(
                ["cluster-eval", "--scenes", SCENE, "--rgba-root",
                 os.path.dirname(paths["data_root"]), "--label-root",
                 labels, "--pred-root", pred, "--out-json", js,
                 "--device", dev]), steps)
            out.setdefault("cluster", []).append(vio.read_json(js))
        if out["cluster"][0] != out["cluster"][1]:
            raise AssertionError(f"cluster-eval: card {out['cluster'][0]} "
                                 f"!= CPU {out['cluster'][1]}")

        # mean shift on gen-z's materials, and on planted ones of two
        # 512x512 views (the shipped max_pixels subsample of 20,000)
        gz = os.path.join(vcfg.train_outdir(cli_out, GEO_SCENE, "nfr_unit"),
                          "gen_z")
        planted = [os.path.join(ev, "planted", v) for v in views]
        truth = _write_clustered_materials(planted, 512, SEED)
        n_ms = {}
        for what, mat_dirs in (("gen-z", [os.path.join(gz, v)
                                          for v in cli_views]),
                               ("planted", planted)):
            labs = []
            for dev in (str(device), "cpu"):
                dirs = [os.path.join(ev, "meanshift_%s_%s" % (what, dev),
                                     os.path.basename(d)) for d in mat_dirs]
                n, _ = _eval_step(
                    "meanshift %s (%s)" % (what, dev),
                    lambda: meanshift.meanshift_segmentation(
                        mat_dirs, dirs, device=dev), steps)
                n_ms.setdefault(what, []).append(n)
                labs.append([np.load(os.path.join(d, "labels.npy"))
                             for d in dirs])
            if n_ms[what][0] != n_ms[what][1] or not all(
                    np.array_equal(a, b) for a, b in zip(*labs)):
                raise AssertionError(f"meanshift {what}: {n_ms[what]} "
                                     "centres on the card and the CPU, or "
                                     "other labels")
        if n_ms["planted"][0] != len(MS_MATERIALS):
            raise AssertionError(f"meanshift found {n_ms['planted'][0]} of "
                                 f"{len(MS_MATERIALS)} planted materials")
        for lab, t in zip(labs[0], truth):
            pairs = np.unique(np.stack([t.ravel(), lab.ravel()]), axis=1)
            if len(pairs[0]) != len(MS_MATERIALS) + 1 or len(
                    np.unique(pairs[0])) != len(pairs[0]) or len(
                    np.unique(pairs[1])) != len(pairs[1]):
                raise AssertionError("meanshift: the labels are not the "
                                     f"planted sectors ({pairs.tolist()})")

        # the CSV tables
        csvs = {}
        for dev in (str(device), "cpu"):
            for name, fn, src in (
                    ("metric_cli", vis_csv.metric_json_to_csv,
                     os.path.join(ev, "metric_cli_%s.json" % dev)),
                    ("metric_mat", vis_csv.metric_json_to_csv,
                     os.path.join(ev, "metric_mat_%s.json" % dev)),
                    ("cluster", vis_csv.cluster_json_to_csv,
                     _cluster_table_json(
                         os.path.join(ev, "cluster_%s.json" % dev),
                         os.path.join(ev, "cluster_table_%s.json" % dev)))):
                path = os.path.join(ev, "%s_%s.csv" % (name, dev))
                fn(src, path)
                with open(path, "rb") as f:
                    csvs.setdefault(name, []).append(f.read())
        csv_cells = [_same_csv(a, b, name)
                       for name, (a, b) in csvs.items()]

        # SSIM and LPIPS of one 512x512 view, on the card
        gt_img = (vio.load_img_f32(os.path.join(
            paths["data_root"], views[0], "rgba.png"))[..., :3] * 255).astype(
                np.uint8)
        pd_img = vio.read_png(os.path.join(serve_root, "pd_test",
                                           "batch%09d" % 0, "pred_rgb.png"))
        timing = {}
        for name, fn in (("ssim", metrics.ssim), ("lpips", metrics.lpips)):
            call = functools.partial(fn, gt_img, pd_img, device=device)
            timing[name + "_ms"] = _time_ms(call, reps=5)
            timing[name + "_device_ms"], timing[name + "_kernels"] = \
                _device_ms(call, reps=5)
        print("eval and import: card against CPU, the score JSONs within "
              "relative %.3e, cluster-eval equal, meanshift %d (gen-z) and "
              "%d (planted) centres and equal label maps, %d CSV tables "
              "with %d of %d cells in their last digits (within 1e-9), the "
              "rest equal; one 512x512 view: %s"
              % (err, n_ms["gen-z"][0], n_ms["planted"][0], len(csvs),
                 sum(n for n, _ in csv_cells), sum(m for _, m in csv_cells),
                 json.dumps(timing)), flush=True)
        print("metric-eval (cli tree, nerf, %d relights): %s" % (
            len(metric_eval.ENV_LIGHTS_CG), json.dumps(
                {b: {m: float(np.mean(v)) for m, v in ms.items()}
                 for b, ms in out["metric_cli"][0][GEO_SCENE].items()})))
        print("eval_dataset (served 512x512 views, mat, 512 -> 420): %s; "
              "cluster-eval %s" % (json.dumps(
                  {b: {m: float(np.mean(v)) for m, v in ms.items()}
                   for b, ms in out["metric_mat"][0][SCENE].items()}),
                  json.dumps(out["cluster"][0])), flush=True)
    finally:
        if old_env is None:
            os.environ.pop("VQNERF_LPIPS_WEIGHTS", None)
        else:
            os.environ["VQNERF_LPIPS_WEIGHTS"] = old_env

    # reference-layout TF checkpoints of the trained models, imported
    cfg, _ = vcfg.decomp_config_for_scene(GEO_SCENE, imh=CLI_IMH)
    train = {m: vcfg.train_outdir(cli_out, GEO_SCENE, m)
             for m in ("vq_nfr", "ref_nfr")}
    tf_root = os.path.join(root, "tf_ckpt")
    fresh = os.path.join(root, "tf_imported")
    vq_state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(train["vq_nfr"]))
    vq_model = cli._load_phase_model(train["vq_nfr"], cfg, "vq_nfr", "cpu")
    ref_model = cli._load_phase_model(train["ref_nfr"], cfg, "ref_nfr",
                                      "cpu", vq=vq_model)
    n_vq = find_vq(os.path.join(train["vq_nfr"], "vis_vali",
                                "epoch%09d" % 1))

    def import_argv(kind, out_root):
        extra = (["--main-k", str(n_vq)] if kind == "vq_nfr" else
                 ["--vq-ckpt", os.path.join(tf_root, "vq_nfr")])
        return ["--phase", kind, "--ckpt", os.path.join(tf_root, kind),
                "--out", vcfg.train_outdir(out_root, GEO_SCENE, kind),
                *extra]

    def tf_import_both():
        write_tf_checkpoint(os.path.join(tf_root, "vq_nfr"),
                            reference_tf_tensors(vq_model, "vq_nfr",
                                                 vq_state["ema"],
                                                 cfg.vq_decay))
        write_tf_checkpoint(os.path.join(tf_root, "ref_nfr"),
                            reference_tf_tensors(ref_model, "ref_nfr"))
        for kind in ("vq_nfr", "ref_nfr"):
            tf_import.main(import_argv(kind, fresh))

    _eval_step("tf import", tf_import_both, steps)
    # the command a user runs, in a process of its own: its launches are
    # not the parent's to count, so it stays out of ``steps``
    by_cmd = os.path.join(root, "tf_imported_cmd")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vqnerf_release_torch.interop.tf_import",
         *import_argv("ref_nfr", by_cmd)],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    cmd_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m ...tf_import --phase ref_nfr exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    cmd_state, in_proc = (ckpt_util.load_ckpt(ckpt_util.latest_ckpt(
        vcfg.train_outdir(r, GEO_SCENE, "ref_nfr"))) for r in (by_cmd, fresh))
    if set(cmd_state["params"]) != set(in_proc["params"]) or not all(
            torch.equal(cmd_state["params"][k], v)
            for k, v in in_proc["params"].items()):
        raise AssertionError("python -m ...tf_import wrote another ref_nfr "
                             "checkpoint than tf_import.main")
    print("eval and import python -m ...tf_import --phase ref_nfr: %.3f s, "
          "its checkpoint equal to tf_import.main's" % cmd_s, flush=True)
    n_tensors = 0
    for kind in ("vq_nfr", "ref_nfr"):
        got = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(
            vcfg.train_outdir(fresh, GEO_SCENE, kind)))
        want = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(train[kind]))
        if set(got["params"]) != set(want["params"]):
            raise AssertionError(f"{kind}: imported keys differ")
        pairs = [(k, got["params"][k], want["params"][k])
                 for k in want["params"]]
        if kind == "vq_nfr":
            pairs += [(f, g, w) for f, g, w in zip(
                VqEmaState._fields, got["ema"], want["ema"])]
        for k, g, w in pairs:
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{kind} {k}: imported != trained")
        n_tensors += len(pairs)
    test_argv = ["test", GEO_SCENE, "--data-root", cli_data,
                 "--output-root", fresh, "--surf-root",
                 vcfg.surf_dir(os.path.join(cli_out, "surf"), GEO_SCENE),
                 "--test-envmap-dir", paths["env_dir"], "--preset-override",
                 "imh=%d" % CLI_IMH, "--device", str(device)]
    _step("test (TF-imported)", lambda: cli.main(test_argv), steps,
          "eval and import")
    _assert_vector_render(steps["test (TF-imported)"], "test (TF-imported)", relit=True)
    served = os.path.join(ref_out, "vis_test", "latest")
    again = os.path.join(vcfg.train_outdir(fresh, GEO_SCENE, "ref_nfr"),
                         "vis_test", "latest")
    if _files(again) != _files(served):
        raise AssertionError("the TF-imported models wrote other files")
    max_err, n_cmp = 0.0, 0
    for rel in _files(served):
        if rel.endswith(".npy"):
            max_err = max(max_err, _compare(
                torch.from_numpy(np.load(os.path.join(again, rel))).double(),
                torch.from_numpy(np.load(os.path.join(served, rel))).double(),
                "TF-imported against direct, " + rel))
            n_cmp += 1
    print("tf import: %d tensors of vq_nfr and ref_nfr equal to the trained "
          "ones bit for bit; test on the imported models: %d arrays within "
          "rtol %g / atol %g of the direct serve (max abs err %.3e), %d "
          "render-kernel launches, all of the 16-byte instance"
          % (n_tensors, n_cmp, RTOL, ATOL, max_err,
             steps["test (TF-imported)"]["launches"]["fused_brdf_render"]),
          flush=True)
    return steps


# ---- capture and formats ----------------------------------------------------

CAPTURE_SCENE = "colmap_capture"  # the "ours" family, as colmap_* scenes
CAPTURE_IMH = 560
CAPTURE_TRAIN, CAPTURE_VAL = 6, 2
CAPTURE_ANGLE_X = 0.8
CAPTURE_SPHERE_POINTS, CAPTURE_TABLE_POINTS = 2000, 1000
CAPTURE_GEO_ITERS = 300
CAPTURE_CROP = 20
CAPTURE_REAL_IMH = 420
CAPTURE_SHAPE_RAYS = 2048
CAPTURE_RTOL = 1e-5
HALF_PROBES = 4
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "data", "torch_jpeg")


def rotmat2qvec(R):
    """COLMAP's quaternion (w, x, y, z) of a rotation matrix, w >= 0."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = np.asarray(R).flat
    k = np.array([
        [rxx - ryy - rzz, 0, 0, 0],
        [ryx + rxy, ryy - rxx - rzz, 0, 0],
        [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
        [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def capture_views(imh, seed):
    """The capture: CAPTURE_TRAIN + CAPTURE_VAL views of sphere_rgba's
    textured sphere from circle_c2w's cameras, as 8-bit RGB frames and
    masks. Returns [(c2w, w2c in the OpenCV convention, rgb uint8, mask
    uint8)], train views first, and the pinhole K [3, 3]."""
    rs = np.random.default_rng(seed)
    fl = 0.5 * imh / np.tan(0.5 * CAPTURE_ANGLE_X)
    K = np.array([[fl, 0.0, imh // 2], [0.0, fl, imh // 2], [0.0, 0.0, 1.0]])
    views = []
    for mode, n in (("train", CAPTURE_TRAIN), ("val", CAPTURE_VAL)):
        for i in range(n):
            c2w = circle_c2w(i, CAPTURE_TRAIN, mode)
            rgba = sphere_rgba(c2w, imh, CAPTURE_ANGLE_X, rs)
            w2c = np.linalg.inv(c2w @ np.diag([1.0, -1.0, -1.0, 1.0]))
            views.append((c2w, w2c,
                          np.round(rgba[..., :3] * 255).astype(np.uint8),
                          (rgba[..., 3] * 255).astype(np.uint8)))
    return views, K


def capture_points(seed):
    """The points SfM would reconstruct: CAPTURE_SPHERE_POINTS on the
    sphere and CAPTURE_TABLE_POINTS on the table it stands on (a ring of
    radius 0.45-0.8 at its foot, masked out of the frames). Returns
    (xyz [P, 3], outward normal [P, 3])."""
    rs = np.random.default_rng(seed)
    d = rs.normal(size=(CAPTURE_SPHERE_POINTS, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ang = rs.uniform(0, 2 * np.pi, CAPTURE_TABLE_POINTS)
    rad = rs.uniform(0.45, 0.8, CAPTURE_TABLE_POINTS)
    table = np.stack([rad * np.cos(ang), np.full_like(ang, -GEO_GT_RADIUS),
                      rad * np.sin(ang)], 1)
    up = np.tile([0.0, 1.0, 0.0], (CAPTURE_TABLE_POINTS, 1))
    return (np.concatenate([GEO_GT_RADIUS * d, table]),
            np.concatenate([d, up]))


def write_colmap_model(model_dir, views, K, imh, pts, normals):
    """A binary COLMAP sparse model of ``views``: one PINHOLE camera, each
    view's qvec / tvec, and every point with its track (the views it faces
    and projects into) and each view's 2D points."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, imh, imh))
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    tracks = [[] for _ in range(len(pts))]
    with open(os.path.join(model_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, (c2w, w2c, _, _) in enumerate(views):
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            uv = cam[:, :2] / cam[:, 2:] * K[0, 0] + K[:2, 2]
            faces = np.sum(normals * (c2w[:3, 3] - pts), axis=1) > 0
            seen = np.flatnonzero(faces & (cam[:, 2] > 0)
                                  & (uv >= 0).all(1) & (uv < imh).all(1))
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *rotmat2qvec(w2c[:3, :3])))
            f.write(struct.pack("<3d", *w2c[:3, 3]))
            f.write(struct.pack("<i", 1))
            f.write(b"%03d.png\x00" % i)
            f.write(struct.pack("<Q", len(seen)))
            for k, p in enumerate(seen):
                f.write(struct.pack("<3d", uv[p, 0], uv[p, 1], float(p + 1)))
                tracks[p].append((i + 1, k))
    with open(os.path.join(model_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p, xyz in enumerate(pts):
            f.write(struct.pack("<Q", p + 1))
            f.write(struct.pack("<3d", *xyz))
            f.write(struct.pack("<3B", 200, 128, 77))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", len(tracks[p])))
            for img_id, k in tracks[p]:
                f.write(struct.pack("<2i", img_id, k))


def _close_f32(got, want, what):
    """float32 matrices a conversion chain rounds: within 1e-6 relative
    (about 8 ulp) plus 1e-6 of the matrix's scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = 1e-6 * np.abs(want) + 1e-6 * np.abs(want).max()
    if not (np.abs(got - want) <= tol).all():
        raise AssertionError(f"{what}: off by {np.abs(got - want).max()}")


def _sphere_hits(rayo, rayd, center, radius):
    oc = rayo - center
    b = np.sum(oc * rayd, axis=-1) / np.linalg.norm(rayd, axis=-1)
    c = np.sum(oc * oc, axis=-1) - radius**2
    return (b * b - c > 0) & (b < 0)


def capture_steps_colmap(root, device, steps):
    """COLMAP -> scene -> geometry: the capture's frames, a binary COLMAP
    model of its cameras, imgs2poses, the colmap_* scene layout, the
    DtuSceneDataset's rays against the frames' alpha, then geo-train and
    gen-geo through cli.main at the "ours" preset. Returns the views."""
    from vqnerf_release_torch.data.neus_dataset import DtuSceneDataset
    from vqnerf_release_torch.preprocess import colmap_wrapper

    cap = os.path.join(root, "capture")
    views, K = capture_views(CAPTURE_IMH, SEED)
    pts, normals = capture_points(SEED)
    sfm = os.path.join(cap, "sfm")

    def colmap():
        write_colmap_model(os.path.join(sfm, "sparse", "0"), views, K,
                           CAPTURE_IMH, pts, normals)
        return colmap_wrapper.imgs2poses(sfm, run_sfm=False)

    pb = _step("imgs2poses", colmap, steps, label="capture")
    cams = dict(np.load(os.path.join(sfm, "preprocessed",
                                     "cameras_sphere.npz")))
    if pb.shape != (len(views), 17) or not np.isfinite(pb).all() \
            or not (pb[:, 15] < pb[:, 16]).all():
        raise AssertionError(f"poses_bounds {pb.shape} not finite or near "
                             ">= far")
    K4 = np.eye(4)
    K4[:3, :3] = K
    for i, (_, w2c, _, _) in enumerate(views):
        _close_f32(cams["world_mat_%d" % i], K4 @ w2c, "world_mat_%d" % i)
    scale = cams["scale_mat_0"].astype(np.float64)
    # 1e-6: the float32 rounding of the stored scale_mat
    inside = np.linalg.norm((pts - scale[:3, 3]) / scale[0, 0],
                            axis=1) <= 1 + 1e-6
    if inside.mean() < 0.99:
        raise AssertionError(f"scale_mat puts {inside.mean():.4f} of the "
                             "points inside the unit sphere")

    scene = os.path.join(cap, CAPTURE_SCENE)
    split = {"train": range(CAPTURE_TRAIN),
             "val": range(CAPTURE_TRAIN, CAPTURE_TRAIN + CAPTURE_VAL)}
    for mode, idx in split.items():
        vio.write_json({"world_mat": [cams["world_mat_%d" % i].tolist()
                                      for i in idx],
                        "scale_mat": [cams["scale_mat_%d" % i].tolist()
                                      for i in idx]},
                       os.path.join(scene, "%s.json" % mode))
        for j, i in enumerate(idx):
            rgba = np.dstack([views[i][2], views[i][3]]).astype(np.uint16)
            d = os.path.join(scene, "%s_%03d" % (mode, j))
            os.makedirs(d)
            vio.write_png(os.path.join(d, "rgba.png"), rgba * 257)
    ds = DtuSceneDataset(scene, is_train=True, new_h=0)
    center = -scale[:3, 3] / scale[0, 0]
    agree = []
    for i in range(ds.n_images):
        rayo, rayd = ds.gen_rays_at(i)
        hit = _sphere_hits(rayo.astype(np.float64), rayd.astype(np.float64),
                           center, GEO_GT_RADIUS / scale[0, 0])
        agree.append(np.mean(hit == (ds.masks[i][..., 0] > 0.5)))
    print("capture: %d views of %dx%d, %d points (%d on the sphere), "
          "scale_mat radius %.4f, %.4f of the points inside the unit "
          "sphere; DtuSceneDataset rays hit the sphere where the frames' "
          "alpha is set on %.5f-%.5f of the pixels"
          % (len(views), CAPTURE_IMH, CAPTURE_IMH, len(pts),
             CAPTURE_SPHERE_POINTS, scale[0, 0], inside.mean(), min(agree),
             max(agree)), flush=True)
    if min(agree) < 0.99:
        raise AssertionError(f"rays agree with alpha on {min(agree):.4f}")

    out = os.path.join(cap, "output")
    common = ["--data-root", scene, "--output-root", out, "--device",
              str(device)]
    shipped_cfg, shipped, meta = vcfg.neus_configs_for_scene(CAPTURE_SCENE)
    warm = max(1, round(shipped.warm_up_end * CAPTURE_GEO_ITERS
                        / shipped.end_iter))
    print("capture cuts: %d train + %d val views of %dx%d (new_h %d, "
          "%d rays a step: the %s preset), geo-train --end-iter %d for the "
          "shipped %d, warm_up_end %d for %d"
          % (CAPTURE_TRAIN, CAPTURE_VAL, CAPTURE_IMH, CAPTURE_IMH,
             meta["new_h"], shipped.batch_size, meta["family"],
             CAPTURE_GEO_ITERS, shipped.end_iter, warm, shipped.warm_up_end))
    _step("geo-train", lambda: cli.main(
        ["geo-train", CAPTURE_SCENE, *common, "--end-iter",
         str(CAPTURE_GEO_ITERS), "--geo-override",
         "warm_up_end=%d" % warm]), steps, label="capture")
    tail_start = CAPTURE_GEO_ITERS - int(round(shipped.tail_frac
                                               * CAPTURE_GEO_ITERS))
    want = (shipped_cfg.up_sample_steps * tail_start
            + vcfg.parse_sampler_spec(shipped.tail_sampler)["up_sample_steps"]
            * (CAPTURE_GEO_ITERS - tail_start))
    got = steps["geo-train"]["launches"]
    if got["sdf_fwd"] != want or got["sdf_fwdgrad"]:
        raise AssertionError(f"capture geo-train launched {got}; kernel 3 "
                             f"should run {want} times")
    _step("gen-geo", lambda: cli.main(["gen-geo", CAPTURE_SCENE, *common]),
          steps, label="capture")
    got = steps["gen-geo"]["launches"]
    if got["sdf_fwd"] <= 0 or got["sdf_fwdgrad"]:
        raise AssertionError(f"capture gen-geo launched {got}: kernel 3 and "
                             "no lvis (kernel 4) for a colmap_* scene")
    surf = vcfg.surf_dir(os.path.join(out, "surf"), CAPTURE_SCENE)
    names = ["train_%03d" % i for i in range(CAPTURE_TRAIN)] + \
        ["val_%03d" % i for i in range(CAPTURE_VAL)]
    if sorted(os.listdir(surf)) != names or not all(
            gen_geo.check_finished(os.path.join(surf, v), with_lvis=False)
            for v in names):
        raise AssertionError(f"gen-geo wrote {sorted(os.listdir(surf))}")
    n = _check_finite_npy(surf)
    alpha = np.mean([vio.load_img_f32(os.path.join(surf, v, "alpha.png"))
                     .mean() for v in names])
    print("capture gen-geo: %d views of %dx%d, %d arrays finite, mean "
          "alpha %.4f" % (len(names), meta["new_h"], meta["new_h"], n,
                          alpha), flush=True)
    return views, K


def capture_steps_aruco_real(root, views, K, steps):
    """ArUco: tmp/poses.npy (rvec | tvec), tmp/intrinsic.npy and
    tmp/image_undistort/*.png of the capture, convert_cameras with a crop;
    then make_real_dataset on the frames and masks at CAPTURE_REAL_IMH,
    loaded by NerfSceneDataset and NerfRaysDataset."""
    from scipy.spatial.transform import Rotation

    from vqnerf_release_torch.data import rays as vrays
    from vqnerf_release_torch.data.nerf_rays_dataset import NerfRaysDataset
    from vqnerf_release_torch.preprocess import aruco_cameras, data_gen

    work = os.path.join(root, "capture", "aruco")
    und = os.path.join(work, "tmp", "image_undistort")
    os.makedirs(und)
    np.save(os.path.join(work, "tmp", "poses.npy"), np.stack([
        [Rotation.from_matrix(w2c[:3, :3]).as_rotvec(), w2c[:3, 3]]
        for _, w2c, _, _ in views]))
    np.save(os.path.join(work, "tmp", "intrinsic.npy"), K)
    for i, (_, _, rgb, _) in enumerate(views):
        vio.write_png(os.path.join(und, "%03d.png" % i), rgb)
    out = _step("aruco", lambda: aruco_cameras.convert_cameras(
        work, crop_pixels=CAPTURE_CROP), steps, label="capture")
    cams = np.load(os.path.join(out, "cameras_sphere.npz"))
    K4 = np.eye(4)
    K4[:3, :3] = K
    K4[:2, 2] -= CAPTURE_CROP
    c = CAPTURE_CROP
    for i, (_, w2c, rgb, _) in enumerate(views):
        _close_f32(cams["world_mat_%d" % i], K4 @ w2c, "aruco world_mat")
        img = vio.read_png(os.path.join(out, "image", "%03d.png" % i))
        if not np.array_equal(img, rgb[c:-c, c:-c]):
            raise AssertionError(f"aruco image {i} is not the frame's crop")
        mask = vio.read_png(os.path.join(out, "mask", "%03d.png" % i))
        if mask.shape != img.shape[:2] or (mask != 255).any():
            raise AssertionError(f"aruco mask {i}")

    real = os.path.join(root, "capture", "real")
    frames, masks = [], []
    for i, (_, _, rgb, mask) in enumerate(views):
        frames.append(os.path.join(real, "frames", "%03d.png" % i))
        masks.append(os.path.join(real, "masks", "%03d.png" % i))
        os.makedirs(os.path.dirname(frames[-1]), exist_ok=True)
        os.makedirs(os.path.dirname(masks[-1]), exist_ok=True)
        vio.write_png(frames[-1], rgb)
        vio.write_png(masks[-1], mask)
    c2ws = [v[0] for v in views]
    every = (CAPTURE_TRAIN + CAPTURE_VAL) // CAPTURE_VAL
    counts = _step("make_real_dataset", lambda: data_gen.make_real_dataset(
        frames, c2ws, CAPTURE_ANGLE_X, os.path.join(real, "scene"),
        masks=masks, val_every=every, imh=CAPTURE_REAL_IMH), steps,
        label="capture")
    if counts != {"train": CAPTURE_TRAIN, "val": CAPTURE_VAL}:
        raise AssertionError(f"make_real_dataset split {counts}")
    scene = os.path.join(real, "scene")
    order = [i for i in range(len(views)) if i % every != every - 1] + \
        [i for i in range(len(views)) if i % every == every - 1]
    n_rays = 0
    for is_train in (True, False):
        ds = NerfSceneDataset(scene, is_train=is_train)
        rd = NerfRaysDataset(scene, mode="train" if is_train else "vali",
                             imh=CAPTURE_REAL_IMH)
        picks = order[:CAPTURE_TRAIN] if is_train else order[CAPTURE_TRAIN:]
        if ds.n_images != len(picks) or len(rd) != len(picks) \
                or ds.H != CAPTURE_REAL_IMH:
            raise AssertionError("assembled scene: %d / %d views of height "
                                 "%d" % (ds.n_images, len(rd), ds.H))
        for j, i in enumerate(picks):
            ro, rd_ = vrays.nerf_rays(views[i][0], CAPTURE_ANGLE_X,
                                      CAPTURE_REAL_IMH, CAPTURE_REAL_IMH)
            v = rd.load_view(rd.files[j])
            if not (np.array_equal(v["rayo"], ro.reshape(-1, 3))
                    and np.array_equal(v["rayd"], rd_.reshape(-1, 3))):
                raise AssertionError(f"NerfRaysDataset rays of view {i}")
            so, sd = ds.gen_rays_at(j)
            _, unit = vrays.nerf_rays(views[i][0], CAPTURE_ANGLE_X,
                                      CAPTURE_REAL_IMH, CAPTURE_REAL_IMH,
                                      normalize=True)
            if not (np.array_equal(so, ro)
                    and np.abs(sd - unit).max() <= 1e-6):
                raise AssertionError(f"NerfSceneDataset rays of view {i}")
            n_rays += ro.size // 3
    print("capture aruco: %d views cropped by %d to %dx%d, world mats and "
          "crops checked; make_real_dataset: %s at %dx%d, %d rays of "
          "NerfSceneDataset and NerfRaysDataset equal to nerf_rays"
          % (len(views), c, CAPTURE_IMH - 2 * c, CAPTURE_IMH - 2 * c,
             json.dumps(counts), CAPTURE_REAL_IMH, CAPTURE_REAL_IMH, n_rays),
          flush=True)


def exr_relight_steps(cfg, vq, ref, ds, vali_dir, paths, root, device,
                      steps):
    """EXR probes on the served model: step 3's probes rewritten as
    float32 ZIP EXRs, and the first HALF_PROBES as half EXRs (ZIPS and
    NONE in turn); `test`'s run_test over one 512x512 view with each probe
    directory. The float32 EXRs' pd_relit PNGs must equal the .hdr run's
    bit for bit; the half probes' differences are printed."""
    from vqnerf_release_torch.data import exr

    cap = os.path.join(root, "capture")
    dirs = {"hdr": paths["env_dir"],
            "exr32": os.path.join(cap, "probes_exr32"),
            "exr16": os.path.join(cap, "probes_exr16")}
    hdrs = sorted(glob.glob(os.path.join(paths["env_dir"], "*.hdr")))
    for d in (dirs["exr32"], dirs["exr16"]):
        os.makedirs(d)
    for i, path in enumerate(hdrs):
        name = os.path.basename(path)[:-4] + ".exr"
        env = vio.read_hdr(path)
        exr.write_exr(os.path.join(dirs["exr32"], name), env,
                      compression="zip", dtype=np.float32)
        if i < HALF_PROBES:
            exr.write_exr(os.path.join(dirs["exr16"], name), env,
                          compression=("zips", "none")[i % 2],
                          dtype=np.float16)
    one = copy.copy(ds)
    one.files = ds.files[:1]
    outs = {}
    for key, env_dir in dirs.items():
        outs[key] = os.path.join(cap, "serve_" + key)
        _step("test " + key, functools.partial(
            run_test, ref, vq, cfg, one, outs[key], env_dir,
            vali_epoch_dir=vali_dir, data_root=paths["data_root"],
            scene_name=SCENE, device=device), steps, label="capture")
        _assert_vector_render(steps["test " + key], "capture test " + key, relit=True)

    def relit(key):
        d = os.path.join(outs[key], "pd_relit", "batch%09d" % 0)
        return {f: vio.read_png(os.path.join(d, f)) for f in sorted(
            os.listdir(d)) if f.startswith("pred_rgb_probes_")}

    hdr, f32, f16 = relit("hdr"), relit("exr32"), relit("exr16")
    if sorted(hdr) != sorted(f32) or len(hdr) != len(hdrs) \
            or len(f16) != HALF_PROBES:
        raise AssertionError(f"relit files {len(hdr)} / {len(f32)} / "
                             f"{len(f16)} for {len(hdrs)} probes")
    for f in hdr:
        if not np.array_equal(hdr[f], f32[f]):
            raise AssertionError(f"{f}: the float32 EXR render differs from "
                                 "the .hdr one")
    half = max(int(np.abs(f16[f].astype(int) - hdr[f].astype(int)).max())
               for f in f16)
    print("capture EXR relight: %d float32-EXR probe renders equal the "
          ".hdr ones bit for bit; %d half-EXR probes within %d of 255 "
          "(max abs over the uint8 PNGs); kernel 1 launches %s"
          % (len(f32), len(f16), half,
             {k: steps["test " + k]["launches"]["fused_brdf_render"]
              for k in dirs}), flush=True)


def capture_steps_formats(root, device, steps):
    """JPEG fixtures, MERL, the BRDF sphere and ShapeRefine (each on the
    card and on the CPU)."""
    from vqnerf_release_torch.data import merl
    from vqnerf_release_torch.models import shape_refine
    from vqnerf_release_torch.ops.sphere_render import render_brdf_sphere
    from vqnerf_release_torch.preprocess import data_gen

    seconds = {}

    def jpegs():
        jpgs = sorted(glob.glob(os.path.join(JPEG_FIXTURES, "*.jpg")))
        if len(jpgs) != 8:
            raise AssertionError(f"{len(jpgs)} JPEG fixtures")
        for path in jpgs:
            t0 = time.perf_counter()
            got = vio.read_image(path)
            seconds[os.path.basename(path)] = time.perf_counter() - t0
            if not np.array_equal(got, vio.read_png(path[:-4] + ".png")):
                raise AssertionError(f"{path}: not cv2's decode")

    _step("jpeg", jpegs, steps, label="capture")
    print("capture jpeg: %d fixtures equal cv2's decodes bit for bit; decode "
          "seconds on this host %s" % (len(seconds), json.dumps(
              {k: round(v, 4) for k, v in seconds.items()})), flush=True)

    def merl_round_trip():
        raw = np.random.default_rng(SEED).random((3,) + merl.MERL_DIMS)
        path = os.path.join(root, "capture", "seeded.binary")
        with open(path, "wb") as f:
            f.write(struct.pack("3i", *merl.MERL_DIMS))
            f.write(raw.tobytes())
        npz = os.path.join(root, "capture", "seeded.npz")
        shape = data_gen.merl_to_npz(path, npz)
        cube = merl.read_merl(path)
        want = raw * merl.MERL_SCALES[:, None, None, None]
        if shape != want.shape or not np.array_equal(cube, want) \
                or not np.array_equal(np.load(npz)["cube"], want):
            raise AssertionError("MERL round trip")
        return os.path.getsize(path)

    size = _step("merl", merl_round_trip, steps, label="capture")
    print("capture merl: a %d-byte .binary through merl_to_npz and read_merl "
          "equal" % size, flush=True)

    env = (np.random.default_rng(SEED + 1).random((16, 32, 3)) * 2).astype(
        np.float32)
    sphere_args = ([0.6, 0.3, 0.2], 0.8, [0.04, 0.05, 0.06], env)
    card = _step("sphere", lambda: render_brdf_sphere(
        *sphere_args, device=device), steps, label="capture")
    plain = render_brdf_sphere(*sphere_args, device="cpu")
    err = np.abs(card - plain)
    tol = CAPTURE_RTOL * np.abs(plain) + 1e-6 * np.abs(plain).max()
    if card.shape != (128, 128, 3) or not np.isfinite(card).all() \
            or not (err <= tol).all():
        raise AssertionError(f"sphere: card and CPU {err.max()} apart")
    print("capture sphere: 128x128 at light_h 16, card against CPU max abs "
          "err %.3g (rtol %g)" % (err.max(), CAPTURE_RTOL), flush=True)

    cfg = dc.DecompConfig()
    gen = torch.Generator().manual_seed(SEED)
    model = shape_refine.init_shape_refine(gen, cfg)
    rs = np.random.default_rng(SEED + 2)
    batch = {"alpha": rs.random((CAPTURE_SHAPE_RAYS, 1)),
             "xyz": rs.random((CAPTURE_SHAPE_RAYS, 3)) - 0.5,
             "rayd": rs.normal(size=(CAPTURE_SHAPE_RAYS, 3)),
             "normal": rs.normal(size=(CAPTURE_SHAPE_RAYS, 3))}
    batch["alpha"][: CAPTURE_SHAPE_RAYS // 8] = 0.0

    def refine(m, dev):
        b = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
             for k, v in batch.items()}
        m.zero_grad()
        pred = shape_refine.shape_refine_forward(m, b, cfg)
        loss = shape_refine.shape_refine_loss(pred, b, cfg)
        loss.backward()
        return (loss.item(), pred["normal"].detach().cpu().numpy(),
                [p.grad.detach().cpu().numpy() for p in m.parameters()])

    on_card = copy.deepcopy(model).to(device)
    l_card, n_card, g_card = _step("shape_refine",
                                   lambda: refine(on_card, device), steps,
                                   label="capture")
    l_cpu, n_cpu, g_cpu = refine(model, "cpu")
    grad_err = max(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
                   for a, b in zip(g_card, g_cpu))
    loss_err = abs(l_card - l_cpu) / abs(l_cpu)
    if not np.isfinite(l_card) or loss_err > CAPTURE_RTOL \
            or grad_err > CAPTURE_RTOL \
            or np.abs(n_card - n_cpu).max() > 1e-5:
        raise AssertionError(
            f"ShapeRefine: loss {loss_err}, normals "
            f"{np.abs(n_card - n_cpu).max()}, gradients {grad_err} apart")
    print("capture shape_refine: %d rays at DecompConfig widths, card "
          "against CPU: loss %.3g relative, normals %.3g abs, gradients "
          "%.3g norm-relative (rtol %g)"
          % (CAPTURE_SHAPE_RAYS, loss_err, np.abs(n_card - n_cpu).max(),
             grad_err, CAPTURE_RTOL), flush=True)


# ---- import, acceptance and parallel ----------------------------------------

# one card: the mesh of the parallel steps is two replicas on it
PAR_MESH = ("cuda:0", "cuda:0")
PAR_VQ_STEPS = 3
PAR_TIME_REPS = 5
# views split over devices or processes: a matrix product's blocking may
# depend on the rows it gets, so a value may differ in its last bits
SPLIT_RTOL, SPLIT_ATOL = 1e-5, 1e-6


def reference_neus_checkpoint(model, iter_step):
    """A NeuS in the reference's torch.save layout (what
    interop/torch_import.py reads): per weight-normed layer of the SDF and
    colour nets lin<l>.weight_v [out, in], weight_g [out, 1] and bias, the
    variance, and iter_step (no background net: n_outside is 0)."""
    def wn(layers):
        sd = {}
        for i, layer in enumerate(layers):
            sd["lin%d.weight_v" % i] = layer.v.detach().cpu().T.contiguous()
            sd["lin%d.weight_g" % i] = layer.g.detach().cpu().reshape(-1, 1)
            sd["lin%d.bias" % i] = layer.b.detach().cpu().clone()
        return sd
    return {"sdf_network_fine": wn(model.sdf),
            "color_network_fine": wn(model.color),
            "variance_network_fine": {
                "variance": model.variance.variance.detach().cpu().clone()},
            "iter_step": iter_step}


def _compare_geo_files(got_dir, want_dir, what, exact=False):
    """The files under got_dir against want_dir's: equal byte for byte
    when ``exact``, else .npy arrays within SPLIT_RTOL / SPLIT_ATOL and PNGs
    within 1. Returns (files, files equal byte for byte, max abs difference
    of the arrays)."""
    files = _files(want_dir)
    if _files(got_dir) != files or not files:
        raise AssertionError(f"{what}: files {_files(got_dir)} != {files}")
    n_same, err = 0, 0.0
    for rel in files:
        a, b = os.path.join(got_dir, rel), os.path.join(want_dir, rel)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() == fb.read():
                n_same += 1
                continue
        if exact:
            raise AssertionError(f"{what}: {rel} differs")
        if rel.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            if x.shape != y.shape or not np.allclose(
                    x, y, rtol=SPLIT_RTOL, atol=SPLIT_ATOL):
                raise AssertionError(f"{what}: {rel} beyond rtol {SPLIT_RTOL}"
                                     f" / atol {SPLIT_ATOL}")
            err = max(err, float(np.abs(x - y).max()))
        elif np.abs(vio.read_png(a).astype(np.int64)
                    - vio.read_png(b).astype(np.int64)).max() > 1:
            raise AssertionError(f"{what}: {rel} off by more than 1")
    return len(files), n_same, err


def _load_script(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gen_geo_processes(argvs, reports):
    """`python -m vqnerf_release_torch.cli` processes through
    SERVER_LAUNCHER, started together; returns (seconds until the last
    exits, each process's report). Any exit but 0 raises."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", SERVER_LAUNCHER, rep,
                               *argv], cwd=here, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, rep in zip(argvs, reports)]
    try:
        outs = [p.communicate(timeout=CLI_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"gen-geo process {i} exited "
                                 f"{p.returncode}: {err[-3000:]}")
    return seconds, [vio.read_json(rep) for rep in reports]


def _process_step(name, seconds, reports, steps):
    launches = {k: sum(r["launches"][k] for r in reports)
                for k in reports[0]["launches"]}
    steps[name] = {"seconds": seconds,
                   "peak_bytes": max(r["peak_bytes"] for r in reports),
                   "launches": launches}
    print("import/parallel %s: %.3f s, peak %.3f GiB, kernel launches %s "
          "(by process %s)" % (name, seconds,
                               steps[name]["peak_bytes"] / 2**30, launches,
                               [r["launches"] for r in reports]), flush=True)


def _vq_batches(cfg, views, n_steps):
    """n_steps jitter-pair batches of the cli scene's train views, one row
    short of 2 * n_rays_per_step (so that a mesh of 2 pads), with their
    dropout uniforms."""
    rng = np.random.RandomState(SEED)
    gen = torch.Generator().manual_seed(SEED)
    out = []
    for s in range(n_steps):
        b = outer_sample(views[s % len(views)], cfg.n_rays_per_step, rng,
                         jitter_mode="random")
        b = {k: v[:-1] for k, v in b.items()}
        out.append((b, torch.rand((1, cfg.num_embed), generator=gen)))
    return out


def _vq_mesh_run(cfg, vq_dir, batches, device, mesh, thres, lxyz, lareas):
    """PAR_VQ_STEPS chained vq_nfr steps from the cli tree's checkpoint, on
    one device (the batches padded as the mesh pads them) or over
    ``mesh``; returns (model, optimizer, ema state, loss dicts, step
    function)."""
    state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(vq_dir))
    model = cli._load_phase_model(vq_dir, cfg, "vq_nfr", device)
    ema = VqEmaState(*(t.to(device) for t in state["ema"]))
    opt, step = dt.make_vq_nfr_step(model, cfg, lxyz, lareas, mesh=mesh)
    opt.state = {k: v.to(device) for k, v in state["opt_state"].items()}
    lds = []
    for s, (b, roll) in enumerate(batches):
        if mesh is None:
            b = pad_rows(b, 1)
        b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        b["_roll"] = roll.to(device)
        ema, ld = step(ema, b, thres, None, s)
        lds.append(ld)
    return model, opt, ema, lds, step


def _median_mesh_step_ms(step, ema, batch, thres, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ema, _ = step(ema, batch, thres, None, 0)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def import_parallel_phase(root, paths, device):
    """The last of the port ("import, acceptance and parallel"), every
    kernel's launch count set to 0 just before each step and read just
    after:

    1. stage 1's trained NeuS written as a reference .pth and imported by
       interop/torch_import.main: params equal bit for bit, a fresh Adam
       state, iter_step NEUS_ITERS;
    2. run_gen_geo of one view of the CG scene (its last train view) from
       the imported checkpoint: kernels 3 and 4 launch and the view's files
       equal the direct extraction's byte for byte;
    3. scripts/torch_acceptance.py on the cli tree (test, metric-eval,
       cluster-eval) with the eval phase's metric-eval scores of the same
       tree as --ref-scores: every row PASS, kernel 1 in its test; then
       with one buffer's PSNR raised by 10 dB: that row FAIL, exit 1;
    4. two `python -m vqnerf_release_torch.cli gen-geo --num-hosts 2
       --coordinator 127.0.0.1:<port> --host-id i` processes on the card,
       each reporting its own launch counts (kernels 3 and 4 in both), the
       union of their trees equal to the cli phase's one-process tree; one
       such process alone, for the time;
    5. the mesh PAR_MESH: one view extracted over it equal to the cli
       phase's; PAR_VQ_STEPS chained vq_nfr steps over it equal to one
       device's at rtol 2e-4 / atol 1e-5, kernel 2 once a step, and a
       step's time over the mesh and on one device.
    Returns the steps."""
    label = "import/parallel"
    steps = {}
    par = os.path.join(root, "parallel")
    os.makedirs(par)

    # 1. the trained NeuS as the reference's .pth, and the import command
    stage1_out = os.path.join(root, "stage1_out")
    geo_cfg, _, meta = vcfg.neus_configs_for_scene(GEO_SCENE)
    exp_dir = os.path.join(stage1_out, "exp", GEO_SCENE, meta["family"])
    state = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(exp_dir))
    trained = init_neus(SEED, geo_cfg)
    trained.load_state_dict(state["params"])
    ref_exp = os.path.join(par, "reference_exp")
    os.makedirs(os.path.join(ref_exp, "checkpoints"))
    torch.save(reference_neus_checkpoint(trained, int(state["iter_step"])),
               os.path.join(ref_exp, "checkpoints",
                            "ckpt_%06d.pth" % NEUS_ITERS))
    imp_root = os.path.join(par, "imported")
    imp_exp = os.path.join(imp_root, "exp", GEO_SCENE, meta["family"])
    _step("torch_import", lambda: torch_import.main(
        ["--ckpt", ref_exp, "--out", imp_exp, "--scene", GEO_SCENE,
         "--device", str(device)]), steps, label)
    got = ckpt_util.load_ckpt(ckpt_util.latest_ckpt(imp_exp))
    if set(got["params"]) != set(state["params"]) or not all(
            torch.equal(got["params"][k], v)
            for k, v in state["params"].items()):
        raise AssertionError("the imported NeuS differs from the trained one")
    if int(got["iter_step"]) != NEUS_ITERS or int(
            got["opt_state"]["count"]) != 0 or any(
            got["opt_state"][k].any() for k in ("mu", "nu")):
        raise AssertionError(f"the imported state: iter_step "
                             f"{got['iter_step']}, opt count "
                             f"{got['opt_state']['count']}")
    if any(steps["torch_import"]["launches"].values()):
        raise AssertionError(f"torch_import launched "
                             f"{steps['torch_import']['launches']}")
    print("import/parallel: the trained NeuS (%d tensors) written as a "
          "reference .pth and imported equal bit for bit, iter_step %d, a "
          "fresh Adam state" % (len(got["params"]), NEUS_ITERS))

    # 2. extraction of one view from the imported checkpoint
    data_root = os.path.join(root, "stage1", GEO_SCENE)
    done = _step("gen-geo (imported)", lambda: gen_geo.run_gen_geo(
        GEO_SCENE, data_root, imp_root, seed=SEED, near=GEO_NEAR,
        far=GEO_FAR, num_p=GEO_TRAIN_VIEWS, p_i=GEO_TRAIN_VIEWS - 1,
        device=device), steps, label)
    view = "train_%03d" % (GEO_TRAIN_VIEWS - 1)
    if [os.path.basename(d) for d in done["train"] + done["val"]] != [view]:
        raise AssertionError(f"gen-geo of one shard extracted {done}")
    if min(steps["gen-geo (imported)"]["launches"][k]
           for k in ("sdf_fwd", "sdf_fwdgrad")) <= 0:
        raise AssertionError(f"gen-geo (imported) launched "
                             f"{steps['gen-geo (imported)']['launches']}")
    direct = os.path.join(vcfg.surf_dir(os.path.join(stage1_out, "surf"),
                                        GEO_SCENE), view)
    n, _, _ = _compare_geo_files(done["train"][0], direct,
                                 "gen-geo from the imported checkpoint",
                                 exact=True)
    print("import/parallel: %s extracted from the imported checkpoint, its "
          "%d files equal the direct extraction's byte for byte" % (view, n))

    # 3. the acceptance run on the cli tree
    acc = _load_script("torch_acceptance")
    cli_out = os.path.join(root, "cli", "output")
    cli_data = os.path.join(root, "cli", "data", "nfr_blender", GEO_SCENE)
    gt_cli = os.path.join(root, "eval", "gt_cli")
    own = os.path.join(root, "eval", "metric_cli_%s.json" % device)
    labels = os.path.join(par, "labels")
    _write_idx(os.path.join(labels, GEO_SCENE, "val_000"),
               os.path.join(gt_cli, GEO_SCENE, "val_000", "rgba.png"))
    acc_argv = [GEO_SCENE, "--data-root", cli_data, "--output-root", cli_out,
                "--gt-root", gt_cli, "--test-envmap-dir", paths["env_dir"],
                "--label-root", labels, "--preset-override",
                "imh=%d" % CLI_IMH, "--device", str(device)]
    report = _step("acceptance", lambda: acc.main(
        acc_argv + ["--ref-scores", own]), steps, label)
    _assert_vector_render(steps["acceptance"], "acceptance test", relit=True)
    stray = {k: v for k, v in steps["acceptance"]["launches"].items()
             if v and k != "fused_brdf_render"}
    rows = report["comparison"]
    if report["steps"] != ["test", "metric-eval", "cluster-eval"] or stray \
            or not report["pass"] or {r["buffer"] for r in rows} != \
            {"rgb", "kd", "env"} or any(r["verdict"] != "PASS"
                                        for r in rows):
        raise AssertionError(f"acceptance against the port's own scores: "
                             f"{report}, launches "
                             f"{steps['acceptance']['launches']}")
    bad = vio.read_json(own)
    bad[GEO_SCENE]["rgb"]["psnr"] = [
        v + 10.0 for v in bad[GEO_SCENE]["rgb"]["psnr"]]
    bad_path = os.path.join(par, "ref_scores_perturbed.json")
    vio.write_json(bad, bad_path)

    def failing():
        try:
            acc.main(acc_argv + ["--ref-scores", bad_path, "--skip-test"])
        except SystemExit as e:
            return e.code
        return 0
    code = _step("acceptance (perturbed)", failing, steps, label)
    report = vio.read_json(os.path.join(cli_out,
                                        "acceptance_%s.json" % GEO_SCENE))
    verdicts = {r["buffer"]: r["verdict"] for r in report["comparison"]}
    if code != 1 or report["pass"] or verdicts != {
            "rgb": "FAIL", "kd": "PASS", "env": "PASS"} or any(
            steps["acceptance (perturbed)"]["launches"].values()):
        raise AssertionError(f"acceptance against perturbed scores: exit "
                             f"{code}, {verdicts}")
    print("import/parallel: acceptance on the cli tree, rows %s against the "
          "port's own scores (every delta %s dB), cluster-eval %s; against "
          "rgb +10 dB: exit 1, %s"
          % ({r["buffer"]: r["verdict"] for r in rows},
             sorted({round(r["delta_db"], 6) for r in rows}),
             vio.read_json(os.path.join(
                 cli_out, "acceptance_%s_cluster.json" % GEO_SCENE))["vq"],
             verdicts))

    # 4. extraction over two processes on the one card, and one process;
    # this process's allocator gives its cached blocks back to the card
    # first, or the processes find it full
    one_proc_tree = vcfg.surf_dir(os.path.join(cli_out, "surf"), GEO_SCENE)
    cli_views = ["train_%03d" % i for i in range(CLI_TRAIN_VIEWS)] + \
        ["val_%03d" % i for i in range(CLI_VAL_VIEWS)]
    gc.collect()
    torch.cuda.empty_cache()
    trees = {}
    for name, n_proc in (("gen-geo 2 processes", 2),
                         ("gen-geo 1 process", 1)):
        out = os.path.join(par, "procs%d" % n_proc)
        os.makedirs(out)
        os.symlink(os.path.join(cli_out, "exp"), os.path.join(out, "exp"))
        base = ["gen-geo", GEO_SCENE, "--data-root", cli_data,
                "--output-root", out, "--device", str(device)]
        port = _free_port()
        argvs = [base + (["--num-hosts", str(n_proc), "--coordinator",
                          "127.0.0.1:%d" % port, "--host-id", str(i)]
                         if n_proc > 1 else []) for i in range(n_proc)]
        reports = [os.path.join(par, "procs%d_%d.json" % (n_proc, i))
                   for i in range(n_proc)]
        _reset_counts()
        seconds, got = _gen_geo_processes(argvs, reports)
        _process_step(name, seconds, got, steps)
        for i, r in enumerate(got):
            if min(r["launches"]["sdf_fwd"],
                   r["launches"]["sdf_fwdgrad"]) <= 0:
                raise AssertionError(f"{name}: process {i} launched "
                                     f"{r['launches']}")
        trees[name] = vcfg.surf_dir(os.path.join(out, "surf"), GEO_SCENE)
        if sorted(os.listdir(trees[name])) != cli_views:
            raise AssertionError(f"{name} extracted "
                                 f"{os.listdir(trees[name])}")
        n = same = 0
        err = 0.0
        for v in cli_views:
            got_v = _compare_geo_files(os.path.join(trees[name], v),
                                       os.path.join(one_proc_tree, v),
                                       f"{name}, {v}")
            n, same, err = n + got_v[0], same + got_v[1], max(err, got_v[2])
        print("import/parallel %s: the %d views' %d files against the cli "
              "phase's one-process gen-geo, %d equal byte for byte, arrays "
              "within %.3e" % (name, len(cli_views), n, same, err),
              flush=True)

    # 5. the mesh: one view extracted over it, then vq_nfr steps
    mesh = [torch.device(d) for d in PAR_MESH]
    mesh_views = {}
    for name, m in (("gen-geo mesh", mesh), ("gen-geo one device", None)):
        out = os.path.join(par, name.replace(" ", "_"))
        os.makedirs(out)
        os.symlink(os.path.join(cli_out, "exp"), os.path.join(out, "exp"))
        done = _step(name, lambda: gen_geo.run_gen_geo(
            GEO_SCENE, cli_data, out, seed=SEED, num_p=CLI_TRAIN_VIEWS,
            p_i=CLI_TRAIN_VIEWS - 1, device=device, mesh=m), steps, label)
        mesh_views[name] = done["train"]
        if min(steps[name]["launches"][k]
               for k in ("sdf_fwd", "sdf_fwdgrad")) <= 0:
            raise AssertionError(f"{name} launched "
                                 f"{steps[name]['launches']}")
    view = "train_%03d" % (CLI_TRAIN_VIEWS - 1)
    for name, dirs in mesh_views.items():
        if [os.path.basename(d) for d in dirs] != [view]:
            raise AssertionError(f"{name} extracted {dirs}")
        n, same, err = _compare_geo_files(
            dirs[0], os.path.join(one_proc_tree, view), name)
        print("import/parallel %s: %s's %d files against the cli phase's, "
              "%d equal byte for byte, arrays within %.3e"
              % (name, view, n, same, err), flush=True)

    cfg, _ = vcfg.decomp_config_for_scene(GEO_SCENE, imh=CLI_IMH)
    vq_dir = vcfg.train_outdir(cli_out, GEO_SCENE, "vq_nfr")
    views = cli._views(cli_data, one_proc_tree, cfg, "train")
    batches = _vq_batches(cfg, views, PAR_VQ_STEPS)
    lxyz, lareas = dc.light_constants(cfg, device)
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    runs = {}
    for name, m in (("vq_nfr steps one device", None),
                    ("vq_nfr steps mesh", mesh)):
        runs[name] = _step(name, lambda: _vq_mesh_run(
            cfg, vq_dir, batches, device, m, thres, lxyz, lareas), steps,
            label)
        n = steps[name]["launches"]["vq_fused_train"]
        if n != PAR_VQ_STEPS:
            raise AssertionError(f"{name}: kernel 2 launched {n} times in "
                                 f"{PAR_VQ_STEPS} steps")
    (m1, o1, e1, l1, s1), (m2, o2, e2, l2, s2) = runs.values()
    err = 0.0
    for (k, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        err = max(err, _compare(b.double(), a.double(),
                                "mesh vq_nfr params " + k, rtol=2e-4,
                                atol=1e-5))
    for k in ("m", "v", "vhat"):
        err = max(err, _compare(o2.state[k].double(), o1.state[k].double(),
                                "mesh vq_nfr opt " + k, rtol=2e-4,
                                atol=1e-5))
    for a, b, k in zip(e1, e2, e1._fields):
        err = max(err, _compare(b.double(), a.double(), "mesh vq_nfr " + k,
                                rtol=2e-4, atol=1e-5))
    skipped = sum(float(ld["nonfinite_grads"]) for ld in l1 + l2)
    if skipped or int(o2.state["count"]) != int(o1.state["count"]):
        raise AssertionError(f"mesh vq_nfr: {skipped} skipped steps")
    b, roll = batches[0]
    tb = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    tb["_roll"] = roll.to(device)
    ms_mesh = _median_mesh_step_ms(s2, e2, tb, thres, PAR_TIME_REPS)
    tb1 = {k: torch.as_tensor(v, device=device)
           for k, v in pad_rows(b, 1).items()}
    tb1["_roll"] = roll.to(device)
    ms_one = _median_mesh_step_ms(s1, e1, tb1, thres, PAR_TIME_REPS)
    print("import/parallel: %d vq_nfr steps over the mesh %s equal one "
          "device's within rtol 2e-4 / atol 1e-5 (max abs err %.3e; "
          "params, optimizer, EMA), kernel 2 once a step; a step of %d rows "
          "(padded to %d): %.3f ms over the mesh, %.3f ms on one device "
          "(medians of %d, synchronised)"
          % (PAR_VQ_STEPS, list(PAR_MESH), err, 2 * cfg.n_rays_per_step - 1,
             2 * cfg.n_rays_per_step, ms_mesh, ms_one, PAR_TIME_REPS),
          flush=True)
    steps["vq_nfr steps mesh"]["step_ms"] = ms_mesh
    steps["vq_nfr steps one device"]["step_ms"] = ms_one
    return steps


def main():
    profile = "--profile" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    print("device:", device_name, flush=True)
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
        # pd_relit: one multi-map launch a chunk of a served view
        relit = N_VIEWS * -(-cfg.imh * cfg.imh // _RAY_CHUNK)
        if render_kernel.LAUNCHES_BY_INSTANCE != {
                "vector": render_launches, "scalar": 0,
                "maps_vector": relit, "maps_scalar": 0}:
            raise AssertionError(
                "run_test at 512 lights left the 16-byte instances, or its "
                "relight pass did not take one multi-map launch a chunk: %s"
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

        # ---- editing at serving's width, with the trained models ----------
        t0 = time.perf_counter()
        edit_steps = edit_phase(cfg, vq, ref, ds, outroot, paths["env_dir"],
                                root, device)
        print("edit phase: %.1f s" % (time.perf_counter() - t0), flush=True)

        # ---- capture and formats, part 1: EXR probes on the served model -
        capture_steps = {}
        t0 = time.perf_counter()
        exr_relight_steps(cfg, vq, ref, ds, trained["vali_dir"], paths, root,
                          device, capture_steps)
        print("capture EXR relight: %.1f s" % (time.perf_counter() - t0),
              flush=True)

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
            maps_entry = check_render_maps_kernel(
                vq, cfg, view, lxyz, lareas, paths["env_dir"], device)
            vq_entry = check_vq_kernel(trained, cfg, device)
        fwd_entry, fwdgrad_entry = check_sdf_kernels(geo, neus["runner"],
                                                     device)
        t0 = time.perf_counter()
        manual_steps = sdf_manual_phase(neus, device)
        print("sdf_manual phase: %.1f s" % (time.perf_counter() - t0),
              flush=True)
        time_steps(cfg, trained, lxyz, lareas, device, profile)
        t0 = time.perf_counter()
        scan_steps = scan_phase(cfg, trained, neus, root, device)
        print("scanned dispatch phase: %.1f s" % (time.perf_counter() - t0),
              flush=True)
        t0 = time.perf_counter()
        mesh_steps = mesh_scan_phase(cfg, trained, paths, root, device)
        print("mesh scan phase: %.1f s" % (time.perf_counter() - t0),
              flush=True)
        t0 = time.perf_counter()
        host_steps = host_sampler_phase(cfg, trained, root, device)
        print("host sampler phase: %.1f s" % (time.perf_counter() - t0),
              flush=True)
        render_entry["launches"] = render_launches
        maps_entry["launches"] = relit
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

        # ---- video and the edit server from the command line --------------
        t0 = time.perf_counter()
        edit_steps.update(video_cli_phase(root, paths["env_dir"], device))
        print("edit and video phase: %.1f s in all, %.1f s of it the video "
              "and edit-server subcommands; steps %s" % (
                  sum(st["seconds"] for st in edit_steps.values()),
                  time.perf_counter() - t0,
                  json.dumps({k: {"seconds": round(v["seconds"], 3),
                                  "peak_gib": round(v["peak_bytes"] / 2**30,
                                                    3)}
                              for k, v in edit_steps.items()})), flush=True)

        # ---- video frames composed from the served view dirs -------------
        frame_phase(outroot, paths["env_dir"], root, smi)

        # ---- evaluation, and the reference's TF checkpoints imported -----
        t0 = time.perf_counter()
        eval_steps = eval_import_phase(root, paths, outroot, device)
        print("eval and import phase: %.1f s; steps %s" % (
            time.perf_counter() - t0,
            json.dumps({k: {"seconds": round(v["seconds"], 3),
                            "peak_gib": round(v["peak_bytes"] / 2**30, 3)}
                        for k, v in eval_steps.items()})), flush=True)

        # ---- capture and formats, part 2: a capture into a scene ----------
        t0 = time.perf_counter()
        views, K = capture_steps_colmap(root, device, capture_steps)
        capture_steps_aruco_real(root, views, K, capture_steps)
        capture_steps_formats(root, device, capture_steps)
        for step, st in capture_steps.items():
            want = {"geo-train": ("sdf_fwd",), "gen-geo": ("sdf_fwd",)}.get(
                step, ("fused_brdf_render",) if step.startswith("test ")
                else ())
            stray = {k: n for k, n in st["launches"].items()
                     if n and k not in want}
            if stray:
                raise AssertionError(f"capture {step} launched {stray}")
        print("capture and formats phase: %.1f s in all, %.1f s of it part "
              "2; steps %s" % (
                  sum(st["seconds"] for st in capture_steps.values()),
                  time.perf_counter() - t0,
                  json.dumps({k: {"seconds": round(v["seconds"], 3),
                                  "peak_gib": round(v["peak_bytes"] / 2**30,
                                                    3)}
                              for k, v in capture_steps.items()})),
              flush=True)

        # ---- the last of the port: import, acceptance and parallel -------
        t0 = time.perf_counter()
        final_steps = import_parallel_phase(root, paths, device)
        print("import, acceptance and parallel phase: %.1f s; steps %s" % (
            time.perf_counter() - t0,
            json.dumps({k: {"seconds": round(v["seconds"], 3),
                            "peak_gib": round(v["peak_bytes"] / 2**30, 3)}
                        for k, v in final_steps.items()})), flush=True)

    for entry in (render_entry, vq_entry, fwd_entry, fwdgrad_entry):
        by_sub = {sub: n[entry["name"]] for sub, n in cli_launches.items()}
        entry["cli_launches"] = sum(by_sub.values())
        entry["cli_launches_by_subcommand"] = by_sub
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in edit_steps.items()}
        entry["edit_video_launches"] = sum(by_step.values())
        entry["edit_video_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in eval_steps.items()}
        entry["eval_import_launches"] = sum(by_step.values())
        entry["eval_import_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in capture_steps.items()}
        entry["capture_launches"] = sum(by_step.values())
        entry["capture_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in final_steps.items()}
        entry["final_launches"] = sum(by_step.values())
        entry["final_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in scan_steps.items()}
        entry["scan_launches"] = sum(by_step.values())
        entry["scan_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in mesh_steps.items()}
        entry["mesh_scan_launches"] = sum(by_step.values())
        entry["mesh_scan_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in host_steps.items()}
        entry["host_sampler_launches"] = sum(by_step.values())
        entry["host_sampler_launches_by_step"] = by_step
        by_step = {step: st["launches"][entry["name"]]
                   for step, st in manual_steps.items()}
        entry["sdf_manual_launches"] = sum(by_step.values())
        entry["sdf_manual_launches_by_step"] = by_step
    # the multi-map kernel's launches, by instance in each step that
    # records them (its launches are not among _launch_counts')
    for label, steps in (("edit_video", edit_steps), ("eval_import",
                                                      eval_steps),
                         ("capture", capture_steps), ("final", final_steps)):
        by_step = {step: st["render_instances"]["maps_vector"]
                   + st["render_instances"]["maps_scalar"]
                   for step, st in steps.items() if "render_instances" in st}
        maps_entry[label + "_launches"] = sum(by_step.values())
        maps_entry[label + "_launches_by_step"] = by_step
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"kernels": [render_entry, maps_entry, vq_entry,
                                  fwd_entry, fwdgrad_entry]}))
    print("nvidia-smi:", smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
