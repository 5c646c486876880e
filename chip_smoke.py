#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (vqnerf_release_torch) on one GPU.

    python3 chip_smoke.py

1. checks for a CUDA device and prints its name and power limit;
2. builds the fused render kernel from csrc/ and prints the build time;
3. writes a synthetic sphere scene in the reference layout to a temporary
   directory: 2 val views of 512x512 rays with 512-light lvis, the
   vis_comps GT-albedo mirror, 16 probe .hdr files and a main_5 vali dir;
4. builds vq_nfr and ref_nfr at the DecompConfig defaults (mlp_width 128,
   z_dim 256, 512 lights, 15 codes) from a seeded torch.Generator;
5. runs the port's four-pass run_test on the GPU, with the kernel's launch
   count reset just before and read just after;
6. checks the outputs: the kernel launched, every expected file exists,
   every written array is finite, embed ids lie in [0, n_vq];
7. holds the kernel against its plain PyTorch twin on the GPU (a 49,152-ray
   chunk of a view with lvis, and 1,000 rays without lvis; rtol 2e-4,
   atol 1e-5, the JAX kernel test's tolerance for a 512-term fp32 sum taken
   in another order), and the fused vq_fast_render against the eager one;
8. prints per-pass wall times, the kernel's and the twin's times (CUDA
   events, median), peak device memory, a {"kernels": [...]} line, and as
   the last line {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; without CUDA it exits 1 before doing
anything.
"""

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vqnerf_release_torch.data import io as vio
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.kernels import render as render_kernel
from vqnerf_release_torch.models import decomp_common as dc
from vqnerf_release_torch.models import vq_nfr
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.models.ref_nfr import init_ref_nfr
from vqnerf_release_torch.pipelines.test_driver import (_RAY_CHUNK,
                                                         load_novel_lights,
                                                         run_test)

SCENE = "sphere"
N_VIEWS = 2
N_PROBES = 16
N_VQ = 5
SEED = 0
RTOL, ATOL = 2e-4, 1e-5
RAGGED_N = 1000


def _look_at(eye):
    """NeRF-convention camera-to-world (camera looks down -z, y up)."""
    z = eye / np.linalg.norm(eye)
    x = np.cross([0.0, 0.0, 1.0], z)
    x /= np.linalg.norm(x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, eye
    return c2w


def write_scene(root, imh, n_views, light_h, n_probes, n_vq, seed):
    """A unit sphere seen from n_views cameras, in the reference layout.

    Returns dict(data_root, surf_root, env_dir, vali_dir). lvis is seeded
    uniform noise stored as float16 (the loader casts to float32)."""
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
    for i in range(n_views):
        vid = "val_%03d" % i
        phi = 2 * np.pi * i / n_views
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
    os.makedirs(os.path.join(vali_dir, "main_%d" % n_vq))
    return {"data_root": data_root, "surf_root": surf_root,
            "env_dir": env_dir, "vali_dir": vali_dir}


def build_models(cfg, seed, device):
    """(ref_nfr, vq_nfr) from the port's init, chained as in training."""
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


def _time_ms(fn, reps=7):
    """Median of per-call CUDA-event times after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _compare(got, want, what):
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if not torch.isfinite(got).all() or bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {got.numel()} values outside "
            f"rtol={RTOL}, atol={ATOL}; max abs err {float(err.max())}")
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


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print("device:", name, flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print("nvidia-smi:", smi, flush=True)

    t0 = time.perf_counter()
    so, log = render_kernel.build()
    print("kernel build: %.3f s -> %s" % (time.perf_counter() - t0, so.name))
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    cfg = dc.DecompConfig()
    with tempfile.TemporaryDirectory(prefix="vqnerf_smoke_") as root:
        t0 = time.perf_counter()
        paths = write_scene(root, cfg.imh, N_VIEWS, cfg.light_h, N_PROBES,
                            N_VQ, SEED)
        print("scene written: %.3f s" % (time.perf_counter() - t0))
        ref, vq = build_models(cfg, SEED, device)
        ds = ShapeDataset(paths["data_root"], paths["surf_root"],
                          data_type="nerf", imh=cfg.imh, mode="test",
                          with_ref=True)
        if len(ds) != N_VIEWS:
            raise AssertionError(f"dataset has {len(ds)} views")
        outroot = os.path.join(root, "vis_test")

        torch.cuda.reset_peak_memory_stats()
        render_kernel.LAUNCHES = 0
        t0 = time.perf_counter()
        info = run_test(ref, vq, cfg, ds, outroot, paths["env_dir"],
                        vali_epoch_dir=paths["vali_dir"],
                        data_root=paths["data_root"], scene_name=SCENE,
                        device=device)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        launches = render_kernel.LAUNCHES
        peak = torch.cuda.max_memory_allocated()
        if launches <= 0:
            raise AssertionError("run_test never launched the render kernel")
        if info["n_vq"] != N_VQ:
            raise AssertionError(f"n_vq {info['n_vq']} != {N_VQ}")
        n_arrays = check_outputs(
            outroot, expected_files(cfg, paths["env_dir"]), N_VIEWS, N_VQ)
        print("run_test: %.3f s total, opt_scale %s, %d arrays checked"
              % (total, info["opt_scale"], n_arrays))
        for phase, sec in info["seconds"].items():
            print("  pass %-8s %.3f s (%.3f s per %dx%d view)"
                  % (phase, sec, sec / N_VIEWS, cfg.imh, cfg.imh))
        print("peak device memory in run_test: %d bytes (%.3f GiB)"
              % (peak, peak / 2**30))

        view = ds.load_view(ds.files[0])

    lxyz, lareas = dc.light_constants(cfg, device)
    batch = {k: torch.as_tensor(x, device=device)
             for k, x in view.as_batch().items() if k != "ref"}
    with torch.inference_mode():
        # a chunk through the middle rows of the view, where the sphere is
        chunk = {k: v[2 * _RAY_CHUNK:3 * _RAY_CHUNK] for k, v in batch.items()}
        args = kernel_inputs(vq, cfg, chunk, lxyz, lareas)
        ragged = [a[:RAGGED_N] for a in args[:6]] + [None, args[7]]
        err = 0.0
        for what, a in (("chunk %dx%d" % (_RAY_CHUNK, cfg.n_lights), args),
                        ("ragged %d, no lvis" % RAGGED_N, ragged)):
            got = render_kernel.fused_brdf_render(*a)
            want = render_kernel.fused_brdf_render_reference(*a)
            torch.cuda.synchronize()
            e = _compare(got, want, what)
            print("kernel vs plain twin, %s: max abs err %.3e" % (what, e))
            err = max(err, e)

        fused = vq_nfr.vq_fast_render(vq, chunk, cfg, lxyz, lareas)
        eager = vq_nfr.vq_fast_render(
            vq, chunk, dc.DecompConfig(use_fused_render=False), lxyz, lareas)
        e = _compare(fused["rgb"], eager["rgb"], "vq_fast_render fused/eager")
        print("vq_fast_render rgb, fused vs eager: max abs err %.3e" % e)

        ms = _time_ms(lambda: render_kernel.fused_brdf_render(*args))
        plain_ms = _time_ms(
            lambda: render_kernel.fused_brdf_render_reference(*args))
    print("time at %d rays x %d lights: kernel %.4f ms, plain twin %.4f ms"
          % (_RAY_CHUNK, cfg.n_lights, ms, plain_ms))

    print(json.dumps({"kernels": [{
        "name": "fused_brdf_render",
        "route": "cuda",
        "source": "vqnerf_release_torch/csrc/render_kernel.cu",
        "replaces": "vqnerf_release_tpu/ops/pallas/render_kernel.py:133",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
