"""Time of one vq_nfr training step (``train/decomp_trainer.py``), the
step ``chip_smoke.py`` times in its parallel phase, on random weights.

A VqNfr of the scene's stage-2 config (full widths, the fused VQ on a
card) is made from --seed, with random k-means centres; a batch of --rows
random rows (unit normals, a fifth of them alpha 0, lvis over all lights)
and the dropout uniforms are made once. After --warmup steps, --reps steps
are timed one at a time, each between two ``torch.cuda.synchronize()``.
Prints one JSON line: the step's median, quartiles and every time in ms,
on the device alone and over the mesh --mesh (a comma list of devices,
e.g. ``cuda:0,cuda:0``), when given.

    python scripts/torch_vq_step_time.py [--device cuda] [--rows 2048]
        [--reps 30] [--mesh cuda:0,cuda:0]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vqnerf_release_torch import config as vcfg  # noqa: E402
from vqnerf_release_torch.models import decomp_common as dc  # noqa: E402
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit  # noqa: E402
from vqnerf_release_torch.models.vq_nfr import init_vq_nfr  # noqa: E402
from vqnerf_release_torch.train import decomp_trainer as dt  # noqa: E402
from vqnerf_release_torch.utils.device import resolve_device  # noqa: E402


def _batch(n, n_lights, rs, device):
    normal = rs.randn(n, 3)
    alpha = (rs.rand(n, 1) > 0.2).astype(np.float32)
    b = dict(rayo=np.tile([0.0, 0.0, 3.0], (n, 1)) + 0.1 * rs.randn(n, 3),
             rayd=rs.randn(n, 3), xyz=rs.rand(n, 3) - 0.5,
             normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
             alpha=alpha, pred_alpha=alpha, rgb=rs.rand(n, 3),
             lvis=rs.rand(n, n_lights))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in b.items()}


def step_times(cfg, device, mesh, rows, warmup, reps, seed):
    """Every timed step's ms, of a fresh model, over ``mesh`` (None: the
    device alone)."""
    gen = torch.Generator().manual_seed(seed)
    rs = np.random.RandomState(seed)
    centers = torch.as_tensor(rs.randn(cfg.num_embed, cfg.z_dim),
                              dtype=torch.float32)
    model, ema = init_vq_nfr(gen, cfg, init_nfr_unit(gen, cfg), centers)
    model = model.to(device)
    ema = type(ema)(*(t.to(device) for t in ema))
    lxyz, lareas = dc.light_constants(cfg, device)
    _, step = dt.make_vq_nfr_step(model, cfg, lxyz, lareas, mesh=mesh)
    batch = _batch(rows, lxyz.shape[0], rs, device)
    batch["_roll"] = torch.rand((1, cfg.num_embed), generator=gen).to(device)
    thres = torch.as_tensor(cfg.train_thres(), device=device)
    times = []
    for i in range(warmup + reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        ema, _ = step(ema, batch, thres, None, i)
        torch.cuda.synchronize(device)
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t0))
    return times


def _summary(times):
    q1, med, q3 = np.percentile(times, [25, 50, 75])
    return {"median_ms": float(med), "q1_ms": float(q1), "q3_ms": float(q3),
            "ms": [float(t) for t in times]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", default="lego_3072")
    ap.add_argument("--imh", type=int, default=128)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("times a step on a card: --device must be cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _ = vcfg.decomp_config_for_scene(args.scene, imh=args.imh)
    out = {"rows": args.rows, "device": str(device),
           "one_device": _summary(step_times(cfg, device, None, args.rows,
                                             args.warmup, args.reps,
                                             args.seed))}
    if args.mesh:
        mesh = args.mesh.split(",")
        out["mesh"] = mesh
        out["over_mesh"] = _summary(step_times(
            cfg, device, mesh, args.rows, args.warmup, args.reps, args.seed))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
