"""Time of one NeuS training step (``train/neus_trainer.py::
make_neus_train_step``), single and unscanned, at a scene's shipped
sampler schedule: the carve sampler and the tail's, on random weights.

A NeuS of the scene's config (full widths; on a card the up-sample chain
through the SDF kernel) is made from --seed, and one batch of the config's
rays: origins on a sphere of radius 2 aimed near the centre, near 0.5 and
far 3.5, random colours and masks. No occupancy grid. After --warmup steps
of each phase, --reps steps are timed one at a time, each between two
``torch.cuda.synchronize()``, with the perturbation drawn from a generator
seeded by --seed. Prints one JSON line: per phase the step's median,
quartiles and every time in ms, and the peak device memory of a step.

    python scripts/torch_neus_step_time.py [--scene lego_3072]
        [--device cuda] [--reps 20]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vqnerf_release_torch import config as vcfg  # noqa: E402
from vqnerf_release_torch.models.neus import init_neus  # noqa: E402
from vqnerf_release_torch.train.neus_trainer import (  # noqa: E402
    make_neus_train_step)
from vqnerf_release_torch.utils.device import resolve_device  # noqa: E402


def _batch(n, rs, device):
    o = rs.randn(n, 3)
    o = 2.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = -o + 0.3 * rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    b = dict(rays_o=o, rays_d=d, rgb=rs.rand(n, 3),
             mask=(rs.rand(n, 1) > 0.5), near=np.full((n, 1), 0.5),
             far=np.full((n, 1), 3.5), valid=np.ones((n, 1)))
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in b.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scene", default="lego_3072")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg, tcfg, _ = vcfg.neus_configs_for_scene(args.scene)
    phases = {"carve": cfg}
    if tcfg.tail_frac > 0.0 and tcfg.tail_sampler:
        phases["tail"] = dataclasses.replace(cfg, **vcfg.parse_sampler_spec(
            tcfg.tail_sampler))
    batch = _batch(tcfg.batch_size, np.random.RandomState(args.seed), device)
    out = {"scene": args.scene, "device": str(device),
           "batch_size": tcfg.batch_size}
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    for name, c in phases.items():
        model = init_neus(args.seed, c).to(device)
        _, step = make_neus_train_step(model, c, tcfg, 1.0)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        for i in range(args.warmup):
            step(batch, i, generator=gen)
        times = []
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        for i in range(args.reps):
            _sync(device)
            t0 = time.perf_counter()
            step(batch, args.warmup + i, generator=gen)
            _sync(device)
            times.append(1e3 * (time.perf_counter() - t0))
        q1, med, q3 = np.percentile(times, [25, 50, 75])
        out[name] = {"sampler": "%d+%dr%d" % (c.n_samples, c.n_importance,
                                              c.up_sample_steps),
                     "median_ms": float(med), "q1_ms": float(q1),
                     "q3_ms": float(q3), "times_ms": times}
        if device.type == "cuda":
            out[name]["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
