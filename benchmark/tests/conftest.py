"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files cut to tiny sizes, which the harness runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(mlp_width=16, z_dim=16, light_h=4, imh=24,
                  n_rays_per_step=32, num_embed=6, num_drop=3,
                  thres_str="0.1;0.2;0.3", epoch_scan_chunk=1)

TINY_SDF = dict(d_out=17, d_hidden=16, n_layers=4, skip_in=[2], multires=2)
TINY_COLOR = dict(d_feature=16, d_hidden=16, n_layers=2, multires_view=2)
TINY_SAMPLER = dict(n_samples=8, n_importance=4, up_sample_steps=2)
TINY_TRAIN = dict(batch_size=64, occ_res=8, occ_update_freq=5,
                  tail_sampler="8+8r2")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny runs are thousands of small
    operations, which a pool of spinning threads only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tiny_root(dest):
    """A checkout-like tree at ``dest``: BENCHMARK.json and the benchmark's
    configurations, mixes, drivers and readers, with the configurations and
    mixes cut to tiny sizes (the harness's code is imported from the
    repository)."""
    dest = Path(dest)
    (dest / "benchmark").mkdir(parents=True, exist_ok=True)
    for d in ("drivers", "metrics", "traffic", "configs"):
        shutil.copytree(ROOT / "benchmark" / d, dest / "benchmark" / d)
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        if "n_train_views" in cfg.get("scene", {}):
            cfg["model"].update(TINY_MODEL)
            cfg["scene"].update(n_train_views=2, n_test_views=2)
        if "train" in cfg:
            cfg["model"]["sdf"].update(TINY_SDF)
            cfg["model"]["color"].update(TINY_COLOR)
            cfg["model"].update(TINY_SAMPLER)
            cfg["train"].update(TINY_TRAIN)
            cfg["scene"].update(n_views=4, image_hw=32)
        path.write_text(json.dumps(cfg))
    tiny_mix = {"vq_train": dict(trace_skip=1, trace_chunks=1),
                "relight": dict(ray_chunk=200, n_probes=3, sample=2,
                                sample_within=3, trace_skip=1,
                                trace_requests=1),
                "geo_train": dict(carve_steps=2, tail_steps=1, trace_skip=1,
                                  trace_cycles=1)}
    for name, cut in tiny_mix.items():
        path = dest / "benchmark" / "traffic" / f"{name}.json"
        mix = json.loads(path.read_text())
        mix.update(cut)
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path / "checkout")


def run_cell(root, workload, seed=2_200_000_007, seconds=0.5, trace=0,
             capsys=None):
    """Run ``workload`` through the harness on the CPU; returns (exit code,
    the parsed last line of standard output or None)."""
    from benchmark import run
    code = run.main(["--workload", workload, "--seed", str(seed),
                     "--seconds", str(seconds), "--trace", str(trace)],
                    root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    result = None
    if out:
        try:
            result = json.loads(out[-1])
        except json.JSONDecodeError:
            result = None
    return code, result
