"""The port's training loop and what feeds it against the JAX package's, on
the CPU: the copied numpy modules bit for bit, the ray sampler under the
same RandomState, the device store's gather, the loop's small helpers, the
file tree a 2-epoch nfr_unit + vq_nfr training writes, resuming from a
checkpoint, and the conversions of the EMA and optimizer states.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL, jax_params
from vqnerf_release_tpu.data import rays as j_rays
from vqnerf_release_tpu.data import sampler as j_sampler
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.ops import light as j_light
from vqnerf_release_tpu.train import loop as j_loop
from vqnerf_release_torch.data import rays as t_rays
from vqnerf_release_torch.data import sampler as t_sampler
from vqnerf_release_torch.data.device_store import (DeviceViewStore,
                                                    fits_device_memory,
                                                    store_nbytes,
                                                    views_compatible)
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.interop import jax_params as interop
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.ops import light as t_light
from vqnerf_release_torch.train import decomp_trainer as t_dt
from vqnerf_release_torch.train import loop as t_loop
from vqnerf_release_torch.utils import ckpt as t_ckpt


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    thousands of small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TRAIN = dict(SMALL, epochs=2, n_rays_per_step=16, total_sample_vq=64)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scene")
    data_root, surf_root = _make_synth_scene(str(root), n_train=2, n_val=1)
    load = lambda mode: [  # noqa: E731
        ds.load_view(f) for ds in [ShapeDataset(
            data_root, surf_root, imh=16, mode=mode)] for f in ds.files]
    return {"data_root": data_root, "surf_root": surf_root,
            "train": load("train"), "vali": load("vali")}


def test_copied_numpy_modules_equal_jax_bit_for_bit():
    """The port keeps its own copies of the JAX package's numpy-only light,
    ray and marching-tetrahedra helpers; they must stay equal bit for
    bit."""
    for h in (2, 16):
        for got, want in zip(t_light.gen_light_xyz(h, 2 * h),
                             j_light.gen_light_xyz(h, 2 * h)):
            np.testing.assert_array_equal(got, want)
        got, want = t_light.olat_envmaps(h, 150.0, 0.2), \
            j_light.olat_envmaps(h, 150.0, 0.2)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    rs = np.random.RandomState(0)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(rs.randn(3, 3))[0]
    c2w[:3, 3] = rs.randn(3)
    for kw in ({}, {"cx": 7.5, "cy": 6.0}, {"normalize": True}):
        for got, want in zip(t_rays.nerf_rays(c2w, 0.7, 12, 16, **kw),
                             j_rays.nerf_rays(c2w, 0.7, 12, 16, **kw)):
            np.testing.assert_array_equal(got, want)
    k = np.array([[500.0, 0.2, 8.0], [0, 480.0, 6.0], [0, 0, 1.0]])
    world = np.eye(4)
    world[:3, :4] = k @ np.concatenate([c2w[:3, :3].T,
                                        -c2w[:3, :3].T @ c2w[:3, 3:]], 1)
    scale = np.diag([2.0, 2.0, 2.0, 1.0])
    for got, want in zip(t_rays.dtu_rays(world, scale, 12, 16, 6),
                         j_rays.dtu_rays(world, scale, 12, 16, 6)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_rays.decompose_projection(world[:3]),
                         j_rays.decompose_projection(world[:3])):
        np.testing.assert_array_equal(got, want)

    from vqnerf_release_torch.ops import marching_cubes as t_mc
    from vqnerf_release_tpu.ops import marching_cubes as j_mc
    lin = np.linspace(-1.0, 1.0, 14)
    xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
    field = 0.6 - np.sqrt(xs**2 + 1.5 * ys**2 + zs**2) + 0.05 * rs.randn(
        14, 14, 14)
    for thr in (0.0, 0.1):
        for got, want in zip(t_mc.marching_cubes(field, thr),
                             j_mc.marching_cubes(field, thr)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(t_mc.marching_cubes(-np.ones((4, 4, 4))),
                         j_mc.marching_cubes(-np.ones((4, 4, 4)))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jitter_mode", ["random", "contrast"])
def test_sampler_equals_jax_under_the_same_random_state(scene, jitter_mode):
    view = scene["train"][0]
    got = t_sampler.sample_pix(view, 16, np.random.RandomState(3),
                               jitter_mode=jitter_mode)
    want = j_sampler.sample_pix(view, 16, np.random.RandomState(3),
                                jitter_mode=jitter_mode)
    np.testing.assert_array_equal(got, want)
    got = t_sampler.outer_sample(view, 16, np.random.RandomState(4),
                                 jitter_mode=jitter_mode)
    want = j_sampler.outer_sample(view, 16, np.random.RandomState(4),
                                  jitter_mode=jitter_mode)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_vq_eval_set_equals_jax(scene):
    got = t_sampler.build_vq_eval_set(scene["train"], 20, 16,
                                      np.random.RandomState(5))
    want = j_sampler.build_vq_eval_set(scene["train"], 20, 16,
                                       np.random.RandomState(5))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape[0] == 40
        np.testing.assert_array_equal(got[k], want[k])


def test_store_gather_equals_outer_sample(scene):
    views = scene["train"]
    assert views_compatible(views)
    # the JAX store's layout: a zero row past each view's 256 pixels
    assert store_nbytes(views) == 2 * 257 * (3 * 5 + 2 + 8) * 4
    from vqnerf_release_tpu.data import device_store as j_store
    assert store_nbytes(views) == j_store.store_nbytes(views)
    assert fits_device_memory(views, "cpu")
    assert not fits_device_memory(views, "cpu", budget_bytes=1000)
    store = DeviceViewStore(views, "cpu")
    for vi, view in enumerate(views):
        flat = t_sampler.sample_pix(view, 16, np.random.RandomState(6 + vi))
        want = t_sampler.outer_sample(view, 16,
                                      np.random.RandomState(6 + vi))
        got = store.gather(vi, flat)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_batch_source_modes_give_equal_batches(scene):
    """'auto', 'on' and 'shard' (row-sharded over ["cpu", "cpu"]) gather
    the host path's batches bit for bit; 'u8' stages lvis as uint8 (every
    other buffer bit for bit, lvis within 1/510); an unknown mode is
    refused."""
    cfgs = {m: t_dc.DecompConfig(**TRAIN, device_views=m)
            for m in ("auto", "on", "u8", "shard", "off")}
    batches = {}
    for mode, cfg in cfgs.items():
        source, store = t_loop._make_batch_source(
            scene["train"], cfg, "contrast", torch.device("cpu"),
            ["cpu", "cpu"])
        assert (store is None) == (mode == "off")
        assert mode == "off" or store.quant == (mode == "u8")
        assert mode == "off" or store.sharded == (mode == "shard")
        batches[mode] = list(source(np.random.RandomState(7)))
    for mode in ("auto", "on", "u8", "shard"):
        for got, want in zip(batches[mode], batches["off"]):
            for k in want:
                if mode == "u8" and k == "lvis":
                    assert float((got[k] - want[k]).abs().max()) <= \
                        1 / 510 + 1e-7
                else:
                    assert torch.equal(got[k], want[k]), (mode, k)
    with pytest.raises(ValueError, match="device_views"):
        t_loop._make_batch_source(
            scene["train"], t_dc.DecompConfig(device_views="sharded"),
            "random", torch.device("cpu"))


@pytest.mark.parametrize("losses", [
    [0.5, 0.3, 0.29, 0.291, 0.2905], [0.5, 0.4, 0.3, 0.2], [0.1, 0.2, 0.3],
    [0.3, 0.2, 0.25, 0.1995], [0.2, 0.2]])
def test_elbow_select_equals_jax(losses):
    for thres in (0.002, 0.05):
        assert t_loop.elbow_select(losses, thres) == \
            j_loop.elbow_select(losses, thres)


@pytest.mark.parametrize("epochs", [1, 2, 7, 29, 30, 150])
def test_ckpt_period_equals_jax(epochs):
    assert t_loop.cfg_ckpt_period(t_dc.DecompConfig(epochs=epochs)) == \
        j_loop.cfg_ckpt_period(j_dc.DecompConfig(epochs=epochs))
    assert t_loop._VALI_RAY_CHUNK == j_loop._VALI_RAY_CHUNK


@pytest.mark.parametrize("n,chunk", [(10, 4), (8, 4), (3, 100)])
def test_forward_chunked_equals_jax(n, chunk):
    rs = np.random.RandomState(n)
    batch = {"a": rs.rand(n, 3).astype(np.float32),
             "b": rs.rand(n, 1).astype(np.float32)}
    want = j_loop._forward_chunked(
        lambda b: {"s": b["a"] * b["b"], "m": jnp.max(b["a"]) + 0 * b["b"]},
        {k: jnp.asarray(v) for k, v in batch.items()}, chunk=chunk)
    got = t_loop._forward_chunked(
        lambda b: {"s": b["a"] * b["b"], "m": torch.max(b["a"]) + 0 * b["b"]},
        {k: torch.from_numpy(v) for k, v in batch.items()}, chunk=chunk)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def _tree_names(root):
    """Relative paths under root. A checkpoint counts as one name (orbax
    writes a directory, torch.save a file), and main_<k> as <k>: which
    code count the elbow picks depends on the weights, and the two
    packages draw their initial weights from different generators."""
    import re
    names = set()
    for d, dirs, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if os.path.basename(os.path.dirname(d)) == "checkpoints":
            dirs[:] = []
            continue
        for f in files:
            names.add(os.path.normpath(os.path.join(rel, f)))
        if os.path.basename(d) == "checkpoints":
            names.update(os.path.normpath(os.path.join(rel, x))
                         for x in dirs)
    return {re.sub(r"main_(\d+)", r"\1", n) for n in names}


def _finite_log(outdir):
    import json
    with open(os.path.join(outdir, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [1, 2]
    for r in rows:
        assert r["skipped_steps"] == 0
        assert all(np.isfinite(v) for v in r.values())
    return rows


def test_training_writes_the_file_tree_of_jax_and_resumes(scene, tmp_path,
                                                          capsys,
                                                          monkeypatch):
    """train_nfr_unit then train_vq_nfr for 2 epochs: the same file names
    as the JAX loop's, finite losses; and a run stopped after epoch 1 and
    resumed ends in the same state as the uninterrupted one. epoch_scan=
    False dispatches step by step, without a notice; the scanned dispatch
    (the default with the views staged) writes the same tree."""
    jcfg = j_dc.DecompConfig(**TRAIN, device_views="off")
    tcfg = t_dc.DecompConfig(**TRAIN, epoch_scan=False)
    j_views = scene  # the views are plain numpy dataclasses: both take them
    j_nfr, _ = j_loop.train_nfr_unit(
        jcfg, j_views["train"], j_views["vali"], str(tmp_path / "j_nfr"))
    j_loop.train_vq_nfr(jcfg, j_nfr, j_views["train"], j_views["vali"],
                        str(tmp_path / "j_vq"))

    scans = []
    for name in ("make_plain_epoch_scan", "make_vq_epoch_scan"):
        real = getattr(t_dt, name)
        monkeypatch.setattr(t_dt, name, lambda *a, _real=real, **kw: (
            scans.append(1), _real(*a, **kw))[1])
    nfr, hist = t_loop.train_nfr_unit(
        tcfg, scene["train"], scene["vali"], str(tmp_path / "t_nfr"),
        device="cpu")
    assert "scanned-epoch dispatch" not in capsys.readouterr().out
    assert not scans  # epoch_scan=False: step by step
    assert len(hist) == 2 and np.isfinite(hist).all()
    vq, ema, hist = t_loop.train_vq_nfr(
        tcfg, nfr, scene["train"], scene["vali"], str(tmp_path / "t_vq"),
        device="cpu")
    assert len(hist) == 2 and np.isfinite(hist).all()
    assert int(ema.counter) == 4
    assert not scans
    # the scanned dispatch, the default: the same tree
    scfg = t_dc.DecompConfig(**TRAIN)
    s_nfr, _ = t_loop.train_nfr_unit(scfg, scene["train"], scene["vali"],
                                     str(tmp_path / "s_nfr"), device="cpu")
    t_loop.train_vq_nfr(scfg, s_nfr, scene["train"], scene["vali"],
                        str(tmp_path / "s_vq"), device="cpu")
    assert len(scans) == 2
    for phase in ("nfr", "vq"):
        want = _tree_names(tmp_path / f"j_{phase}")
        for run in ("t", "s"):
            got = _tree_names(tmp_path / f"{run}_{phase}")
            assert got == want, (run, sorted(got - want), sorted(want - got))
            _finite_log(str(tmp_path / f"{run}_{phase}"))
    from vqnerf_release_torch.pipelines.test_driver import find_vq
    vali_dir = tmp_path / "t_vq" / "vis_vali" / "epoch000000002"
    k = find_vq(str(vali_dir))
    assert (vali_dir / ("main_%d" % k) / "batch000000000"
            / "pred_vq_rgb.png").exists()

    # the checkpoint holds the returned state
    state = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(str(tmp_path / "t_vq")))
    assert state["epoch"] == 2
    for k, v in vq.state_dict().items():
        assert torch.equal(state["params"][k], v), k
    for a, b in zip(state["ema"], ema):
        assert torch.equal(a, b)

    # stop after epoch 1, resume to epoch 2
    nfr_1, _ = t_loop.train_nfr_unit(
        tcfg, scene["train"], scene["vali"], str(tmp_path / "r_nfr"),
        epochs=1, device="cpu")
    nfr_r, hist_r = t_loop.train_nfr_unit(
        tcfg, scene["train"], scene["vali"], str(tmp_path / "r_nfr"),
        device="cpu")
    assert len(hist_r) == 1
    for (k, a), b in zip(nfr_r.state_dict().items(),
                         nfr.state_dict().values()):
        assert torch.equal(a, b), k
    t_loop.train_vq_nfr(tcfg, nfr_r, scene["train"], scene["vali"],
                        str(tmp_path / "r_vq"), epochs=1, device="cpu")
    vq_r, ema_r, hist_r = t_loop.train_vq_nfr(
        tcfg, nfr_r, scene["train"], scene["vali"], str(tmp_path / "r_vq"),
        device="cpu")
    assert len(hist_r) == 1
    for (k, a), b in zip(vq_r.state_dict().items(),
                         vq.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(ema_r, ema):
        assert torch.equal(a, b)
    resumed = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(str(tmp_path / "r_vq")))
    for k, v in state["opt_state"].items():
        assert torch.equal(resumed["opt_state"][k], v), k
    # a finished run is a no-op on resume
    _, _, hist_n = t_loop.train_vq_nfr(
        tcfg, nfr_r, scene["train"], scene["vali"], str(tmp_path / "r_vq"),
        device="cpu")
    assert hist_n == []


def test_trainers_raise_without_the_device_they_were_asked_for(scene,
                                                                 tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has the device")
    cfg = t_dc.DecompConfig(**TRAIN)
    with pytest.raises(RuntimeError, match="cuda"):
        t_loop.train_nfr_unit(cfg, scene["train"], scene["vali"],
                              str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")


def test_ckpt_keep_and_latest(tmp_path):
    out = str(tmp_path)
    assert t_ckpt.latest_ckpt(out) is None
    with pytest.raises(FileNotFoundError):
        t_ckpt.load_ckpt(None)
    for step in (1, 2, 10):
        t_ckpt.save_ckpt(out, step, {"epoch": step, "t": torch.ones(2) * step},
                         keep=2)
    names = [os.path.basename(p) for p in t_ckpt.list_ckpts(out)]
    assert names == ["ckpt-2", "ckpt-10"]
    state = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(out))
    assert state["epoch"] == 10 and torch.equal(state["t"], torch.ones(2) * 10)


def test_ema_and_optimizer_state_round_trip():
    from vqnerf_release_tpu.ops.vq import VqEmaState as JVqEmaState
    from vqnerf_release_tpu.train.decomp_trainer import _amsgrad
    rs = np.random.RandomState(0)
    j_ema = JVqEmaState(jnp.asarray(rs.rand(4).astype(np.float32)),
                        jnp.asarray(rs.rand(16, 4).astype(np.float32)),
                        jnp.asarray(7, jnp.int32))
    t_ema = interop.ema_from_jax(j_ema)
    assert t_ema.counter.dtype == torch.int32 and int(t_ema.counter) == 7
    back = JVqEmaState(**interop.ema_to_jax(t_ema))
    for a, b in zip(back, j_ema):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))

    _, vq_np, _ = jax_params()
    j_state = _amsgrad(j_dc.DecompConfig()).init(
        jax.tree_util.tree_map(jnp.asarray, vq_np))
    j_state = {"count": jnp.asarray(3, jnp.int32), **{
        key: jax.tree_util.tree_map(
            lambda x: jnp.asarray(rs.rand(*x.shape).astype(np.float32)),
            j_state[key]) for key in ("m", "v", "vhat")}}
    model = interop.from_jax(vq_np, "vq_nfr")
    opt = t_dt.KerasAmsgrad(list(model.parameters()))
    opt.state = interop.opt_state_from_jax(j_state, model, "vq_nfr")
    assert opt.state["m"].shape == (sum(p.numel()
                                        for p in model.parameters()),)
    back = interop.opt_state_to_jax(opt.state, model, "vq_nfr")
    assert int(back["count"]) == 3
    want = jax.tree_util.tree_map(np.asarray, j_state)
    for key in ("m", "v", "vhat"):
        g_leaves, g_def = jax.tree_util.tree_flatten(back[key])
        w_leaves, w_def = jax.tree_util.tree_flatten(want[key])
        assert g_def == w_def
        for g, w in zip(g_leaves, w_leaves):
            np.testing.assert_array_equal(g, w)
    # the flat order is the model's: the codebook's moments sit where the
    # optimizer reads them
    names = [n for n, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]
    at = names.index("codebook")
    np.testing.assert_array_equal(
        opt.state["v"].split(sizes)[at].view_as(model.codebook).numpy(),
        want["v"]["codebook"])
