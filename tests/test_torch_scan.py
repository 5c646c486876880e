"""The port's scanned training dispatch against its per-step path and the
JAX package's scan, on the CPU, at tiny widths (the JAX side run once per
module):
  * ``_chunk_plan`` and ``_resolve_scan_chunk`` equal JAX's over a grid;
  * scanned nfr_unit, vq_nfr and ref_nfr runs (chunks of 1 and 2, store
    'on') equal the per-step runs bit for bit, resume to the uninterrupted
    run's state, and write the file tree of a JAX ``device_views="on",
    epoch_scan=True`` run;
  * the device sampler fed the JAX sampler's own draws gives its indices,
    in both jitter modes and on an all-background view;
  * the u8 store's gather equals JAX's bit for bit and the float32 store's
    within 1/510;
  * ``make_neus_multi_step``: reduced metrics and final state equal k
    single steps of the port bit for bit, and JAX's multi-step within
    ``tests/test_torch_neus_train.py``'s tolerances.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_fields import neus_pair, small_cfgs
from tests.test_torch_models import SMALL
from tests.test_torch_neus import rays
from tests.test_torch_cuda import runner_k_against_1
from tests.test_torch_train_loop import _tree_names
from vqnerf_release_tpu.data import device_sampler as j_sampler
from vqnerf_release_tpu.data import device_store as j_store
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.train import loop as j_loop
from vqnerf_release_tpu.train import neus_trainer as j_tr
from vqnerf_release_torch.data import device_store as t_store
from vqnerf_release_torch.data.device_sampler import make_device_sampler
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.train import decomp_trainer as t_dt
from vqnerf_release_torch.train import loop as t_loop
from vqnerf_release_torch.train import neus_trainer as t_tr
from vqnerf_release_torch.utils import ckpt as t_ckpt

TRAIN = dict(SMALL, epochs=4, n_rays_per_step=16, total_sample_vq=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    thousands of small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- the chunk plan ---------------------------------------------------------

@pytest.mark.parametrize("period", [1, 2, 5, 30])
@pytest.mark.parametrize("chunk", [1, 2, 4, 6])
def test_chunk_plan_equals_jax(period, chunk):
    for epochs in (1, 2, 7, 30, 31, 61):
        for epoch in range(epochs):
            assert t_loop._chunk_plan(epoch, epochs, period, chunk) == \
                j_loop._chunk_plan(epoch, epochs, period, chunk)


@pytest.mark.parametrize("epochs", [1, 2, 7, 30, 150])
@pytest.mark.parametrize("scan_chunk", [None, 1, 4, 12])
def test_resolve_scan_chunk_equals_jax(epochs, scan_chunk):
    kw = dict(epochs=epochs, epoch_scan_chunk=scan_chunk)
    jcfg, tcfg = j_dc.DecompConfig(**kw), t_dc.DecompConfig(**kw)
    for scan_on in (False, True):
        assert t_loop._resolve_scan_chunk(tcfg, scan_on) == \
            j_loop._resolve_scan_chunk(jcfg, object() if scan_on else None)


def test_resolve_epoch_scan_is_jax_default():
    """None scans iff the store is active, on one device and over a device
    list alike (the store a mesh stages is a store like another)."""
    store = object()
    for want in (None, True, False):
        cfg = t_dc.DecompConfig(epoch_scan=want)
        jcfg = j_dc.DecompConfig(epoch_scan=want)
        for st in (None, store):
            assert t_loop._resolve_epoch_scan(cfg, st) == \
                j_loop._resolve_epoch_scan(jcfg, st)


# ---- training: scanned against per-step -------------------------------------

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_scene")
    data_root, surf_root = _make_synth_scene(str(root), n_train=2, n_val=1)
    load = lambda mode: [  # noqa: E731
        ds.load_view(f) for ds in [ShapeDataset(
            data_root, surf_root, imh=16, mode=mode, with_ref=True)]
        for f in ds.files]
    return {"train": load("train"), "vali": load("vali")}


def _train_all(cfg, scene, out, epochs=None):
    """nfr_unit -> vq_nfr -> ref_nfr on the CPU under ``cfg``."""
    nfr, h1 = t_loop.train_nfr_unit(cfg, scene["train"], scene["vali"],
                                    os.path.join(out, "nfr"), epochs=epochs,
                                    device="cpu")
    vq, ema, h2 = t_loop.train_vq_nfr(cfg, nfr, scene["train"],
                                      scene["vali"], os.path.join(out, "vq"),
                                      epochs=epochs, device="cpu")
    light = np.load(os.path.join(out, "vq", "vis_vali", "np_light.npy"))
    ref, h3 = t_loop.train_ref_nfr(cfg, vq, light, scene["train"],
                                   scene["vali"], os.path.join(out, "ref"),
                                   epochs=epochs, device="cpu")
    return {"models": (nfr, vq, ref), "ema": ema, "hist": (h1, h2, h3),
            "light": light}


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_runs")
    out = {}
    for name, kw in (("step", dict(epoch_scan=False)),
                     ("chunk1", dict(device_views="on", epoch_scan_chunk=1)),
                     ("chunk2", dict(device_views="on", epoch_scan_chunk=2))):
        out[name] = _train_all(t_dc.DecompConfig(**TRAIN, **kw), scene,
                               str(root / name))
        out[name]["dir"] = str(root / name)
    return out


def _assert_same_models(a, b, what):
    for m_a, m_b in zip(a["models"], b["models"]):
        for (k, x), y in zip(m_a.state_dict().items(),
                             m_b.state_dict().values()):
            assert torch.equal(x, y), (what, k)
    for x, y in zip(a["ema"], b["ema"]):
        assert torch.equal(x, y), what


@pytest.mark.parametrize("name", ["chunk1", "chunk2"])
def test_scanned_runs_equal_per_step_runs(runs, name):
    """Parameters, EMA, optimizer states, epoch losses and every logged
    term equal bit for bit."""
    a, b = runs["step"], runs[name]
    _assert_same_models(a, b, name)
    assert a["hist"] == b["hist"]
    for phase in ("nfr", "vq", "ref"):
        ca = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(
            os.path.join(a["dir"], phase)))
        cb = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(
            os.path.join(b["dir"], phase)))
        for k, v in ca["opt_state"].items():
            assert torch.equal(cb["opt_state"][k], v), (name, phase, k)
        logs = []
        for d in (a["dir"], b["dir"]):
            with open(os.path.join(d, phase, "train_log.jsonl")) as f:
                logs.append([{k: v for k, v in json.loads(line).items()
                              if k != "wall_s"} for line in f])
        assert logs[0] == logs[1], (name, phase)
        assert len(logs[0]) == 4


def test_scanned_run_resumes_to_the_uninterrupted_state(runs, scene,
                                                        tmp_path):
    """Each phase stopped after epoch 2 (a chunk boundary, after the next
    chunk was already sampled) and resumed: the state of the uninterrupted
    run, phase by phase from the same inputs."""
    cfg = t_dc.DecompConfig(**TRAIN, device_views="on", epoch_scan_chunk=2)
    run = runs["chunk2"]
    nfr_w, vq_w, ref_w = run["models"]
    tr, va = scene["train"], scene["vali"]
    out = str(tmp_path)
    got = []
    for epochs in (2, None):
        nfr, h1 = t_loop.train_nfr_unit(cfg, tr, va, out + "/nfr",
                                        epochs=epochs, device="cpu")
    got.append((nfr, h1))
    for epochs in (2, None):
        vq, ema, h2 = t_loop.train_vq_nfr(cfg, nfr_w, tr, va, out + "/vq",
                                          epochs=epochs, device="cpu")
    got.append((vq, h2))
    for epochs in (2, None):
        ref, h3 = t_loop.train_ref_nfr(cfg, vq_w, run["light"], tr, va,
                                       out + "/ref", epochs=epochs,
                                       device="cpu")
    got.append((ref, h3))
    for (model, hist), want, want_hist in zip(got, run["models"],
                                              run["hist"]):
        assert hist == want_hist[2:]
        for (k, x), y in zip(model.state_dict().items(),
                             want.state_dict().values()):
            assert torch.equal(x, y), k
    for x, y in zip(ema, run["ema"]):
        assert torch.equal(x, y)


def test_scanned_trees_equal_a_jax_scanned_run(runs, scene, tmp_path):
    """ref_nfr scanned for 2 epochs in both packages from the same VqNfr
    and light, without validation views (their renders are held to JAX's
    in tests/test_torch_ref_nfr_train.py): the same file names (the
    nfr_unit and vq_nfr trees are held to JAX's in
    tests/test_torch_train_loop.py)."""
    kw = dict(TRAIN, epochs=2)
    vq, light = runs["chunk2"]["models"][1], runs["chunk2"]["light"]
    j_loop.train_ref_nfr(
        j_dc.DecompConfig(**kw, device_views="on", epoch_scan=True),
        to_jax(vq, "vq_nfr"), light, scene["train"], [],
        str(tmp_path / "j"))
    t_loop.train_ref_nfr(t_dc.DecompConfig(**kw, device_views="on"), vq,
                         light, scene["train"], [], str(tmp_path / "t"),
                         device="cpu")
    got, want = _tree_names(tmp_path / "t"), _tree_names(tmp_path / "j")
    assert got == want, sorted(got ^ want)


def test_divergence_guard_fires_at_the_end_of_a_chunk(scene, tmp_path):
    """A poisoned view under a chunk of 2 epochs: the guard raises at epoch
    1 and saves the state of the chunk's end, epoch 2, as JAX does."""
    import copy
    views = copy.deepcopy(scene["train"])
    views[0].rgb[:] = np.nan
    cfg = t_dc.DecompConfig(**TRAIN, device_views="on", epoch_scan_chunk=2,
                            skip_nonfinite_updates=False)
    with pytest.raises(RuntimeError, match="the saved state is that of "
                                           "epoch 2"):
        t_loop.train_nfr_unit(cfg, views, [], str(tmp_path), device="cpu")
    dump = tmp_path / "debug_failure"
    assert os.path.basename(t_ckpt.latest_ckpt(str(dump))) == "ckpt-2"
    with open(dump / "train_log.jsonl") as f:
        row = json.loads(f.readline())
    assert (row["epoch"], row["state_epoch"]) == (1, 2)


def test_device_sampling_trains_on_foreground_pairs(scene, tmp_path):
    """device_sampling=True: finite losses, and every pair a step samples
    is two foreground 8-neighbours."""
    cfg = t_dc.DecompConfig(**dict(TRAIN, epochs=1), device_views="on",
                            device_sampling=True)
    _, hist = t_loop.train_nfr_unit(cfg, scene["train"], scene["vali"],
                                    str(tmp_path), device="cpu")
    assert len(hist) == 1 and np.isfinite(hist).all()
    store = t_store.DeviceViewStore(scene["train"], "cpu")
    for mode in ("random", "contrast"):
        sampler = make_device_sampler(store, scene["train"], 64,
                                      jitter_mode=mode)
        gen = torch.Generator()
        for vi, view in enumerate(scene["train"]):
            gen.manual_seed(t_loop._sampling_base_key(0) + vi)
            pix = sampler(torch.tensor(vi), *sampler.draw(gen)).numpy()
            c, j = pix[0::2], pix[1::2]
            dy, dx = j // view.w - c // view.w, j % view.w - c % view.w
            assert (np.abs(dy) <= 1).all() and (np.abs(dx) <= 1).all()
            assert ((dy != 0) | (dx != 0)).all()
            alpha = view.alpha.reshape(-1)
            assert (alpha[c] > 0.9).all() and (alpha[j] > 0.9).all()


# ---- the device sampler and the u8 store against JAX ------------------------

def _views(n, h, w, lights, seed, background=()):
    """Views as the stores read them; those in ``background`` have no
    foreground."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        alpha = (rs.rand(h * w, 1) > 0.3).astype(np.float32)
        if i in background:
            alpha[:] = 0.0
        out.append(types.SimpleNamespace(
            h=h, w=w, rayo=rs.rand(h * w, 3).astype(np.float32),
            rayd=rs.rand(h * w, 3).astype(np.float32),
            rgb=rs.rand(h * w, 3).astype(np.float32), alpha=alpha,
            xyz=rs.rand(h * w, 3).astype(np.float32),
            normal=rs.rand(h * w, 3).astype(np.float32),
            lvis=rs.rand(h * w, lights).astype(np.float32)))
    return out


@pytest.mark.parametrize("mode", ["random", "contrast"])
def test_device_sampler_gives_jax_indices_from_jax_draws(mode):
    h, w, n = 12, 14, 40
    views = _views(3, h, w, 4, 5, background=(2,))
    j_st = j_store.DeviceViewStore(views)
    j_sample = jax.jit(j_sampler.make_device_sampler(
        j_st, h, w, n, jitter_mode=mode, views=views))
    sampler = make_device_sampler(t_store.DeviceViewStore(views, "cpu"),
                                  views, n, jitter_mode=mode)
    interior = (h - 2) * (w - 2)
    for vi in range(len(views)):
        for s in range(3):
            key = jax.random.PRNGKey(10 * vi + s)
            want = np.asarray(j_sample(j_st.arrays, jnp.int32(vi), key))
            if mode == "random":
                k_jit, k_sel = jax.random.split(key)
                jidx = torch.from_numpy(np.asarray(jax.random.randint(
                    k_jit, (interior,), 0, 8)).astype(np.int64))
            else:
                k_sel, jidx = key, None
            _, _, cs = sampler.candidates(torch.tensor(vi), jidx)
            sel = jax.random.randint(k_sel, (n,), 0,
                                     jnp.maximum(int(cs[-1]), 1))
            got = sampler.pairs(torch.tensor(vi), jidx,
                                torch.from_numpy(np.asarray(sel)))
            np.testing.assert_array_equal(got.numpy(), want)
            if vi == 2:  # all background: pad rows, the store's zero row
                assert (want == h * w).all()


def test_u8_store_equals_jax_and_float_store():
    views = _views(3, 10, 12, 16, 7)
    views[0].lvis[:4] = [[0.0] * 16, [1.0] * 16, [0.5] * 16,
                         [1 / 510] * 16]  # the ends and ties of rounding
    rs = np.random.RandomState(8)
    pix = rs.randint(0, 10 * 12 + 1, size=(3, 50))  # the pad row too
    j_u8 = j_store.DeviceViewStore(views, quant=True)
    t_u8 = t_store.DeviceViewStore(views, "cpu", quant=True)
    t_f32 = t_store.DeviceViewStore(views, "cpu")
    assert t_u8.arrays["lvis"].dtype == torch.uint8
    for quant in (False, True):
        assert t_store.store_nbytes(views, quant=quant) == \
            j_store.store_nbytes(views, quant=quant)
    # lvis at a byte a value: 3 views x (120 + 1) rows x 16 lights x 3
    assert t_store.store_nbytes(views) - t_store.store_nbytes(
        views, quant=True) == 3 * 121 * 16 * 3
    for vi in range(3):
        want = j_u8.gather(vi, pix[vi])
        for got in (t_u8.gather(vi, pix[vi]),
                    t_u8.gather_at(torch.tensor(vi),
                                   torch.from_numpy(pix[vi]))):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]), err_msg=k)
        flt = t_f32.gather(vi, pix[vi])
        got = t_u8.gather(vi, pix[vi])
        for k in flt:
            if k == "lvis":
                assert float((got[k] - flt[k]).abs().max()) <= 1 / 510 + 1e-7
            else:
                assert torch.equal(got[k], flt[k]), k


# ---- NeuS: k steps in one dispatch ------------------------------------------

RADIUS = 2.5
N = 32
CAP = 16
NEUS_TRAIN = dict(warm_up_end=2, end_iter=40, anneal_end=5, occ_res=8,
                  empty_n_samples=4)


def _neus_batches(k, seed):
    out = []
    for j in range(k):
        o, d, near, far = rays(N, seed + j)
        rs = np.random.RandomState(50 + seed + j)
        out.append({"rays_o": o, "rays_d": d,
                    "rgb": rs.rand(N, 3).astype(np.float32),
                    "mask": (rs.rand(N, 1) > 0.4).astype(np.float32),
                    "near": near, "far": far,
                    "valid": np.ones((N, 1), np.float32)})
    return out


def _grid():
    grid = np.zeros((8, 8, 8), np.float32)
    grid[2:6, 2:6, 2:6] = 1.0
    return grid


@pytest.mark.parametrize("variant", ["plain", "grid", "two_tier"])
def test_neus_multi_step_equals_single_steps(variant):
    """k = 3 steps, twice, with the perturbation drawn from a generator:
    the reduced metrics and the final parameters, Adam state and generator
    equal six single steps', bit for bit."""
    _, model0, _, tcfg_m = neus_pair()
    tt = t_tr.NeuSTrainConfig(**NEUS_TRAIN)
    occ = variant != "plain"
    cap = CAP if variant == "two_tier" else None
    grid = torch.from_numpy(_grid()) if occ else None
    models = [from_jax(to_jax(model0, "neus"), "neus") for _ in range(2)]
    gens = [torch.Generator().manual_seed(3) for _ in range(2)]
    opt_a, step = t_tr.make_neus_train_step(models[0], tcfg_m, tt, RADIUS,
                                            with_occ=occ, active_cap=cap)
    opt_b, multi = t_tr.make_neus_multi_step(models[1], tcfg_m, tt, RADIUS,
                                             3, with_occ=occ, active_cap=cap)
    for base in (3, 6):  # over the warm-up and the anneal
        batches = _neus_batches(3, base)
        singles = [step({k: torch.from_numpy(v) for k, v in b.items()},
                        base + j, occ_grid=grid, generator=gens[0])
                   for j, b in enumerate(batches)]
        got = multi(batches, base, occ_grid=grid, generator=gens[1])
        keys = sorted(singles[0])
        want = t_tr.reduce_metrics(torch.stack(
            [torch.stack([m[k] for k in keys]) for m in singles]), keys)
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (variant, base, k)
        assert float(got["nonfinite_grads"]) == 0.0
    for (k, a), b in zip(models[0].state_dict().items(),
                         models[1].state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in opt_a.state.items():
        assert torch.equal(opt_b.state[k], v), k
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_neus_multi_step_reduction_guards_nonfinite_steps():
    rows = torch.tensor([[1.0, 0.0, 0.5], [float("nan"), 1.0, 0.4],
                         [3.0, 0.0, 0.3]])
    out = t_tr.reduce_metrics(rows, ["loss", "nonfinite_grads", "lr"])
    assert float(out["loss"]) == 2.0
    assert float(out["nonfinite_grads"]) == 1.0
    assert float(out["lr"]) == np.float32(0.3)
    nan = t_tr.reduce_metrics(torch.full((2, 1), float("nan")), ["loss"])
    assert not np.isfinite(float(nan["loss"]))


def test_neus_multi_step_matches_jax():
    """Without perturbation (JAX draws from fold_in(key, i), the port
    from its generator), k = 3 steps on the grid: JAX's multi-step's
    reduced metrics at rtol 1e-4 and its parameters at rtol 1e-4 /
    atol 2e-6."""
    jp, model, _, _ = neus_pair()
    jcfg, tcfg_m = small_cfgs(perturb=0.0)
    jt = j_tr.NeuSTrainConfig(**NEUS_TRAIN)
    tt = t_tr.NeuSTrainConfig(**NEUS_TRAIN)
    j_multi = jax.jit(j_tr.make_neus_multi_step(jcfg, jt, RADIUS, 3,
                                                with_occ=True))
    _, multi = t_tr.make_neus_multi_step(model, tcfg_m, tt, RADIUS, 3,
                                         with_occ=True)
    batches = _neus_batches(3, 11)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_params, _, j_m = j_multi(
        j_params, j_tr.init_neus_opt_state(j_params),
        {k: jnp.asarray(np.stack([b[k] for b in batches]))
         for k in batches[0]}, jax.random.PRNGKey(0),
        jnp.asarray(4, jnp.float32), jnp.asarray(_grid()))
    t_m = multi(batches, 4, occ_grid=torch.from_numpy(_grid()))
    assert set(t_m) == set(j_m)
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    got = jax.tree_util.tree_leaves(to_jax(model, "neus"))
    for g, w in zip(got, jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=2e-6)


def test_epoch_scan_runs_the_per_step_function(scene):
    """The scan's steps are the per-step path's function: one step through
    ``EpochScan`` equals one call of step_fn on the gathered batch."""
    cfg = t_dc.DecompConfig(**TRAIN)
    lxyz, lareas = t_dc.light_constants(cfg, "cpu")
    models = [t_loop.phase_model(cfg, "nfr_unit") for _ in range(2)]
    store = t_store.DeviceViewStore(scene["train"], "cpu")
    _, step_a = t_dt.make_nfr_unit_step(models[0], cfg, lxyz, lareas)
    _, step_b = t_dt.make_nfr_unit_step(models[1], cfg, lxyz, lareas)
    scan = t_dt.make_plain_epoch_scan(step_b, store, 2, cfg.n_rays_per_step)
    pix = np.stack([np.arange(32) + 20, np.arange(32) + 40])
    scan.stage([1, 0], [t_dt.decomp_lr(5, cfg), t_dt.decomp_lr(6, cfg)],
               pix=pix)
    rows = scan.run(2)
    want = [step_a(store.gather(vi, pix[j]), 5 + j)["loss"]
            for j, vi in enumerate([1, 0])]
    assert torch.equal(rows[:, scan.keys.index("loss")], torch.stack(want))
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)


def test_runner_k_step_dispatch_equals_single_steps(tmp_path):
    """``runner_k_against_1`` on the CPU; the runner holds the tail's
    dispatch alone: the carve's was dropped when the tail began."""
    three = runner_k_against_1(tmp_path, "cpu")
    assert [key for key in three._fn_cache if len(key) == 4] == [
        (3, None, True, False)]


def test_geo_train_steps_per_dispatch_equals_single_steps(tmp_path):
    """From the command line, `geo-train --geo-override
    steps_per_dispatch=2` writes the checkpoint of single steps bit for
    bit (decomp-train's scanned default runs in tests/test_torch_cli_e2e.py
    and is held to per-step runs above)."""
    import chip_smoke
    from tests.test_torch_cli_e2e import GEO_SMALL, SCENE
    from vqnerf_release_torch.cli import main
    data_root = str(tmp_path / "data")
    chip_smoke.write_stage1_scene(data_root, 12, 2, 1, 0)
    states = []
    for geo in (",steps_per_dispatch=2", ""):
        out = str(tmp_path / ("k" + geo[-1:]))
        main(["geo-train", SCENE, "--data-root", data_root, "--output-root",
              out, "--device", "cpu", "--end-iter", "2", "--geo-override",
              GEO_SMALL + geo, "--n-samples", "8"])
        states.append(t_ckpt.load_ckpt(t_ckpt.latest_ckpt(
            os.path.join(out, "exp", SCENE, "nerf"))))
    assert states[0]["iter_step"] == states[1]["iter_step"] == 2
    for part in ("params", "opt_state"):
        for k, v in states[1][part].items():
            assert torch.equal(states[0][part][k], v), (part, k)
