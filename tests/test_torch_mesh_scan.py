"""The port's scanned dispatch over a device list and its row-sharded store
(``device_views='shard'``) on the CPU, at tiny widths, against its own
per-step path and the JAX package:
  * ``_resolve_epoch_scan`` equals JAX's for every ``epoch_scan`` value,
    with no store and with the stores that ``_make_batch_source`` stages
    over ["cpu"] and ["cpu", "cpu"];
  * nfr_unit, vq_nfr and ref_nfr trained over ["cpu", "cpu"] scanned equal
    the same runs step by step, bit for bit (parameters, optimizer and EMA
    states, per-epoch losses);
  * vq_nfr over ["cpu", "cpu"] and ["cpu"] * 3 with 'shard' equals 'on'
    bit for bit (the three-entry store's last shard is padded);
  * the sharded ``gather`` and ``gather_at`` equal the JAX package's
    sharded gather (float32 and u8) over 2 and 3 devices, and each entry
    holds 1/n of the rows;
  * ``device_sampling`` over a sharded store samples on the host, with
    JAX's notice;
  * a vq_nfr step over ["cpu"] * 3 at 7 pairs, whose 14 rows pad to an odd
    15 where the JAX package fails, pads to 18 and equals the one-device
    step on those 18 rows.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL, batch_np
from vqnerf_release_tpu.data import device_store as j_store
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.parallel import get_mesh as j_get_mesh
from vqnerf_release_tpu.train import loop as j_loop
from vqnerf_release_torch.data import device_store as t_store
from vqnerf_release_torch.data.device_sampler import make_device_sampler
from vqnerf_release_torch.data.sampler import sample_pix
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.models.vq_nfr import init_vq_nfr
from vqnerf_release_torch.ops.vq import init_vq_ema_state
from vqnerf_release_torch.parallel.mesh import pad_rows
from vqnerf_release_torch.train import decomp_trainer as t_dt
from vqnerf_release_torch.train import loop as t_loop
from vqnerf_release_torch.utils import ckpt as t_ckpt

TRAIN = dict(SMALL, epochs=2, n_rays_per_step=16, total_sample_vq=64)
MESH2 = ["cpu", "cpu"]
MESH3 = ["cpu"] * 3
# a step over a device list against one device: the mesh tests' tolerance
# (tests/test_torch_parallel.py; the sums over the blocks add in another
# order)
RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    thousands of small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two 16x16 train views: 2 x 257 = 514 flat rows, which 3 devices
    shard into blocks of 172, the last holding 2 padding rows."""
    root = tmp_path_factory.mktemp("mesh_scene")
    data_root, surf_root = _make_synth_scene(str(root), n_train=2, n_val=1)
    ds = ShapeDataset(data_root, surf_root, imh=16, mode="train",
                      with_ref=True)
    return [ds.load_view(f) for f in ds.files]


# ---- the dispatch rule ------------------------------------------------------

@pytest.mark.parametrize("mesh", [["cpu"], MESH2], ids=["one", "mesh2"])
def test_resolve_epoch_scan_equals_jax_on_a_mesh(scene, mesh):
    for mode in ("off", "on", "shard"):
        for want in (None, True, False):
            cfg = t_dc.DecompConfig(**TRAIN, device_views=mode,
                                    epoch_scan=want)
            _, store = t_loop._make_batch_source(scene, cfg, "random",
                                                 torch.device("cpu"), mesh)
            assert (store is None) == (mode == "off")
            assert store is None or store.sharded == (
                mode == "shard" and len(mesh) > 1)
            assert t_loop._resolve_epoch_scan(cfg, store) == \
                j_loop._resolve_epoch_scan(
                    j_dc.DecompConfig(epoch_scan=want), store), (mode, want)


# ---- training over the mesh: scanned against per-step -----------------------

def _train(cfg, scene, out, mesh, phases=("nfr", "vq", "ref"), nfr=None):
    """The phases in order over ``mesh`` on the CPU, without validation
    views; vq_nfr starts from ``nfr`` when given."""
    got = {}
    kw = dict(device="cpu", devices=mesh)
    if "nfr" in phases:
        nfr, got["nfr_hist"] = t_loop.train_nfr_unit(
            cfg, scene, [], os.path.join(out, "nfr"), **kw)
        got["nfr"] = nfr
    if "vq" in phases:
        got["vq"], got["ema"], got["vq_hist"] = t_loop.train_vq_nfr(
            cfg, nfr, scene, [], os.path.join(out, "vq"), **kw)
    if "ref" in phases:
        light = np.load(os.path.join(out, "vq", "vis_vali", "np_light.npy"))
        got["ref"], got["ref_hist"] = t_loop.train_ref_nfr(
            cfg, got["vq"], light, scene, [], os.path.join(out, "ref"), **kw)
    got["dir"] = out
    return got


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_runs")
    out = {}
    for name, kw in (("step", dict(device_views="on", epoch_scan=False)),
                     ("scan", dict(device_views="on", epoch_scan_chunk=2))):
        out[name] = _train(t_dc.DecompConfig(**TRAIN, **kw), scene,
                           str(root / name), MESH2)
    return out


def _assert_same_phase(a, b, phase):
    for x, y in zip(a[phase].state_dict().values(),
                    b[phase].state_dict().values()):
        assert torch.equal(x, y), phase
    assert a[phase + "_hist"] == b[phase + "_hist"], phase
    sa, sb = (t_ckpt.load_ckpt(t_ckpt.latest_ckpt(os.path.join(r["dir"],
                                                               phase)))
              for r in (a, b))
    for k, v in sa["opt_state"].items():
        assert torch.equal(v, sb["opt_state"][k]), (phase, k)
    if phase == "vq":
        for x, y in zip(a["ema"], b["ema"]):
            assert torch.equal(x, y)


@pytest.mark.parametrize("phase", ["nfr", "vq", "ref"])
def test_mesh_scan_equals_mesh_steps(runs, phase):
    _assert_same_phase(runs["scan"], runs["step"], phase)


@pytest.mark.parametrize("mesh", [MESH2, MESH3], ids=["mesh2", "mesh3"])
def test_shard_trains_as_on(runs, scene, tmp_path, mesh):
    """vq_nfr over the mesh from the same warm-up model, scanned, with the
    views row-sharded and staged whole: equal bit for bit. Over 3 entries a
    step takes 24 pairs: vq_nfr's pair terms need an even padded batch (32
    rows pad to 33 over 3 entries, in the JAX package too)."""
    got = {}
    rays = dict(n_rays_per_step=16 if mesh == MESH2 else 24)
    for mode in ("on", "shard"):
        if mode == "on" and mesh == MESH2:
            got[mode] = runs["scan"]
            continue
        cfg = t_dc.DecompConfig(**dict(TRAIN, **rays), device_views=mode,
                                epoch_scan_chunk=2)
        got[mode] = _train(cfg, scene, str(tmp_path / mode), mesh,
                           phases=("vq",), nfr=runs["scan"]["nfr"])
    _assert_same_phase(got["shard"], got["on"], "vq")


# ---- the sharded gather against the JAX package's ---------------------------

@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "u8"])
def test_sharded_gather_equals_jax(scene, n, quant):
    j_st = j_store.DeviceViewStore(scene, mesh=j_get_mesh(jax.devices()[:n]),
                                   quant=quant, shard=True)
    t_st = t_store.DeviceViewStore(scene, "cpu", quant=quant,
                                   mesh=["cpu"] * n, shard=True)
    on = t_store.DeviceViewStore(scene, "cpu", quant=quant)
    assert j_st.sharded and t_st.sharded
    rows = len(scene) * t_st.row_stride
    assert t_st.rows_local == -(-rows // n)
    for k, blocks in t_st.shards.items():
        assert len(blocks) == n
        assert all(b.shape[0] == t_st.rows_local for b in blocks)
        assert torch.equal(torch.cat(blocks)[:rows],
                           on.arrays[k].reshape(rows, -1)), k
    assert t_store.store_nbytes(scene, quant=quant, shards=n) == sum(
        b.numel() * b.element_size() for bl in t_st.shards.values()
        for b in bl[:1])
    for vi, view in enumerate(scene):
        pix = sample_pix(view, 16, np.random.RandomState(5 + vi))
        pix[:3] = t_st.pad_index  # the zero row, as the samplers pad
        want = j_st.gather(vi, pix)
        got = t_st.gather(vi, pix)
        got_at = t_st.gather_at(torch.tensor(vi), torch.as_tensor(pix))
        replicated = on.gather(vi, pix)
        assert set(got) == set(want) == set(got_at)
        for k in want:
            w = np.asarray(want[k])[:len(pix)]
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
            assert torch.equal(got_at[k], got[k]), k
            assert torch.equal(got[k], replicated[k]), k


def test_shard_on_one_device_is_on(scene):
    st = t_store.DeviceViewStore(scene, "cpu", mesh=["cpu"], shard=True)
    assert not st.sharded and st.arrays and not st.shards
    assert t_store.store_nbytes(scene, shards=1) == t_store.store_nbytes(
        scene)


def test_device_sampling_over_a_sharded_store_samples_on_the_host(
        scene, capsys):
    cfg = t_dc.DecompConfig(**TRAIN, device_views="shard",
                            device_sampling=True)
    _, store = t_loop._make_batch_source(scene, cfg, "random",
                                         torch.device("cpu"), MESH2)
    assert store.sharded
    assert t_loop._resolve_device_sampling(cfg, store, scene,
                                           "random") is None
    assert "device_views='shard' keeps the host index stream" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="replicated"):
        make_device_sampler(store, scene, 16)


def test_preset_override_stages_the_sharded_store(scene):
    """`decomp-train --preset-override device_views=shard` reaches the
    loop's batch source: over ["cpu", "cpu"] the store is row-sharded."""
    from vqnerf_release_torch.cli import _apply_preset_overrides
    cfg = _apply_preset_overrides(t_dc.DecompConfig(**TRAIN),
                                  "device_views=shard,epoch_scan_chunk=2")
    assert cfg.device_views == "shard"
    _, store = t_loop._make_batch_source(scene, cfg, "random",
                                         torch.device("cpu"), MESH2)
    assert store.sharded and [b.shape[0] for b in store.shards["lvis"]] \
        == [257, 257]


# ---- vq_nfr over an odd mesh ------------------------------------------------

def test_vq_nfr_step_over_three_entries_at_an_odd_padded_count():
    """7 pairs are 14 rows; over 3 entries they pad to 15, an odd count
    whose pair terms ([::2] against [1::2]) cannot pair up (the JAX
    package fails there). The step pads 3 more alpha-0 rows, to 18, and
    equals the one-device step on the same 18 rows."""
    cfg = t_dc.DecompConfig(**SMALL)
    assert cfg.mat_sloss_weight > 0  # the pair terms run
    gen = torch.Generator().manual_seed(0)
    centers = np.random.RandomState(0).rand(cfg.num_embed, cfg.z_dim)
    vq0, _ = init_vq_nfr(gen, cfg, init_nfr_unit(gen, cfg),
                         centers.astype(np.float32))
    lxyz, lareas = t_dc.light_constants(cfg, "cpu")
    thres = torch.as_tensor(cfg.train_thres())
    batch = {k: torch.from_numpy(v)
             for k, v in batch_np(14, cfg.n_lights, seed=9).items()}
    roll = torch.rand((1, cfg.num_embed), generator=gen)
    got = {}
    for name, mesh, b in (("three", MESH3, batch),
                          ("one", None, pad_rows(batch, 4))):
        model = copy.deepcopy(vq0)
        opt, step = t_dt.make_vq_nfr_step(model, cfg, lxyz, lareas,
                                          mesh=mesh)
        ema, ld = step(init_vq_ema_state(cfg.z_dim, cfg.num_embed),
                       dict(b, _roll=roll), thres, None, 0)
        got[name] = (model, opt, ema, ld)
    (m1, o1, e1, l1), (m3, o3, e3, l3) = got["one"], got["three"]
    assert float(l3["nonfinite_grads"]) == 0.0
    assert set(l1) == set(l3) and "chr_smooth" in l3
    for k in l1:
        np.testing.assert_allclose(float(l3[k]), float(l1[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for (k, x), y in zip(m3.state_dict().items(), m1.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k in ("m", "v", "vhat"):
        np.testing.assert_allclose(o3.state[k].numpy(), o1.state[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for a, b, name in zip(e3, e1, e1._fields):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
