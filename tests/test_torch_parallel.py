"""The port's parallel layer (vqnerf_release_torch/parallel/) on the CPU,
against the JAX package's and against one device:

  * ``compose_view_shard`` and ``pad_to_multiple`` equal the JAX ones over
    a grid of cases, and ``shard_batch``'s blocks the rows of the JAX
    sharded batch; its padded rows are alpha-0 copies of the last row
    (the JAX package pads zeros, whose black render gives the
    chromaticity's square root an infinite derivative: a NaN gradient);
  * ``init_distributed`` is a no-op on one host and refuses a group
    without its size or rank; on a loopback coordinator it leaves the
    environment as it found it;
  * two ``gen-geo --num-hosts 2`` processes on the gloo backend write the
    tree that one process writes, file for file and bit for bit;
  * ``GeoExtractor`` over the mesh ["cpu", "cpu"] writes the files of one
    device, lvis included: every ray is independent, but a matrix
    product's blocking depends on the rows it gets, so a value may differ
    in its last bit (1.2e-7 seen on unit normals): .npy within rtol 1e-5 /
    atol 1e-6, PNGs within 1 LSB;
  * three chained vq_nfr steps over ["cpu", "cpu"] on a row count that
    needs padding equal the one-device steps on the padded batch (the
    global batch JAX's ``_device_batch`` forms) at rtol 2e-4 / atol 1e-5,
    the tolerance tests/test_trainers.py holds the JAX package's sharded
    trajectory to; so do one nfr_unit step and one ref_nfr step, and two
    epochs of nfr_unit and vq_nfr through the training loop.
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_gen_geo import KW, _datasets
from tests.test_torch_fields import small_cfgs
from tests.test_torch_models import SMALL, batch_np
from tests.test_torch_train_loop import TRAIN, _make_synth_scene
from vqnerf_release_tpu.parallel import distributed as j_dist
from vqnerf_release_tpu.parallel import mesh as j_mesh
from vqnerf_release_torch.cli import main
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models.neus import init_neus
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.models.ref_nfr import init_ref_nfr
from vqnerf_release_torch.models.vq_nfr import init_vq_nfr
from vqnerf_release_torch.ops.vq import init_vq_ema_state
from vqnerf_release_torch.parallel import distributed as t_dist
from vqnerf_release_torch.parallel import mesh as t_mesh
from vqnerf_release_torch.pipelines import gen_geo as t_geo
from vqnerf_release_torch.train import decomp_trainer as t_dt
from vqnerf_release_torch.train import loop as t_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = ["cpu", "cpu"]
RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: the suite's workers share the host, and
    a pool of spinning threads a worker turns these tests' hundreds of
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compose_view_shard_equals_jax():
    for n_proc in (1, 2, 3, 4):
        for proc in range(n_proc):
            for num_p, p_i in ((None, None), (1, 0), (2, 0), (2, 1), (3, 2)):
                assert t_dist.compose_view_shard(num_p, p_i, proc, n_proc) \
                    == j_dist.compose_view_shard(num_p, p_i, proc, n_proc)
    for mod in (t_dist, j_dist):
        with pytest.raises(ValueError, match="--num-p given without --p-i"):
            mod.compose_view_shard(2, None, 0, 2)


@pytest.mark.parametrize("shape,multiple,axis", [
    ((5, 3), 2, 0), ((8, 3), 4, 0), ((7,), 3, 0), ((1, 2, 2), 8, 0),
    ((4, 5), 3, 1), ((0, 2), 2, 0)])
def test_pad_to_multiple_equals_jax(shape, multiple, axis):
    a = np.random.RandomState(len(shape)).rand(*shape).astype(np.float32)
    for pad_value in (0.0, -1.5):
        got, n = t_mesh.pad_to_multiple(a, multiple, axis, pad_value)
        want, m = j_mesh.pad_to_multiple(a, multiple, axis, pad_value)
        assert n == m and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_dev", [(8, 2), (7, 2), (5, 4), (3, 8)])
def test_shard_batch_rows_equal_jax(n, n_dev):
    import jax
    batch = batch_np(n, 4)
    blocks, n_orig = t_mesh.shard_batch(batch, ["cpu"] * n_dev)
    sharded, m = j_mesh.shard_batch(
        batch, j_mesh.get_mesh(jax.devices()[:n_dev]))
    assert n_orig == m == n and len(blocks) == n_dev
    for k in batch:
        got = torch.cat([b[k] for b in blocks]).numpy()
        want = np.asarray(sharded[k])
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:n], want[:n])
        assert len({b[k].shape[0] for b in blocks}) == 1
        if k in ("alpha", "pred_alpha"):
            assert not got[n:].any()
        else:
            np.testing.assert_array_equal(got[n:], np.repeat(
                batch[k][-1:], got.shape[0] - n, axis=0))
    # the extractor's unpadded blocks differ by at most a row, the larger
    # first, as torch.tensor_split's
    sizes = [b - a for a, b in t_mesh.row_blocks(n, n_dev)]
    assert sizes == [len(c) for c in torch.tensor_split(torch.arange(n),
                                                        n_dev)]


def test_init_distributed_single_host_and_refusals(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert t_dist.init_distributed() == (0, 1)
    assert t_dist.init_distributed(None, 1, 0) == (0, 1)
    with pytest.raises(ValueError, match="needs its size"):
        t_dist.init_distributed("127.0.0.1:1", None, None)
    with pytest.raises(ValueError, match="outside"):
        t_dist.init_distributed("127.0.0.1:1", 2, 2)
    assert not torch.distributed.is_initialized()
    assert t_dist.local_mesh(None) is None
    assert t_dist.local_mesh("all", "cpu") is None
    with pytest.raises(ValueError, match="only 1 cpu devices visible"):
        t_dist.local_mesh(2, "cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_on_the_loopback_leaves_the_environment(
        monkeypatch):
    """A loopback coordinator puts gloo on ``lo`` for the group it makes,
    and leaves no GLOO_SOCKET_IFNAME behind for later groups."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "GLOO_SOCKET_IFNAME"):
        monkeypatch.delenv(var, raising=False)
    try:
        assert t_dist.init_distributed(
            "127.0.0.1:%d" % _free_port(), 1, 0) == (0, 1)
        assert "GLOO_SOCKET_IFNAME" not in os.environ
        assert torch.distributed.get_backend() == "gloo"
    finally:
        t_dist.shutdown_distributed()
    assert not torch.distributed.is_initialized()


def _tree(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_two_gloo_processes_write_the_one_process_tree(tmp_path):
    data = str(tmp_path / "data")
    chip_smoke.write_stage1_scene(data, 16, 2, 1, 0)
    flags = ["gen-geo", "lego_3072", "--data-root", data, "--device", "cpu",
             "--no-vis", "--n-samples", "8"]
    main(flags + ["--output-root", str(tmp_path / "one")])
    port = _free_port()
    # one thread a process: the test suite's workers share the host
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        env.pop(var, None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vqnerf_release_torch.cli", *flags,
         "--output-root", str(tmp_path / "two"), "--num-hosts", "2",
         "--coordinator", "127.0.0.1:%d" % port, "--host-id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    one, two = _tree(tmp_path / "one"), _tree(tmp_path / "two")
    views = sorted({os.path.dirname(k) for k in one})
    assert [os.path.basename(v) for v in views] == \
        ["train_000", "train_001", "val_000"]
    assert sorted(two) == sorted(one)
    for k in one:
        assert two[k] == one[k], k


@pytest.mark.parametrize("fast_vis", [False, True])
def test_geo_extractor_over_two_devices_equals_one(tmp_path, fast_vis):
    scene = str(tmp_path / "scene")
    from tests.test_gen_geo import _make_stage1_scene
    _make_stage1_scene(scene)
    _, tcfg = small_cfgs()
    model = init_neus(0, tcfg)
    _, td = _datasets(scene)
    outs = {}
    for name, mesh in (("one", None), ("two", MESH)):
        ex = t_geo.GeoExtractor(copy.deepcopy(model), tcfg, td,
                                str(tmp_path / name), device="cpu",
                                mesh=mesh, fast_vis=fast_vis,
                                **dict(KW, batch_size=50))
        ex.extract_views(is_train=True)
        outs[name] = _tree(tmp_path / name)
        if mesh:
            assert len(ex._replicas) == 2
            assert ex._replicas[1].params is not ex.params
    assert sorted(outs["one"]) == sorted(outs["two"])
    assert any(k.endswith("lvis.npy") for k in outs["one"])
    for k in outs["one"]:
        a, b = (os.path.join(tmp_path, name, k) for name in ("one", "two"))
        if k.endswith(".npy"):
            np.testing.assert_allclose(np.load(b), np.load(a), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            off = np.abs(t_io.read_png(b).astype(int)
                         - t_io.read_png(a).astype(int))
            assert off.max() <= 1, k


def _models(cfg, seed=0):
    """A NfrUnit, a VqNfr on it (random codebook) and a RefNfr on that, the
    port's own inits at ``cfg``."""
    gen = torch.Generator().manual_seed(seed)
    rs = np.random.RandomState(seed)
    nfr = init_nfr_unit(gen, cfg)
    centers = rs.rand(cfg.num_embed, cfg.z_dim).astype(np.float32)
    vq, _ = init_vq_nfr(gen, cfg, nfr, centers)
    light = torch.as_tensor(rs.rand(*cfg.light_res, 3) * 0.5,
                            dtype=torch.float32)
    return {"nfr_unit": nfr, "vq_nfr": vq,
            "ref_nfr": init_ref_nfr(gen, cfg, vq, light)}


def _compare_models(a, b, what):
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _pad(batch, n):
    return t_mesh.pad_rows(batch, n - next(iter(batch.values())).shape[0])


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
def test_vq_nfr_steps_over_two_devices_equal_one(data_type):
    """33 rows: the mesh pads to 34, blocks of 17, so a jitter pair of the
    smoothness term straddles the two devices."""
    cfg = t_dc.DecompConfig(**dict(SMALL, data_type=data_type))
    vq0 = _models(cfg)["vq_nfr"]
    lxyz, lareas = t_dc.light_constants(cfg, "cpu")
    thres = torch.as_tensor(cfg.train_thres())
    rs = np.random.RandomState(3)
    batches = [batch_np(33, cfg.n_lights, seed=20 + s) for s in range(3)]
    rolls = [rs.rand(1, cfg.num_embed).astype(np.float32) for _ in batches]
    runs = {}
    for name, mesh in (("one", None), ("two", MESH)):
        model = copy.deepcopy(vq0)
        opt, step = t_dt.make_vq_nfr_step(model, cfg, lxyz, lareas,
                                          mesh=mesh)
        ema = init_vq_ema_state(cfg.z_dim, cfg.num_embed)
        lds = []
        for s, (b, roll) in enumerate(zip(batches, rolls)):
            b = _pad(b, 34) if mesh is None else dict(b)
            b = {k: torch.from_numpy(v) for k, v in b.items()}
            b["_roll"] = torch.from_numpy(roll)
            ema, ld = step(ema, b, thres, None, s)
            lds.append(ld)
        runs[name] = (model, opt, ema, lds)
    (m1, o1, e1, l1), (m2, o2, e2, l2) = runs["one"], runs["two"]
    assert all(float(ld["nonfinite_grads"]) == 0.0 for ld in l1 + l2)
    _compare_models(m1, m2, "params")
    for k in ("m", "v", "vhat"):
        np.testing.assert_allclose(o2.state[k].numpy(), o1.state[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert int(o1.state["count"]) == int(o2.state["count"]) == 3
    for a, b, name in zip(e1, e2, e1._fields):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for a, b in zip(l1, l2):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k]), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


@pytest.mark.parametrize("kind", ["nfr_unit", "ref_nfr"])
def test_one_step_over_two_devices_equals_one(kind):
    cfg = t_dc.DecompConfig(**SMALL)
    model0 = _models(cfg)[kind]
    lxyz, lareas = t_dc.light_constants(cfg, "cpu")
    make = {"nfr_unit": t_dt.make_nfr_unit_step,
            "ref_nfr": t_dt.make_ref_nfr_step}[kind]
    b = batch_np(31, cfg.n_lights, seed=5)
    models, lds = {}, {}
    for name, mesh in (("one", None), ("two", MESH)):
        model = copy.deepcopy(model0)
        _, step = make(model, cfg, lxyz, lareas, mesh=mesh)
        rows = _pad(b, 32) if mesh is None else b
        lds[name] = step({k: torch.from_numpy(v) for k, v in rows.items()},
                         0)
        models[name] = model
    _compare_models(models["one"], models["two"], kind)
    for k in lds["one"]:
        np.testing.assert_allclose(float(lds["two"][k]),
                                   float(lds["one"][k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_training_loop_over_two_devices_equals_one(tmp_path):
    root = str(tmp_path / "scene")
    data_root, surf_root = _make_synth_scene(root, n_train=2, n_val=1)
    load = lambda mode: [  # noqa: E731
        ds.load_view(f) for ds in [ShapeDataset(
            data_root, surf_root, imh=16, mode=mode)] for f in ds.files]
    train, vali = load("train"), load("vali")
    cfg = t_dc.DecompConfig(**TRAIN)
    got = {}
    for name, devices in (("one", None), ("two", MESH)):
        out = str(tmp_path / name)
        nfr, h1 = t_loop.train_nfr_unit(cfg, train, vali, out + "/nfr",
                                        device="cpu", devices=devices)
        vq, ema, h2 = t_loop.train_vq_nfr(cfg, nfr, train, vali,
                                          out + "/vq", device="cpu",
                                          devices=devices)
        got[name] = (nfr, vq, ema, h1 + h2)
    np.testing.assert_allclose(got["two"][3], got["one"][3], rtol=RTOL,
                               atol=ATOL)
    _compare_models(got["one"][0], got["two"][0], "nfr_unit")
    _compare_models(got["one"][1], got["two"][1], "vq_nfr")
    assert int(got["two"][2].counter) == 4
