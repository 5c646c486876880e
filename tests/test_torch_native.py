"""The port's host sampler (``data/native.py`` over ``csrc/fastloader.cpp``)
and its route through stage-2 training, on the CPU, against the JAX
package's native route (``vqnerf_release_tpu/data/native.py``, whose
library ``tests/conftest.py`` builds):
  * ``select_pairs`` bit for bit (both jitter modes, three seeds, 20x20 and
    37x53 views; a view without foreground raises in both);
  * ``gather_rows`` against numpy's indexing, ``load_npy_f32`` against
    ``np.load`` ('<f4' and '<f8'; Fortran order refused);
  * under ``VQNERF_NATIVE_SAMPLER=1`` the loop's ``sample_view_pix``,
    ``sample_view_pix_many`` and ``outer_sample`` against JAX's, bit for
    bit, leaving the same RandomState behind;
  * ``_native_mode``'s three settings, and a build without its compiler or
    with a broken source raising with the compiler's story;
  * ``_prefetch``: order, a worker's exception, an early close;
  * a 1-epoch ``train_nfr_unit`` on the host-gather path with native
    sampling against the JAX loop's from the same initial parameters, and
    the port's native scanned run against its native per-step run, bit for
    bit.

The port's library is built by the host compiler into the package's
``_build/`` at the first call (under a second).
"""

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL
from vqnerf_release_tpu.data import native as j_native
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.models.nfr_unit import init_nfr_unit as j_init_nfr
from vqnerf_release_tpu.train import loop as j_loop
from vqnerf_release_torch.data import native as t_native
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
from vqnerf_release_torch.kernels import build as kbuild
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.train import loop as t_loop

TRAIN = dict(SMALL, epochs=2, n_rays_per_step=16, total_sample_vq=64)
# a 1-epoch loop against the JAX loop from the same parameters: the
# tolerance of tests/test_torch_trainer.py's step trajectories (amsgrad's
# division by sqrt(vhat) + 1e-7 turns the gradients' fp32 rounding into
# parameter differences of about 1e-6 whatever the parameter's size)
LOOP_RTOL, LOOP_ATOL = 1e-4, 2e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module, as the other loop tests run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_lib():
    if not j_native.native_available():
        pytest.skip("the JAX package's libfastloader.so did not build")


@pytest.fixture
def native_env(monkeypatch):
    monkeypatch.setenv("VQNERF_NATIVE_SAMPLER", "1")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_scene")
    data_root, surf_root = _make_synth_scene(str(root), n_train=2, n_val=1)
    ds = ShapeDataset(data_root, surf_root, imh=16, mode="train")
    return [ds.load_view(f) for f in ds.files]


def _images(h, w, seed, foreground=True):
    """An [h, w] alpha with a disc of foreground (none when not
    ``foreground``) and a random [h, w, 3] rgb."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    disc = (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (min(h, w) / 2.5) ** 2
    alpha = (disc & foreground).astype(np.float32)
    return alpha, rs.rand(h, w, 3).astype(np.float32)


# ---- the library against the JAX package's ----------------------------------

@pytest.mark.parametrize("hw", [(20, 20), (37, 53)], ids=["20x20", "37x53"])
@pytest.mark.parametrize("jitter_mode", ["random", "contrast"])
def test_select_pairs_equals_jax_bit_for_bit(jax_lib, hw, jitter_mode):
    alpha, rgb = _images(*hw, seed=hw[1])
    for seed in (0, 7, 2**31 - 2):
        got = t_native.select_pairs(alpha, rgb, 50, jitter_mode=jitter_mode,
                                    seed=seed)
        want = j_native.select_pairs(alpha, rgb, 50, jitter_mode=jitter_mode,
                                     seed=seed)
        assert got.dtype == want.dtype and got.shape == (100, 2)
        np.testing.assert_array_equal(got, want)
        # every pair is a foreground pixel and a neighbour of it
        pix, jit = got[0::2], got[1::2]
        assert (alpha[pix[:, 0], pix[:, 1]] > 0.9).all()
        assert (alpha[jit[:, 0], jit[:, 1]] > 0.9).all()
        assert (np.abs(pix - jit).max(1) == 1).all()


def test_select_pairs_without_foreground_raises_as_jax(jax_lib):
    alpha, rgb = _images(20, 20, 1, foreground=False)
    for lib in (t_native, j_native):
        with pytest.raises(ValueError, match="no foreground"):
            lib.select_pairs(alpha, rgb, 8, seed=3)
    with pytest.raises(ValueError, match="rgb of shape"):
        t_native.select_pairs(alpha, rgb[:, :, :2], 8)
    with pytest.raises(ValueError, match="no interior pixel"):
        t_native.select_pairs(alpha[:2], rgb[:2], 8)


def test_gather_rows_equals_numpy_indexing():
    rs = np.random.RandomState(2)
    src = rs.rand(300, 7).astype(np.float32)
    idx = rs.randint(0, 300, size=123)
    np.testing.assert_array_equal(t_native.gather_rows(src, idx), src[idx])
    f64 = rs.rand(40, 3)
    np.testing.assert_array_equal(t_native.gather_rows(f64, [0, 39, 5]),
                                  f64[[0, 39, 5]].astype(np.float32))
    assert t_native.gather_rows(src, np.zeros(0, np.int64)).shape == (0, 7)
    with pytest.raises(IndexError):
        t_native.gather_rows(src, [300])


@pytest.mark.parametrize("dtype", ["<f4", "<f8"])
def test_load_npy_f32_equals_np_load(tmp_path, dtype):
    arr = np.random.RandomState(3).randn(5, 6, 7).astype(dtype)
    path = str(tmp_path / "a.npy")
    np.save(path, arr)
    got = t_native.load_npy_f32(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.load(path).astype(np.float32))
    np.save(path, np.asfortranarray(arr))
    with pytest.raises(IOError, match=r"load_npy_f32 failed \(-3\)"):
        t_native.load_npy_f32(path)


# ---- the loop's sampler entry points against JAX's --------------------------

def test_loop_samplers_equal_jax_under_one_random_state(jax_lib, native_env,
                                                        scene):
    """sample_view_pix, sample_view_pix_many (the seeds drawn first, the
    calls on a pool) and outer_sample: the same indices and rows as the
    JAX package's native route, and the same RandomState after."""
    views = scene + scene[::-1] + scene
    for mode in ("random", "contrast"):
        t_rs, j_rs = np.random.RandomState(11), np.random.RandomState(11)
        for view in scene:
            np.testing.assert_array_equal(
                t_loop.sample_view_pix(view, 16, t_rs, jitter_mode=mode),
                j_loop.sample_view_pix(view, 16, j_rs, jitter_mode=mode))
        got = t_loop.sample_view_pix_many(views, 16, t_rs, jitter_mode=mode)
        want = j_loop.sample_view_pix_many(views, 16, j_rs, jitter_mode=mode)
        assert len(got) == len(want) == len(views)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        for view in scene:
            got = t_loop.outer_sample(view, 16, t_rs, jitter_mode=mode)
            want = j_loop.outer_sample(view, 16, j_rs, jitter_mode=mode)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == np.float32
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for a, b in zip(t_rs.get_state(), j_rs.get_state()):
            np.testing.assert_array_equal(a, b)


def test_pool_equals_serial_native_calls(native_env, scene):
    """sample_view_pix_many's pool gives the serial calls' batches."""
    views = scene * 5
    rs_a, rs_b = np.random.RandomState(4), np.random.RandomState(4)
    many = t_loop.sample_view_pix_many(views, 32, rs_a)
    serial = [t_loop.sample_view_pix(v, 32, rs_b) for v in views]
    for a, b in zip(many, serial):
        np.testing.assert_array_equal(a, b)
    assert rs_a.randint(0, 2**31 - 1) == rs_b.randint(0, 2**31 - 1)


# ---- the switch and the build -----------------------------------------------

def test_native_mode_settings(monkeypatch, scene):
    monkeypatch.setenv("VQNERF_NATIVE_SAMPLER", "0")
    assert t_loop._native_mode() == "numpy"
    rs_a, rs_b = np.random.RandomState(1), np.random.RandomState(1)
    from vqnerf_release_torch.data.sampler import sample_pix
    np.testing.assert_array_equal(t_loop.sample_view_pix(scene[0], 8, rs_a),
                                  sample_pix(scene[0], 8, rs_b))
    monkeypatch.setenv("VQNERF_NATIVE_SAMPLER", "1")
    assert t_loop._native_mode() == "native"
    monkeypatch.delenv("VQNERF_NATIVE_SAMPLER")
    assert t_loop._native_mode() == "native"


def test_a_build_without_its_compiler_raises(monkeypatch, tmp_path):
    """With the library not built yet and no compiler, the default mode
    raises; nothing falls back to numpy."""
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native, "_LIB", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("VQNERF_NATIVE_SAMPLER", raising=False)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        t_loop._native_mode()
    monkeypatch.setenv("VQNERF_NATIVE_SAMPLER", "1")
    with pytest.raises(RuntimeError, match="was not found"):
        t_loop.sample_view_pix_many([], 8, np.random.RandomState(0))
    assert t_native._LIB is None


def test_a_failed_build_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name") as info:
        kbuild.build_host(bad, "bad")
    assert "-fopenmp" in str(info.value)
    assert not list((tmp_path / "build").glob("*.so"))


# ---- the prefetch -----------------------------------------------------------

def test_prefetch_yields_the_items_in_order():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        got = list(t_loop._prefetch(iter(range(2000)), depth=2))
    finally:
        sys.setswitchinterval(old)
    assert got == list(range(2000))
    assert list(t_loop._prefetch(iter([]))) == []


def test_prefetch_raises_the_worker_exception_after_the_items_before():
    def items():
        yield 1
        yield 2
        raise KeyError("in the worker")

    got = []
    with pytest.raises(KeyError, match="in the worker"):
        for x in t_loop._prefetch(items()):
            got.append(x)
    assert got == [1, 2]


def test_prefetch_closed_early_stops_the_worker():
    taken = []

    def items():
        for i in range(100):
            taken.append(i)
            yield i

    gen = t_loop._prefetch(items(), depth=2)
    assert next(gen) == 0
    gen.close()
    assert not [t for t in threading.enumerate()
                if t.name == "batch-prefetch"]
    assert len(taken) <= 4  # the item handed over, the queue, one in hand


# ---- training with the native sampler ---------------------------------------

def test_nfr_unit_epoch_on_the_host_path_follows_jax(jax_lib, native_env,
                                                     scene, tmp_path,
                                                     monkeypatch):
    """One epoch of nfr_unit, views on the host (device_views='off': the
    native outer_sample and the prefetch), from JAX's initial parameters:
    the same batches, so the parameters and the epoch's loss follow the
    JAX loop's within the trainer tests' tolerance."""
    kw = dict(TRAIN, epochs=1, device_views="off")
    j_cfg, t_cfg = j_dc.DecompConfig(**kw), t_dc.DecompConfig(**kw)
    j_params, j_hist = j_loop.train_nfr_unit(j_cfg, scene, [],
                                             str(tmp_path / "jax"), seed=3)
    init = jax.tree_util.tree_map(np.asarray, j_init_nfr(3, j_cfg))
    monkeypatch.setattr(t_loop, "init_nfr_unit",
                        lambda gen, cfg: from_jax(init, "nfr_unit"))
    model, t_hist = t_loop.train_nfr_unit(t_cfg, scene, [],
                                          str(tmp_path / "port"), seed=3,
                                          device="cpu")
    np.testing.assert_allclose(t_hist, j_hist, rtol=LOOP_RTOL)
    got = to_jax(model, "nfr_unit")
    want = jax.tree_util.tree_map(np.asarray, j_params)
    moved = False
    for (path, g), w, i in zip(
            jax.tree_util.tree_flatten_with_path(got)[0],
            jax.tree_util.tree_leaves(want),
            jax.tree_util.tree_leaves(init)):
        np.testing.assert_allclose(g, w, rtol=LOOP_RTOL, atol=LOOP_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        moved |= not np.array_equal(g, i)
    assert moved


def _train_pair(cfg, views, out):
    nfr, h1 = t_loop.train_nfr_unit(cfg, views, [], out + "/nfr",
                                    device="cpu")
    vq, ema, h2 = t_loop.train_vq_nfr(cfg, nfr, views, [], out + "/vq",
                                      device="cpu")
    return nfr, vq, ema, h1 + h2


def test_native_scanned_run_equals_native_per_step_run(native_env, scene,
                                                       tmp_path):
    """The store on: chunks of 2 epochs sampled through the pool against
    steps fed by the prefetch, nfr_unit then vq_nfr (its k-means batches
    natively sampled too), bit for bit."""
    runs = {}
    for name, kw in (("step", dict(epoch_scan=False)),
                     ("scan", dict(epoch_scan_chunk=2))):
        cfg = t_dc.DecompConfig(**TRAIN, device_views="on", **kw)
        runs[name] = _train_pair(cfg, scene, str(tmp_path / name))
    (n1, v1, e1, h1), (n2, v2, e2, h2) = runs["step"], runs["scan"]
    assert h1 == h2 and np.isfinite(h1).all()
    for a, b in ((n1, n2), (v1, v2)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for x, y in zip(e1, e2):
        assert torch.equal(x, y)
