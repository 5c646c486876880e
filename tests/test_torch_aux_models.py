"""The port's modules off the pipeline path against the JAX package, on the
CPU: ops/geom.py (a copy, bit for bit), safe_atan2 / safe_acos with the JAX
custom JVPs as their backward, ShapeRefine (forward, loss, gradients, the
"shape_refine" converter), the BRDF sphere, ndc_rays and NerfRaysDataset.

Tolerances: bit for bit for the numpy copies and the datasets' rays; rtol
1e-5 for the safe-math values and gradients (at (0, 0), +/-1 and beyond
too), ShapeRefine and the sphere, which run in float32 on both sides. At
roughness below 0.6 the GGX D term amplifies last-bit differences near its
peak, and the sphere is held to 1e-4 there, as tests/test_torch_ops.py
holds the BRDF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from vqnerf_release_tpu.data import nerf_rays_dataset as j_nrd
from vqnerf_release_tpu.data import rays as j_rays
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.models import shape_refine as j_sr
from vqnerf_release_tpu.ops import geom as j_geom
from vqnerf_release_tpu.ops import math as j_math
from vqnerf_release_tpu.ops import sphere_render as j_sphere
from vqnerf_release_torch.data import nerf_rays_dataset as t_nrd
from vqnerf_release_torch.data import rays as t_rays
from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models import shape_refine as t_sr
from vqnerf_release_torch.ops import geom as t_geom
from vqnerf_release_torch.ops import math as t_math
from vqnerf_release_torch.ops import sphere_render as t_sphere


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
SMALL = dict(mlp_width=16, n_freqs_xyz=4)


def _close(got, want, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---- geom -------------------------------------------------------------------

def test_geom_equals_jax():
    rs = np.random.RandomState(0)
    normals = rs.randn(64, 3)
    normals[:3] = [[0, 0, 1], [0, 0, -1], [0, 0, 1e-9]]  # the +Z nudge
    np.testing.assert_array_equal(t_geom.world2local(normals),
                                  j_geom.world2local(normals))
    from scipy.spatial.transform import Rotation
    r0, r1 = Rotation.from_rotvec(rs.randn(2, 3)).as_matrix()
    ts = [0.0, 0.3, 0.77, 1.0]
    np.testing.assert_array_equal(t_geom.slerp_rotations(r0, r1, ts),
                                  j_geom.slerp_rotations(r0, r1, ts))
    c0, c1 = np.eye(4), np.eye(4)
    c0[:3, :3], c1[:3, :3] = r0, r1
    c0[:3, 3], c1[:3, 3] = rs.randn(3), rs.randn(3)
    for t in (0.0, 0.4, 1.0):
        np.testing.assert_array_equal(t_geom.interpolate_pose(c0, c1, t),
                                      j_geom.interpolate_pose(c0, c1, t))


def test_ndc_rays_equals_jax():
    rs = np.random.RandomState(1)
    o = rs.randn(50, 3) * 0.1
    d = rs.randn(50, 3) - [0, 0, 2]
    for got, want in zip(t_rays.ndc_rays(16, 24, 20.0, 1.0, o, d),
                         j_rays.ndc_rays(16, 24, 20.0, 1.0, o, d)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---- safe math --------------------------------------------------------------

def _grads_torch(fn, *xs):
    ts = [torch.tensor(x, dtype=torch.float32, requires_grad=True)
          for x in xs]
    y = fn(*ts)
    y.sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts]


def test_safe_atan2_value_and_gradient_equal_jax():
    rs = np.random.RandomState(2)
    x = np.concatenate([[0.0, 0.0, 1e-4, -1.0], rs.randn(60)]).astype(
        np.float32)
    y = np.concatenate([[0.0, -1.0, 0.0, 0.0], rs.randn(60)]).astype(
        np.float32)
    val, (gx, gy) = _grads_torch(t_math.safe_atan2, x, y)
    jval = j_math.safe_atan2(jnp.asarray(x), jnp.asarray(y))
    jgx, jgy = jax.grad(lambda a, b: j_math.safe_atan2(a, b).sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    _close(val, jval)
    _close(gx, jgx)
    _close(gy, jgy)
    assert np.isfinite(gx).all() and gx[0] == 0.0 and gy[0] == 0.0


def test_safe_acos_value_and_gradient_equal_jax():
    rs = np.random.RandomState(3)
    x = np.concatenate([[1.0, -1.0, 1.5, -2.0, 0.0, 0.999999],
                        rs.uniform(-1, 1, 50)]).astype(np.float32)
    val, (g,) = _grads_torch(t_math.safe_acos, x)
    jval = j_math.safe_acos(jnp.asarray(x))
    jg = jax.grad(lambda a: j_math.safe_acos(a).sum())(jnp.asarray(x))
    _close(val, jval)
    _close(g, jg)
    assert np.isfinite(g).all()
    assert g[2] == g[0] and g[0] < -400  # clipped input, finite slope


# ---- ShapeRefine ------------------------------------------------------------

def _shape_batch(n=40, seed=4):
    rs = np.random.RandomState(seed)
    alpha = rs.rand(n, 1).astype(np.float32)
    alpha[-5:] = 0.0
    return {"alpha": alpha,
            "xyz": (rs.rand(n, 3) - 0.5).astype(np.float32),
            "rayd": rs.randn(n, 3).astype(np.float32),
            "normal": rs.randn(n, 3).astype(np.float32)}


@pytest.mark.parametrize("white_bg", [True, False])
def test_shape_refine_equals_jax(white_bg):
    jcfg = j_dc.DecompConfig(**SMALL, white_bg=white_bg)
    tcfg = t_dc.DecompConfig(**SMALL, white_bg=white_bg)
    params = jax.tree_util.tree_map(np.asarray,
                                    j_sr.init_shape_refine(0, jcfg))
    model = from_jax(params, "shape_refine")
    assert isinstance(model, t_sr.ShapeRefine)
    back = to_jax(model, "shape_refine")
    for key in params:
        for p, q in zip(params[key], back[key]):
            np.testing.assert_array_equal(p["w"], q["w"])
            np.testing.assert_array_equal(p["b"], q["b"])

    batch = _shape_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def jloss(p):
        return j_sr.shape_refine_loss(j_sr.shape_refine_forward(p, jb, jcfg),
                                      jb, jcfg)

    jpred = j_sr.shape_refine_forward(params, jb, jcfg)
    jl, jg = jax.value_and_grad(jloss)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tpred = t_sr.shape_refine_forward(model, tb, tcfg)
    tl = t_sr.shape_refine_loss(tpred, tb, tcfg)
    tl.backward()
    _close(tpred["normal"].detach(), jpred["normal"], atol=1e-6)
    np.testing.assert_array_equal(tpred["mask"].numpy(), jpred["mask"])
    assert (tpred["normal"][-5:] == 0).all()
    _close(tl.item(), float(jl))
    for key in ("normal_mlp", "normal_out"):
        for lin, g in zip(getattr(model, key).layers, jg[key]):
            _close(lin.weight.grad.numpy().T, g["w"], atol=1e-7)
            _close(lin.bias.grad.numpy(), g["b"], atol=1e-7)


def test_shape_refine_init_widths():
    cfg = t_dc.DecompConfig(**SMALL)
    model = t_sr.init_shape_refine(torch.Generator().manual_seed(0), cfg)
    params = j_sr.init_shape_refine(0, j_dc.DecompConfig(**SMALL))
    for key in ("normal_mlp", "normal_out"):
        shapes = [tuple(lin.weight.shape[::-1])
                  for lin in getattr(model, key).layers]
        assert shapes == [tuple(p["w"].shape) for p in params[key]]


# ---- the BRDF sphere --------------------------------------------------------

@pytest.mark.parametrize("rough,rtol", [(0.3, 1e-4), (0.8, RTOL)])
def test_render_brdf_sphere_equals_jax(rough, rtol):
    env = (np.random.RandomState(5).rand(8, 16, 3) * 2).astype(np.float32)
    args = ([0.6, 0.3, 0.2], rough, [0.04, 0.05, 0.06], env)
    got = t_sphere.render_brdf_sphere(*args, imh=24, light_h=8, device="cpu")
    want = j_sphere.render_brdf_sphere(*args, imh=24, light_h=8)
    assert got.shape == want.shape == (24, 24, 3)
    _close(got, want, rtol=rtol, atol=1e-7)
    assert got[0, 0].sum() == 0 and got[12, 12].sum() > 0
    normals, mask = t_sphere.sphere_normals(24)
    jn, jm = j_sphere.sphere_normals(24)
    np.testing.assert_array_equal(normals, jn)
    np.testing.assert_array_equal(mask, jm)


def test_render_brdf_sphere_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sphere.render_brdf_sphere([0.5] * 3, 0.5, [0.04] * 3,
                                    np.ones((4, 8, 3), np.float32), imh=8,
                                    light_h=4)


# ---- NerfRaysDataset --------------------------------------------------------

@pytest.mark.parametrize("ndc,white_bg,mode", [(False, True, "train"),
                                               (True, False, "vali"),
                                               (False, False, "test")])
def test_nerf_rays_dataset_equals_jax(tmp_path, ndc, white_bg, mode):
    data_root, _ = _make_synth_scene(str(tmp_path))
    kw = dict(mode=mode, imh=16, white_bg=white_bg, ndc=ndc)
    tds, jds = t_nrd.NerfRaysDataset(data_root, **kw), \
        j_nrd.NerfRaysDataset(data_root, **kw)
    assert len(tds) == len(jds) == (3 if mode == "train" else 2)
    for f in jds.files:
        got, want = tds.load_view(f), jds.load_view(f)
        assert set(got) == set(want)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                assert got[k] == want[k], k
    with pytest.raises(ValueError, match="mode"):
        t_nrd.NerfRaysDataset(data_root, mode="eval")
