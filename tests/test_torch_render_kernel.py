"""The fused BRDF+render kernel module (vqnerf_release_torch/kernels/render.py).

On the CPU the port's fused_render_equation runs the kernel's plain twin;
it is held against the JAX package's fused_render_equation, which runs the
Pallas kernel in interpret mode on the CPU. The CUDA kernel itself is held
against the twin in tests/test_torch_cuda.py.

Tolerance rtol=2e-4, atol=1e-5: the JAX kernel test's own
(tests/test_pallas_render.py), for a sum over L lights in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.ops.light import gen_light_xyz
from vqnerf_release_tpu.ops.render import \
    fused_render_equation as j_fused_render_equation
from vqnerf_release_torch.kernels import render as kr
from vqnerf_release_torch.ops.render import \
    fused_render_equation as t_fused_render_equation


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 1e-5


def _inputs(n, light_h, seed=0):
    """Ragged n rays against L = 2 light_h^2 lights, as numpy float32."""
    rs = np.random.RandomState(seed)
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    l = lxyz.shape[0] * lxyz.shape[1]
    normal = rs.randn(n, 3)
    normal[::17] *= 1e-4  # short normals: the safe-normalize floor
    arrays = dict(
        xyz=rs.rand(n, 3) - 0.5, normal=normal,
        surf2c=rs.randn(n, 3), albedo=rs.rand(n, 3),
        rough=rs.rand(n, 1) * 0.9 + 0.05, f0=rs.rand(n, 3),
        lvis=rs.rand(n, l), lareas=lareas.reshape(-1),
        lxyz=lxyz.reshape(-1, 3), light=rs.rand(l, 3) * 0.3)
    return {k: np.asarray(v, np.float32) for k, v in arrays.items()}


_ORDER = ("xyz", "normal", "surf2c", "albedo", "rough", "f0", "lvis",
          "lareas", "lxyz", "light")


@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("with_lvis", [True, False])
def test_fused_render_equation_matches_jax(with_lvis, gamma):
    d = _inputs(200, 4)  # N = 200 (not a multiple of 128), L = 64
    if not with_lvis:
        d["lvis"] = None
    t_args = [None if d[k] is None else torch.from_numpy(d[k])
              for k in _ORDER]
    j_args = [None if d[k] is None else jnp.asarray(d[k]) for k in _ORDER]
    t_gamma = (torch.tensor([1.2]), torch.tensor([0.9])) if gamma else None
    j_gamma = (jnp.asarray([1.2]), jnp.asarray([0.9])) if gamma else None
    launches = kr.LAUNCHES
    got = t_fused_render_equation(*t_args, gamma=t_gamma)
    want = j_fused_render_equation(*j_args, gamma=j_gamma)
    assert kr.LAUNCHES == launches  # CPU tensors take the plain twin
    assert got.shape == (200, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pack_lights_layout():
    d = _inputs(4, 2)
    lxyz, lareas, light = (torch.from_numpy(d[k])
                           for k in ("lxyz", "lareas", "light"))
    packed = kr.pack_lights(lxyz, lareas, light)
    assert packed.shape == (8, lxyz.shape[0])
    np.testing.assert_array_equal(packed[0:3].T.numpy(), d["lxyz"])
    np.testing.assert_array_equal(packed[3:6].T.numpy(), d["light"])
    np.testing.assert_array_equal(packed[6].numpy(), d["lareas"])
    assert not packed[7].any()
