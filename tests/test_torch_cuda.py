"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor cv2, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest because tests/conftest.py configures jax.)

Tolerance rtol=2e-4, atol=1e-5: the JAX kernel test's own
(tests/test_pallas_render.py), for a sum over L lights in another order.
"""

import numpy as np
import pytest
import torch

from vqnerf_release_tpu.ops.light import gen_light_xyz  # numpy only
from vqnerf_release_torch.kernels import render as kr
from vqnerf_release_torch.ops.render import fused_render_equation

RTOL, ATOL = 2e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n, light_h, device, seed=0, rough=(0.05, 0.95)):
    rs = np.random.RandomState(seed)
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    l = lxyz.shape[0] * lxyz.shape[1]
    normal = rs.randn(n, 3)
    normal[::17] *= 1e-4  # short normals: the safe-normalize floor
    arrays = dict(
        xyz=rs.rand(n, 3) - 0.5, normal=normal, surf2c=rs.randn(n, 3),
        albedo=rs.rand(n, 3),
        rough=rough[0] + (rough[1] - rough[0]) * rs.rand(n, 1),
        f0=rs.rand(n, 3), lvis=rs.rand(n, l), lareas=lareas.reshape(-1),
        lxyz=lxyz.reshape(-1, 3), light=rs.rand(l, 3) * 0.3)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in arrays.items()}


_PER_RAY = ("xyz", "normal", "surf2c", "albedo", "rough", "f0")


@pytest.mark.cuda
@pytest.mark.parametrize("n,light_h,with_lvis", [
    (49152, 16, True), (1000, 16, False), (37, 4, True), (1, 27, True)])
def test_kernel_matches_plain_twin(cuda_device, n, light_h, with_lvis):
    t = _inputs(n, light_h, cuda_device)
    packed = kr.pack_lights(t["lxyz"], t["lareas"], t["light"])
    args = [t[k] for k in _PER_RAY] + [
        t["lvis"] if with_lvis else None, packed]
    launches = kr.LAUNCHES
    got = kr.fused_brdf_render(*args)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == launches + 1
    want = kr.fused_brdf_render_reference(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused_render_equation_cuda_matches_cpu(cuda_device):
    # rough >= 0.5: across devices rsqrt rounds differently (correctly
    # rounded on the CPU, rsqrtf on the GPU), and below that the GGX peak
    # amplifies the difference past the tolerance
    t = _inputs(3000, 8, cuda_device, rough=(0.5, 0.95))
    order = _PER_RAY + ("lvis", "lareas", "lxyz", "light")
    gamma = (torch.tensor([1.2]), torch.tensor([0.9]))
    got = fused_render_equation(
        *[t[k] for k in order], gamma=tuple(g.to(cuda_device) for g in gamma))
    want = fused_render_equation(*[t[k].cpu() for k in order], gamma=gamma)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda_device):
    t = _inputs(64, 4, cuda_device)
    packed = kr.pack_lights(t["lxyz"], t["lareas"], t["light"])
    args = [t[k] for k in _PER_RAY] + [t["lvis"], packed]
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError, match="float32"):
        kr.fused_brdf_render(*bad)
    bad = list(args)
    bad[6] = args[6][:-1]
    with pytest.raises(ValueError, match="shape"):
        kr.fused_brdf_render(*bad)
    bad = list(args)
    bad[0] = args[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        kr.fused_brdf_render(*bad)
