"""What the two stage-2 CUDA kernels do otherwise than their plain versions,
checked on the CPU.

The render kernel (csrc/render_kernel.cu) groups part of its arithmetic
otherwise than ``fused_brdf_render_reference``: three explicit FMAs, one
divide for two, approximate divide and square root (within 2 ulp) behind the
ill-conditioned GGX term, and a sum over L taken four neighbouring lights a
lane. ``fused_brdf_render_regrouped`` evaluates exactly that in plain
PyTorch (FMA as float32(float64 a * float64 b + float64 c), the approximate
operations as 2-ulp perturbations), and is held here to the plain version at
the tolerance the kernel itself is held to on the card, rtol=2e-4,
atol=1e-5 (the JAX kernel test's own, for a sum over L in another order),
over roughness from 0.02 to 1, grazing and back-facing normals, with and
without lvis; and the (ray, light) pairs that come out exactly 0 are the
same pairs in both.

The VQ kernel's wrapper (kernels/vq.py) packs its five float32 outputs into
one buffer; the views must not overlap, and must be contiguous, 16-byte
aligned and of the documented shapes. Its grid and scratch sizes and the
SASS loop finder of kernels/build.py are plain Python and are checked too.
"""

import numpy as np
import pytest
import torch

from vqnerf_release_torch.kernels import build as kbuild
from vqnerf_release_torch.kernels import render as kr
from vqnerf_release_torch.kernels import vq as kv
from vqnerf_release_torch.ops.light import gen_light_xyz

RTOL, ATOL = 2e-4, 1e-5  # chip_smoke.py's, for the kernel against its twin
_LIGHT_H = {32: 4, 128: 8, 512: 16}


def _inputs(n, n_lights, rough, seed=0):
    """n rays against L lights at one roughness. Rows 0-7 are special: unit
    normals exactly perpendicular to the view direction (cos_vn == 0), a
    normal that faces away from half of the lights, grazing views, black
    albedo, and a short normal on the safe-normalize floor."""
    rs = np.random.RandomState(seed)
    light_h = _LIGHT_H[n_lights]
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    xyz = rs.rand(n, 3) - 0.5
    normal = rs.randn(n, 3)
    surf2c = rs.randn(n, 3)
    albedo = rs.rand(n, 3)
    normal[0], surf2c[0] = (0.0, 0.0, 1.0), (1.0, 0.0, 0.0)
    normal[1], surf2c[1] = (0.0, 1.0, 0.0), (0.0, 0.0, 2.0)
    xyz[2], normal[2] = (0.0, 0.0, 0.0), (0.0, 0.0, -1.0)  # half are behind
    xyz[3] = 0.45 * lxyz.reshape(-1, 3)[5]  # close under one light
    normal[4], surf2c[4] = (0.0, 0.0, 1.0), (1.0, 0.0, 1e-4)  # grazing view
    normal[5], surf2c[5] = (1e-3, 0.0, 1.0), (-1.0, 0.0, 1e-3)
    albedo[0] = albedo[1] = albedo[6] = 0.0
    normal[7] *= 1e-4
    arrays = dict(
        xyz=xyz, normal=normal, surf2c=surf2c, albedo=albedo,
        rough=np.full((n, 1), rough), f0=rs.rand(n, 3),
        lvis=rs.rand(n, n_lights) * (rs.rand(n, n_lights) > 0.2))
    t = {k: torch.as_tensor(np.asarray(v, np.float32))
         for k, v in arrays.items()}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    packed = kr.pack_lights(f32(lxyz.reshape(-1, 3)), f32(lareas.reshape(-1)),
                            f32(rs.rand(n_lights, 3) * 0.3))
    return t, packed


def _args(t, packed, with_lvis):
    return [t[k] for k in ("xyz", "normal", "surf2c", "albedo", "rough",
                           "f0")] + [t["lvis"] if with_lvis else None, packed]


def _assert_within(got, want):
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert not (err > ATOL + RTOL * want.abs()).any(), float(err.max())


@pytest.mark.parametrize("with_lvis", [True, False])
@pytest.mark.parametrize("n_lights", [32, 128, 512])
@pytest.mark.parametrize("rough", [0.02, 0.05, 0.1, 0.3, 0.6, 1.0])
def test_regrouped_arithmetic_matches_plain_version(rough, n_lights,
                                                    with_lvis):
    t, packed = _inputs(96, n_lights, rough, seed=n_lights)
    args = _args(t, packed, with_lvis)
    want = kr.fused_brdf_render_reference(*args)
    _assert_within(kr.fused_brdf_render_regrouped(*args), want)


@pytest.mark.parametrize("lights_per_lane", [1, 2, 4])
@pytest.mark.parametrize("rough", [0.02, 0.3])
def test_summation_order_alone_matches_plain_version(rough, lights_per_lane):
    """The plain version's arithmetic in the kernel's order of the sum over
    L, for the vector instance, the scalar one, and two lights a lane."""
    t, packed = _inputs(64, 128, rough)
    args = _args(t, packed, True)
    want = kr.fused_brdf_render_reference(*args)
    got = kr.fused_brdf_render_regrouped(
        *args, lights_per_lane=lights_per_lane, regroup=False)
    _assert_within(got, want)


@pytest.mark.parametrize("approx_ulps", [0.0, 2.0])
@pytest.mark.parametrize("rough", [0.02, 0.05, 0.3, 1.0])
def test_regrouping_zeroes_the_same_pairs(rough, approx_ulps):
    """Each (ray, light) pair alone, as a table of one light: the pairs
    that the front-lit select, lvis == 0 and the == 0 guards of the
    denominators zero are the same pairs, whatever the grouping."""
    t, packed = _inputs(48, 32, rough, seed=3)
    zero = {}
    for name, fn in (
            ("plain", kr.fused_brdf_render_reference),
            ("regrouped", lambda *a: kr.fused_brdf_render_regrouped(
                *a, approx_ulps=approx_ulps))):
        cols = []
        for j in range(32):
            args = _args(t, packed[:, j:j + 1].contiguous(), True)
            args[6] = t["lvis"][:, j:j + 1].contiguous()
            cols.append((fn(*args) == 0.0).all(dim=1))
        zero[name] = torch.stack(cols, dim=1)
    assert torch.equal(zero["plain"], zero["regrouped"])
    # the special rows do produce zeros, and not everything is zero
    assert zero["plain"].any() and not zero["plain"].all()
    # row 2 sits at the origin and faces -z: every light above is behind it
    assert zero["plain"][2][packed[2] > 0].all()


def test_regrouped_default_instance_follows_the_launcher():
    """L a multiple of four sums four lights a lane, any other L one."""
    t, packed = _inputs(16, 32, 0.3)
    args = _args(t, packed, True)
    assert torch.equal(
        kr.fused_brdf_render_regrouped(*args),
        kr.fused_brdf_render_regrouped(*args, lights_per_lane=4))
    ragged = [a if i < 6 else a[:, :30].contiguous()
              for i, a in enumerate(args)]
    assert torch.equal(
        kr.fused_brdf_render_regrouped(*ragged),
        kr.fused_brdf_render_regrouped(*ragged, lights_per_lane=1))
    _assert_within(kr.fused_brdf_render_regrouped(*ragged),
                   kr.fused_brdf_render_reference(*ragged))


@pytest.mark.parametrize("n,d,k", [(2048, 256, 15), (1000, 256, 8),
                                   (7, 16, 4), (1, 48, 3), (0, 64, 5)])
def test_vq_output_packing(n, d, k):
    out = kv.allocate_outputs(n, d, k, torch.device("cpu"))
    shapes = {"indices": (n,), "quantized": (n, d), "counts": (k,),
              "hidden_cs": (k,), "hidden_dw": (d, k), "update": (d, k)}
    assert set(out) == set(shapes)
    spans = []
    for name, shape in shapes.items():
        view = out[name]
        assert tuple(view.shape) == shape
        assert view.dtype == (torch.int32 if name == "indices"
                              else torch.float32)
        assert view.is_contiguous()
        if name != "indices":
            assert view.data_ptr() % 16 == 0 or view.numel() == 0
            spans.append((view.data_ptr(),
                          view.data_ptr() + 4 * view.numel()))
    spans.sort()
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert end <= start  # no two views overlap
    # writing one view changes no other
    for name in shapes:
        out[name].zero_()
    out["counts"].fill_(1.0)
    assert all(not out[name].any() for name in shapes if name != "counts")
    layout, total = kv.output_layout(n, d, k)
    assert all(offset % 4 == 0 for offset, _ in layout.values())
    assert total >= n * d + 2 * k + 2 * d * k


def test_vq_cpu_path_returns_the_same_keys_and_types():
    rs = np.random.RandomState(0)
    n, d, k = 50, 16, 4
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    got = kv.vq_fused_train(
        f32(rs.rand(d, k)), f32(rs.rand(n, d)), f32(rs.rand(n) > 0.3),
        torch.ones(k), f32(rs.rand(k)), f32(rs.rand(d, k)),
        torch.tensor(3.0), decay=0.99, epsilon=1e-5)
    packed = kv.allocate_outputs(n, d, k, torch.device("cpu"))
    assert set(got) == set(packed)
    for name, view in packed.items():
        assert got[name].shape == view.shape, name
        assert got[name].dtype == view.dtype, name


def test_vq_grid_scratch_and_shared_memory_sizes():
    assert [kv.grid_blocks(n) for n in (0, 1, 32, 33, 1000, 2048, 65536)] \
        == [1, 1, 1, 2, 32, 64, 128]
    # never more blocks than the card has SMs: the launch is cooperative
    assert kv.grid_blocks(65536, sms=108) == 108
    # per block a [K, D] sum and the counts of 16 codes
    assert kv.scratch_floats(32, 256, 15) == 32 * (15 * 256 + 16)
    assert kv.scratch_floats(1, 16, 17) == 17 * 16 + 32
    # the training shape needs more than the default 48 KB and fits 227 KB
    assert 48 * 1024 < kv.smem_bytes(256, 15) == 139120 <= kv.MAX_SMEM
    assert kv.smem_bytes(256, 26) > kv.MAX_SMEM


def test_wrappers_refuse_cpu_devices_in_the_cuda_checks():
    with pytest.raises(ValueError, match="CUDA"):
        kbuild.check_tensors((("x", torch.zeros(2), (2,)),), torch.float32,
                             torch.device("cpu"))


def test_sass_inner_loop_finds_the_innermost_marked_loop():
    ins = [(0x00, "MOV R1, c[0x0][0x28]"), (0x10, "MUFU.RSQ R2, R3"),
           (0x20, "FADD R1, R2, R3"), (0x30, "MUFU.RSQ R4, R5"),
           (0x40, "@P0 BRA 0x20"), (0x50, "ISETP.GE.AND P1, PT, R0, R7, PT"),
           (0x60, "@!P1 BRA 0x10"), (0x70, "EXIT"), (0x80, "BRA 0x80")]
    assert kbuild.sass_inner_loop(ins, "MUFU.RSQ") == [
        "FADD R1, R2, R3", "MUFU.RSQ R4, R5", "@P0 BRA 0x20"]
    assert kbuild.sass_inner_loop(ins, "ISETP") == [
        t for a, t in ins if 0x10 <= a <= 0x60]
    assert kbuild.sass_inner_loop(ins, "HGMMA") == []
