"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor cv2, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest because tests/conftest.py configures jax.)

Tolerance of the render kernel, rtol=2e-4, atol=1e-5: the JAX kernel test's
own (tests/test_pallas_render.py), for a sum over L lights in another order.

The VQ kernel is held to its plain version in two stages, so that a
near-tie does not look like a fault: (i) equal indices except on rows whose
two smallest plain distances lie within 1e-5 of each other; (ii) every other
output against the plain version fed the kernel's indices and evaluated in
float64, at rtol 1e-5 / atol 1e-6.

The two SDF kernels are held to their plain versions at rtol 1e-4 / atol
1e-5 (sums of up to 256 fp32 terms taken in another order than cuBLAS takes
them, through eight layers), and to the autograd gradient at the JAX kernel
test's own rtol 3e-3 / atol 3e-4.
"""

import numpy as np
import pytest
import torch

from vqnerf_release_torch.ops.light import gen_light_xyz
from vqnerf_release_torch.kernels import render as kr
from vqnerf_release_torch.kernels import sdf as ks
from vqnerf_release_torch.kernels import vq as kv
from vqnerf_release_torch.models import fields
from vqnerf_release_torch.models import decomp_common as dc
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.models.vq_nfr import init_vq_nfr
from vqnerf_release_torch.ops.render import fused_render_equation
from vqnerf_release_torch.ops.vq import VqEmaState, init_vq_ema_state
from vqnerf_release_torch.train.decomp_trainer import make_vq_nfr_step

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


def _vq_inputs(n, d, k, device, drop, seed=0):
    g = torch.Generator().manual_seed(seed)
    z = torch.rand((n, d), generator=g)
    c = torch.rand((d, k), generator=g)
    sel = torch.ones(k)
    if drop:
        sel[k // 2:] = (torch.rand(k - k // 2, generator=g) > 0.5).float()
    args = (c / c.norm(dim=0, keepdim=True), z / z.norm(dim=1, keepdim=True),
            (torch.rand((n,), generator=g) > 0.3).float(), sel,
            torch.rand(k, generator=g) * 100,
            torch.rand((d, k), generator=g) * 10, torch.tensor(37.0))
    return [t.to(device) for t in args]


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,drop", [
    (2048, 256, 15, True), (2048, 256, 15, False), (65536, 256, 15, True),
    (1000, 256, 15, True), (2048, 256, 8, True), (7, 16, 4, False),
    (1, 48, 3, True)])
def test_vq_kernel_matches_plain_version(cuda_device, n, d, k, drop):
    args = _vq_inputs(n, d, k, cuda_device, drop)
    kw = dict(decay=0.999, epsilon=1e-5)
    launches = kv.LAUNCHES
    out = kv.vq_fused_train(*args, **kw)
    again = kv.vq_fused_train(*args, **kw)
    torch.cuda.synchronize()
    assert kv.LAUNCHES == launches + 2
    for key in out:  # no atomics: the same bits from run to run
        assert torch.equal(out[key], again[key]), key
    plain = kv.vq_fused_train_reference(*args, **kw)
    cb, x, _, sel = args[:4]
    dist = (torch.sum(x * x, 1, keepdim=True) - 2.0 * (x @ cb)
            + torch.sum(cb * cb, 0, keepdim=True))
    dist = torch.where(sel[None] > 0, dist, torch.full_like(dist, kv.BIG))
    two = torch.topk(dist, 2, dim=1, largest=False).values
    near = (two[:, 1] - two[:, 0]) < 1e-5
    differ = out["indices"] != plain["indices"]
    assert not (differ & ~near).any()
    assert int(near.sum()) <= max(1, n // 100)
    fed = kv.vq_fused_train_reference(*[a.double() for a in args], **kw,
                                      indices=out["indices"])
    for key in ("quantized", "counts", "hidden_cs", "hidden_dw", "update"):
        torch.testing.assert_close(out[key].double(), fed[key], rtol=1e-5,
                                   atol=1e-6, msg=key)


@pytest.mark.cuda
def test_vq_kernel_fma_contraction_stays_within_tolerance(cuda_device,
                                                          monkeypatch):
    """The kernel is built with nvcc's default FMA contraction. Built with
    -fmad=false beside it, it gives the same indices and statistics within
    the same tolerance of the float64 plain version: nothing here is as
    ill-conditioned as the render kernel's GGX peak. Run with -s to see
    the two builds' errors and times."""
    args = _vq_inputs(65536, 256, 15, cuda_device, True)
    kw = dict(decay=0.999, epsilon=1e-5)
    outs = {}
    for name, flags in (("fma", ()), ("no fma", ("-fmad=false",))):
        monkeypatch.setattr(kv, "_lib", kv.load(kv.build(flags)[0]))
        outs[name] = kv.vq_fused_train(*args, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            kv.vq_fused_train(*args, **kw)
        end.record()
        end.synchronize()
        fed = kv.vq_fused_train_reference(
            *[a.double() for a in args], **kw, indices=outs[name]["indices"])
        errs = {}
        for key in ("counts", "hidden_cs", "hidden_dw", "update"):
            torch.testing.assert_close(outs[name][key].double(), fed[key],
                                       rtol=1e-5, atol=1e-6, msg=key)
            errs[key] = float((outs[name][key].double() - fed[key]).abs().max())
        print("%s: %.4f ms a call at 65536 x 256 x 15, max abs errs %s"
              % (name, start.elapsed_time(end) / 20, errs))
    differ = int((outs["fma"]["indices"] != outs["no fma"]["indices"]).sum())
    print("indices that differ between the builds: %d of 65536" % differ)
    assert differ <= 65


@pytest.mark.cuda
def test_vq_kernel_rejects_bad_inputs(cuda_device):
    args = _vq_inputs(64, 32, 4, cuda_device, False)
    kw = dict(decay=0.999, epsilon=1e-5)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(ValueError, match="float32"):
        kv.vq_fused_train(*bad, **kw)
    bad = list(args)
    bad[2] = args[2][:-1]
    with pytest.raises(ValueError, match="shape"):
        kv.vq_fused_train(*bad, **kw)
    bad = list(args)
    bad[0] = args[0].T.contiguous().T
    with pytest.raises(ValueError, match="contiguous"):
        kv.vq_fused_train(*bad, **kw)
    wide = _vq_inputs(8, 512, 4, cuda_device, False)
    with pytest.raises(ValueError, match="D <="):
        kv.vq_fused_train(*wide, **kw)


@pytest.mark.cuda
def test_fused_vq_training_step_cuda_matches_cpu(cuda_device):
    """One vq_nfr training step with the kernel on the card against the
    same step on the CPU (the plain version): losses, parameters, codebook
    and EMA state. rtol 1e-3 / atol 1e-5: the two devices round rsqrt, exp
    and the matmuls differently, and amsgrad's first step moves every
    parameter by lr whatever its gradient's size."""
    cfg = dc.DecompConfig(light_h=4, num_embed=6, num_drop=3, z_dim=64,
                          mlp_width=32, thres_str="0.1;0.2;0.3")
    gen = torch.Generator().manual_seed(0)
    nfr = init_nfr_unit(gen, cfg)
    centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
    model_cpu, _ = init_vq_nfr(gen, cfg, nfr, centers)
    rs = np.random.RandomState(1)
    n = 256
    normal = rs.randn(n, 3)
    batch = dict(
        rayo=np.tile([0.0, 0.0, 3.0], (n, 1)), xyz=rs.rand(n, 3) - 0.5,
        normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        alpha=(rs.rand(n, 1) > 0.2), rgb=rs.rand(n, 3),
        lvis=rs.rand(n, cfg.n_lights),
        _roll=rs.rand(1, cfg.num_embed))
    batch = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in batch.items()}
    results = {}
    for device in (torch.device("cpu"), cuda_device):
        import copy
        model = copy.deepcopy(model_cpu).to(device)
        _, step = make_vq_nfr_step(model, cfg,
                                   *dc.light_constants(cfg, device))
        ema = init_vq_ema_state(cfg.z_dim, cfg.num_embed, device)
        launches = kv.LAUNCHES
        ema, ld = step(ema, {k: v.to(device) for k, v in batch.items()},
                       torch.as_tensor(cfg.train_thres(), device=device),
                       None, 0)
        assert kv.LAUNCHES == launches + (device.type == "cuda")
        results[device.type] = (
            {k: float(v) for k, v in ld.items()},
            {k: v.cpu() for k, v in model.state_dict().items()},
            VqEmaState(*(t.cpu() for t in ema)))
    (ld_c, sd_c, ema_c), (ld_g, sd_g, ema_g) = results["cpu"], results["cuda"]
    assert ld_g["nonfinite_grads"] == 0.0
    for k in ld_c:
        np.testing.assert_allclose(ld_g[k], ld_c[k], rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    for k in sd_c:
        torch.testing.assert_close(sd_g[k], sd_c[k], rtol=1e-3, atol=1e-5,
                                   msg=k)
    for a, b in zip(ema_g, ema_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)


SDF_RTOL, SDF_ATOL = 1e-4, 1e-5
_SDF_NETS = {
    "default": dict(),
    "scale2": dict(scale=2.0),
    "small": dict(d_hidden=32, n_layers=4, skip_in=(2,), multires=2,
                  d_out=33),
    "odd": dict(d_hidden=100, n_layers=3, skip_in=(1, 3), multires=4,
                d_out=7, scale=0.5),
}


def _sdf_net(name, device, seed=0):
    cfg = fields.SDFConfig(**_SDF_NETS[name])
    params = fields.init_sdf(seed, cfg).to(device)
    return cfg, params, ks.pack_sdf(params, cfg)


def _sdf_points(n, device, seed=0):
    rs = np.random.RandomState(seed)
    return torch.as_tensor(rs.randn(n, 3).astype(np.float32) * 0.5,
                           device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("net,n", [
    ("default", 524288), ("default", 131072 + 77), ("default", 1),
    ("default", 63), ("scale2", 4096 + 5), ("small", 1000), ("odd", 777)])
def test_sdf_fwd_kernel_matches_plain_version(cuda_device, net, n):
    cfg, params, packed = _sdf_net(net, cuda_device)
    pts = _sdf_points(n, cuda_device)
    before = ks.LAUNCHES["sdf_fwd"]
    got = ks.sdf_fwd(packed, pts)
    again = ks.sdf_fwd(packed, pts)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["sdf_fwd"] == before + 2
    assert torch.equal(got, again)  # fixed summation order
    want = ks.sdf_fwd_plain(packed, pts)
    torch.testing.assert_close(got, want, rtol=SDF_RTOL, atol=SDF_ATOL)
    with torch.no_grad():
        auto = fields.sdf_only(params, pts[:4096], cfg)
    torch.testing.assert_close(got[:4096], auto, rtol=SDF_RTOL,
                               atol=SDF_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("net,n", [
    ("default", 1048576), ("default", 131072 + 77), ("default", 1),
    ("default", 15), ("scale2", 4096 + 5), ("small", 1000), ("odd", 777)])
def test_sdf_fwdgrad_kernel_matches_plain_version(cuda_device, net, n):
    cfg, params, packed = _sdf_net(net, cuda_device)
    pts = _sdf_points(n, cuda_device, seed=1)
    before = ks.LAUNCHES["sdf_fwdgrad"]
    sdf, grad = ks.sdf_fwdgrad(packed, pts)
    sdf2, grad2 = ks.sdf_fwdgrad(packed, pts)
    torch.cuda.synchronize()
    assert ks.LAUNCHES["sdf_fwdgrad"] == before + 2
    assert torch.equal(sdf, sdf2) and torch.equal(grad, grad2)
    want_sdf, want_grad = ks.sdf_fwdgrad_plain(packed, pts)
    torch.testing.assert_close(sdf, want_sdf, rtol=SDF_RTOL, atol=SDF_ATOL)
    torch.testing.assert_close(grad, want_grad, rtol=SDF_RTOL, atol=SDF_ATOL)
    # the second yardstick: autograd, at the JAX kernel test's tolerance
    auto = fields.sdf_gradient(params, pts[:4096], cfg)
    torch.testing.assert_close(grad[:4096], auto, rtol=3e-3, atol=3e-4)
    # the forward kernel gives the same values as the gradient kernel's
    torch.testing.assert_close(ks.sdf_fwd(packed, pts), sdf, rtol=1e-6,
                               atol=1e-7)


@pytest.mark.cuda
def test_sdf_kernels_fma_contraction_stays_within_tolerance(cuda_device,
                                                            monkeypatch):
    """The SDF kernels are built with nvcc's default FMA contraction (their
    products are explicit fmaf anyway). Built with -fmad=false beside it,
    both stay within the same tolerance of the plain versions. Run with -s
    to see the two builds' errors and times."""
    cfg, params, packed = _sdf_net("default", cuda_device)
    pts = _sdf_points(262144, cuda_device, seed=2)
    want = ks.sdf_fwdgrad_plain(packed, pts)
    for name, flags in (("fma", ()), ("no fma", ("-fmad=false",))):
        monkeypatch.setattr(ks, "_lib", ks.load(ks.build(flags)[0]))
        ms = {}
        for what, fn in (("fwd", lambda: ks.sdf_fwd(packed, pts)),
                         ("fwdgrad", lambda: ks.sdf_fwdgrad(packed, pts))):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fn()
            end.record()
            end.synchronize()
            ms[what] = start.elapsed_time(end) / 3
        sdf, grad = ks.sdf_fwdgrad(packed, pts)
        fwd = ks.sdf_fwd(packed, pts)
        torch.testing.assert_close(fwd, want[0], rtol=SDF_RTOL, atol=SDF_ATOL)
        torch.testing.assert_close(sdf, want[0], rtol=SDF_RTOL, atol=SDF_ATOL)
        torch.testing.assert_close(grad, want[1], rtol=SDF_RTOL,
                                   atol=SDF_ATOL)
        print("%s: fwd %.3f ms, fwdgrad %.3f ms at 262,144 points; max abs "
              "err sdf %.3e, grad %.3e"
              % (name, ms["fwd"], ms["fwdgrad"],
                 float((sdf - want[0]).abs().max()),
                 float((grad - want[1]).abs().max())))


@pytest.mark.cuda
def test_sdf_kernel_rejects_bad_inputs(cuda_device):
    cfg, params, packed = _sdf_net("small", cuda_device)
    pts = _sdf_points(64, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ks.sdf_fwd(packed, pts.double())
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        ks.sdf_fwdgrad(packed, pts[:, :2])
    with pytest.raises(ValueError, match="contiguous"):
        ks.sdf_fwd(packed, pts.T.contiguous().T)
    wide = fields.SDFConfig(d_hidden=300, n_layers=2, skip_in=(), multires=2)
    with pytest.raises(ValueError, match="widths up to"):
        ks.pack_sdf(fields.init_sdf(0, wide), wide)
    assert ks.sdf_fwd(packed, pts[:0]).shape == (0,)


@pytest.mark.cuda
def test_neus_occlusion_fused_matches_plain_path(cuda_device):
    """The shadow pass with both kernels against the autograd path, at a
    ragged number of rays that the TPU kernels' gate would have refused."""
    from vqnerf_release_torch.models.neus import (NeuSConfig, init_neus,
                                                  neus_occlusion)
    cfg = NeuSConfig()
    model = init_neus(0, cfg).to(cuda_device)
    rs = np.random.RandomState(3)
    n = 1000 + 37
    o = rs.randn(n, 3).astype(np.float32)
    o = 0.55 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.as_tensor(x, device=cuda_device) for x in (o, d))
    near = torch.full((n, 1), 0.1, device=cuda_device)
    far = torch.full((n, 1), 2.0, device=cuda_device)
    before = dict(ks.LAUNCHES)
    fused = neus_occlusion(model, cfg, o, d, near, far, 2.5)
    assert ks.LAUNCHES["sdf_fwd"] == before["sdf_fwd"] + cfg.up_sample_steps
    assert ks.LAUNCHES["sdf_fwdgrad"] == before["sdf_fwdgrad"] + 1
    plain = neus_occlusion(model, cfg, o, d, near, far, 2.5,
                           use_fused_sdf=False)
    assert ks.LAUNCHES["sdf_fwdgrad"] == before["sdf_fwdgrad"] + 1
    torch.testing.assert_close(fused, plain, rtol=0, atol=2e-3)
