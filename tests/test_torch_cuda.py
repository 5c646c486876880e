"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor cv2, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest because tests/conftest.py configures jax.)

Tolerance of the render kernel, rtol=2e-4, atol=1e-5: the JAX kernel test's
own (tests/test_pallas_render.py), for a sum over L lights in another order.
Its vector and scalar instances, its variants behind macros and the 16-byte
loads in its machine code are checked here too.

The VQ kernel is held to its plain version in two stages, so that a
near-tie does not look like a fault: (i) equal indices except on rows whose
two smallest plain distances lie within 1e-5 of each other; (ii) every other
output against the plain version fed the kernel's indices and evaluated in
float64, at rtol 1e-5 / atol 1e-6. It is one cooperative launch a call, and
equal inputs must give equal bits, call after call.

The two SDF kernels are held to their plain versions at rtol 1e-4 / atol
1e-5 (sums of up to 256 terms taken in another order than cuBLAS takes
them, each product split in three TF32 products on the tensor cores,
through eight layers), and to the autograd gradient at the JAX kernel
test's own rtol 3e-3 / atol 3e-4.
"""

import re
import subprocess
import types

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


def _inputs(n, light_h, device, seed=0, rough=(0.05, 0.95), n_lights=None):
    """``n_lights``, when given, keeps the first so many lights of the
    light_h x 2 light_h map, for an L that no map has."""
    rs = np.random.RandomState(seed)
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    l = n_lights or lxyz.shape[0] * lxyz.shape[1]
    lxyz, lareas = lxyz.reshape(-1, 3)[:l], lareas.reshape(-1)[:l]
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


def _render_args(t, with_lvis=True):
    packed = kr.pack_lights(t["lxyz"], t["lareas"], t["light"])
    return [t[k] for k in _PER_RAY] + [t["lvis"] if with_lvis else None,
                                       packed]


@pytest.mark.cuda
@pytest.mark.parametrize("n,light_h,with_lvis", [
    (49152, 16, True), (1000, 16, False), (37, 4, True), (1, 27, True)])
def test_kernel_matches_plain_twin(cuda_device, n, light_h, with_lvis):
    args = _render_args(_inputs(n, light_h, cuda_device), with_lvis)
    launches = kr.LAUNCHES
    got = kr.fused_brdf_render(*args)
    torch.cuda.synchronize()
    assert kr.LAUNCHES == launches + 1
    want = kr.fused_brdf_render_reference(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("with_lvis", [True, False])
@pytest.mark.parametrize("n", [0, 1, 1000, 49152])
@pytest.mark.parametrize("n_lights", [32, 128, 500, 510, 512])
def test_kernel_instances_match_plain_twin(cuda_device, n_lights, n,
                                           with_lvis):
    """Every L and N through the instance the launcher chooses for it: the
    16-byte one where L is a multiple of four, the scalar one elsewhere,
    and the same L again with an lvis whose base is 4 bytes off a 16-byte
    boundary, which must take the scalar one and match as well."""
    t = _inputs(n, 16, cuda_device, seed=n_lights + n, n_lights=n_lights)
    args = _render_args(t, with_lvis)
    want = kr.fused_brdf_render_reference(*args)
    before = dict(kr.LAUNCHES_BY_INSTANCE)
    got = kr.fused_brdf_render(*args)
    torch.cuda.synchronize()
    which = "vector" if n_lights % 4 == 0 else "scalar"
    after = dict(before)
    after[which] += n > 0
    assert kr.LAUNCHES_BY_INSTANCE == after
    assert got.shape == (n, 3)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if with_lvis and n > 0:
        flat = torch.empty((n * n_lights + 1,), device=cuda_device)
        off = flat[1:].view(n, n_lights)
        off.copy_(t["lvis"])
        assert off.is_contiguous() and off.data_ptr() % 16 == 4
        got_off = kr.fused_brdf_render(*args[:6], off, args[7])
        torch.cuda.synchronize()
        after["scalar"] += 1
        assert kr.LAUNCHES_BY_INSTANCE == after
        torch.testing.assert_close(got_off, want, rtol=RTOL, atol=ATOL)


def _sass_count(instructions, pattern):
    return sum(bool(re.search(pattern, text)) for _, text in instructions)


_LDG_128 = r"LDG\.E\.(\w+\.)*128"  # cache hints stand before the width


@pytest.mark.cuda
def test_render_library_holds_16_byte_loads(cuda_device):
    """The vector instances read lvis with LDG.E.128 and the light table
    with LDS.128; the scalar instances hold neither in their light loop."""
    functions = kr.kbuild.sass_functions(kr.build()[0])

    def instance(key):
        found = [ins for name, ins in functions.items()
                 if kr.SASS_NAMES[key] in name]
        assert len(found) == 1, (key, list(functions))
        return found[0]
    fast = instance(("vector", True))
    print(sorted({t.split()[0] for _, t in fast if "LDG" in t}))
    assert _sass_count(fast, _LDG_128) >= 1
    assert _sass_count(fast, r"LDS\.128") >= 7
    assert _sass_count(instance(("vector", False)), r"LDS\.128") >= 7
    for with_lvis in (True, False):
        loop = kr.kbuild.sass_inner_loop(instance(("scalar", with_lvis)),
                                         "MUFU.RSQ")
        assert loop and not any(re.search(_LDG_128 + r"|LDS\.128", t)
                                for t in loop)


def _event_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _event_ms_beside_smi(fn, reps):
    """(_event_ms of ``reps`` calls of ``fn``, the card's SM clock and power
    draw as nvidia-smi reads them every 0.1 s while the calls run)."""
    import threading
    import time
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
            time.sleep(0.1)
    thread = threading.Thread(target=sample)
    thread.start()
    try:
        ms = _event_ms(fn, reps=reps)
    finally:
        stop.set()
        thread.join()
    return ms, samples


@pytest.mark.cuda
def test_render_kernel_clock_under_load(cuda_device):
    """A study, run with -s: 20,000 launches on end at 49,152 rays x 512
    lights with the card's SM clock and power sampled beside them, so that
    the kernel's time can be held to its issue floor at the clock it really
    ran at, not at the card's highest."""
    args = _render_args(_inputs(49152, 16, cuda_device))
    ms, samples = _event_ms_beside_smi(
        lambda: kr.fused_brdf_render(*args), reps=20000)
    print("20,000 calls on end: %.4f ms a call; clocks.sm, power.draw: %s"
          % (ms, samples))
    assert ms > 0 and samples


@pytest.mark.cuda
def test_render_kernel_variants(cuda_device, monkeypatch):
    """A study, run with -s: the variants that the source keeps behind
    macros, each held to the plain version at the port's tolerance and timed
    at the main path's 49,152 rays x 512 lights with and without lvis
    (events around 50 launches: at 0.1 ms a launch the card, not the host,
    sets the time). ptxas' registers of each build are printed."""
    args = _render_args(_inputs(49152, 16, cuda_device))
    no_lvis = args[:6] + [None, args[7]]
    low = _render_args(_inputs(4096, 16, cuda_device, rough=(0.02, 0.1)))
    want, want_low = (kr.fused_brdf_render_reference(*a) for a in (args, low))
    variants = (
        ("port's build", ()),
        ("IEEE divide and sqrt", ("-DRENDER_APPROX=0",)),
        ("the plain version's grouping", ("-DRENDER_REGROUP=0",)),
        ("two lights a lane", ("-DRENDER_LIGHTS=2",)),
        ("one light a lane, vector instance", ("-DRENDER_LIGHTS=1",)),
        ("registers for 1 block an SM", ("-DRENDER_MIN_BLOCKS=1",)),
        ("registers for 3 blocks an SM", ("-DRENDER_MIN_BLOCKS=3",)),
        ("registers for 4 blocks an SM", ("-DRENDER_MIN_BLOCKS=4",)),
    )
    for name, flags in variants:
        so, log = kr.build(flags)
        monkeypatch.setattr(kr, "_lib", kr.load(so))
        got, got_low = kr.fused_brdf_render(*args), kr.fused_brdf_render(*low)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got_low, want_low, rtol=RTOL, atol=ATOL)
        ms = _event_ms(lambda: kr.fused_brdf_render(*args), reps=50)
        ms_null = _event_ms(lambda: kr.fused_brdf_render(*no_lvis), reps=50)
        registers = [line.split("Used ")[1].split(",")[0]
                     for line in log.splitlines() if "Used " in line]
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print("%s: %.4f ms with lvis, %.4f ms without; max abs err %.3e "
              "(rough 0.05-0.95), %.3e (rough 0.02-0.1); ptxas %s; %s"
              % (name, ms, ms_null, float((got - want).abs().max()),
                 float((got_low - want_low).abs().max()), registers, spills))


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
    bad = list(args)
    bad[6] = args[6].cpu()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kr.fused_brdf_render(*bad)
    wide = _render_args(_inputs(8, 28, cuda_device))  # 1,568 lights
    with pytest.raises(ValueError, match="lights"):
        kr.fused_brdf_render(*wide)
    none = [a[:, :0] if i in (6, 7) else a for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="lights"):
        kr.fused_brdf_render(*none)


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
    odd = _vq_inputs(8, 30, 4, cuda_device, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        kv.vq_fused_train(*odd, **kw)
    many = _vq_inputs(8, 4, 300, cuda_device, False)
    with pytest.raises(ValueError, match="codes"):
        kv.vq_fused_train(*many, **kw)
    bad = list(args)
    flat = torch.empty((64 * 32 + 1,), device=cuda_device)
    bad[1] = flat[1:].view(64, 32).copy_(args[1])
    with pytest.raises(ValueError, match="aligned"):
        kv.vq_fused_train(*bad, **kw)
    bad = list(args)
    bad[4] = args[4].cpu()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kv.vq_fused_train(*bad, **kw)


@pytest.mark.cuda
def test_vq_kernel_shared_memory_size_agrees_with_the_source(cuda_device):
    lib = kv.load(kv.build()[0])
    for d, k in ((256, 15), (256, 8), (16, 4), (48, 3), (64, 40), (4, 256)):
        assert kv.smem_bytes(d, k) == lib.vq_fused_train_smem(d, k)


@pytest.mark.cuda
def test_vq_kernel_thousand_calls_on_end(cuda_device, monkeypatch):
    """1,000 calls on end at alternating N: the scratch buffer grows from 32
    to 64 to 128 blocks' worth, and equal inputs give equal bits every
    time, whatever the call before left in the scratch. Then a launch that
    is refused: the wrapper raises, and the next call is right again."""
    kw = dict(decay=0.999, epsilon=1e-5)
    monkeypatch.setattr(kv, "_scratch", {})
    sizes = (1000, 2048, 65536)
    cases = [_vq_inputs(n, 256, 15, cuda_device, True, seed=n) for n in sizes]
    first = [kv.vq_fused_train(*args, **kw) for args in cases]
    floats = [kv.scratch_floats(kv.grid_blocks(n), 256, 15) for n in sizes]
    assert floats == sorted(floats)
    assert kv._scratch[cuda_device.index].numel() == floats[-1]
    for out, args in zip(first, cases):
        plain = kv.vq_fused_train_reference(
            *[a.double() for a in args], **kw, indices=out["indices"])
        torch.testing.assert_close(out["update"].double(), plain["update"],
                                   rtol=1e-5, atol=1e-6)
    launches = kv.LAUNCHES
    for i in range(1000):
        out = kv.vq_fused_train(*cases[i % 3], **kw)
        for key in out:
            assert torch.equal(out[key], first[i % 3][key]), (i, key)
    assert kv.LAUNCHES == launches + 1000

    # more blocks than the card can hold at once: refused, not hung
    monkeypatch.setattr(kv, "grid_blocks", lambda n, sms: 4 * sms)
    with pytest.raises(RuntimeError, match="CUDA error"):
        kv.vq_fused_train(*cases[1], **kw)
    monkeypatch.undo()
    out = kv.vq_fused_train(*cases[1], **kw)
    for key in out:
        assert torch.equal(out[key], first[1][key]), key


def _profiled_device_ms(fn, reps):
    """(device time of one call in ms, kernel launches a call) from
    torch.profiler's kernel durations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)) for e in kernels)
    return us / 1e3 / reps, sum(e.count for e in kernels) / reps


@pytest.mark.cuda
def test_vq_kernel_is_one_launch_and_grid_sizes(cuda_device, monkeypatch):
    """One CUDA launch a call, counted by torch.profiler. Then a study, run
    with -s: the device time of a call at N 2,048 and N 65,536 for grids
    of exactly 16, 32, 64 and 128 blocks, beside the port's own sizing."""
    kw = dict(decay=0.999, epsilon=1e-5)
    for n in (2048, 65536):
        args = _vq_inputs(n, 256, 15, cuda_device, True)
        want = kv.vq_fused_train(*args, **kw)
        ms, per_call = _profiled_device_ms(
            lambda: kv.vq_fused_train(*args, **kw), 50)
        assert per_call == 1
        print("N %d, the port's grid of %d blocks: %.5f ms of device time a "
              "call" % (n, kv.grid_blocks(n), ms))
        with monkeypatch.context() as m:
            m.setattr(kv, "ROWS_PER_BLOCK", 8)
            for cap in (16, 32, 64, 128):
                m.setattr(kv, "MAX_BLOCKS", cap)
                assert kv.grid_blocks(n) == cap <= n // 8
                got = kv.vq_fused_train(*args, **kw)
                assert torch.equal(got["indices"], want["indices"])
                torch.testing.assert_close(got["update"], want["update"],
                                           rtol=1e-5, atol=1e-6)
                ms, _ = _profiled_device_ms(
                    lambda: kv.vq_fused_train(*args, **kw), 50)
                print("N %d, %d blocks: %.5f ms of device time a call"
                      % (n, cap, ms))


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
    ("default", 63), ("scale2", 4096 + 5), ("small", 1000), ("odd", 777),
    ("default", ks.TILE_ROWS - 1), ("default", ks.TILE_ROWS),
    ("default", ks.TILE_ROWS + 1), ("odd", ks.TILE_ROWS + 1)])
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
    ("default", 15), ("scale2", 4096 + 5), ("small", 1000), ("odd", 777),
    ("default", ks.TILE_ROWS // 4 - 1), ("default", ks.TILE_ROWS // 4),
    ("default", ks.TILE_ROWS // 4 + 1), ("odd", ks.TILE_ROWS // 4 + 1)])
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
    products run on the tensor cores; the flag touches the epilogue and the
    last layer's dot product). Built with -fmad=false beside it, both stay
    within the same tolerance of the plain versions. Run with -s to see the
    two builds' errors and times."""
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
def test_sdf_kernels_three_tf32_products_against_one(cuda_device,
                                                     monkeypatch):
    """The precision study: the port's build (each product split in three
    TF32 products, the small ones in an accumulator of their own) beside
    the three products in one accumulator (-DSDF_ONE_ACCUMULATOR, the design
    before) and the single-product build (-DSDF_TF32_PASSES=1), on sdf, the
    gradient, and lvis of 300 points x 512 lights through
    GeoExtractor._lvis_full. Only the port's build is held to the
    tolerances; run with -s to see the builds' times and errors."""
    from vqnerf_release_torch.models.neus import NeuSConfig, init_neus
    from vqnerf_release_torch.pipelines.gen_geo import GeoExtractor
    cfg = NeuSConfig()
    model = init_neus(0, cfg).to(cuda_device)
    packed = ks.pack_sdf(model.sdf, cfg.sdf)
    pts = _sdf_points(262144, cuda_device, seed=2)
    want = ks.sdf_fwdgrad_plain(packed, pts)
    rs = np.random.RandomState(4)
    normal = rs.randn(300, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    surf = 0.5 * normal  # the geometric init is a sphere of radius 0.5
    ds = types.SimpleNamespace(max_radius=1.0)
    lvis_plain = GeoExtractor(model, cfg, ds, "unused", use_fused_sdf=False,
                              vis_point_batch=16, device=cuda_device
                              )._lvis_full(surf, normal)
    errs = {}
    for name, flags in (("three products", ()),
                        ("one accumulator", ("-DSDF_ONE_ACCUMULATOR",)),
                        ("one product", ("-DSDF_TF32_PASSES=1",))):
        monkeypatch.setattr(ks, "_lib", ks.load(ks.build(flags)[0]))
        ms_fwd = _event_ms(lambda: ks.sdf_fwd(packed, pts))
        ms_grad = _event_ms(lambda: ks.sdf_fwdgrad(packed, pts))
        sdf, grad = ks.sdf_fwdgrad(packed, pts)
        ex = GeoExtractor(model, cfg, ds, "unused", device=cuda_device)
        assert ex.use_fused_sdf
        lvis = ex._lvis_full(surf, normal)
        errs[name] = (float((sdf - want[0]).abs().max()),
                      float((grad - want[1]).abs().max()),
                      float(np.abs(lvis - lvis_plain).max()))
        print("%s: fwd %.3f ms, fwdgrad %.3f ms at 262,144 points; max abs "
              "err sdf %.3e, grad %.3e, lvis (300 x 512) %.3e"
              % ((name, ms_fwd, ms_grad) + errs[name]))
        if not flags:
            torch.testing.assert_close(sdf, want[0], rtol=SDF_RTOL,
                                       atol=SDF_ATOL)
            torch.testing.assert_close(grad, want[1], rtol=SDF_RTOL,
                                       atol=SDF_ATOL)
            assert errs[name][2] <= 2e-3
    # the split is what buys the accuracy
    assert errs["three products"][0] < errs["one product"][0]


@pytest.mark.cuda
def test_sdf_kernels_where_the_time_goes(cuda_device, monkeypatch):
    """A study, run with -s: both kernels' times at the main path's sizes
    for the port's build, with the epilogue's arithmetic compiled out (the
    products alone; wrong results), and with a weight ring of 3 stages in
    place of 6 (equal bits); then 60 calls of the gradient kernel on end
    with the card's clock and power sampled beside them."""
    cfg, params, packed = _sdf_net("default", cuda_device)
    pts_fwd = _sdf_points(524288, cuda_device, seed=5)
    pts_grad = _sdf_points(1048576, cuda_device, seed=6)
    outputs = {}
    for name, flags in (("port's build", ()),
                        ("no activation", ("-DSDF_SKIP_ACTIVATION",)),
                        ("3 stages", ("-DSDF_STAGES=3",))):
        monkeypatch.setattr(ks, "_lib", ks.load(ks.build(flags)[0]))
        ms_fwd = _event_ms(lambda: ks.sdf_fwd(packed, pts_fwd), reps=5)
        ms_grad = _event_ms(lambda: ks.sdf_fwdgrad(packed, pts_grad), reps=5)
        outputs[name] = ks.sdf_fwdgrad(packed, pts_grad[:4096])
        print("%s: fwd %.3f ms at 524,288 points, fwdgrad %.3f ms at "
              "1,048,576 points" % (name, ms_fwd, ms_grad))
    for got, want in zip(outputs["3 stages"], outputs["port's build"]):
        assert torch.equal(got, want)
    monkeypatch.setattr(ks, "_lib", ks.load(ks.build()[0]))
    ms, samples = _event_ms_beside_smi(
        lambda: ks.sdf_fwdgrad(packed, pts_grad), reps=60)
    print("60 calls on end: %.3f ms a call; clocks.sm, power.draw: %s"
          % (ms, samples))


@pytest.mark.cuda
def test_sdf_library_holds_tensor_core_instructions(cuda_device):
    """Both kernels' products are wgmma instructions in the built library's
    machine code: three a depth-8 step, in two kernels."""
    so, _ = ks.build()
    count = ks.tensor_core_instructions(so)
    print("tensor-core instructions in", so.name, ":", count)
    assert count >= 6


def _wgmma_probe(a, w):
    """a [64, 8 steps] times w [8 steps, out <= 256] through the SDF
    kernel's own wgmma path (csrc/wgmma_probe.cu) and pack_sdf's tiling."""
    import ctypes
    so, _ = ks.kbuild.build(ks.kbuild.CSRC_DIR / "wgmma_probe.cu", "probe")
    ptr = ctypes.c_void_p
    lib = ks.kbuild.load(so, {"wgmma_probe": [ptr, ptr, ptr, ctypes.c_int,
                                              ptr]})
    tiles = ks._tile_weights(w).reshape(-1)
    d = torch.empty((64, ks.MAX_WIDTH), device=a.device)
    err = lib.wgmma_probe(a.contiguous().data_ptr(), tiles.data_ptr(),
                          d.data_ptr(), a.shape[1] // ks.TILE_K,
                          torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    return d[:, :w.shape[1]]


@pytest.mark.cuda
def test_packed_tiles_descriptor_and_fragments_give_the_product(cuda_device):
    """Small integers are exact in TF32 and in the sums, so the product
    through the packed tiles, the matrix descriptor and the register
    fragments must equal a @ w bit for bit."""
    rs = np.random.RandomState(7)
    a = torch.as_tensor(rs.randint(-4, 5, (64, 40)).astype(np.float32),
                        device=cuda_device)
    w = torch.as_tensor(rs.randint(-4, 5, (40, 217)).astype(np.float32),
                        device=cuda_device)
    assert torch.equal(_wgmma_probe(a, w), a @ w)


@pytest.mark.cuda
def test_tensor_core_accumulator_rounding(cuda_device):
    """How the fp32 accumulator of a TF32 wgmma rounds: 1 + 0.75 ulp and
    1 + 1.75 ulp, within one instruction and across two. Round to nearest
    would give 1 and 2 ulp; the H100 truncates (0 and 1 ulp across
    instructions), which is why the split-TF32 kernels' error is above
    that of fp32 FMAs. Only the envelope is asserted; run with -s."""
    ulp = 2.0**-23
    for what, rows in (
            ("one instruction, 1 + 0.75 ulp", [[1.0, 0.75 * ulp]]),
            ("one instruction, 1 + 0.5 ulp + 0.5 ulp",
             [[1.0, 0.5 * ulp, 0.5 * ulp]]),
            ("two instructions, 1 then + 0.75 ulp", [[1.0], [0.75 * ulp]]),
            ("two instructions, 1 then + 1.75 ulp", [[1.0], [1.75 * ulp]]),
            ("two instructions, -1 then - 0.75 ulp",
             [[-1.0], [-0.75 * ulp]])):
        a = torch.zeros((64, 8 * len(rows)), device=cuda_device)
        w = torch.zeros((8 * len(rows), 8), device=cuda_device)
        for step, vals in enumerate(rows):
            for k, v in enumerate(vals):
                a[0, 8 * step + k] = v
                w[8 * step + k, 0] = 1.0
        got = float(_wgmma_probe(a, w)[0, 0])
        exact = sum(sum(vals) for vals in rows)
        off = (abs(got) - 1.0) / ulp
        print("%s: 1 %+g ulp (exact %+g ulp)"
              % (what, off, (abs(exact) - 1.0) / ulp))
        assert abs(got - exact) < ulp  # truncated or rounded, never worse


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


@pytest.mark.cuda
def test_vq_kernel_where_the_time_goes(cuda_device, monkeypatch):
    """A study, run with -s: the kernel built with -DVQ_TIMING stamps the
    SM's cycle counter at the ends of each block's phases. Printed: the
    median cycles of every phase over the blocks, and the nanoseconds from
    the first block's start to the last block's end."""
    phases = ("set-up", "rows", "block sums", "grid barrier",
              "counts and smoothing", "slots and epilogue")
    kw = dict(decay=0.999, epsilon=1e-5)
    monkeypatch.setattr(kv, "_lib", kv.load(kv.build(("-DVQ_TIMING",))[0]))
    monkeypatch.setattr(kv, "_scratch", {})
    plain_size = kv.scratch_floats
    monkeypatch.setattr(kv, "scratch_floats",
                        lambda b, d, k: plain_size(b, d, k) + 32 * b)
    for n in (2048, 65536):
        args = _vq_inputs(n, 256, 15, cuda_device, True)
        blocks = kv.grid_blocks(n)
        for _ in range(3):
            kv.vq_fused_train(*args, **kw)
        torch.cuda.synchronize()
        at = plain_size(blocks, 256, 15)
        t = kv._scratch[cuda_device.index][at:at + 32 * blocks]
        t = t.view(torch.int64).view(blocks, 16).cpu().numpy()
        cycles = np.median(np.diff(t[:, :7], axis=1), axis=0)
        print("N %d, %d blocks, median cycles of a block: %s; first start "
              "to last end %d ns; starts spread over %d ns"
              % (n, blocks,
                 ", ".join("%s %d" % pc for pc in zip(phases, cycles)),
                 t[:, 11].max() - t[:, 10].min(),
                 t[:, 10].max() - t[:, 10].min()))


def _neus_batch(n, device, seed=0):
    """n rays from a circle of radius 2 toward the unit cube's middle, with
    colour, a mask and the bounds of a 0.5..3.5 scene."""
    rs = np.random.RandomState(seed)
    ang = rs.rand(n) * 2 * np.pi
    o = np.stack([2 * np.sin(ang), 0.3 + 0 * ang, 2 * np.cos(ang)], 1)
    d = -o + rs.randn(n, 3) * 0.15
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    arrays = dict(rays_o=o, rays_d=d, rgb=rs.rand(n, 3),
                  mask=(rs.rand(n, 1) > 0.5), near=np.full((n, 1), 0.5),
                  far=np.full((n, 1), 3.5), valid=np.ones((n, 1)))
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in arrays.items()}


def _neus_setup(device, n_rays=512):
    """The default NeuS widths under the shipped carve sampler (24+8r2 over
    a 32^3 grid of the init sphere), one step's uniforms drawn outside."""
    from vqnerf_release_torch.models.neus import NeuSConfig, init_neus
    from vqnerf_release_torch.ops.occupancy import build_occ_grid
    from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig
    cfg = NeuSConfig(n_samples=24, n_importance=8, up_sample_steps=2)
    tcfg = NeuSTrainConfig(warm_up_end=0, end_iter=1000, occ_res=32)
    model = init_neus(0, cfg).to(device)
    grid = build_occ_grid(model.sdf, cfg.sdf, 2.5, res=32)
    rand = {"occ_u": torch.rand((n_rays, cfg.n_samples),
                                generator=torch.Generator().manual_seed(1)
                                ).to(device)}
    return cfg, tcfg, model, grid, rand, _neus_batch(n_rays, device)


@pytest.mark.cuda
def test_neus_training_step_fused_against_plain(cuda_device):
    """One NeuS training step at the default widths with the up-sample
    chain through sdf_fwd (use_fused_sdf=None on CUDA tensors) against the
    same step with use_fused_sdf=False: kernel 3 launches up_sample_steps
    times in the first and never in the second; the metrics agree to
    rtol 1e-3 (the kernel's ~3e-5 on the SDF moves the up-sampled
    positions a little); Adam's first step moves every element by at most
    lr, and 99% of the elements move alike to 1e-3 lr."""
    import copy
    from vqnerf_release_torch.train.neus_trainer import make_neus_train_step
    cfg, tcfg, model0, grid, rand, batch = _neus_setup(cuda_device)
    out = {}
    for fused in (None, False):
        model = copy.deepcopy(model0)
        _, step = make_neus_train_step(model, cfg, tcfg, 2.5, with_occ=True,
                                       use_fused_sdf=fused)
        before = ks.LAUNCHES["sdf_fwd"]
        m = step(batch, 500, occ_grid=grid, rand=rand)
        torch.cuda.synchronize()
        launched = ks.LAUNCHES["sdf_fwd"] - before
        assert launched == (cfg.up_sample_steps if fused is None else 0)
        out[fused] = ({k: float(v) for k, v in m.items()},
                      torch.cat([(p - p0).reshape(-1) for p, p0 in zip(
                          model.parameters(), model0.parameters())]))
    (m_k, d_k), (m_p, d_p) = out[None], out[False]
    assert m_k["nonfinite_grads"] == m_p["nonfinite_grads"] == 0.0
    for k in m_p:
        np.testing.assert_allclose(m_k[k], m_p[k], rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    lr = m_p["lr"]
    assert float(d_k.abs().max()) <= 1.001 * lr
    close = (d_k - d_p).abs() <= 1e-3 * lr
    assert float(close.float().mean()) >= 0.99


@pytest.mark.cuda
def test_pack_sdf_is_redone_after_each_step(cuda_device):
    """After a training step the kernel must read the new weights: a pack
    of the updated net agrees with the plain SDF of that net, while the pack
    made before the step (stale) is off by far more than the kernel's
    tolerance."""
    from vqnerf_release_torch.train.neus_trainer import make_neus_train_step
    cfg, tcfg, model, grid, rand, batch = _neus_setup(cuda_device)
    stale = ks.pack_sdf(model.sdf, cfg.sdf)
    _, step = make_neus_train_step(model, cfg, tcfg, 2.5, with_occ=True)
    for i in range(3):
        step(batch, 500 + i, occ_grid=grid, rand=rand)
    fresh = ks.pack_sdf(model.sdf, cfg.sdf)
    pts = _sdf_points(65536, cuda_device)
    with torch.no_grad():
        want = fields.sdf_only(model.sdf, pts, cfg.sdf)
    torch.testing.assert_close(ks.sdf_fwd(fresh, pts), want, rtol=SDF_RTOL,
                               atol=SDF_ATOL)
    off = float((ks.sdf_fwd(stale, pts) - want).abs().max())
    assert off > 20 * SDF_ATOL, off


@pytest.mark.cuda
def test_ref_nfr_step_cuda_matches_cpu(cuda_device):
    """One ref_nfr training step on the card against the same step on the
    CPU: losses, the trainable part (rtol 1e-3 / atol 1e-5, as the vq_nfr
    step above), and the frozen part bit for bit unchanged."""
    import copy
    from vqnerf_release_torch.models.ref_nfr import init_ref_nfr
    from vqnerf_release_torch.train.decomp_trainer import make_ref_nfr_step
    cfg = dc.DecompConfig(light_h=4, num_embed=6, num_drop=3, z_dim=64,
                          mlp_width=32, thres_str="0.1;0.2;0.3")
    gen = torch.Generator().manual_seed(0)
    nfr = init_nfr_unit(gen, cfg)
    centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
    vq, _ = init_vq_nfr(gen, cfg, nfr, centers)
    ref_cpu = init_ref_nfr(gen, cfg, vq, torch.rand((4, 8, 3),
                                                    generator=gen))
    rs = np.random.RandomState(1)
    n = 256
    normal = rs.randn(n, 3)
    batch = dict(
        rayo=np.tile([0.0, 0.0, 3.0], (n, 1)), xyz=rs.rand(n, 3) - 0.5,
        normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        alpha=(rs.rand(n, 1) > 0.2), rgb=rs.rand(n, 3),
        lvis=rs.rand(n, cfg.n_lights), ref=rs.rand(n, 3))
    batch = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in batch.items()}
    results = {}
    for device in (torch.device("cpu"), cuda_device):
        model = copy.deepcopy(ref_cpu).to(device)
        _, step = make_ref_nfr_step(model, cfg,
                                    *dc.light_constants(cfg, device))
        ld = step({k: v.to(device) for k, v in batch.items()}, 0)
        results[device.type] = (
            {k: float(v) for k, v in ld.items()},
            {k: v.cpu() for k, v in model.state_dict().items()})
    (ld_c, sd_c), (ld_g, sd_g) = results["cpu"], results["cuda"]
    assert ld_g["nonfinite_grads"] == 0.0
    for k in ld_c:
        np.testing.assert_allclose(ld_g[k], ld_c[k], rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    frozen0 = ref_cpu.state_dict()
    for k in sd_c:
        if k.startswith("frozen."):
            assert torch.equal(sd_g[k], frozen0[k]), k
        else:
            assert not torch.equal(sd_g[k], frozen0[k]), k
            torch.testing.assert_close(sd_g[k], sd_c[k], rtol=1e-3,
                                       atol=1e-5, msg=k)
