"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Every test here is marked `cuda` and skips without a GPU. The file imports
neither jax nor cv2, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(--noconftest because tests/conftest.py configures jax.)

Tolerance of the render kernel, rtol=2e-4, atol=1e-5: the JAX kernel test's
own (tests/test_pallas_render.py), for a sum over L lights in another order.
Its vector and scalar instances, its variants behind macros and the 16-byte
loads in its machine code are checked here too. The multi-map kernel of the
same source is held at that tolerance to its twin and, at the relight pass's
chunks, to the plain relight path on the card.

The VQ kernel is held to its plain version in two stages, so that a
near-tie does not look like a fault: (i) equal indices except on rows whose
two smallest plain distances lie within 1e-5 of each other; (ii) every other
output against the plain version fed the kernel's indices and evaluated in
float64, at rtol 1e-5 / atol 1e-6. It is one cooperative launch a call, and
equal inputs must give equal bits, call after call.

A relight call's per-row half replayed as a CUDA graph
(``train/graphed.py::CallGraphs``) is held to the eager call bit for bit,
call after call, with outputs that no later replay overwrites.

The two SDF kernels are held to their plain versions at rtol 1e-4 / atol
1e-5 (sums of up to 256 terms taken in another order than cuBLAS takes
them, each product split in three TF32 products on the tensor cores,
through eight layers), and to the autograd gradient at the JAX kernel
test's own rtol 3e-3 / atol 3e-4.
"""

import os
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
from vqnerf_release_torch.models import vq_nfr
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


def _maps_args(t, n_maps, seed, with_lvis=True):
    """The per-ray inputs of ``t`` with unit normals, its lvis and a table
    of ``n_maps`` maps: skies with a bright sun and, every third, an OLAT of
    200. Unit normals, as the geometry buffers hold: the plain relight path
    (the twin) weights a light by its cosine to the normal as given, the
    kernels to the normalised one."""
    t["normal"] = t["normal"] / t["normal"].norm(dim=1, keepdim=True)
    l = t["lxyz"].shape[0]
    g = torch.Generator(device=t["xyz"].device).manual_seed(seed)
    maps = torch.rand((n_maps, l, 3), generator=g, device=t["xyz"].device)
    maps[:, l // 3] += 20.0
    maps[2::3] = 0.0
    maps[2::3, l // 2] = 200.0
    table = kr.pack_light_maps(t["lxyz"], t["lareas"], maps)
    return [t[k] for k in _PER_RAY] + [t["lvis"] if with_lvis else None,
                                       table], maps


@pytest.mark.cuda
@pytest.mark.parametrize("n,light_h,n_lights,n_maps,with_lvis,instance", [
    (49152, 16, None, 21, True, "maps_vector"),   # a relight chunk
    (16384, 16, None, 21, True, "maps_vector"),   # a view's ragged last
    (1000, 16, None, 21, False, "maps_vector"),
    (1000, 16, None, 2, True, "maps_vector"),     # 2 maps, a pass of 24
    (1000, 16, None, 30, True, "maps_vector"),    # two passes of 24
    (37, 16, 510, 21, True, "maps_scalar"),
    (1, 26, None, 9, True, "maps_vector"),        # 1,352 lights: 8 a pass
])
def test_maps_kernel_matches_twin(cuda_device, n, light_h, n_lights,
                                  n_maps, with_lvis, instance):
    """The multi-map kernel against its plain twin at the render kernel's
    tolerance; one launch a pass, of the instance the launcher chooses."""
    t = _inputs(n, light_h, cuda_device, seed=n + n_maps, n_lights=n_lights)
    args, _ = _maps_args(t, n_maps, seed=n_maps, with_lvis=with_lvis)
    l = args[7].shape[1]
    per_pass = 24 if (4 + 3 * 24) * 4 * l <= 232448 else 8
    before = dict(kr.LAUNCHES_BY_INSTANCE)
    launches = kr.LAUNCHES
    got = kr.fused_brdf_render_maps(*args)
    torch.cuda.synchronize()
    after = dict(before)
    after[instance] += -(-n_maps // per_pass)
    assert kr.LAUNCHES_BY_INSTANCE == after and kr.LAUNCHES == launches
    assert got.shape == (n, n_maps, 3)
    want = kr.fused_brdf_render_maps_reference(*args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    print("%d rays x %d lights x %d maps: max abs err %.3e"
          % (n, l, n_maps, float((got - want).abs().max())))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49152, 16384])
def test_maps_kernel_rounds_as_the_plain_relight_path(cuda_device, n):
    """At the relight pass's chunks (49,152 rows, and a 512x512 view's last
    16,384), the multi-map kernel against the plain relight path on the
    card (render_equation over microfacet_brdf, as vq_fast_render computed
    it before), at the render kernel's tolerance over roughness 0.05-0.95:
    its chain into the GGX term rounds as that path's (whose sum and dot
    orders PyTorch takes for these shapes), where the GGX peak turns a last
    bit of cos_nh into relative errors of 1e-3 and more. Kernel 1's gap to
    the same path is printed beside it."""
    from vqnerf_release_torch.ops.microfacet import microfacet_brdf
    from vqnerf_release_torch.ops.render import render_equation
    t = _inputs(n, 16, cuda_device, seed=11)
    args, maps = _maps_args(t, 21, seed=11)
    surf2c = t["surf2c"] / t["surf2c"].norm(dim=1, keepdim=True)
    args[2] = surf2c
    surf2l = dc.calc_ldir(t["lxyz"], t["xyz"])
    brdf, _, _ = microfacet_brdf(surf2l, surf2c, t["normal"],
                                 albedo=t["albedo"], rough=t["rough"],
                                 f0=t["f0"])
    plain = render_equation(brdf, surf2l, t["normal"], t["lareas"], maps,
                            light_vis=t["lvis"], probe_batch=True)
    del brdf, surf2l
    clip = lambda x: torch.clamp(x, 0.0, 1.0)  # noqa: E731
    got = clip(kr.fused_brdf_render_maps(*args))
    one = clip(torch.stack([kr.fused_brdf_render(
        *args[:7], kr.pack_lights(t["lxyz"], t["lareas"], maps[e]))
        for e in range(21)], dim=1))
    units = lambda a: float(((a - plain).abs()  # noqa: E731
                             / (ATOL + RTOL * plain.abs())).max())
    print("%d rows, against the plain relight path, in units of the "
          "tolerance: multi-map kernel %.3f, kernel 1 %.3f"
          % (n, units(got), units(one)))
    torch.testing.assert_close(got, plain, rtol=RTOL, atol=ATOL)


def _cublas_version():
    """cuBLAS' version as the library PyTorch loaded reports it, or None."""
    import ctypes
    try:
        lib = ctypes.CDLL("libcublas.so.%s" % torch.version.cuda.split(".")[0])
        parts = []
        for prop in range(3):  # MAJOR_VERSION, MINOR_VERSION, PATCH_LEVEL
            v = ctypes.c_int(0)
            if lib.cublasGetProperty(prop, ctypes.byref(v)) != 0:
                return None
            parts.append(str(v.value))
        return ".".join(parts)
    except (OSError, AttributeError):
        return None


@pytest.mark.cuda
@pytest.mark.parametrize("n", [49152, 16384])
def test_torch_keeps_the_orders_the_maps_kernel_copies(cuda_device, n):
    """The multi-map kernel's chain into the GGX term (AS_TORCH in the
    source) copies two orders that PyTorch and cuBLAS choose on the card
    for the plain relight path's shapes, and that no API promises:
    torch.sum over a last dimension of 3 (safe_l2_normalize) adds
    (x^2 + z^2) + y^2, and einsum("nlk,nk->nl") over 3 (microfacet_brdf's
    cosines, a batched gemv) gives z b_z + fma(y, b_y, x b_x). Held bit for
    bit at the relight pass's chunks (49,152 rows and a 512x512 view's last
    16,384, 512 lights): a PyTorch or cuBLAS that orders them otherwise
    fails here, and the relight cell's limit on its sRGB renders is then to
    be derived again. Prints the versions held."""
    from vqnerf_release_torch.ops.math import safe_l2_normalize
    t = _inputs(n, 16, cuda_device, seed=3)
    v = t["lxyz"][None] - t["xyz"][:, None]  # [N, L, 3]
    x, y, z = v.unbind(-1)
    ss = torch.sum(torch.square(v), dim=2)
    h = safe_l2_normalize(v, axis=2)
    nrm = safe_l2_normalize(t["normal"], axis=1)
    dot = torch.einsum("nlk,nk->nl", h, nrm)
    hx, hy, hz = h.unbind(-1)
    by = lambda i: nrm[:, None, i]  # noqa: E731
    want_dot = hz * by(2) + kr._fma(hy, by(1), hx * by(0))
    print("torch %s, CUDA %s, cuBLAS %s, %d rows: sums of squares %d of %d "
          "as (x^2 + z^2) + y^2, dot products %d of %d as z b_z + fma(y, "
          "b_y, x b_x)" % (torch.__version__, torch.version.cuda,
                           _cublas_version(), n,
                           int((ss == (x * x + z * z) + y * y).sum()),
                           ss.numel(), int((dot == want_dot).sum()),
                           dot.numel()))
    assert torch.equal(ss, (x * x + z * z) + y * y)
    assert torch.equal(dot, want_dot)


@pytest.mark.cuda
def test_maps_kernel_takes_the_scalar_instance_off_alignment(cuda_device):
    """An lvis 4 bytes off a 16-byte boundary takes the scalar instance,
    which sums in kernel 1's scalar order: within the tolerance of the
    twin."""
    t = _inputs(1000, 16, cuda_device, seed=5)
    args, _ = _maps_args(t, 21, seed=5)
    flat = torch.empty((1000 * 512 + 1,), device=cuda_device)
    off = flat[1:].view(1000, 512)
    off.copy_(t["lvis"])
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    before = kr.LAUNCHES_BY_INSTANCE["maps_scalar"]
    got = kr.fused_brdf_render_maps(*args[:6], off, args[7])
    torch.cuda.synchronize()
    assert kr.LAUNCHES_BY_INSTANCE["maps_scalar"] == before + 1
    torch.testing.assert_close(got, kr.fused_brdf_render_maps_reference(
        *args), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_maps_kernel_rejects_bad_inputs(cuda_device):
    t = _inputs(64, 4, cuda_device)
    args, _ = _maps_args(t, 3, seed=0)
    bad = list(args)
    bad[7] = args[7][:-1].contiguous()
    with pytest.raises(ValueError, match="rows"):
        kr.fused_brdf_render_maps(*bad)
    bad = list(args)
    bad[6] = args[6][:, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        kr.fused_brdf_render_maps(*bad)
    wide = _inputs(4, 33, cuda_device)  # 2,178 lights: no pass fits
    wide_args, _ = _maps_args(wide, 3, seed=0)
    with pytest.raises(ValueError, match="lights"):
        kr.fused_brdf_render_maps(*wide_args)


@pytest.mark.cuda
def test_render_maps_library_holds_16_byte_loads(cuda_device):
    """The multi-map vector instances read lvis with LDG.E.128 and each
    map's row of the table with LDS.128; registers hold the sums (no
    local memory)."""
    functions = kr.kbuild.sass_functions(kr.build()[0])
    for maps in (8, 24):
        for lvis in ("1", "0"):
            key = "render_maps_kernelILi4ELb%sELi%dE" % (lvis, maps)
            found = [ins for name, ins in functions.items() if key in name]
            assert len(found) == 1, (key, list(functions))
            assert _sass_count(found[0], r"LDS\.128") >= 4 + 3 * maps
            assert _sass_count(found[0], r"\b(LDL|STL)") == 0
            if lvis == "1":
                assert _sass_count(found[0], _LDG_128) >= 1


def _relight_model_and_view(device, imh=512, seed=0):
    """vq_nfr at the relight cell's widths (random weights) and one
    imh x imh view of a sphere seen from +z with random lvis."""
    cfg = dc.DecompConfig()
    gen = torch.Generator().manual_seed(seed)
    nfr = init_nfr_unit(gen, cfg)
    centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
    model = init_vq_nfr(gen, cfg, nfr, centers)[0].to(device).eval()
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, imh, device=device),
                            torch.linspace(-1, 1, imh, device=device),
                            indexing="ij")
    xy = torch.stack((xs, ys), -1).reshape(-1, 2) * 0.7
    r2 = (xy * xy).sum(-1, keepdim=True)
    inside = r2 < 0.36
    z = torch.sqrt(torch.clamp(0.36 - r2, min=0.0))
    xyz = torch.cat((xy, z), -1)
    g = torch.Generator(device=device).manual_seed(seed)
    view = {"xyz": xyz, "normal": xyz / 0.6, "alpha": inside.float(),
            "rayo": torch.tensor([[0.0, 0.0, 3.0]], device=device).expand(
                xyz.shape[0], 3).contiguous(),
            "lvis": torch.rand((xyz.shape[0], cfg.n_lights), generator=g,
                               device=device)}
    return cfg, model, view


def _relight_maps(cfg, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    l = cfg.n_lights
    probes = 0.2 + torch.rand((16, l, 3), generator=g, device=device)
    probes[:, 37] += 20.0
    olats = torch.zeros((4, l, 3), device=device)
    for k in range(4):
        olats[k, 128 + 8 * k] = 200.0
    return probes, olats


@pytest.mark.cuda
def test_vq_fast_render_relights_a_view_in_six_launches(cuda_device,
                                                        monkeypatch):
    """A whole 512x512 view through vq_fast_render in the relight pass's
    chunks of 49,152 rows under 16 probes and 4 OLATs: 6 launches of the
    multi-map kernel (one a chunk, every map in it), none of kernel 1, no
    plain relight; every output within the relight cell's limits of the
    plain path (maps 2e-5, sRGB renders 2e-4)."""
    from vqnerf_release_torch.utils import profiling
    cfg, model, view = _relight_model_and_view(cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    probes, olats = _relight_maps(cfg, cuda_device)
    calls = []
    monkeypatch.setattr(profiling, "count",
                        lambda name, n=1: calls.append((name, n)))
    chunk, n = 49152, view["xyz"].shape[0]
    out = {}
    for fused in (True, False):
        c = dc.DecompConfig(use_fused_render=fused)
        before = dict(kr.LAUNCHES_BY_INSTANCE)
        with torch.inference_mode():
            preds = [vq_nfr.vq_fast_render(
                model, {k: v[i:i + chunk] for k, v in view.items()}, c,
                lxyz, lareas, novel_probes=probes, novel_olat=olats)
                for i in range(0, n, chunk)]
        torch.cuda.synchronize()
        out[fused] = {k: torch.cat([p[k] for p in preds]) for k in preds[0]}
        if fused:
            assert kr.LAUNCHES_BY_INSTANCE == dict(
                before, maps_vector=before["maps_vector"] + 6)
    # the fused calls replay a CUDA graph of each chunk shape, captured on
    # its first call: 49,152 rows (chunks 1-5) and 16,384 (chunk 6)
    fused_call = [("render.relight_fused", 1),
                  ("render.relight_fused.maps", 21)]
    capture = [("render.relight_graph.captures", 1)] + fused_call
    replay = [("render.relight_graph.replays", 1)] + fused_call
    assert calls == capture + replay * 4 + capture + [
        ("render.relight_plain", 1), ("render.relight_plain.maps", 21)] * 6
    gaps = {k: float((out[True][k] - out[False][k]).abs().max())
            for k in out[False]}
    print("relight view, multi-map kernel against the plain path:", gaps)
    for k in ("basecolor", "albedo", "spec", "rough"):
        assert gaps[k] <= 2e-5, k
    for k in ("rgb", "rgb_probes", "rgb_olat"):
        assert gaps[k] <= 2e-4, k


def _eager_relight(model, chunk, cfg, lxyz, lareas, probes, olats):
    """vq_fast_render's outputs as the eager path gives them: with grad on
    no call replays a graph."""
    with torch.enable_grad():
        out = vq_nfr.vq_fast_render(model, chunk, cfg, lxyz, lareas,
                                    novel_probes=probes, novel_olat=olats)
    return {k: v.detach() for k, v in out.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [49152, 16384])
def test_relight_graph_replays_equal_the_eager_call(cuda_device, rows):
    """At the relight pass's two chunk shapes, with the learned light, 16
    probes, 4 OLATs and lvis: the first call (eager, then the capture) and
    two replays equal the eager render bit for bit on every output key,
    and return the caller's alpha."""
    cfg, model, view = _relight_model_and_view(cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    probes, olats = _relight_maps(cfg, cuda_device)
    chunk = {k: v[:rows] for k, v in view.items()}
    want = _eager_relight(model, chunk, cfg, lxyz, lareas, probes, olats)
    with torch.inference_mode():
        got = [vq_nfr.vq_fast_render(model, chunk, cfg, lxyz, lareas,
                                     novel_probes=probes, novel_olat=olats)
               for _ in range(3)]
    torch.cuda.synchronize()
    for out in got:
        assert out["alpha"] is chunk["alpha"]
        assert list(out) == list(want)
        for k, v in want.items():
            assert out[k].shape == v.shape, k
            assert torch.equal(out[k], v), k


@pytest.mark.cuda
def test_relight_graph_calls_return_fresh_outputs(cuda_device):
    """Five consecutive replays on five different chunks of a view, kept
    until all are issued, as a request keeps its chunks: five distinct
    outputs, each its own chunk's eager render bit for bit (no output is a
    graph buffer that a later replay overwrites)."""
    cfg, model, view = _relight_model_and_view(cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    probes, olats = _relight_maps(cfg, cuda_device)
    chunk = 49152
    chunks = [{k: v[i:i + chunk] for k, v in view.items()}
              for i in range(0, 5 * chunk, chunk)]
    with torch.inference_mode():
        vq_nfr.vq_fast_render(model, chunks[0], cfg, lxyz, lareas,
                              novel_probes=probes, novel_olat=olats)
        got = [vq_nfr.vq_fast_render(model, c, cfg, lxyz, lareas,
                                     novel_probes=probes, novel_olat=olats)
               for c in chunks]
    want = [_eager_relight(model, c, cfg, lxyz, lareas, probes, olats)
            for c in chunks]
    torch.cuda.synchronize()
    assert len({out["basecolor"].data_ptr() for out in got}) == 5
    for i, (out, ref) in enumerate(zip(got, want)):
        for k, v in ref.items():
            assert torch.equal(out[k], v), (i, k)
    for a, b in zip(got, got[1:]):
        for k in ("basecolor", "rough", "rgb_probes"):
            assert not torch.equal(a[k], b[k]), k


@pytest.mark.cuda
def test_relight_graph_counts_captures_replays_and_launches(cuda_device,
                                                            monkeypatch):
    """Two 512x512 views in the relight pass's chunks: one capture a chunk
    shape, a replay for every later call; the multi-map kernel's launch
    counter still rises by 6 a view and the relight counters by one a
    call. A call with grad on runs eagerly: no capture, no replay."""
    from vqnerf_release_torch.utils import profiling
    cfg, model, view = _relight_model_and_view(cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    probes, olats = _relight_maps(cfg, cuda_device)
    counts = {}

    def count(name, n=1):
        counts[name] = counts.get(name, 0) + n

    monkeypatch.setattr(profiling, "count", count)
    chunk, n = 49152, view["xyz"].shape[0]
    for _ in range(2):
        before = kr.LAUNCHES_BY_INSTANCE["maps_vector"]
        with torch.inference_mode():
            for i in range(0, n, chunk):
                vq_nfr.vq_fast_render(
                    model, {k: v[i:i + chunk] for k, v in view.items()},
                    cfg, lxyz, lareas, novel_probes=probes,
                    novel_olat=olats)
        torch.cuda.synchronize()
        assert kr.LAUNCHES_BY_INSTANCE["maps_vector"] == before + 6
    assert counts == {"render.relight_graph.captures": 2,
                      "render.relight_graph.replays": 10,
                      "render.relight_fused": 12,
                      "render.relight_fused.maps": 12 * 21}
    with torch.enable_grad():
        vq_nfr.vq_fast_render(model, {k: v[:chunk] for k, v in view.items()},
                              cfg, lxyz, lareas, novel_probes=probes,
                              novel_olat=olats)
    assert counts["render.relight_graph.captures"] == 2
    assert counts["render.relight_graph.replays"] == 10
    assert counts["render.relight_fused"] == 13


@pytest.mark.cuda
def test_relight_chunk_memory_far_under_the_plain_path(cuda_device):
    """The peak memory of one relight chunk (49,152 rows, 21 maps) above
    what it starts from: the multi-map path holds no [N, L, 3] tensor
    (302 MB each at this size), the plain path several."""
    cfg, model, view = _relight_model_and_view(cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    probes, olats = _relight_maps(cfg, cuda_device)
    chunk = {k: v[:49152] for k, v in view.items()}
    peak = {}
    for fused in (True, False):
        c = dc.DecompConfig(use_fused_render=fused)
        with torch.inference_mode():
            vq_nfr.vq_fast_render(model, chunk, c, lxyz, lareas,
                                  novel_probes=probes, novel_olat=olats)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            vq_nfr.vq_fast_render(model, chunk, c, lxyz, lareas,
                                  novel_probes=probes, novel_olat=olats)
            torch.cuda.synchronize()
        peak[fused] = torch.cuda.max_memory_allocated() - base
    print("relight chunk peak above its start: multi-map %.1f MB, plain "
          "%.1f MB" % (peak[True] / 1e6, peak[False] / 1e6))
    assert peak[True] * 8 < peak[False]
    assert peak[True] < 302_000_000


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


@pytest.mark.cuda
def test_vq_kernel_refused_launches_leave_no_error(cuda_device, monkeypatch):
    """Two launches the card refuses (more blocks than it can hold at once)
    each raise with their own error, and the good call after them launches
    and gives the bits it gave before them: a refused launch leaves no
    error behind for the next call to report."""
    kw = dict(decay=0.999, epsilon=1e-5)
    monkeypatch.setattr(kv, "_scratch", {})
    args = _vq_inputs(2048, 256, 15, cuda_device, True, seed=7)
    want = kv.vq_fused_train(*args, **kw)
    with monkeypatch.context() as m:
        m.setattr(kv, "grid_blocks", lambda n, sms: 4 * sms)
        for _ in range(2):
            with pytest.raises(RuntimeError, match="CUDA error 720"):
                kv.vq_fused_train(*args, **kw)
    launches = kv.LAUNCHES
    got = kv.vq_fused_train(*args, **kw)
    torch.cuda.synchronize()
    assert kv.LAUNCHES == launches + 1
    for key in want:
        assert torch.equal(got[key], want[key]), key


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


def nested_vfg(params, x, cfg):
    """(sdf, feature, grad) by nested autograd, differentiable in the
    points x (a leaf that requires grad) and in the parameters: the
    reference for models/sdf_manual.py."""
    out = fields.sdf_apply(params, x, cfg)
    (grad,) = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    return out[:, :1], out[:, 1:], grad


def sdf_manual_loss(sdf, feature, grad):
    """A loss that reads all three outputs (an Eikonal term and a grad x
    feature cross term among them), so every cotangent is nonzero."""
    eik = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    return (torch.sum(torch.sin(sdf)) * 0.3 + eik
            + torch.sum(feature**2) * 0.01
            + torch.sum(grad * torch.cos(feature[:, :3])))


def sdf_manual_against_nested(params, x, cfg):
    """(manual outputs, largest gradient error scaled by the gradient's
    max) of sdf_manual_loss over every parameter and x, against nested
    autograd; every manual gradient finite."""
    from vqnerf_release_torch.models.sdf_manual import sdf_vfg_manual
    wrt = list(params.parameters())
    xm = x.detach().clone().requires_grad_(True)
    xn = x.detach().clone().requires_grad_(True)
    manual = sdf_vfg_manual(params, xm, cfg)
    nested = nested_vfg(params, xn, cfg)
    got = torch.autograd.grad(sdf_manual_loss(*manual), wrt + [xm])
    want = torch.autograd.grad(sdf_manual_loss(*nested), wrt + [xn])
    for g in got:
        assert torch.isfinite(g).all()
    err = max(float((m - a).abs().max() / (a.abs().max() + 1e-8))
              for m, a in zip(got, want))
    return manual, err


@pytest.mark.cuda
@pytest.mark.parametrize("net,n", [("small", 1000), ("default", 4096)])
def test_sdf_vfg_manual_matches_nested_autograd(cuda_device, net, n):
    """models/sdf_manual.py on the card: sdf and feature equal
    sdf_value_feature_gradient's, grad within the SDF kernels' tolerance,
    the gradients of a loss over all three outputs within 2e-5 of nested
    autograd's (scaled by each one's max)."""
    cfg, params, _ = _sdf_net(net, cuda_device)
    pts = _sdf_points(n, cuda_device, seed=2)
    (sdf, feat, grad), err = sdf_manual_against_nested(params, pts, cfg)
    want_sdf, want_feat, want_grad = fields.sdf_value_feature_gradient(
        params, pts, cfg)
    assert torch.equal(sdf, want_sdf) and torch.equal(feat, want_feat)
    torch.testing.assert_close(grad, want_grad, rtol=SDF_RTOL, atol=SDF_ATOL)
    assert err < 2e-5, err


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


# ---- evaluation: the card against the CPU -----------------------------------


def _eval_images(h=160, w=200, seed=0):
    rs = np.random.RandomState(seed)
    a = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-40, 40, a.shape), 0,
                255).astype(np.uint8)
    return a, b


@pytest.mark.cuda
def test_ssim_and_proxy_cuda_match_cpu(cuda_device):
    """float64 on both: within 1e-9 relative (sums in another order)."""
    from vqnerf_release_torch.eval import metrics
    a, b = _eval_images()
    for fn in (metrics.ssim, metrics._lpips_proxy):
        got, want = fn(a, b, device=cuda_device), fn(a, b, device="cpu")
        assert abs(got - want) <= 1e-9 * abs(want), (fn.__name__, got, want)


@pytest.mark.cuda
def test_lpips_alexnet_cuda_matches_cpu(cuda_device, tmp_path):
    """AlexNet LPIPS at the published widths (random weights) in float64,
    the card against the CPU within 1e-9 relative."""
    from vqnerf_release_torch.eval.lpips_net import lpips_from_weights
    rs = np.random.RandomState(1)
    widths, ks = [3, 64, 192, 384, 256, 256], [11, 5, 3, 3, 3]
    w = {}
    for i in range(5):
        w[f"conv{i + 1}/kernel"] = (0.05 * rs.randn(
            ks[i], ks[i], widths[i], widths[i + 1])).astype(np.float32)
        w[f"conv{i + 1}/bias"] = (0.05 * rs.randn(widths[i + 1])).astype(
            np.float32)
        w[f"lin{i}/kernel"] = rs.rand(1, 1, widths[i + 1], 1).astype(
            np.float32)
    path = str(tmp_path / "alex.npz")
    np.savez(path, **w)
    a, b = _eval_images(256, 256, 2)
    got = lpips_from_weights(a, b, path, device=cuda_device)
    want = lpips_from_weights(a, b, path, device="cpu")
    assert abs(got - want) <= 1e-9 * abs(want), (got, want)


@pytest.mark.cuda
def test_meanshift_cuda_matches_cpu(cuda_device):
    """The same centres within 1e-9 and the same labels, the card against
    the CPU, on clustered float32 features as gen-z exports them."""
    from vqnerf_release_torch.eval import meanshift
    rs = np.random.RandomState(3)
    centres = rs.rand(6, 7)
    x = (centres[rs.randint(0, 6, 8000)]
         + 0.03 * rs.randn(8000, 7)).astype(np.float32)
    got = meanshift.mean_shift(x, 0.2, device=cuda_device)
    want = meanshift.mean_shift(x, 0.2, device="cpu")
    assert got.shape == want.shape and got.shape[0] >= 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    pts = torch.as_tensor(x, dtype=torch.float64)
    lab_g = meanshift.nearest_center(pts.to(cuda_device),
                                     torch.as_tensor(got, device=cuda_device))
    lab_c = meanshift.nearest_center(pts, torch.as_tensor(want))
    assert torch.equal(lab_g.cpu(), lab_c)


# ---- the scanned dispatch: steps replayed as CUDA graphs --------------------

def _graph_views(n, h, w, lights, device_seed=0):
    rs = np.random.RandomState(device_seed)
    views = []
    for _ in range(n):
        alpha = (rs.rand(h * w, 1) > 0.2).astype(np.float32)
        views.append(types.SimpleNamespace(
            h=h, w=w, alpha=alpha, pred_alpha=alpha,
            rayo=rs.randn(h * w, 3).astype(np.float32),
            rayd=rs.randn(h * w, 3).astype(np.float32),
            rgb=rs.rand(h * w, 3).astype(np.float32),
            xyz=(rs.rand(h * w, 3) - 0.5).astype(np.float32),
            normal=rs.randn(h * w, 3).astype(np.float32),
            lvis=rs.rand(h * w, lights).astype(np.float32)))
    return views


@pytest.mark.cuda
def test_vq_kernel_inside_a_cuda_graph(cuda_device, monkeypatch):
    """vq_fused_train captured in a StepGraph: the replays give the eager
    call's bits, count one launch each, and survive a later eager call that
    grows the kernel's scratch (the graph keeps the buffer it recorded).
    The scratch starts empty: one an earlier test grew would not grow."""
    from vqnerf_release_torch.train.graphed import StepGraph
    kw = dict(decay=0.999, epsilon=1e-5)
    monkeypatch.setattr(kv, "_scratch", {})
    args = _vq_inputs(2048, 256, 15, cuda_device, True)
    want = kv.vq_fused_train(*args, **kw)

    def body(i):
        out = kv.vq_fused_train(*args, **kw)
        return {"update": out["update"].sum(), "counts": out["counts"].sum(),
                "first": out["indices"][0].float()}

    graph = StepGraph(body, cuda_device, 4)
    before = kv.LAUNCHES
    rows = graph.run(4)
    assert kv.LAUNCHES - before == 4  # 1 eager + 3 replays
    assert graph.launches_per_replay["vq_fused_train"] == 1
    wanted = torch.stack([want["counts"].sum(), want["indices"][0].float(),
                          want["update"].sum()])
    for r in range(4):
        assert torch.equal(rows[r], wanted), r
    pinned = kv.scratch_buffers()
    big = _vq_inputs(65536, 256, 15, cuda_device, True)
    kv.vq_fused_train(*big, **kw)  # grows the module's scratch
    assert kv.scratch_buffers()[0].data_ptr() != pinned[0].data_ptr()
    assert graph._pinned[0].data_ptr() == pinned[0].data_ptr()
    rows = graph.run(4)
    for r in range(4):
        assert torch.equal(rows[r], wanted), r


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["nfr_unit", "vq_nfr"])
def test_scanned_steps_replay_the_eager_steps(cuda_device, phase):
    """A chunk of 6 stage-2 steps through EpochScan (1 eager step, a
    capture, 5 replays) against 6 per-step calls on the gathered batches:
    parameters, optimizer state, EMA and losses bit for bit."""
    _scanned_against_eager(cuda_device, phase, None)


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["nfr_unit", "vq_nfr"])
def test_mesh_scanned_steps_replay_the_eager_mesh_steps(cuda_device, phase):
    """The same over the mesh [cuda:0, cuda:0]: every entry's work on a
    stream of its own, forked from the capturing stream and joined back;
    the replays give the eager mesh steps' bits, kernel 2 once a step."""
    _scanned_against_eager(cuda_device, phase, [cuda_device, cuda_device])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_sharded_gather_inside_a_cuda_graph(cuda_device, quant):
    """gather_at of a store row-sharded over [cuda:0, cuda:0], captured in
    a CUDA graph and replayed on new indices, equals the replicated
    store's gather bit for bit."""
    from vqnerf_release_torch.data.device_store import DeviceViewStore
    views = _graph_views(3, 24, 24, 32)  # 1731 rows: the last block padded
    whole = DeviceViewStore(views, cuda_device, quant=quant)
    sharded = DeviceViewStore(views, cuda_device, quant=quant,
                              mesh=[cuda_device] * 2, shard=True)
    assert sharded.sharded and sharded.rows_local == 866
    vi = torch.zeros((), dtype=torch.int64, device=cuda_device)
    pix = torch.zeros((512,), dtype=torch.int64, device=cuda_device)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        sharded.gather_at(vi, pix)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = sharded.gather_at(vi, pix)
    rs = np.random.RandomState(3)
    for v in (0, 1, 2, 1):
        vi.fill_(v)
        pix.copy_(torch.as_tensor(rs.randint(0, 24 * 24 + 1, size=512)))
        graph.replay()
        want = whole.gather_at(vi, pix)
        for k in want:
            assert torch.equal(got[k], want[k]), (v, k)


def _scanned_against_eager(cuda_device, phase, mesh):
    from vqnerf_release_torch.data.device_store import DeviceViewStore
    from vqnerf_release_torch.train import decomp_trainer as dt
    cfg = dc.DecompConfig(light_h=4, num_embed=6, num_drop=3, z_dim=64,
                          mlp_width=32, thres_str="0.1;0.2;0.3",
                          n_rays_per_step=256)
    views = _graph_views(2, 24, 24, cfg.n_lights)
    store = DeviceViewStore(views, cuda_device)
    lxyz, lareas = dc.light_constants(cfg, cuda_device)
    models, emas = [], []
    for _ in range(2):
        gen = torch.Generator().manual_seed(0)
        nfr = init_nfr_unit(gen, cfg)
        if phase == "nfr_unit":
            models.append(nfr.to(cuda_device))
            continue
        centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
        m, e = init_vq_nfr(gen, cfg, nfr, centers)
        models.append(m.to(cuda_device))
        emas.append(VqEmaState(*(t.to(cuda_device) for t in e)))
    rs = np.random.RandomState(1)
    vi = [0, 1, 0, 1, 1, 0]
    pix = rs.randint(0, 24 * 24, size=(6, 2 * cfg.n_rays_per_step))
    lrs = [dt.decomp_lr(3 + j, cfg) for j in range(6)]
    thres = torch.as_tensor(cfg.train_thres(), device=cuda_device)
    gens = [torch.Generator(device=cuda_device).manual_seed(5)
            for _ in range(2)]
    if phase == "nfr_unit":
        opt_a, step_a = dt.make_nfr_unit_step(models[0], cfg, lxyz, lareas,
                                              mesh=mesh)
        opt_b, step_b = dt.make_nfr_unit_step(models[1], cfg, lxyz, lareas,
                                              mesh=mesh)
        want = [step_a(store.gather(v, p), 3 + j)
                for j, (v, p) in enumerate(zip(vi, pix))]
        scan = dt.make_plain_epoch_scan(step_b, store, 6,
                                        cfg.n_rays_per_step)
    else:
        opt_a, step_a = dt.make_vq_nfr_step(models[0], cfg, lxyz, lareas,
                                            mesh=mesh)
        opt_b, step_b = dt.make_vq_nfr_step(models[1], cfg, lxyz, lareas,
                                            mesh=mesh)
        want, ema = [], emas[0]
        for j, (v, p) in enumerate(zip(vi, pix)):
            ema, ld = step_a(ema, store.gather(v, p), thres, gens[0], 3 + j)
            want.append(ld)
        scan = dt.make_vq_epoch_scan(step_b, store, 6, cfg.n_rays_per_step,
                                     emas[1], thres)
    before = kv.LAUNCHES
    scan.stage(vi, lrs, pix=pix, roll_gen=gens[1])
    rows = scan.run(6)
    if phase == "vq_nfr":
        assert kv.LAUNCHES - before == 6  # kernel 2 in every replay
        assert scan.graph.launches_per_replay["vq_fused_train"] == 1
        for a, b in zip(ema, scan.ema):
            assert torch.equal(a, b)
    for j, ld in enumerate(want):
        for k, v in ld.items():
            assert torch.equal(rows[j, scan.keys.index(k)],
                               v.to(torch.float32)), (j, k)
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    for k, v in opt_a.state.items():
        assert torch.equal(opt_b.state[k], v), k


@pytest.mark.cuda
def test_neus_multi_step_graph_runs_kernel_3(cuda_device):
    """make_neus_multi_step on the card (kernel 3 and pack_sdf inside the
    graph, 2 launches a step) against 2 x 4 single steps with the same
    draws: metrics, parameters and Adam state bit for bit."""
    from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
    from vqnerf_release_torch.models.neus import (NeuSConfig, init_neus)
    from vqnerf_release_torch.train import neus_trainer as nt
    cfg = NeuSConfig(sdf=fields.SDFConfig(d_hidden=64, n_layers=4,
                                          skip_in=(2,), multires=4,
                                          d_out=65),
                     color=fields.ColorConfig(d_feature=64, d_hidden=32,
                                              n_layers=2),
                     n_samples=16, n_importance=16, up_sample_steps=2)
    tcfg = nt.NeuSTrainConfig(warm_up_end=2, end_iter=100, anneal_end=6,
                              batch_size=512)
    base = init_neus(0, cfg)
    models = [from_jax(to_jax(base, "neus"), "neus").to(cuda_device)
              for _ in range(2)]
    rs = np.random.RandomState(2)

    def batch():
        o = rs.randn(512, 3) * 0.1 + [0.0, 0.0, 2.0]
        d = -o + rs.randn(512, 3) * 0.3
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return {"rays_o": o, "rays_d": d, "rgb": rs.rand(512, 3),
                "mask": (rs.rand(512, 1) > 0.4) * 1.0,
                "near": np.full((512, 1), 0.5), "far": np.full((512, 1), 3.5),
                "valid": np.ones((512, 1))}

    batches = [{k: np.asarray(v, np.float32) for k, v in batch().items()}
               for _ in range(8)]
    gens = [torch.Generator(device=cuda_device).manual_seed(4)
            for _ in range(2)]
    opt_a, step = nt.make_neus_train_step(models[0], cfg, tcfg, 1.0)
    opt_b, multi = nt.make_neus_multi_step(models[1], cfg, tcfg, 1.0, 4)
    before = dict(ks.LAUNCHES)
    for d in range(2):
        chunk = batches[4 * d:4 * d + 4]
        singles = [step({k: torch.as_tensor(v, device=cuda_device)
                         for k, v in b.items()}, 4 * d + j,
                        generator=gens[0]) for j, b in enumerate(chunk)]
        got = multi(chunk, 4 * d, generator=gens[1])
        keys = sorted(singles[0])
        want = nt.reduce_metrics(torch.stack(
            [torch.stack([m[k] for k in keys]) for m in singles]), keys)
        for k in want:
            assert torch.equal(got[k], want[k]), (d, k)
    assert ks.LAUNCHES["sdf_fwd"] - before["sdf_fwd"] == 2 * 16
    assert multi.graph.launches_per_replay["sdf:sdf_fwd"] == 2
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a, b)
    for k, v in opt_a.state.items():
        assert torch.equal(opt_b.state[k], v), k


def runner_k_against_1(tmp_path, device):
    """NeuSRunner with steps_per_dispatch=3 against 1 on ``device``, from
    one seed with the perturbation on, over occupancy rebuilds, the carve
    switch and the tail: the same rebuild steps, the same final parameters,
    Adam state and random streams, bit for bit; the dispatches never
    straddle a rebuild or the tail boundary. Returns the k=3 runner."""
    import chip_smoke
    from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
    from vqnerf_release_torch.models.neus import NeuSConfig
    from vqnerf_release_torch.train import neus_loop as t_nloop
    from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig
    chip_smoke.write_stage1_scene(str(tmp_path / "scene"), 12, 2, 1, 0)
    cfg = NeuSConfig(
        sdf=fields.SDFConfig(d_hidden=32, n_layers=4, skip_in=(2,),
                             multires=2, d_out=33),
        color=fields.ColorConfig(d_feature=32, d_hidden=16, n_layers=2),
        n_samples=8, n_importance=4, up_sample_steps=1)
    ds = NerfSceneDataset(str(tmp_path / "scene"), is_train=True, near=0.5,
                          far=3.5)
    base = dict(batch_size=32, end_iter=13, warm_up_end=2, save_freq=6,
                val_freq=10**9, mesh_freq=10**9, occ_res=8,
                occ_update_freq=5, carve_auto=True,
                carve_alt_sampler="12+4r1", carve_auto_thresh=0.0,
                carve_probe_res=16, tail_frac=0.25, tail_sampler="8+4r1",
                tail_occ=True)
    runs = {}
    for k in (1, 3):
        run = t_nloop.NeuSRunner(
            cfg, NeuSTrainConfig(**base, steps_per_dispatch=k), ds,
            str(tmp_path / str(k)), seed=3, device=device)
        hist = run.train(log_every=1)
        assert all(np.isfinite(h["loss"]) for h in hist)
        runs[k] = (run, hist)
    (one, h1), (three, h3) = runs[1], runs[3]
    assert len(h1) == 13
    assert three.occ_builds == one.occ_builds == [0, 5, 10]
    assert three.iter_step == one.iter_step == 13
    for (k, a), b in zip(one.params.state_dict().items(),
                         three.params.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in one.opt.state.items():
        assert torch.equal(three.opt.state[k], v), k
    assert torch.equal(one.generator.get_state(),
                       three.generator.get_state())
    assert one.rng.get_state()[2] == three.rng.get_state()[2]
    # a checkpoint at the end of the dispatch that crossed save_freq, as
    # the JAX runner saves: dispatches [0, 3) 3 4 [5, 8) 8 9 [10, 13)
    assert sorted(os.listdir(tmp_path / "1" / "checkpoints")) == [
        "ckpt-12", "ckpt-6"]
    assert sorted(os.listdir(tmp_path / "3" / "checkpoints")) == [
        "ckpt-13", "ckpt-8"]
    assert len(h3) == 7
    return three


@pytest.mark.cuda
def test_runner_k_step_dispatch_replays_graphs(cuda_device, tmp_path):
    """NeuSRunner.train with steps_per_dispatch=3 on the card (a graph
    captured in the carve, freed when the tail begins, and one in the
    tail) against single steps, bit for bit (``runner_k_against_1``)."""
    from vqnerf_release_torch.train import graphed
    replays = graphed.REPLAYS
    three = runner_k_against_1(tmp_path, cuda_device)
    # dispatches [0, 3) [5, 8) [10, 13): a capture and 2 replays each
    assert graphed.REPLAYS - replays == 6
    (key, fn), = [(k, f) for k, f in three._fn_cache.items() if len(k) == 4]
    assert key == (3, None, True, False) and fn.graph.graph is not None
