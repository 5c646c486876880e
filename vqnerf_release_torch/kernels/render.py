"""Fused microfacet-BRDF + render-equation kernel: the CUDA build, the
wrapper, and its plain PyTorch twin.

The kernel (``csrc/render_kernel.cu``) replaces the Pallas TPU kernel
``vqnerf_release_tpu/ops/pallas/render_kernel.py::fused_brdf_render``.
``kernels/build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first use
and binds it with ``ctypes``.

``fused_brdf_render`` takes the plain twin ``fused_brdf_render_reference``
only for CPU tensors. For CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_INSTANCE`` the same by
the instance of the kernel that ran: "vector" (four lights a lane, 16-byte
loads; any L that is a multiple of four with a 16-byte-aligned lvis) or
"scalar" (every other L or base address).

``fused_brdf_render_regrouped`` evaluates, in plain PyTorch, the kernel's
arithmetic where it is grouped otherwise than the plain twin's (three
explicit FMAs, one divide for two, the order of the sum over L). It stands
for the kernel in the CPU tests and is called nowhere else.
"""

import ctypes

import torch

from . import build as kbuild

__all__ = ["LAUNCHES", "LAUNCHES_BY_INSTANCE", "SOURCE", "SASS_NAMES",
           "build", "load", "pack_lights", "fused_brdf_render",
           "fused_brdf_render_reference", "fused_brdf_render_regrouped"]

LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {"vector": 0, "scalar": 0}
LIGHTS_PER_LANE = 4  # of the vector instance (RENDER_LIGHTS in the source)
# MUFU instructions of a ray-light pair in the built kernel: two reciprocal
# square roots, Smith's square root, two reciprocals. With the mangled
# names of the four instances, for the SASS checks.
MUFU_PER_PAIR = 5
SASS_NAMES = {("vector", True): "render_kernelILi4ELb1E",
              ("vector", False): "render_kernelILi4ELb0E",
              ("scalar", True): "render_kernelILi1ELb1E",
              ("scalar", False): "render_kernelILi1ELb0E"}

SOURCE = kbuild.CSRC_DIR / "render_kernel.cu"
# the light table [8, L] must fit the default 48 KB of dynamic shared memory
MAX_LIGHTS = 48 * 1024 // (8 * 4)

# without FMA contraction, so that the kernel rounds as its plain twin does
_EXTRA_FLAGS = ("-fmad=false",)

_lib = None


def build(extra_flags=()):
    """Compile the kernel unless its library exists; see ``build.build``.
    ``extra_flags`` lets the card-only tests build the variants the source
    keeps behind macros (RENDER_LIGHTS, RENDER_MIN_BLOCKS, RENDER_REGROUP,
    RENDER_APPROX) beside the port's build."""
    return kbuild.build(SOURCE, "render", (*_EXTRA_FLAGS, *extra_flags))


def load(so):
    """The ctypes library of a built kernel."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    return kbuild.load(so, {"fused_brdf_render_launch":
                            [ptr] * 9 + [i32] * 3
                            + [ptr, ctypes.POINTER(ctypes.c_int)]})


def _library():
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return _lib


def pack_lights(lxyz, lareas, light_flat):
    """[8, L] light table: lxyz (rows 0-2), rgb (3-5), area (6), pad (7)."""
    l = lxyz.shape[0]
    return torch.cat((lxyz.T, light_flat.T, lareas.reshape(1, l),
                      lareas.new_zeros((1, l))), dim=0).to(torch.float32)


def _safe_norm3(x, y, z, eps=1e-6):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=eps))
    return x * inv, y * inv, z * inv


def _gsub(cos_t, alpha2):
    cos_t = torch.clamp(cos_t, 0.0, 1.0)
    den = cos_t + torch.sqrt(torch.abs(alpha2 + (1.0 - alpha2) * cos_t * cos_t))
    return torch.where(den == 0.0, 0.0,
                       2.0 * cos_t / torch.where(den == 0.0, 1.0, den))


def fused_brdf_render_reference(xyz, normal, surf2c, albedo, rough, f0, lvis,
                                lights_packed):
    """Plain PyTorch twin of the kernel: builds the [N, L] terms and sums
    over L. Same arguments and result as ``fused_brdf_render``."""
    col = lambda a, i: a[:, i:i + 1]  # noqa: E731  [N, 1]
    lx, ly, lz = lights_packed[0:1], lights_packed[1:2], lights_packed[2:3]
    areas = lights_packed[6:7]  # [1, L]

    nx, ny, nz = _safe_norm3(col(normal, 0), col(normal, 1), col(normal, 2))
    vx, vy, vz = _safe_norm3(col(surf2c, 0), col(surf2c, 1), col(surf2c, 2))
    sx, sy, sz = _safe_norm3(lx - col(xyz, 0), ly - col(xyz, 1),
                             lz - col(xyz, 2))
    hx, hy, hz = _safe_norm3(sx + vx, sy + vy, sz + vz)

    cos_vh = torch.clamp(hx * vx + hy * vy + hz * vz, 0.0, 1.0)  # [N, L]
    cos_nh = torch.clamp(hx * nx + hy * ny + hz * nz, 0.0, 1.0)
    cos_ln = sx * nx + sy * ny + sz * nz
    cos_vn = nx * vx + ny * vy + nz * vz  # [N, 1]

    alpha2 = torch.square(rough * rough)  # [N, 1]
    den_d = torch.pi * torch.square(cos_nh * cos_nh * (alpha2 - 1.0) + 1.0)
    d = torch.where(den_d == 0.0, 0.0,
                    alpha2 / torch.where(den_d == 0.0, 1.0, den_d))
    g = _gsub(cos_ln, alpha2) * _gsub(cos_vn, alpha2)
    den_spec = 4.0 * torch.abs(cos_ln) * torch.abs(cos_vn)
    gd_over_den = torch.where(
        den_spec == 0.0, 0.0,
        (g * d) / torch.where(den_spec == 0.0, 1.0, den_spec))

    lv = (cos_ln > 0.0).to(torch.float32)
    if lvis is not None:
        lv = lv * lvis
    weight = lv * cos_ln * areas
    u = 1.0 - cos_vh
    u2 = u * u
    one_m_cvh5 = u2 * u2 * u  # as JAX's integer_pow and the kernel

    out = []
    for c in range(3):
        f0_c = col(f0, c)
        f = f0_c + (1.0 - f0_c) * one_m_cvh5
        brdf_c = f * gd_over_den + col(albedo, c) * (1.0 / torch.pi)
        out.append(torch.sum(brdf_c * weight * lights_packed[3 + c:4 + c],
                             dim=1))
    return torch.stack(out, dim=1)


def _fma(a, b, c):
    """fmaf as float32(float64(a) * float64(b) + float64(c)): the product of
    two float32 is exact in float64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def fused_brdf_render_regrouped(xyz, normal, surf2c, albedo, rough, f0, lvis,
                                lights_packed, lights_per_lane=None,
                                regroup=True, approx_ulps=2.0):
    """The kernel's arithmetic in plain PyTorch, where it differs from
    ``fused_brdf_render_reference``; same arguments and result.

    With ``regroup`` (the kernel's default build): the Schlick term
    f0 + (1 - f0) u^5, the sum alpha^2 + (1 - alpha^2) cos^2 under Smith's
    square root and the three accumulations are fused multiply-adds, and
    Smith's divide for the light and D's divide are one divide,
    (2 cos alpha^2) / (den_g den_d), zeroed where either denominator is 0.
    That divide, the divide by 4 |cos_ln| |cos_vn| and Smith's square root
    for the light are approximate in the kernel, within 2 ulp; here each
    result is moved by ``approx_ulps`` ulp up or down, the signs drawn from
    a fixed seed (0 leaves them exact).
    The sum over L is taken in the kernel's order: lane i of 32 owns lights
    (32 s + i) w .. + w - 1 of step s (w = ``lights_per_lane``: 4 in the
    vector instance, 1 in the scalar one; by default as the launcher chooses
    from L), adds them in that order, and a tree over the lanes (offsets 16,
    8, 4, 2, 1) ends in lane 0."""
    col = lambda a, i: a[:, i:i + 1]  # noqa: E731  [N, 1]
    l = lights_packed.shape[1]
    if lights_per_lane is None:
        lights_per_lane = (LIGHTS_PER_LANE if l % LIGHTS_PER_LANE == 0
                           else 1)
    lx, ly, lz = lights_packed[0:1], lights_packed[1:2], lights_packed[2:3]
    areas = lights_packed[6:7]  # [1, L]

    nx, ny, nz = _safe_norm3(col(normal, 0), col(normal, 1), col(normal, 2))
    vx, vy, vz = _safe_norm3(col(surf2c, 0), col(surf2c, 1), col(surf2c, 2))
    sx, sy, sz = _safe_norm3(lx - col(xyz, 0), ly - col(xyz, 1),
                             lz - col(xyz, 2))
    hx, hy, hz = _safe_norm3(sx + vx, sy + vy, sz + vz)

    cos_vh = torch.clamp(hx * vx + hy * vy + hz * vz, 0.0, 1.0)  # [N, L]
    cos_nh = torch.clamp(hx * nx + hy * ny + hz * nz, 0.0, 1.0)
    cos_ln = sx * nx + sy * ny + sz * nz
    cos_vn = nx * vx + ny * vy + nz * vz  # [N, 1]

    alpha2 = torch.square(rough * rough)  # [N, 1]
    g_v = _gsub(cos_vn, alpha2)
    den_d = torch.pi * torch.square(cos_nh * cos_nh * (alpha2 - 1.0) + 1.0)
    gen = torch.Generator(device=xyz.device).manual_seed(0)

    def approx(x):  # an approximate operation's result
        if not (regroup and approx_ulps):
            return x
        sign = torch.randint(0, 2, x.shape, generator=gen,
                             device=x.device).to(x.dtype) * 2.0 - 1.0
        return x * (1.0 + sign * (approx_ulps * 2.0 ** -23))

    if regroup:
        c = torch.clamp(cos_ln, 0.0, 1.0)
        den_g = c + approx(torch.sqrt(torch.abs(
            _fma(1.0 - alpha2, c * c, alpha2))))
        zero = (den_g == 0.0) | (den_d == 0.0)
        q = approx(((2.0 * c) * alpha2)
                   / torch.where(zero, 1.0, den_g * den_d))
        gd_num = torch.where(zero, 0.0, q * g_v)
    else:
        d = torch.where(den_d == 0.0, 0.0,
                        alpha2 / torch.where(den_d == 0.0, 1.0, den_d))
        gd_num = (_gsub(cos_ln, alpha2) * g_v) * d
    den_spec = torch.abs(cos_ln) * (4.0 * torch.abs(cos_vn))
    gd = torch.where(den_spec == 0.0, 0.0, approx(
        gd_num / torch.where(den_spec == 0.0, 1.0, den_spec)))

    lv = (cos_ln > 0.0).to(torch.float32)
    if lvis is not None:
        lv = lv * lvis
    weight = lv * cos_ln * areas
    u = 1.0 - cos_vh
    u2 = u * u
    u5 = u2 * u2 * u

    n = xyz.shape[0]
    w = lights_per_lane
    pad = -l % (32 * w)
    out = []
    for ch in range(3):
        f0_c = col(f0, ch)
        a_c = col(albedo, ch) * (1.0 / torch.pi)
        rgb = lights_packed[3 + ch:4 + ch]
        if regroup:
            term = (_fma(1.0 - f0_c, u5, f0_c) * gd + a_c) * weight
        else:
            term = ((f0_c + (1.0 - f0_c) * u5) * gd + a_c) * weight * rgb
            rgb = torch.ones_like(rgb)
        # [N, steps, 32 lanes, w]: a masked light adds nothing
        term = torch.nn.functional.pad(term, (0, pad)).reshape(n, -1, 32, w)
        rgb = torch.nn.functional.pad(rgb.expand(n, l), (0, pad)).reshape(
            n, -1, 32, w)
        acc = torch.zeros((n, 32), dtype=torch.float32, device=xyz.device)
        for s in range(term.shape[1]):
            for i in range(w):
                if regroup:
                    acc = _fma(term[:, s, :, i], rgb[:, s, :, i], acc)
                else:
                    acc = acc + term[:, s, :, i]
        for off in (16, 8, 4, 2, 1):
            acc = acc[:, :off] + acc[:, off:2 * off]
        out.append(acc[:, 0])
    return torch.stack(out, dim=1)


def fused_brdf_render(xyz, normal, surf2c, albedo, rough, f0, lvis,
                      lights_packed):
    """Fused render; returns pre-gamma rgb [N, 3].

    xyz, normal, surf2c, albedo, f0: [N, 3]; rough: [N, 1]; lvis: [N, L]
    or None (front-lit mask only); lights_packed: [8, L] from pack_lights.
    CPU tensors go through the plain twin; CUDA tensors through the kernel,
    on the current stream, without synchronising.
    """
    global LAUNCHES
    if xyz.device.type == "cpu":
        return fused_brdf_render_reference(
            xyz, normal, surf2c, albedo, rough, f0, lvis, lights_packed)
    device = xyz.device
    n = xyz.shape[0]
    l = lights_packed.shape[1]
    if not 1 <= l <= MAX_LIGHTS:
        raise ValueError(f"fused_brdf_render takes 1 to {MAX_LIGHTS} "
                         f"lights, got {l}")
    specs = (("xyz", xyz, (n, 3)), ("normal", normal, (n, 3)),
             ("surf2c", surf2c, (n, 3)), ("albedo", albedo, (n, 3)),
             ("rough", rough, (n, 1)), ("f0", f0, (n, 3)),
             ("lights_packed", lights_packed, (8, l)))
    if lvis is not None:
        specs += (("lvis", lvis, (n, l)),)
    kbuild.check_tensors(specs, torch.float32, device)
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    if n == 0:
        return out
    lights_per_lane = ctypes.c_int(0)
    err = _library().fused_brdf_render_launch(
        xyz.data_ptr(), normal.data_ptr(), surf2c.data_ptr(),
        albedo.data_ptr(), rough.data_ptr(), f0.data_ptr(),
        None if lvis is None else lvis.data_ptr(), lights_packed.data_ptr(),
        out.data_ptr(), n, l, device.index,
        torch.cuda.current_stream(device).cuda_stream,
        ctypes.byref(lights_per_lane))
    if err != 0:
        raise RuntimeError(f"fused_brdf_render: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[
        "vector" if lights_per_lane.value > 1 else "scalar"] += 1
    return out
