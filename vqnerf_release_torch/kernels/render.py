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

``fused_brdf_render_maps`` renders E light maps at once through the same
source's multi-map kernel (the BRDF of a ray-light pair once, added into
every map), with the same pieces beside it: ``pack_light_maps``, the plain
twin ``fused_brdf_render_maps_reference`` and
``fused_brdf_render_maps_regrouped``. Its launches count in
``LAUNCHES_BY_INSTANCE`` as "maps_vector" and "maps_scalar" (one a pass of
up to ``MAPS_PER_PASS`` maps), not in ``LAUNCHES``.
"""

import ctypes

import torch

from . import build as kbuild

__all__ = ["LAUNCHES", "LAUNCHES_BY_INSTANCE", "SOURCE", "SASS_NAMES",
           "MAPS_PER_PASS", "MAX_MAP_LIGHTS", "build", "load", "pack_lights",
           "pack_light_maps", "fused_brdf_render",
           "fused_brdf_render_reference", "fused_brdf_render_regrouped",
           "fused_brdf_render_maps", "fused_brdf_render_maps_reference",
           "fused_brdf_render_maps_regrouped"]

LAUNCHES = 0
LAUNCHES_BY_INSTANCE = {"vector": 0, "scalar": 0, "maps_vector": 0,
                        "maps_scalar": 0}
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
# the multi-map kernel's instances (kFewMaps, kManyMaps in the source), and
# the most lights whose table of the small one fits the 232,448 bytes of
# shared memory an H100 block may ask for
MAPS_PER_PASS = (8, 24)
MAX_MAP_LIGHTS = 232448 // (4 * (4 + 3 * MAPS_PER_PASS[0]))

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
    out = ctypes.POINTER(ctypes.c_int)
    return kbuild.load(so, {"fused_brdf_render_launch":
                            [ptr] * 9 + [i32] * 3 + [ptr, out],
                            "fused_brdf_render_maps_launch":
                            [ptr] * 9 + [i32] * 4 + [ptr, out, out]})


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


def pack_light_maps(lxyz, lareas, maps):
    """[4 + 3 E, L] table of E light maps ``maps`` [E, L, 3]: lxyz (rows
    0-2), area (3), then map e's rgb (rows 4 + 3 e .. 6 + 3 e)."""
    e, l = maps.shape[0], lxyz.shape[0]
    return torch.cat((lxyz.T, lareas.reshape(1, l),
                      maps.transpose(1, 2).reshape(3 * e, l)),
                     dim=0).to(torch.float32).contiguous()


def _single_map(table, e):
    """Map e of a ``pack_light_maps`` table as a ``pack_lights`` table."""
    return torch.cat((table[0:3], table[4 + 3 * e:7 + 3 * e], table[3:4],
                      torch.zeros_like(table[3:4])), dim=0)


def _safe_norm3(x, y, z, eps=1e-6, torch_order=False):
    """x, y, z over their norm; ``torch_order``: the sum of squares as
    torch.sum adds a last dimension of 3 on the card, (x^2 + z^2) + y^2."""
    ss = (x * x + z * z) + y * y if torch_order else x * x + y * y + z * z
    inv = torch.rsqrt(torch.clamp(ss, min=eps))
    return x * inv, y * inv, z * inv


def _gsub(cos_t, alpha2):
    cos_t = torch.clamp(cos_t, 0.0, 1.0)
    den = cos_t + torch.sqrt(torch.abs(alpha2 + (1.0 - alpha2) * cos_t * cos_t))
    return torch.where(den == 0.0, 0.0,
                       2.0 * cos_t / torch.where(den == 0.0, 1.0, den))


def _cosines(xyz, normal, surf2c, lxyz_rows, torch_order):
    """The twins' cosines of a pair: cos_vh, cos_nh, cos_ln [N, L] and
    cos_vn [N, 1]; lxyz_rows [3, L]. ``torch_order``: the multi-map kernel's
    chain, rounded as the plain relight path's on the card: the light
    direction normalised twice, sums of squares as torch.sum adds a last
    dimension of 3, (x^2 + z^2) + y^2, and the dot products as einsum's
    contraction over 3 (cuBLAS gemv), z b_z + fma(y, b_y, x b_x)."""
    col = lambda a, i: a[:, i:i + 1]  # noqa: E731  [N, 1]
    lx, ly, lz = lxyz_rows[0:1], lxyz_rows[1:2], lxyz_rows[2:3]

    def norm(x, y, z):
        return _safe_norm3(x, y, z, torch_order=torch_order)

    def dot(ax, ay, az, bx, by, bz):
        if torch_order:
            return az * bz + _fma(ay, by, ax * bx)
        return ax * bx + ay * by + az * bz

    nx, ny, nz = norm(col(normal, 0), col(normal, 1), col(normal, 2))
    vx, vy, vz = norm(col(surf2c, 0), col(surf2c, 1), col(surf2c, 2))
    sx, sy, sz = norm(lx - col(xyz, 0), ly - col(xyz, 1), lz - col(xyz, 2))
    if torch_order:
        sx, sy, sz = norm(sx, sy, sz)
    hx, hy, hz = norm(sx + vx, sy + vy, sz + vz)
    return (torch.clamp(dot(hx, hy, hz, vx, vy, vz), 0.0, 1.0),
            torch.clamp(dot(hx, hy, hz, nx, ny, nz), 0.0, 1.0),
            dot(sx, sy, sz, nx, ny, nz), nx * vx + ny * vy + nz * vz)


def _plain_terms(xyz, normal, surf2c, albedo, rough, f0, lvis, lxyz_rows,
                 areas, torch_order=False):
    """The plain twins' per-pair terms (F_c gd + albedo_c / pi) * weight,
    three [N, L] tensors that a light's rgb then scales; lxyz_rows [3, L],
    areas [1, L]; ``torch_order`` as ``_cosines``."""
    col = lambda a, i: a[:, i:i + 1]  # noqa: E731  [N, 1]
    cos_vh, cos_nh, cos_ln, cos_vn = _cosines(xyz, normal, surf2c,
                                              lxyz_rows, torch_order)
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

    terms = []
    for c in range(3):
        f0_c = col(f0, c)
        f = f0_c + (1.0 - f0_c) * one_m_cvh5
        brdf_c = f * gd_over_den + col(albedo, c) * (1.0 / torch.pi)
        terms.append(brdf_c * weight)
    return terms


def fused_brdf_render_reference(xyz, normal, surf2c, albedo, rough, f0, lvis,
                                lights_packed):
    """Plain PyTorch twin of the kernel: builds the [N, L] terms and sums
    over L. Same arguments and result as ``fused_brdf_render``."""
    terms = _plain_terms(xyz, normal, surf2c, albedo, rough, f0, lvis,
                         lights_packed[0:3], lights_packed[6:7])
    return torch.stack([torch.sum(terms[c] * lights_packed[3 + c:4 + c],
                                  dim=1) for c in range(3)], dim=1)


def fused_brdf_render_maps_reference(xyz, normal, surf2c, albedo, rough, f0,
                                     lvis, table):
    """Plain PyTorch twin of the multi-map kernel: the [N, L] terms once,
    with the kernel's chain into the GGX term, then each map's sums over L.
    Same arguments and result as ``fused_brdf_render_maps``."""
    terms = _plain_terms(xyz, normal, surf2c, albedo, rough, f0, lvis,
                         table[0:3], table[3:4], torch_order=True)
    maps = (table.shape[0] - 4) // 3
    return torch.stack([torch.stack(
        [torch.sum(terms[c] * table[4 + 3 * e + c:5 + 3 * e + c], dim=1)
         for c in range(3)], dim=1) for e in range(maps)], dim=1)


def _fma(a, b, c):
    """fmaf as float32(float64(a) * float64(b) + float64(c)): the product of
    two float32 is exact in float64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def fused_brdf_render_regrouped(xyz, normal, surf2c, albedo, rough, f0, lvis,
                                lights_packed, lights_per_lane=None,
                                regroup=True, approx_ulps=2.0,
                                torch_order=False):
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
    8, 4, 2, 1) ends in lane 0.
    ``torch_order``: the multi-map kernel's chain into the GGX term, which
    rounds as PyTorch's operations on the card do (``_cosines``)."""
    col = lambda a, i: a[:, i:i + 1]  # noqa: E731  [N, 1]
    l = lights_packed.shape[1]
    if lights_per_lane is None:
        lights_per_lane = (LIGHTS_PER_LANE if l % LIGHTS_PER_LANE == 0
                           else 1)
    areas = lights_packed[6:7]  # [1, L]
    cos_vh, cos_nh, cos_ln, cos_vn = _cosines(
        xyz, normal, surf2c, lights_packed[0:3], torch_order)
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


def fused_brdf_render_maps_regrouped(xyz, normal, surf2c, albedo, rough, f0,
                                     lvis, table, lights_per_lane=None,
                                     approx_ulps=2.0):
    """The multi-map kernel's arithmetic in plain PyTorch: for each map,
    ``fused_brdf_render_regrouped`` of that map alone with ``torch_order``.
    The kernel evaluates a pair's terms once for all maps, and each map's
    sums take kernel 1's FMAs in kernel 1's order and its reduction tree
    (``LaneSum`` in the source); the 2-ulp perturbations are drawn alike for
    every map, as the kernel's approximate operations are taken once. Same
    arguments and result as ``fused_brdf_render_maps``."""
    maps = (table.shape[0] - 4) // 3
    return torch.stack([fused_brdf_render_regrouped(
        xyz, normal, surf2c, albedo, rough, f0, lvis, _single_map(table, e),
        lights_per_lane=lights_per_lane, approx_ulps=approx_ulps,
        torch_order=True) for e in range(maps)], dim=1)


def _check_inputs(what, xyz, normal, surf2c, albedo, rough, f0, lvis,
                  named_table, rows, max_lights):
    """Device, shape and type of a launch's inputs, the light table given
    as (its name, the tensor); returns (n, L)."""
    name, table = named_table
    n, l = xyz.shape[0], table.shape[1]
    if not 1 <= l <= max_lights:
        raise ValueError(f"{what} takes 1 to {max_lights} lights, got {l}")
    specs = (("xyz", xyz, (n, 3)), ("normal", normal, (n, 3)),
             ("surf2c", surf2c, (n, 3)), ("albedo", albedo, (n, 3)),
             ("rough", rough, (n, 1)), ("f0", f0, (n, 3)),
             (name, table, (rows, l)))
    if lvis is not None:
        specs += (("lvis", lvis, (n, l)),)
    kbuild.check_tensors(specs, torch.float32, xyz.device)
    return n, l


def _pointers(*tensors):
    return [None if t is None else t.data_ptr() for t in tensors]


def fused_brdf_render_maps(xyz, normal, surf2c, albedo, rough, f0, lvis,
                           table):
    """Fused render under E light maps; returns pre-gamma rgb [N, E, 3].

    Per-ray inputs and lvis as ``fused_brdf_render``'s; table [4 + 3 E, L]
    from ``pack_light_maps``, L up to ``MAX_MAP_LIGHTS``. CPU tensors go
    through the plain twin; CUDA tensors through the multi-map kernel, one
    launch a pass of up to 24 maps (8 where the table of 24 does not fit),
    on the current stream, without synchronising.
    """
    if xyz.device.type == "cpu":
        return fused_brdf_render_maps_reference(
            xyz, normal, surf2c, albedo, rough, f0, lvis, table)
    rows = table.shape[0]
    if rows < 7 or (rows - 4) % 3:
        raise ValueError(f"fused_brdf_render_maps: a table of 4 + 3 E rows, "
                         f"got {rows}")
    maps = (rows - 4) // 3
    n, l = _check_inputs("fused_brdf_render_maps", xyz, normal, surf2c,
                         albedo, rough, f0, lvis, ("table", table), rows,
                         MAX_MAP_LIGHTS)
    out = torch.empty((n, maps, 3), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    lights_per_lane, per_pass = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().fused_brdf_render_maps_launch(
        *_pointers(xyz, normal, surf2c, albedo, rough, f0, lvis, table, out),
        n, l, maps, xyz.device.index,
        torch.cuda.current_stream(xyz.device).cuda_stream,
        ctypes.byref(lights_per_lane), ctypes.byref(per_pass))
    if err != 0:
        raise RuntimeError(f"fused_brdf_render_maps: kernel launch failed "
                           f"with CUDA error {err}")
    key = "maps_vector" if lights_per_lane.value > 1 else "maps_scalar"
    LAUNCHES_BY_INSTANCE[key] += -(-maps // per_pass.value)
    return out


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
    n, l = _check_inputs("fused_brdf_render", xyz, normal, surf2c, albedo,
                         rough, f0, lvis, ("lights_packed", lights_packed),
                         8, MAX_LIGHTS)
    out = torch.empty((n, 3), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    lights_per_lane = ctypes.c_int(0)
    err = _library().fused_brdf_render_launch(
        *_pointers(xyz, normal, surf2c, albedo, rough, f0, lvis,
                   lights_packed, out),
        n, l, xyz.device.index,
        torch.cuda.current_stream(xyz.device).cuda_stream,
        ctypes.byref(lights_per_lane))
    if err != 0:
        raise RuntimeError(f"fused_brdf_render: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    LAUNCHES_BY_INSTANCE[
        "vector" if lights_per_lane.value > 1 else "scalar"] += 1
    return out
