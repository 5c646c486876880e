"""Fused microfacet-BRDF + render-equation kernel: the CUDA build, the
wrapper, and its plain PyTorch twin.

The kernel (``csrc/render_kernel.cu``) replaces the Pallas TPU kernel
``vqnerf_release_tpu/ops/pallas/render_kernel.py::fused_brdf_render``.
``kernels/build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first use
and binds it with ``ctypes``.

``fused_brdf_render`` takes the plain twin ``fused_brdf_render_reference``
only for CPU tensors. For CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches.
"""

import ctypes

import torch

from . import build as kbuild

__all__ = ["LAUNCHES", "SOURCE", "build", "pack_lights", "fused_brdf_render",
           "fused_brdf_render_reference"]

LAUNCHES = 0

SOURCE = kbuild.CSRC_DIR / "render_kernel.cu"
# the light table [8, L] must fit the default 48 KB of dynamic shared memory
MAX_LIGHTS = 48 * 1024 // (8 * 4)

# without FMA contraction, so that the kernel rounds as its plain twin does
_EXTRA_FLAGS = ("-fmad=false",)

_lib = None


def build():
    """Compile the kernel unless its library exists; see ``build.build``."""
    return kbuild.build(SOURCE, "render", _EXTRA_FLAGS)


def _library():
    global _lib
    if _lib is None:
        so, _ = build()
        _lib = kbuild.load(so, {"fused_brdf_render_launch":
                                [ctypes.c_void_p] * 9
                                + [ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]})
    return _lib


def pack_lights(lxyz, lareas, light_flat):
    """[8, L] light table: lxyz (rows 0-2), rgb (3-5), area (6), pad (7)."""
    l = lxyz.shape[0]
    out = torch.zeros((8, l), dtype=torch.float32, device=lxyz.device)
    out[0:3] = lxyz.T
    out[3:6] = light_flat.T
    out[6] = lareas
    return out


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
    n = xyz.shape[0]
    l = lights_packed.shape[1]
    if l > MAX_LIGHTS:
        raise ValueError(f"fused_brdf_render takes at most {MAX_LIGHTS} "
                         f"lights, got {l}")
    for name, t, shape in (
            ("xyz", xyz, (n, 3)), ("normal", normal, (n, 3)),
            ("surf2c", surf2c, (n, 3)), ("albedo", albedo, (n, 3)),
            ("rough", rough, (n, 1)), ("f0", f0, (n, 3)),
            ("lights_packed", lights_packed, (8, l))):
        kbuild.check_tensor(name, t, shape, torch.float32, xyz.device)
    if lvis is not None:
        kbuild.check_tensor("lvis", lvis, (n, l), torch.float32, xyz.device)
    out = torch.empty((n, 3), dtype=torch.float32, device=xyz.device)
    if n == 0:
        return out
    fn = _library().fused_brdf_render_launch
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xyz.data_ptr(), normal.data_ptr(), surf2c.data_ptr(),
                 albedo.data_ptr(), rough.data_ptr(), f0.data_ptr(),
                 None if lvis is None else lvis.data_ptr(),
                 lights_packed.data_ptr(), out.data_ptr(), n, l, stream)
    if err != 0:
        raise RuntimeError(f"fused_brdf_render: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return out
