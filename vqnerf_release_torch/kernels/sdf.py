"""Fused SDF MLP, forward and forward-with-gradient: the CUDA build, the
wrappers, and their plain PyTorch versions.

The kernels (``csrc/sdf_kernel.cu``) replace the two Pallas TPU kernels of
``vqnerf_release_tpu/ops/pallas/sdf_kernel.py``: ``sdf_fwd_pallas`` (the
SDF of a batch of points, for the up-sample chain) and
``sdf_fwdgrad_pallas`` (the SDF and its spatial gradient, carried as three
forward-mode tangent channels, for the final pass of the shadow rays).
``kernels/build.py`` compiles the source with ``nvcc`` for ``sm_90a`` at
first use and binds it with ``ctypes``.

``pack_sdf`` folds the weight norm and lays the weights out for the kernel
ONCE (one contiguous buffer and a table of offsets); a caller that evaluates
many batches, such as the geometry extractor, packs once and passes the
result to every call. The net may have any layer widths up to 256, any
``skip_in`` and any ``scale``; N is free, the kernel masks its ragged tail.

``sdf_fwd`` and ``sdf_fwdgrad`` take the plain versions ``sdf_fwd_plain`` /
``sdf_fwdgrad_plain`` only for CPU tensors. For CUDA tensors they launch the
kernel or raise. ``LAUNCHES`` counts, per kernel, the calls that launched
it. Nothing here takes part in autograd: both are forward-only, as the TPU
kernels are.
"""

import ctypes
import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from ..models.fields import SOFTPLUS_BETA, pack_sdf_params, softplus100
from ..ops.embed import posenc
from . import build as kbuild

__all__ = ["LAUNCHES", "SOURCE", "PackedSDF", "build", "load", "pack_sdf",
           "sdf_fwd", "sdf_fwdgrad", "sdf_fwd_plain", "sdf_fwdgrad_plain",
           "flops_per_point", "MAX_WIDTH", "MAX_LAYERS"]

LAUNCHES = {"sdf_fwd": 0, "sdf_fwdgrad": 0}

SOURCE = kbuild.CSRC_DIR / "sdf_kernel.cu"
MAX_WIDTH = 256  # widest layer input and hidden output the kernel takes
MAX_LAYERS = 16
MAX_FREQS = 10
_INV_SQRT2 = 1.0 / math.sqrt(2.0)

_lib = None


def build(extra_flags=()):
    """Compile the kernels unless their library exists; see ``build.build``.
    The port builds with nvcc's default FMA contraction; ``extra_flags``
    lets the card-only tests build with ``-fmad=false`` beside that."""
    return kbuild.build(SOURCE, "sdf", extra_flags)


def load(so):
    """The ctypes library of a built kernel."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    table = ctypes.POINTER(ctypes.c_int)
    return kbuild.load(so, {
        "sdf_mlp_launch": [ptr, ptr, i32, i32, i32] + [table] * 5
        + [f64, ptr, ptr, ptr],
    })


def _library():
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return _lib


@dataclass
class PackedSDF:
    """An SDF net with the weight norm folded in, ready for both the kernel
    and the plain versions.

    layers: [(W [in, out], b [out])], detached. buffer: the kernel's layout
    on the layers' device: each hidden layer's W zero-padded to [in, 256]
    then its b; the last layer as its column 0 then b[0]; every offset a
    multiple of 4 floats. The tables are ctypes int arrays (host)."""
    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    n_freqs: int
    skip_in: Tuple[int, ...]
    scale: float
    buffer: torch.Tensor
    in_dim: ctypes.Array
    out_dim: ctypes.Array
    w_off: ctypes.Array
    b_off: ctypes.Array
    skip: ctypes.Array

    @property
    def device(self):
        return self.buffer.device


def pack_sdf(params, cfg):
    """SDF layers (``fields.init_sdf``'s ModuleList) + SDFConfig ->
    PackedSDF on the parameters' device."""
    layers = pack_sdf_params(params)
    n = len(layers)
    d_embed = 3 + 6 * cfg.multires
    if cfg.d_in != 3 or cfg.multires < 1 or cfg.multires > MAX_FREQS:
        raise ValueError(
            f"the fused SDF takes 3-d points with 1..{MAX_FREQS} encoding "
            f"frequencies; got d_in={cfg.d_in}, multires={cfg.multires}")
    if not 2 <= n <= MAX_LAYERS:
        raise ValueError(f"the fused SDF takes 2..{MAX_LAYERS} dense layers; "
                         f"got {n}")
    if 0 in cfg.skip_in:
        raise ValueError("skip_in may not name layer 0")
    pieces, in_dim, out_dim, w_off, b_off, skip = [], [], [], [], [], []
    pos = 0

    def put(t):
        nonlocal pos
        flat = t.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        pieces.append(flat)
        start = pos
        pos += flat.numel()
        return start

    prev_out = None
    for l, (w, b) in enumerate(layers):
        d_in, d_out = w.shape
        is_skip = l in cfg.skip_in
        want_in = d_embed if l == 0 else prev_out + (d_embed if is_skip else 0)
        if d_in != want_in:
            raise ValueError(f"SDF layer {l}: input width {d_in}, expected "
                             f"{want_in}")
        last = l == n - 1
        if d_in > MAX_WIDTH or (not last and d_out > MAX_WIDTH):
            raise ValueError(
                f"SDF layer {l}: {d_in} -> {d_out}; the fused SDF takes "
                f"widths up to {MAX_WIDTH}")
        if last:
            w_off.append(put(w[:, 0]))
            b_off.append(put(b[:1]))
        else:
            padded = w.new_zeros((d_in, MAX_WIDTH))
            padded[:, :d_out] = w
            w_off.append(put(padded))
            b_off.append(put(b))
        in_dim.append(d_in)
        out_dim.append(d_out)
        skip.append(int(is_skip))
        prev_out = d_out
    ints = ctypes.c_int * n
    return PackedSDF(
        layers=layers, n_freqs=cfg.multires, skip_in=tuple(cfg.skip_in),
        scale=float(cfg.scale),
        buffer=torch.cat(pieces).to(torch.float32).contiguous(),
        in_dim=ints(*in_dim), out_dim=ints(*out_dim), w_off=ints(*w_off),
        b_off=ints(*b_off), skip=ints(*skip))


def flops_per_point(packed, with_grad):
    """fp32 operations the function needs for one point: 2 in out for each
    hidden layer and 2 in for column 0 of the last, times the four
    channels (value and three tangents) with the gradient."""
    ops = sum(2 * w.shape[0] * w.shape[1] for w, _ in packed.layers[:-1])
    ops += 2 * packed.layers[-1][0].shape[0]
    return ops * (4 if with_grad else 1)


def _posenc_with_grad(pts, n_freqs):
    """(embed [N, D], d_embed [3][N, D]): the encoding of ops/embed.posenc
    and its derivative with respect to each of the three coordinates."""
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    sel = [eye[k][None, :].expand(pts.shape[0], 3) for k in range(3)]
    feats = [pts]
    d_feats = [[s] for s in sel]
    for i in range(n_freqs):
        freq = float(2**i)
        s = torch.sin(pts * freq)
        c = torch.cos(pts * freq)
        feats += [s, c]
        for k in range(3):
            d_feats[k] += [c * freq * sel[k], -s * freq * sel[k]]
    return torch.cat(feats, dim=-1), [torch.cat(d, dim=-1) for d in d_feats]


@torch.no_grad()
def sdf_fwd_plain(packed, pts, cfg=None):
    """Plain PyTorch version of the forward kernel: sdf [N]. ``cfg`` is
    accepted for symmetry with the JAX signature; everything the function
    needs is in ``packed``."""
    embed = posenc(pts.detach() * packed.scale, packed.n_freqs)
    h = embed
    n = len(packed.layers)
    for l, (w, b) in enumerate(packed.layers):
        if l in packed.skip_in:
            h = torch.cat([h, embed], dim=-1) * _INV_SQRT2
        if l == n - 1:
            return (h @ w[:, 0] + b[0]) / packed.scale
        h = softplus100(h @ w + b)


@torch.no_grad()
def sdf_fwdgrad_plain(packed, pts, cfg=None):
    """Plain PyTorch version of the gradient kernel, step by step in forward
    mode: (sdf [N], grad [N, 3])."""
    x = pts.detach() * packed.scale
    embed, d_embed = _posenc_with_grad(x, packed.n_freqs)
    h, dh = embed, d_embed
    n = len(packed.layers)
    for l, (w, b) in enumerate(packed.layers):
        if l in packed.skip_in:
            h = torch.cat([h, embed], dim=-1) * _INV_SQRT2
            dh = [torch.cat([dh[k], d_embed[k]], dim=-1) * _INV_SQRT2
                  for k in range(3)]
        if l == n - 1:
            sdf = (h @ w[:, 0] + b[0]) / packed.scale
            # the input scaling and the output's 1/scale cancel
            return sdf, torch.stack([dh[k] @ w[:, 0] for k in range(3)],
                                    dim=-1)
        pre = h @ w + b
        e = torch.exp(-torch.abs(SOFTPLUS_BETA * pre))
        gate = torch.where(pre >= 0, torch.ones_like(e), e) / (1.0 + e)
        h = torch.clamp(pre, min=0.0) + torch.log1p(e) / SOFTPLUS_BETA
        dh = [(dh[k] @ w) * gate for k in range(3)]


def _launch(packed, pts, with_grad):
    name = "sdf_fwdgrad" if with_grad else "sdf_fwd"
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"{name}: expected points [N, 3], got "
                         f"{tuple(pts.shape)}")
    n = pts.shape[0]
    pts = pts.detach()
    kbuild.check_tensor("pts", pts, (n, 3), torch.float32)
    device = pts.device
    if packed.device != device:
        raise ValueError(f"{name}: points on {device}, packed weights on "
                         f"{packed.device}")
    sdf = torch.empty((n,), dtype=torch.float32, device=device)
    grad = (torch.empty((n, 3), dtype=torch.float32, device=device)
            if with_grad else None)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sdf_mlp_launch(
            pts.data_ptr(), packed.buffer.data_ptr(), n, len(packed.layers),
            packed.n_freqs, packed.in_dim, packed.out_dim, packed.w_off,
            packed.b_off, packed.skip, packed.scale, sdf.data_ptr(),
            grad.data_ptr() if with_grad else None, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    if n > 0:
        LAUNCHES[name] += 1
    return sdf, grad


def sdf_fwd(packed, pts, cfg=None):
    """sdf [N] of points [N, 3] (float32, contiguous), any N."""
    if pts.device.type == "cpu":
        return sdf_fwd_plain(packed, pts)
    return _launch(packed, pts, False)[0]


def sdf_fwdgrad(packed, pts, cfg=None):
    """(sdf [N], d sdf / d pts [N, 3]) of points [N, 3], any N."""
    if pts.device.type == "cpu":
        return sdf_fwdgrad_plain(packed, pts)
    return _launch(packed, pts, True)
