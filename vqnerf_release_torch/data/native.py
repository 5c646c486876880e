"""ctypes binding of the host sampler library (``csrc/fastloader.cpp``),
the counterpart of vqnerf_release_tpu/data/native.py: the jitter-pair
selection and row gather of stage-2 training's host path, and a .npy
reader.

The library is built with the host compiler at first use
(``kernels/build.py::build_host``, into ``vqnerf_release_torch/_build/``).
A failed build raises with the compiler's output: where the JAX package
falls back to numpy when its library was not built by hand, the port builds
its own and does not fall back.

``select_pairs`` seeds every image row on its own (xorshift128+), so its
result does not depend on the thread count, and equals the JAX package's
library bit for bit for the same seed. The calls release the interpreter
lock (ctypes does) and share no state, so threads may call them at once.
"""

import ctypes
import threading

import numpy as np

from ..kernels import build as kbuild

__all__ = ["native_available", "select_pairs", "gather_rows",
           "gather_batch", "load_npy_f32", "outer_sample_native",
           "openmp_threads"]

_LIB = None
_LIB_LOCK = threading.Lock()

_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_int64)

# the buffers of a view that a batch holds, in outer_sample's order
_BATCH_KEYS = ("rayo", "rayd", "rgb", "alpha", "pred_alpha", "xyz", "normal",
               "lvis", "ref")


def _lib():
    """The loaded library, built at the first call (RuntimeError with the
    compiler's output if the build fails)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            so, _ = kbuild.build_host(kbuild.CSRC_DIR / "fastloader.cpp",
                                      "fastloader")
            lib = ctypes.CDLL(str(so))
            lib.select_pairs.restype = ctypes.c_int64
            lib.select_pairs.argtypes = [
                _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_double, ctypes.c_int64, ctypes.c_int,
                ctypes.c_uint64, _I64P]
            lib.gather_rows.restype = None
            lib.gather_rows.argtypes = [_F32P, ctypes.c_int64, _I64P,
                                        ctypes.c_int64, _F32P]
            lib.load_npy_f32.restype = ctypes.c_int64
            lib.load_npy_f32.argtypes = [ctypes.c_char_p, _F32P,
                                         ctypes.c_int64]
            _LIB = lib
    return _LIB


def native_available():
    """True once the library is built and loaded (the first call builds
    it). A failed build raises RuntimeError with the compiler's output."""
    return _lib() is not None


def openmp_threads():
    """omp_get_max_threads() of the OpenMP runtime the library runs on (the
    one the host compiler links: libgomp for g++, libomp for clang), or
    None where neither is loaded."""
    _lib()
    for name in ("libgomp.so.1", "libomp.so"):
        try:
            return int(ctypes.CDLL(name).omp_get_max_threads())
        except OSError:
            continue
    return None


def _fptr(a):
    return a.ctypes.data_as(_F32P)


def select_pairs(alpha, rgb, n_rays, jitter_mode="random", alpha_thres=0.9,
                 seed=0):
    """[2*n_rays, 2] interleaved (pixel, jitter) (row, col) coordinates of
    an [H, W] alpha and [H, W, 3] rgb image: jitter_mode 'contrast' takes
    each interior pixel's neighbour of largest RGB difference, 'random' a
    uniform one; pairs whose two alphas exceed ``alpha_thres`` are drawn
    with replacement. Raises ValueError where there is no such pair."""
    if jitter_mode not in ("random", "contrast"):
        raise ValueError(f"jitter_mode must be 'random' or 'contrast', got "
                         f"{jitter_mode!r}")
    h, w = alpha.shape
    if np.shape(rgb) != (h, w, 3):
        raise ValueError(f"rgb of shape {np.shape(rgb)} for an alpha of "
                         f"{(h, w)}")
    if h < 3 or w < 3:
        raise ValueError(f"a {h}x{w} view has no interior pixel")
    if n_rays < 0:
        raise ValueError(f"n_rays {n_rays} < 0")
    lib = _lib()
    alpha = np.ascontiguousarray(alpha, np.float32)
    rgb = np.ascontiguousarray(rgb, np.float32)
    out = np.empty((2 * n_rays, 2), np.int64)
    n_cand = lib.select_pairs(
        _fptr(alpha), _fptr(rgb), h, w, alpha_thres, n_rays,
        1 if jitter_mode == "contrast" else 0, ctypes.c_uint64(seed),
        out.ctypes.data_as(_I64P))
    if n_cand < 0:
        raise ValueError("no foreground pixels above threshold")
    return out


def gather_rows(src, flat_idx):
    """src [R, C] (as float32) at rows flat_idx [N] -> [N, C] float32."""
    lib = _lib()
    src = np.ascontiguousarray(src, np.float32)
    flat_idx = np.ascontiguousarray(flat_idx, np.int64)
    if src.ndim != 2 or flat_idx.ndim != 1:
        raise ValueError(f"gather_rows takes [R, C] rows and [N] indices, "
                         f"got {src.shape} and {flat_idx.shape}")
    n, c = flat_idx.shape[0], src.shape[1]
    if n and (flat_idx.min() < 0 or flat_idx.max() >= src.shape[0]):
        raise IndexError(f"row indices outside [0, {src.shape[0]})")
    out = np.empty((n, c), np.float32)
    lib.gather_rows(_fptr(src), c, flat_idx.ctypes.data_as(_I64P), n,
                    _fptr(out))
    return out


def load_npy_f32(path, shape=None):
    """A C-order '<f4' or '<f8' .npy file as float32 (the shape read from
    its header unless given). Raises IOError for another dtype, Fortran
    order or a short file."""
    lib = _lib()
    if shape is None:
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            shape, _, _ = np.lib.format._read_array_header(f, version)
    n = int(np.prod(shape))
    out = np.empty(n, np.float32)
    got = lib.load_npy_f32(str(path).encode(), _fptr(out), n)
    if got < 0:
        raise IOError(f"load_npy_f32 failed ({got}) for {path}")
    if got != n:
        raise IOError(f"load_npy_f32 read {got} values of {n} for {path}")
    return out.reshape(shape)


def gather_batch(view, flat):
    """The batch dict of a view's rows at flat pixel indices [N], every
    buffer the view holds, in ``data.sampler.outer_sample``'s keys."""
    n = view.h * view.w
    return {k: gather_rows(getattr(view, k).reshape(n, -1), flat)
            for k in _BATCH_KEYS if getattr(view, k, None) is not None}


def outer_sample_native(view, n_rays, seed, jitter_mode="random",
                        alpha_thres=0.9):
    """``data.sampler.outer_sample``'s batch with the pairs from
    ``select_pairs`` at ``seed``: the same contract, another random
    stream."""
    h, w = view.h, view.w
    coords = select_pairs(view.alpha.reshape(h, w),
                          view.rgb.reshape(h, w, 3), n_rays,
                          jitter_mode=jitter_mode, alpha_thres=alpha_thres,
                          seed=seed)
    return gather_batch(view, coords[:, 0] * w + coords[:, 1])
