"""Build and load the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` with a plain C interface. ``nvcc`` compiles
it for ``sm_90a`` into a shared library under
``vqnerf_release_torch/_build/``, at first use, under a name keyed by a hash
of the source and the flags; ``ctypes`` loads it. A failed build raises with
the compiler's output.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load",
           "check_tensor"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels need the CUDA toolkit to build")
    return path


def build(source, stem, extra_flags=()):
    """Compile ``source`` unless the library of this source and these flags
    exists.

    Returns (path of the .so, compiler output; empty if nothing was
    built). Raises RuntimeError with nvcc's output if the build fails."""
    source = Path(source)
    flags = [*NVCC_FLAGS, *extra_flags]
    key = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    so = BUILD_DIR / f"lib{stem}_{key.hexdigest()[:16]}.so"
    if so.exists():
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, so)
    return so, log


def load(so, functions):
    """ctypes.CDLL of ``so`` with argtypes set; ``functions`` maps a
    function's name to its argtypes. Every function returns an int, the
    CUDA error of its launch."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in functions.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check_tensor(name, t, shape, dtype, device=None):
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of this
    shape and dtype (on ``device``, when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: inputs on {device} and {t.device}")
    if t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {str(dtype).replace('torch.', '')}, got "
            f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
