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
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load",
           "check_tensor", "check_tensors", "count_sass", "sass_functions",
           "sass_inner_loop"]

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _tool(name):
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", name)
    if os.path.exists(path):
        return path
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin and on PATH); the "
            "port's CUDA kernels need the CUDA toolkit to build")
    return path


def _nvcc():
    return _tool("nvcc")


def count_sass(so, *mnemonics):
    """How often the machine code of a built library names any of
    ``mnemonics`` (``cuobjdump -sass``)."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    return sum(sass.count(m) for m in mnemonics)


_SASS_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_SASS_BRANCH = re.compile(r"\bBRA\S*\s+(?:\S+,\s*)?`?\(?0x([0-9a-f]+)")


def sass_functions(so):
    """The machine code of a built library (``cuobjdump -sass``): a dict
    from each kernel's mangled name to its instructions, a list of
    (address, text) in program order."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    functions, body = {}, None
    for line in sass.splitlines():
        m = _SASS_FUNCTION.match(line)
        if m:
            body = functions.setdefault(m.group(1), [])
            continue
        m = _SASS_LINE.match(line)
        if m and body is not None:
            body.append((int(m.group(1), 16), m.group(2)))
    return functions


def sass_inner_loop(instructions, marker):
    """The texts of the largest innermost loop of one kernel's
    ``instructions`` (from ``sass_functions``) that names ``marker``. A loop
    is the range from the target of a backward branch to the branch;
    innermost means that no other such range with the marker lies inside
    it. Code that a loop only calls (the slow paths of a divide or a square
    root, placed behind the kernel's end) lies outside the range and is not
    counted. Returns [] where no loop names the marker."""
    loops = []
    for i, (addr, text) in enumerate(instructions):
        m = _SASS_BRANCH.search(text)
        if m and int(m.group(1), 16) <= addr:
            target = int(m.group(1), 16)
            body = [t for a, t in instructions[:i + 1] if a >= target]
            if any(marker in t for t in body):
                loops.append((target, addr, body))
    inner = [l for l in loops
             if not any(o is not l and l[0] <= o[0] and o[1] <= l[1]
                        for o in loops)]
    return max((l[2] for l in inner), key=len, default=[])


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


def check_tensors(specs, dtype, device):
    """``check_tensor`` for every (name, tensor, shape) of ``specs`` on the
    CUDA device ``device``, in one pass that formats nothing unless a
    tensor is at fault."""
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {device}")
    for name, t, shape in specs:
        if (t.device != device or t.dtype != dtype or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(name, t, shape, dtype, device)
