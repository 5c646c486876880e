"""Fused VQ-EMA training step: the CUDA build, the wrapper, and its plain
PyTorch version.

The kernel (``csrc/vq_kernel.cu``) replaces the Pallas TPU kernel
``vqnerf_release_tpu/ops/pallas/vq_kernel.py::vq_fused_train``: nearest-code
assignment with dropped codes masked at 1e30, the quantized rows, the masked
counts and dw = x^T (onehot * rowmask), and the Sonnet EMA epilogue that
proposes the new codebook. It is two CUDA launches per call (assign, then
finish). ``kernels/build.py`` compiles it with ``nvcc`` for ``sm_90a`` at
first use and binds it with ``ctypes``.

``vq_fused_train`` takes the plain version ``vq_fused_train_reference`` only
for CPU tensors. For CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts calls that launched the kernel. Nothing here takes part
in autograd: inputs are detached and outputs carry no gradient, as in the
JAX package, where the commitment loss and the straight-through estimator
stay outside the kernel.
"""

import ctypes

import torch

from . import build as kbuild

__all__ = ["LAUNCHES", "SOURCE", "BIG", "build", "load", "vq_fused_train",
           "vq_fused_train_reference"]

LAUNCHES = 0

SOURCE = kbuild.CSRC_DIR / "vq_kernel.cu"
BIG = 1e30  # distance of a dropped code
MAX_DIM = 256  # a row lives in registers, 8 floats per lane
MAX_SMEM = 48 * 1024  # default dynamic shared memory of a block

_lib = None


def build(extra_flags=()):
    """Compile the kernel unless its library exists; see ``build.build``.
    The port builds with nvcc's default FMA contraction; ``extra_flags``
    lets the card-only tests build it with ``-fmad=false`` beside that."""
    return kbuild.build(SOURCE, "vq", extra_flags)


def load(so):
    """The ctypes library of a built kernel."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return kbuild.load(so, {
        "vq_fused_train_blocks": [i32],
        "vq_fused_train_smem": [i32, i32],
        "vq_fused_train_launch": [ptr] * 15 + [i32] * 3 + [f64] * 2 + [ptr],
    })


def _library():
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return _lib


@torch.no_grad()
def vq_fused_train_reference(codebook, flat_inputs, rowmask, sel, hidden_cs,
                             hidden_dw, counter, *, decay, epsilon,
                             indices=None):
    """Plain PyTorch version of the kernel; same arguments and result as
    ``vq_fused_train``. ``indices`` [N], when given, replaces the argmin, so
    that the statistics can be held against a kernel's own assignment."""
    x = flat_inputs.detach()
    cb = codebook.detach()
    k = cb.shape[1]
    if indices is None:
        dist = (torch.sum(x * x, dim=1, keepdim=True) - 2.0 * (x @ cb)
                + torch.sum(cb * cb, dim=0, keepdim=True))
        dist = torch.where(sel[None, :] > 0.0, dist,
                           torch.full_like(dist, BIG))
        indices = torch.argmin(dist, dim=1)  # the first index on ties
    indices = indices.long()
    onehot = torch.nn.functional.one_hot(indices, k).to(x.dtype)
    oh_m = onehot * rowmask[:, None]
    counts = torch.sum(oh_m, dim=0)
    dw = x.T @ oh_m

    one_m_decay = 1.0 - decay
    log_decay = torch.log(torch.tensor(decay, dtype=x.dtype, device=x.device))
    debias = 1.0 - torch.exp(counter.to(x.dtype) * log_decay)
    new_hcs = hidden_cs - (hidden_cs - counts) * one_m_decay
    ema_cs = new_hcs / debias
    new_hdw = hidden_dw - (hidden_dw - dw) * one_m_decay
    ema_dw = new_hdw / debias
    n_total = torch.sum(ema_cs)
    smoothed = (ema_cs + epsilon) / (n_total + k * epsilon) * n_total
    used = (counts > 0.0).to(x.dtype)
    update = (ema_dw / smoothed[None, :] * used[None, :]
              + cb * (1.0 - used[None, :]))
    return {
        "indices": indices.to(torch.int32),
        "quantized": cb.T[indices],
        "counts": counts,
        "hidden_cs": new_hcs,
        "hidden_dw": new_hdw,
        "update": update,
    }


@torch.no_grad()
def vq_fused_train(codebook, flat_inputs, rowmask, sel, hidden_cs, hidden_dw,
                   counter, *, decay, epsilon):
    """Fused training-mode VQ step.

    codebook [D, K]; flat_inputs [N, D] (any N); rowmask [N] validity
    weights; sel [K] usable-code mask (1 = usable), the dropout already
    drawn; hidden_cs [K] and hidden_dw [D, K], the EMA hidden values;
    counter: 0-dim float32 tensor, the ALREADY-INCREMENTED EMA counter
    (read on the device, so the call does not synchronise). All float32.
    Returns dict: indices [N] int32, quantized [N, D], counts [K],
    hidden_cs [K], hidden_dw [D, K], update [D, K]; none carries a gradient.
    """
    global LAUNCHES
    if flat_inputs.device.type == "cpu":
        return vq_fused_train_reference(
            codebook, flat_inputs, rowmask, sel, hidden_cs, hidden_dw,
            counter, decay=decay, epsilon=epsilon)
    device = flat_inputs.device
    n, d = flat_inputs.shape
    k = codebook.shape[1]
    f32 = torch.float32
    tensors = {
        "codebook": (codebook.detach(), (d, k)),
        "flat_inputs": (flat_inputs.detach(), (n, d)),
        "rowmask": (rowmask.detach(), (n,)), "sel": (sel.detach(), (k,)),
        "hidden_cs": (hidden_cs, (k,)), "hidden_dw": (hidden_dw, (d, k)),
        "counter": (counter.reshape(-1), (1,)),
    }
    for name, (t, shape) in tensors.items():
        kbuild.check_tensor(name, t, shape, f32, device)
    lib = _library()
    if d > MAX_DIM or lib.vq_fused_train_smem(d, k) > MAX_SMEM:
        raise ValueError(
            f"vq_fused_train takes D <= {MAX_DIM} and a codebook whose "
            f"block state fits {MAX_SMEM} bytes of shared memory; got "
            f"D={d}, K={k} ({lib.vq_fused_train_smem(d, k)} bytes)")
    blocks = lib.vq_fused_train_blocks(n)
    out = {
        "indices": torch.empty((n,), dtype=torch.int32, device=device),
        "quantized": torch.empty((n, d), dtype=f32, device=device),
        "counts": torch.empty((k,), dtype=f32, device=device),
        "hidden_cs": torch.empty((k,), dtype=f32, device=device),
        "hidden_dw": torch.empty((d, k), dtype=f32, device=device),
        "update": torch.empty((d, k), dtype=f32, device=device),
    }
    partial_dw = torch.empty((blocks, d * k), dtype=f32, device=device)
    partial_counts = torch.empty((blocks, k), dtype=f32, device=device)
    t = {name: v[0] for name, v in tensors.items()}
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vq_fused_train_launch(
            t["flat_inputs"].data_ptr(), t["codebook"].data_ptr(),
            t["rowmask"].data_ptr(), t["sel"].data_ptr(),
            t["hidden_cs"].data_ptr(), t["hidden_dw"].data_ptr(),
            t["counter"].data_ptr(), out["indices"].data_ptr(),
            out["quantized"].data_ptr(), out["counts"].data_ptr(),
            out["hidden_cs"].data_ptr(), out["hidden_dw"].data_ptr(),
            out["update"].data_ptr(), partial_dw.data_ptr(),
            partial_counts.data_ptr(), n, d, k, float(decay),
            float(epsilon), stream)
    if err != 0:
        raise RuntimeError(f"vq_fused_train: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return out
