"""Fused VQ-EMA training step: the CUDA build, the wrapper, and its plain
PyTorch version.

The kernel (``csrc/vq_kernel.cu``) replaces the Pallas TPU kernel
``vqnerf_release_tpu/ops/pallas/vq_kernel.py::vq_fused_train``: nearest-code
assignment with dropped codes masked at 1e30, the quantized rows, the masked
counts and dw = x^T (onehot * rowmask), and the Sonnet EMA epilogue that
proposes the new codebook. It is one CUDA launch per call, a cooperative
one: behind a barrier of the whole grid the blocks share the sum of their
partial statistics and the epilogue. ``kernels/build.py`` compiles it with
``nvcc`` for ``sm_90a`` at first use and binds it with ``ctypes``.

A call makes two allocations, both fresh: one float32 buffer that holds
quantized, counts, hidden_cs, hidden_dw and update (each a view at a
16-byte-aligned offset) and one int32 buffer for the indices. They are
fresh because they outlive the call: hidden_cs and hidden_dw are the next
step's EMA state, and quantized enters the autograd graph. The kernel's
scratch (the blocks' partial sums) is the opposite: one buffer per device,
kept by this module and grown when a call needs more; its contents mean
nothing between calls. Calls on one stream are ordered and may share it;
calls on two streams of one device must not run at once.

``vq_fused_train`` takes the plain version ``vq_fused_train_reference`` only
for CPU tensors. For CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts calls that launched the kernel. Nothing here takes part
in autograd: inputs are detached and outputs carry no gradient, as in the
JAX package, where the commitment loss and the straight-through estimator
stay outside the kernel.
"""

import ctypes
import functools

import torch

from . import build as kbuild

__all__ = ["LAUNCHES", "SOURCE", "BIG", "build", "load", "smem_bytes",
           "grid_blocks", "scratch_floats", "output_layout",
           "allocate_outputs", "vq_fused_train", "vq_fused_train_reference"]

LAUNCHES = 0

SOURCE = kbuild.CSRC_DIR / "vq_kernel.cu"
BIG = 1e30  # distance of a dropped code
MAX_DIM = 256  # a row lives in registers, 8 floats per lane
MAX_CODES = 256  # a thread of a block per code
MAX_SMEM = 232448  # the 227 KB of shared memory a block can be given
# the grid: about ROWS_PER_BLOCK rows a block (one pass of four rows a
# warp), at most MAX_BLOCKS blocks and never more than the card has SMs: the
# launch is cooperative, and a block's shared memory fills an SM
ROWS_PER_BLOCK = 32
MAX_BLOCKS = 128
_WARPS = 8  # of a block
_GROUP = 16  # codes reduced across the lanes together
_ROW_PAD = 4  # floats between the transposed codebook's rows

_lib = None
_scratch = {}  # device index -> the kernel's scratch buffer


def build(extra_flags=()):
    """Compile the kernel unless its library exists; see ``build.build``.
    The port builds with nvcc's default FMA contraction; ``extra_flags``
    lets the card-only tests build it with ``-fmad=false`` beside that."""
    return kbuild.build(SOURCE, "vq", extra_flags)


def load(so):
    """The ctypes library of a built kernel."""
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    return kbuild.load(so, {
        "vq_fused_train_smem": [i32, i32],
        "vq_fused_train_launch": [ptr] * 14 + [i32] * 4 + [f64] * 2
        + [i32, ptr],
    })


def smem_bytes(d, k):
    """Dynamic shared memory of a block, as ``vq_fused_train_smem`` of the
    source computes it."""
    kp = -(-k // _GROUP) * _GROUP
    return 4 * (k * (d + _ROW_PAD) + _WARPS * k * d + (2 + _WARPS) * kp)


def grid_blocks(n, sms=MAX_BLOCKS):
    """Blocks of the launch for n rows on a card of ``sms`` SMs."""
    return max(1, min(MAX_BLOCKS, sms, -(-n // ROWS_PER_BLOCK)))


def scratch_floats(blocks, d, k):
    """Floats of scratch that a launch of ``blocks`` blocks needs: a block's
    [K, D] sums and its counts, padded to a multiple of 16 codes."""
    return blocks * (k * d + -(-k // _GROUP) * _GROUP)


@functools.lru_cache(maxsize=64)
def output_layout(n, d, k):
    """Where each float32 output lies in the call's one output buffer:
    ({name: (offset in floats, shape)}, floats in all). Every offset is a
    multiple of 4 floats, so every view is 16-byte aligned."""
    layout, offset = {}, 0
    for name, shape in (("quantized", (n, d)), ("counts", (k,)),
                        ("hidden_cs", (k,)), ("hidden_dw", (d, k)),
                        ("update", (d, k))):
        layout[name] = (offset, shape)
        size = shape[0] * (shape[1] if len(shape) > 1 else 1)
        offset += -(-size // 4) * 4
    return layout, offset


def allocate_outputs(n, d, k, device):
    """The result dict of ``vq_fused_train`` over two fresh buffers."""
    layout, total = output_layout(n, d, k)
    buf = torch.empty((total,), dtype=torch.float32, device=device)
    out = {"indices": torch.empty((n,), dtype=torch.int32, device=device)}
    for name, (offset, shape) in layout.items():
        size = shape[0] * (shape[1] if len(shape) > 1 else 1)
        out[name] = buf[offset:offset + size].view(shape)
    return out


def _scratch_for(device, floats):
    buf = _scratch.get(device.index)
    if buf is None or buf.numel() < floats:
        buf = torch.empty((floats,), dtype=torch.float32, device=device)
        _scratch[device.index] = buf
    return buf


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
    (read on the device, so the call does not synchronise). All float32;
    on the card D is a multiple of 4 and flat_inputs 16-byte aligned.
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
    x = flat_inputs.detach()
    cb = codebook.detach()
    rowmask = rowmask.detach()
    sel = sel.detach()
    counter = counter.reshape(-1)
    kbuild.check_tensors(
        (("codebook", cb, (d, k)), ("flat_inputs", x, (n, d)),
         ("rowmask", rowmask, (n,)), ("sel", sel, (k,)),
         ("hidden_cs", hidden_cs, (k,)), ("hidden_dw", hidden_dw, (d, k)),
         ("counter", counter, (1,))), torch.float32, device)
    if (d > MAX_DIM or d % 4 or d < 4 or not 1 <= k <= MAX_CODES
            or smem_bytes(d, k) > MAX_SMEM):
        raise ValueError(
            f"vq_fused_train takes D <= {MAX_DIM}, a multiple of 4, and 1 to "
            f"{MAX_CODES} codes whose block state fits {MAX_SMEM} bytes of "
            f"shared memory; got D={d}, K={k} ({smem_bytes(d, k)} bytes)")
    if x.data_ptr() % 16:
        raise ValueError("flat_inputs: expected a 16-byte-aligned tensor")
    blocks = grid_blocks(
        n, torch.cuda.get_device_properties(device).multi_processor_count)
    out = allocate_outputs(n, d, k, device)
    scratch = _scratch_for(device, scratch_floats(blocks, d, k))
    err = _library().vq_fused_train_launch(
        x.data_ptr(), cb.data_ptr(), rowmask.data_ptr(), sel.data_ptr(),
        hidden_cs.data_ptr(), hidden_dw.data_ptr(), counter.data_ptr(),
        out["indices"].data_ptr(), out["quantized"].data_ptr(),
        out["counts"].data_ptr(), out["hidden_cs"].data_ptr(),
        out["hidden_dw"].data_ptr(), out["update"].data_ptr(),
        scratch.data_ptr(), n, d, k, blocks, float(decay), float(epsilon),
        device.index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vq_fused_train: kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES += 1
    return out
