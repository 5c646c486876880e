"""A device mesh as a list of devices along the ray axis, and the row
sharding of batches over it (counterpart of
vqnerf_release_tpu/parallel/mesh.py, whose mesh is a 1-D
``jax.sharding.Mesh`` over the 'rays' axis)."""

import numpy as np
import torch

__all__ = ["get_mesh", "shard_batch", "pad_to_multiple", "pad_rows",
           "row_blocks", "MeshStreams"]


def get_mesh(devices=None, device_type="cuda"):
    """The mesh: a list of torch devices in ray-axis order, with each CUDA
    device's index filled in. ``devices``: a list of devices or names
    (``["cuda:0", "cuda:1"]``; a device may repeat, which keeps several
    replicas on one card), or None for every local device of
    ``device_type`` (all CUDA devices; the CPU is one device)."""
    from ..utils.device import resolve_device

    if devices is None:
        if torch.device(device_type).type == "cuda":
            devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
        else:
            devices = [device_type]
        if not devices:
            raise RuntimeError("get_mesh: no CUDA device is visible")
    return [resolve_device(d) for d in devices]


def pad_to_multiple(arr, multiple, axis=0, pad_value=0.0):
    """Pad axis 0 up to a multiple (so uneven ray counts shard evenly).
    Returns (padded, original_len)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr, n
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(np.asarray(arr), widths, constant_values=pad_value), n


def row_blocks(n, n_blocks):
    """[(start, stop)] of n rows in n_blocks contiguous blocks whose sizes
    differ by at most one, the larger first (``torch.tensor_split``'s)."""
    size, extra = divmod(n, n_blocks)
    bounds, start = [], 0
    for i in range(n_blocks):
        stop = start + size + (1 if i < extra else 0)
        bounds.append((start, stop))
        start = stop
    return bounds


# keys whose padded rows are zero: the alpha that masks a row out
_MASK_KEYS = ("alpha", "pred_alpha")


def pad_rows(batch, n_pad):
    """``batch`` with n_pad rows appended: copies of its last row, with
    alpha and pred_alpha 0, so that they are background everywhere. (Zero
    rows, which the JAX package appends, render black, and
    ``rgb2chromaticity``'s square root has an infinite derivative at 0: the
    masked-out row's 0 x inf poisons the gradient with NaN.)"""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            tail = v[-1:].expand((n_pad,) + tuple(v.shape[1:]))
            tail = torch.zeros_like(tail) if k in _MASK_KEYS else tail
            out[k] = torch.cat([v, tail])
        else:
            tail = np.repeat(np.asarray(v)[-1:], n_pad, axis=0)
            if k in _MASK_KEYS:
                tail = np.zeros_like(tail)
            out[k] = np.concatenate([v, tail])
    return out


def shard_batch(batch, mesh):
    """A dict-of-arrays batch (numpy arrays or tensors) -> (blocks,
    n_orig): blocks[i] holds the i-th contiguous row block of every array,
    as float32 tensors on mesh[i]. The ray axis is first padded to a
    multiple of the device count (``pad_rows``: padded rows carry alpha 0,
    so they behave as background)."""
    n_dev = len(mesh)
    n_orig = next(iter(batch.values())).shape[0]
    if n_orig % n_dev:
        batch = pad_rows(batch, n_dev - n_orig % n_dev)
    n = next(iter(batch.values())).shape[0]
    blocks = []
    for dev, (a, b) in zip(mesh, row_blocks(n, n_dev)):
        blocks.append({k: torch.as_tensor(v[a:b], dtype=torch.float32,
                                          device=dev)
                       for k, v in batch.items()})
    return blocks, n_orig


class MeshStreams:
    """A CUDA stream for every entry of a mesh of CUDA devices, also where
    entries share a card, so that each entry's work, and every copy to or
    from its device, is ordered by events against the stream that called:
    ``map`` forks every entry's stream from the calling stream of mesh[0],
    runs ``fn(i)`` on entry i's stream and joins them all back. Inside a
    CUDA graph capture this is how the further devices' work becomes part
    of the graph (a copy to a device whose current stream is not captured
    breaks the capture). On the CPU, or on a mesh of one entry, ``map``
    calls ``fn(i)`` in turn on the current stream."""

    def __init__(self, mesh):
        self.mesh = list(mesh)
        self.streams = None
        if len(self.mesh) > 1 and self.mesh[0].type == "cuda":
            self.streams = [torch.cuda.Stream(d) for d in self.mesh]

    def guard(self, tensors):
        """Mark every CUDA tensor of ``tensors`` as in use by each entry's
        stream on its device (``Tensor.record_stream``), so that the caching
        allocator hands its memory to no other work before those streams
        are done with it (a batch made on another thread, or freed before
        the streams ran). Does nothing on the CPU, on a mesh of one entry
        and inside a graph capture."""
        if self.streams is None or torch.cuda.is_current_stream_capturing():
            return
        for t in tensors:
            for s in self.streams:
                if t.device == s.device:
                    t.record_stream(s)

    def map(self, fn):
        """[fn(i) for every mesh entry i], entry i's work on its stream."""
        if self.streams is None:
            return [fn(i) for i in range(len(self.mesh))]
        caller = torch.cuda.current_stream(self.mesh[0])
        out = []
        for i, s in enumerate(self.streams):
            s.wait_stream(caller)
            with torch.cuda.stream(s):
                out.append(fn(i))
        for s in self.streams:
            caller.wait_stream(s)
        return out
