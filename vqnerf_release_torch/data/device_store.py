"""Train views resident on the device: per-step batches are gathered there
from view buffers staged once (counterpart of
vqnerf_release_tpu/data/device_store.py, with its float32, uint8 and
row-sharded layouts).

The host path copies a gathered batch (4.3 MB per step with a 512-light
lvis) to the device every step. With the views staged, the host ships only
the sampled ray indices (16 KB per step) and a gather is an
``index_select`` per buffer. Index selection stays on the host
(``data.sampler.sample_pix``, the same RandomState consumption as
``outer_sample``), so device-gathered and host-gathered batches are equal
bit for bit; or, with ``device_sampling``, on the device
(``data/device_sampler.py``).

Memory: one [V, H*W + 1, C] tensor per buffer key, as the JAX store lays
it out: the row past each view's pixels is zeros, the row a sampler names
(``pad_index``) where a view has no foreground pair (alpha 0, masked). A
512x512 view with a 512-light lvis is 0.55 GB in float32, so a 100-view
scene is 55 GB. ``quant=True`` (``device_views='u8'``) stages the [0, 1]
buffers of ``_QUANT_KEYS`` (lvis, 97% of the bytes at 512 lights) as uint8,
rounded as the JAX store rounds them, and a gather dequantises its rows with
``* (1 / 255)``: about 4x smaller, within 1/510 of the float32 store, and
equal to the JAX u8 gather bit for bit. The 'auto' policy stages float32
views only when they fit half of the device memory that is free at that
moment (``torch.cuda.mem_get_info``), and never quantises on its own.

Row-sharded (``shard=True`` over a ``mesh`` of more than one entry,
``device_views='shard'``): each buffer's flat [V * (H*W + 1), C] rows,
padded at the end with zero rows (never indexed) to a multiple of the mesh
size, are cut in equal contiguous blocks, block s on mesh[s], so that an
entry holds 1/n of the store (``store_nbytes(..., shards=n)``). A gather
selects, on every shard's stream (``parallel.MeshStreams``), the rows at
its clamped local indices, copies them to the first device and keeps each
row from the shard that owns it (``torch.where``): a selection, so the
batch equals the replicated gather bit for bit (the JAX package's
reduce-scatter adds +0.0 from the other shards, which turns a stored -0.0
into +0.0). The shapes are static and nothing waits for the device, so a
captured step gathers from it.
"""

import numpy as np
import torch

from ..parallel.mesh import MeshStreams

__all__ = ["DeviceViewStore", "store_nbytes", "views_compatible",
           "fits_device_memory"]

_KEYS = ("rayo", "rayd", "rgb", "alpha", "pred_alpha", "xyz", "normal",
         "lvis", "ref")
# [0, 1] buffers that the u8 layout quantises (the JAX store's)
_QUANT_KEYS = ("lvis",)

# share of the free device memory that the staged views may take; the rest
# is for parameters, activations and the validation chunks
_BUDGET_SHARE = 0.5
# budget on a device that does not report its memory (the CPU)
_DEFAULT_BUDGET_BYTES = 4 << 30


def _rows(arr):
    arr = np.asarray(arr)
    return arr.reshape(arr.shape[0], -1)


def _view_keys(view):
    return [k for k in _KEYS if getattr(view, k, None) is not None]


def store_nbytes(views, quant=False, shards=1):
    """Device bytes the store needs for these views, on each device of a
    store row-sharded over ``shards`` devices (1: the whole store);
    ``quant`` prices the u8 layout (uint8 for ``_QUANT_KEYS``, float32 for
    the rest)."""
    total = 0
    for k in _view_keys(views[0]):
        n, c = _rows(getattr(views[0], k)).shape
        itemsize = 1 if (quant and k in _QUANT_KEYS) else 4
        total += -(-len(views) * (n + 1) // shards) * c * itemsize
    return total


def views_compatible(views):
    """True iff every view has view[0]'s resolution and buffers: the store
    stacks [V, H*W + 1, C] per buffer, so a mixed dataset takes the host
    path."""
    if not views:
        return False
    keys0 = _view_keys(views[0])
    for v in views[1:]:
        if _view_keys(v) != keys0:
            return False
        if any(_rows(getattr(v, k)).shape != _rows(getattr(views[0], k)).shape
               for k in keys0):
            return False
    return True


def fits_device_memory(views, device, budget_bytes=None, quant=False):
    """The 'auto' policy: stage the views iff they fit the budget, by
    default half of the device memory that is free now; ``quant`` prices
    the u8 layout."""
    if budget_bytes is None:
        device = torch.device(device)
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget_bytes = int(free * _BUDGET_SHARE)
        else:
            budget_bytes = _DEFAULT_BUDGET_BYTES
    return store_nbytes(views, quant=quant) <= budget_bytes


def _quantize(rows):
    """[0, 1] float rows -> uint8, as the JAX store rounds them."""
    return np.clip(np.rint(rows * 255.0), 0, 255).astype(np.uint8)


class DeviceViewStore:
    """The views' buffers as tensors [V, H*W + 1, C] on ``device`` (uint8
    for ``_QUANT_KEYS`` under ``quant``, float32 otherwise); row H*W of
    each view is zeros. With ``shard`` over a ``mesh`` of more than one
    entry (the first being ``device``) the flat rows are row-sharded over
    it instead (``shards``: {key: [block on mesh[s]]}; see the module
    docstring); on a mesh of one entry ``shard`` changes nothing."""

    def __init__(self, views, device, quant=False, mesh=None, shard=False):
        if not views_compatible(views):
            raise ValueError("DeviceViewStore needs views of one resolution "
                             "and one set of buffers")
        self.device = torch.device(device)
        self.quant = bool(quant)
        self.mesh = [torch.device(d) for d in mesh] if mesh else [self.device]
        self.sharded = bool(shard) and len(self.mesh) > 1
        self.n_views = len(views)
        self.pad_index = _rows(views[0].rayo).shape[0]  # the zero row
        self.row_stride = self.pad_index + 1
        n_rows = self.n_views * self.row_stride
        n_dev = len(self.mesh) if self.sharded else 1
        self.rows_local = -(-n_rows // n_dev)
        self.arrays, self.shards = {}, {}
        for k in _view_keys(views[0]):
            c = _rows(getattr(views[0], k)).shape[1]
            u8 = self.quant and k in _QUANT_KEYS
            dtype = torch.uint8 if u8 else torch.float32
            blocks = [torch.zeros((self.rows_local, c), dtype=dtype,
                                  device=self.mesh[s]) for s in range(n_dev)]
            for i, v in enumerate(views):  # view by view: no stacked host copy
                src = np.ascontiguousarray(_rows(getattr(v, k)), np.float32)
                src = torch.from_numpy(_quantize(src) if u8 else src)
                start = i * self.row_stride  # the view's first flat row
                for s, blk in enumerate(blocks):
                    lo = max(start, s * self.rows_local)
                    hi = min(start + self.pad_index, (s + 1) * self.rows_local)
                    if lo < hi:
                        blk[lo - s * self.rows_local:hi - s * self.rows_local
                            ].copy_(src[lo - start:hi - start])
            if self.sharded:
                self.shards[k] = blocks
            else:
                self.arrays[k] = blocks[0].view(self.n_views,
                                                self.row_stride, c)
        self._streams = MeshStreams(self.mesh) if self.sharded else None

    def gather(self, view_index, flat_pix):
        """The batch dict of rows ``flat_pix`` (host int array or tensor)
        of view ``view_index`` (an int); equals ``outer_sample``'s gather
        (within 1/510 for the u8 buffers)."""
        idx = torch.as_tensor(flat_pix, dtype=torch.int64).to(
            self.device, non_blocking=True)
        if self.sharded:
            return self._sharded_gather(idx + view_index * self.row_stride,
                                        self.shards)
        return {k: _dequantize(buf[view_index].index_select(0, idx))
                for k, buf in self.arrays.items()}

    def gather_at(self, view_index, flat_pix, keys=None):
        """``gather`` with the view index a device tensor ([] or [1],
        integer) and the rows [N] on the device: one flat row gather per
        buffer (of ``keys``, by default all), ``view_index * (H*W + 1) +
        flat_pix``, so that a captured step reads its view from a staged
        vector."""
        flat = (view_index.reshape(()).to(torch.int64) * self.row_stride
                + flat_pix.to(torch.int64))
        keys = keys or (self.shards if self.sharded else self.arrays)
        if not self.sharded:
            return {k: _dequantize(self.arrays[k].view(
                        -1, self.arrays[k].shape[-1]).index_select(0, flat))
                    for k in keys}
        return self._sharded_gather(flat, keys)

    def _sharded_gather(self, flat, keys):
        n = self.rows_local

        def local(s):  # shard s's rows at the clamped local indices
            loc = (flat.to(self.mesh[s]) - s * n).clamp_(0, n - 1)
            return {k: _dequantize(self.shards[k][s].index_select(0, loc)
                                   .to(self.device)) for k in keys}

        parts = self._streams.map(local)
        owner = (flat // n)[:, None]
        out = {}
        for k in keys:
            rows = parts[0][k]
            for s in range(1, len(parts)):
                rows = torch.where(owner == s, parts[s][k], rows)
            out[k] = rows
        return out


def _dequantize(rows):
    """Gathered rows as float32: uint8 ones times 1/255 (the JAX u8
    gather's float32 product)."""
    if rows.dtype == torch.uint8:
        return rows.to(torch.float32) * (1.0 / 255.0)
    return rows
