"""Train views resident on the device: per-step batches are gathered there
from view buffers staged once (counterpart of
vqnerf_release_tpu/data/device_store.py, with its float32 and uint8 layouts;
the row-sharded layout over a mesh is not ported).

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
"""

import numpy as np
import torch

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


def store_nbytes(views, quant=False):
    """Device bytes the store needs for these views; ``quant`` prices the
    u8 layout (uint8 for ``_QUANT_KEYS``, float32 for the rest)."""
    total = 0
    for k in _view_keys(views[0]):
        n, c = _rows(getattr(views[0], k)).shape
        itemsize = 1 if (quant and k in _QUANT_KEYS) else 4
        total += len(views) * (n + 1) * c * itemsize
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
    each view is zeros."""

    def __init__(self, views, device, quant=False):
        if not views_compatible(views):
            raise ValueError("DeviceViewStore needs views of one resolution "
                             "and one set of buffers")
        self.device = torch.device(device)
        self.quant = bool(quant)
        self.n_views = len(views)
        self.pad_index = _rows(views[0].rayo).shape[0]  # the zero row
        self.row_stride = self.pad_index + 1
        self.arrays = {}
        for k in _view_keys(views[0]):
            rows = _rows(getattr(views[0], k))
            u8 = self.quant and k in _QUANT_KEYS
            buf = torch.zeros((len(views), self.row_stride, rows.shape[1]),
                              dtype=torch.uint8 if u8 else torch.float32,
                              device=self.device)
            for i, v in enumerate(views):  # view by view: no stacked host copy
                src = np.ascontiguousarray(_rows(getattr(v, k)), np.float32)
                buf[i, :self.pad_index].copy_(torch.from_numpy(
                    _quantize(src) if u8 else src))
            self.arrays[k] = buf

    def gather(self, view_index, flat_pix):
        """The batch dict of rows ``flat_pix`` (host int array or tensor)
        of view ``view_index`` (an int); equals ``outer_sample``'s gather
        (within 1/510 for the u8 buffers)."""
        idx = torch.as_tensor(flat_pix, dtype=torch.int64).to(
            self.device, non_blocking=True)
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
        return {k: _dequantize(self.arrays[k].view(
                    -1, self.arrays[k].shape[-1]).index_select(0, flat))
                for k in (keys or self.arrays)}


def _dequantize(rows):
    """Gathered rows as float32: uint8 ones times 1/255 (the JAX u8
    gather's float32 product)."""
    if rows.dtype == torch.uint8:
        return rows.to(torch.float32) * (1.0 / 255.0)
    return rows
