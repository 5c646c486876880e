"""Train views resident on the device: per-step batches are gathered there
from view buffers staged once (counterpart of
vqnerf_release_tpu/data/device_store.py, without its uint8, sharded and
scanned layouts).

The host path copies a gathered batch (4.3 MB per step with a 512-light
lvis) to the device every step. With the views staged, the host ships only
the sampled ray indices (16 KB per step) and ``gather`` is an
``index_select`` per buffer. Index selection stays on the host
(``data.sampler.sample_pix``, the same RandomState consumption as
``outer_sample``), so device-gathered and host-gathered batches are equal
bit for bit.

Memory: one [V, H*W, C] float32 tensor per buffer key. A 512x512 view with
a 512-light lvis is 0.55 GB, so a 100-view scene is 55 GB. The 'auto'
policy stages the views only when they fit half of the device memory that
is free at that moment (``torch.cuda.mem_get_info``).
"""

import numpy as np
import torch

__all__ = ["DeviceViewStore", "store_nbytes", "views_compatible",
           "fits_device_memory"]

_KEYS = ("rayo", "rayd", "rgb", "alpha", "pred_alpha", "xyz", "normal",
         "lvis", "ref")

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


def store_nbytes(views):
    """Device bytes the store needs for these views."""
    return sum(len(views) * _rows(getattr(views[0], k)).size * 4
               for k in _view_keys(views[0]))


def views_compatible(views):
    """True iff every view has view[0]'s resolution and buffers: the store
    stacks [V, H*W, C] per buffer, so a mixed dataset takes the host
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


def fits_device_memory(views, device, budget_bytes=None):
    """The 'auto' policy: stage the views iff they fit the budget, by
    default half of the device memory that is free now."""
    if budget_bytes is None:
        device = torch.device(device)
        if device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(device)
            budget_bytes = int(free * _BUDGET_SHARE)
        else:
            budget_bytes = _DEFAULT_BUDGET_BYTES
    return store_nbytes(views) <= budget_bytes


class DeviceViewStore:
    """The views' buffers as float32 tensors [V, H*W, C] on ``device``."""

    def __init__(self, views, device):
        if not views_compatible(views):
            raise ValueError("DeviceViewStore needs views of one resolution "
                             "and one set of buffers")
        self.device = torch.device(device)
        self.n_views = len(views)
        self.arrays = {}
        for k in _view_keys(views[0]):
            rows = _rows(getattr(views[0], k))
            buf = torch.empty((len(views),) + rows.shape, dtype=torch.float32,
                              device=self.device)
            for i, v in enumerate(views):  # view by view: no stacked host copy
                buf[i].copy_(torch.from_numpy(
                    np.ascontiguousarray(_rows(getattr(v, k)), np.float32)))
            self.arrays[k] = buf

    def gather(self, view_index, flat_pix):
        """The batch dict of rows ``flat_pix`` (host int array or tensor)
        of view ``view_index``; equals ``outer_sample``'s gather."""
        idx = torch.as_tensor(flat_pix, dtype=torch.int64).to(
            self.device, non_blocking=True)
        return {k: buf[view_index].index_select(0, idx)
                for k, buf in self.arrays.items()}
