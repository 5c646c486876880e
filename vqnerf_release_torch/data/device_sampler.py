"""Jitter-pair ray sampling on the device, for the scanned training dispatch
(counterpart of vqnerf_release_tpu/data/device_sampler.py).

The selection is ``data.sampler.sample_pix``'s: per interior pixel one of
the 8 neighbours (the one of largest RGB contrast in 'contrast' mode, a
uniform draw in 'random' mode), kept where BOTH alphas pass the threshold,
n_rays kept pixels drawn with replacement, interleaved [p, p_jit, ...]
flat indices. It runs on the device from the staged store, so that a
dispatch ships no indices; the draws come from a device ``torch.Generator``
instead of the host's RandomState, so the batches are distributed as the
host sampler's but not equal to them: an explicit opt-in
(``DecompConfig.device_sampling``).

The draws are separate from the selection: ``draw`` makes a step's integer
jitter draw and its uniforms, ``pairs`` turns a view index, jitter indices
and selection indices into the flat indices. ``pairs`` fed the JAX
sampler's own ``jax.random.randint`` draws gives its indices exactly.
An all-background view gives pad rows (``store.pad_index``, the store's
zero row: alpha 0, masked downstream) instead of the host path's error.
"""

import numpy as np
import torch

from .sampler import _JITTERS

__all__ = ["make_device_sampler", "contrast_jitter"]


def contrast_jitter(view):
    """[(h - 2) * (w - 2)] int: the neighbour of largest channel-max |rgb
    delta| of each interior pixel (first on ties), as ``sample_pix`` picks
    it; a training-time constant, computed once on the host."""
    h, w = view.h, view.w
    rgb = np.asarray(view.rgb, np.float32).reshape(h, w, 3)
    center = rgb[1:-1, 1:-1]
    deltas = np.stack([
        np.max(np.abs(rgb[1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx] - center),
               axis=-1) for dy, dx in _JITTERS])  # [8, h - 2, w - 2]
    return np.argmax(deltas, axis=0).reshape(-1)


class _DeviceSampler:
    """Samples pairs of one homogeneous view list staged in ``store``."""

    def __init__(self, store, views, n_rays, jitter_mode="random",
                 alpha_thres=0.9):
        if jitter_mode not in ("random", "contrast"):
            raise ValueError(f"unknown jitter_mode {jitter_mode!r}")
        if len({(v.h, v.w) for v in views}) != 1:
            raise ValueError("device sampling needs views of one shape")
        if store.sharded:
            raise ValueError("device sampling needs a replicated store, not "
                             "device_views='shard'")
        h, w = views[0].h, views[0].w
        dev = store.device
        self.store = store
        self.n_rays = n_rays
        self.jitter_mode = jitter_mode
        self.alpha_thres = alpha_thres
        self.n_interior = (h - 2) * (w - 2)
        self.offsets = torch.as_tensor(
            [dy * w + dx for dy, dx in _JITTERS], dtype=torch.int64,
            device=dev)
        ys = torch.arange(1, h - 1, device=dev)[:, None]
        xs = torch.arange(1, w - 1, device=dev)[None, :]
        self.centers = (ys * w + xs).reshape(-1)  # [(h-2)(w-2)]
        self.jitter_table = None
        if jitter_mode == "contrast":
            self.jitter_table = torch.as_tensor(
                np.stack([contrast_jitter(v) for v in views]),
                dtype=torch.int64, device=dev)  # [V, (h-2)(w-2)]

    def draw(self, generator):
        """One step's draws: (jitter indices [(h-2)(w-2)] uint8, or None in
        'contrast' mode; uniforms [n_rays] float32)."""
        dev = self.store.device
        jidx = None
        if self.jitter_mode == "random":
            jidx = torch.randint(0, 8, (self.n_interior,), generator=generator,
                                 device=dev, dtype=torch.uint8)
        u = torch.rand((self.n_rays,), generator=generator, device=dev)
        return jidx, u

    def candidates(self, view_index, jidx=None):
        """(centres, their jitter partners, the running count of kept
        pairs [(h-2)(w-2)]) of view ``view_index`` (a device tensor);
        ``jidx`` the jitter indices in 'random' mode."""
        vi = view_index.reshape(()).to(torch.int64)
        if jidx is None:
            jidx = self.jitter_table.index_select(0, vi.reshape(1))[0]
        cj = self.centers + self.offsets[jidx.to(torch.int64)]
        both = torch.cat([self.centers, cj])
        alpha = self.store.gather_at(vi, both, keys=("alpha",))["alpha"]
        alpha, alpha_j = alpha[:, 0].split(self.n_interior)
        keep = (alpha > self.alpha_thres) & (alpha_j > self.alpha_thres)
        return self.centers, cj, torch.cumsum(keep.to(torch.int64), 0)

    def _select(self, centers, cj, cs, sel):
        # the sel-th kept pair (0-based) is the first position whose running
        # count exceeds sel; pad rows where nothing is kept
        pos = torch.clamp(torch.searchsorted(cs, sel + 1, side="left"),
                          max=cs.shape[0] - 1)
        empty = cs[-1] == 0
        pad = self.store.pad_index
        pc = torch.where(empty, pad, centers[pos])
        pj = torch.where(empty, pad, cj[pos])
        return torch.stack([pc, pj], dim=-1).reshape(-1)

    def pairs(self, view_index, jidx, sel):
        """[2 n_rays] flat indices from the jitter indices (None in
        'contrast' mode) and the selection ``sel`` [n_rays], integers in
        [0, max(count, 1)) over the kept pairs in raster order."""
        return self._select(*self.candidates(view_index, jidx),
                            sel.to(torch.int64))

    def __call__(self, view_index, jidx, u):
        """[2 n_rays] flat indices of view ``view_index`` from a step's
        draws (``draw``): the selection is floor(u max(count, 1))."""
        centers, cj, cs = self.candidates(view_index, jidx)
        count = torch.clamp(cs[-1], min=1)
        sel = torch.minimum((u.to(torch.float64) * count).to(torch.int64),
                            count - 1)
        return self._select(centers, cj, cs, sel)


def make_device_sampler(store, views, n_rays, jitter_mode="random",
                        alpha_thres=0.9):
    """The sampler of ``views`` (the store's, in its order)."""
    return _DeviceSampler(store, views, n_rays, jitter_mode=jitter_mode,
                          alpha_thres=alpha_thres)
