"""Epoch-level training loops of stage 2's three phases (counterpart of
train_nfr_unit / train_vq_nfr / train_ref_nfr in
vqnerf_release_tpu/train/loop.py).

  * ``train_nfr_unit``: per epoch one step per train view (one view = one
    jitter-pair batch), a checkpoint and a validation every
    ``cfg_ckpt_period`` epochs, per-view renders, the metas rollup.
  * ``train_vq_nfr``: the latent k-means init of the codebook, a fixed VQ
    evaluation set, and per validation the codebook-dropout sweep with the
    elbow selection that names the ``main_<k>`` directory, loss.json,
    vq_test_loss.json and vq_num.png.
  * ``train_ref_nfr``: the residual model on top of a trained vq_nfr and
    its converged light (vq_nfr's ``vis_vali/np_light.npy``), on views
    loaded with ``with_ref=True``; per validation the full-view renders.

All three run on ``device`` ("cuda" unless the caller says otherwise) and raise
when it is not there. Ray sampling stays on the host under a seeded
``RandomState``; the code dropout draws from a seeded ``torch.Generator`` on
the device. A step never waits for the device: losses stay there until the
epoch ends.

**The host sampler** (the JAX package's default data path,
``VQNERF_NATIVE_SAMPLER``): unset or ``1``, the jitter pairs are picked by
the native library (``data/native.py``, built at first use; a failed build
raises), one child seed a call drawn from the ``RandomState``
(``sample_view_pix``), a dispatch's views over a thread pool with the seeds
drawn first (``sample_view_pix_many``), and on the host-gather path the rows
gathered natively (``outer_sample``); ``0`` samples in numpy
(``data/sampler.py``), the stream the JAX package's tests pin. Either way
every entry point consumes the ``RandomState`` as the JAX package's does.
Step by step, a background thread (``_prefetch``) samples, gathers and
copies up to two batches ahead of the steps.

**The scanned dispatch** (the JAX package's default, ``epoch_scan=None``:
on whenever the views are staged on the device): the epochs run in chunks
of ``epoch_scan_chunk`` (None: min(6, the checkpoint period); a chunk never
crosses a checkpoint or validation boundary, ``_chunk_plan``), each chunk
one dispatch of ``decomp_trainer.EpochScan``: the host samples the chunk's
ray indices at once (the same RandomState stream as the per-step path) and
stages them with the steps' learning rates and dropout draws, and the steps
run as replays of ONE captured CUDA graph of the per-step path's step (on
the CPU: the same step, eagerly), so that scanned and per-step runs are
equal bit for bit. The next chunk's host sampling overlaps the replays. The
divergence guard fires at the end of a chunk, on the state of that end.
``device_sampling`` (opt-in) samples the rays on the device instead
(``data/device_sampler.py``): a different stream, equally distributed.
``epoch_scan=False`` or views not staged take the per-step dispatch. Over a
device list the scan is the same: the captured step is the mesh step, with
every device's work forked from the capturing stream and joined back.

A checkpoint also holds the states of both random streams (for the scanned
dispatch, the state at the chunk's end, before the next chunk was sampled),
so that a resumed run continues the uninterrupted run's stream of batches.

Each phase trains over ``devices`` (a list, as ``parallel.get_mesh``
takes; by default ``device`` alone, where the JAX loop takes every device):
with more than one, every batch is split over them and the step reduces
the global batch's loss on the first (``train/decomp_trainer.py``).
Validation and checkpoints run on the first device.
"""

import contextlib
import copy
import json
import os
import queue
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from os.path import join

import numpy as np
import torch

from ..data import io as vio
from ..data import native as _native
from ..data.device_sampler import make_device_sampler
from ..data.device_store import (DeviceViewStore, fits_device_memory,
                                 views_compatible)
from ..data.sampler import build_vq_eval_set
from ..data.sampler import outer_sample as _outer_sample_np
from ..data.sampler import sample_pix
from ..eval.metrics import lpips_impl
from ..models import decomp_common as dc
from ..models.nfr_unit import init_nfr_unit, nfr_unit_forward
from ..models.ref_nfr import init_ref_nfr, ref_nfr_forward
from ..models.vq_nfr import init_vq_nfr, vq_nfr_forward, vq_test
from ..ops.colorspace import linear2srgb, srgb2linear
from ..ops.kmeans import kmeans
from ..ops.math import rgb2chromaticity
from ..ops.vq import VqEmaState, init_vq_ema_state
from ..parallel.mesh import get_mesh
from ..utils import ckpt as ckpt_util
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.html import write_vali_index
from ..utils.vis import vis_view
from . import decomp_trainer as dt

__all__ = ["train_nfr_unit", "train_vq_nfr", "train_ref_nfr", "save_metas",
           "elbow_select", "cfg_ckpt_period", "phase_model",
           "sample_view_pix", "sample_view_pix_many", "outer_sample"]

# Full-view validation forwards pass the WHOLE view (background rows too)
# through the model; at 512 lights the [N, L, 3] BRDF temporaries of a
# 262,144-ray view do not fit beside the staged views. The forwards are per
# ray, so chunking is exact for nfr_unit. For vq_nfr the dropout fill is the
# largest distance of each chunk, so the chunk is the JAX package's.
_VALI_RAY_CHUNK = 131072
# rows per BRDF/render chunk of the drop-loss sweep (its VQ lookup is one
# call over the whole evaluation set)
_VQ_TEST_RENDER_CHUNK = 65536


def _train_mesh(device, devices):
    """(first device, mesh) of a phase: ``devices`` when given, else
    ``device`` alone."""
    mesh = get_mesh(devices) if devices else [resolve_device(device)]
    return mesh[0], mesh


def _device_batch(batch, device):
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in batch.items()}


def _native_mode():
    """VQNERF_NATIVE_SAMPLER -> 'native' or 'numpy', the one place that
    reads it: '0' samples in numpy; anything else (unset, '1') natively,
    building the library at the first call (a failed build raises). Every
    sampler entry point routes through here, so that all of them consume
    the RandomState alike."""
    if os.environ.get("VQNERF_NATIVE_SAMPLER", "") == "0":
        return "numpy"
    _native.native_available()
    return "native"


def _native_select(view, n_rays, seed, jitter_mode, alpha_thres):
    """One native select_pairs call -> [2*n_rays] flat pixel indices."""
    coords = _native.select_pairs(
        view.alpha.reshape(view.h, view.w),
        view.rgb.reshape(view.h, view.w, 3), n_rays,
        jitter_mode=jitter_mode, alpha_thres=alpha_thres, seed=seed)
    return coords[:, 0] * view.w + coords[:, 1]


def _native_flat_pix(view, n_rays, rng, jitter_mode, alpha_thres):
    """Native index selection, or None for the numpy path; draws exactly
    one child seed from ``rng`` a call."""
    if _native_mode() == "numpy":
        return None
    return _native_select(view, n_rays, int(rng.randint(0, 2**31 - 1)),
                          jitter_mode, alpha_thres)


def sample_view_pix(view, n_rays, rng, jitter_mode="random",
                    alpha_thres=0.9):
    """[2*n_rays] flat pixel indices of interleaved (pixel, jitter) pairs,
    natively or in numpy (``_native_mode``; the same contract, different
    random streams)."""
    flat = _native_flat_pix(view, n_rays, rng, jitter_mode, alpha_thres)
    if flat is not None:
        return flat
    return sample_pix(view, n_rays, rng, jitter_mode=jitter_mode,
                      alpha_thres=alpha_thres)


_SAMPLER_POOL = None
_SAMPLER_POOL_LOCK = threading.Lock()


def _sampler_pool():
    """The threads that ``sample_view_pix_many`` maps over (at most 8),
    made at the first call."""
    global _SAMPLER_POOL
    with _SAMPLER_POOL_LOCK:
        if _SAMPLER_POOL is None:
            _SAMPLER_POOL = ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1),
                thread_name_prefix="pix-sampler")
    return _SAMPLER_POOL


def sample_view_pix_many(views, n_rays, rng, jitter_mode="random",
                         alpha_thres=0.9):
    """``sample_view_pix`` over a list of views, equal to the serial loop
    bit for bit. Natively, the loop draws only one child seed a view from
    ``rng``: the seeds are drawn first, serially, and the calls (which
    release the interpreter lock) run on a thread pool. In numpy ``rng``
    threads through every call, serially."""
    cause = profiling.current()  # the span the pool's selections belong to
    parent, step = (cause.id, cause.step) if cause else (None, None)
    if _native_mode() == "native":
        seeds = [int(rng.randint(0, 2**31 - 1)) for _ in views]

        def select(vs):
            with profiling.span("sampler.select", parent=parent, step=step):
                return _native_select(vs[0], n_rays, vs[1], jitter_mode,
                                      alpha_thres)
        return list(_sampler_pool().map(select, zip(views, seeds)))
    out = []
    for v in views:
        with profiling.span("sampler.select"):
            out.append(sample_view_pix(v, n_rays, rng,
                                       jitter_mode=jitter_mode,
                                       alpha_thres=alpha_thres))
    return out


def outer_sample(view, n_rays, rng, jitter_mode="random", alpha_thres=0.9):
    """``sample_view_pix`` and the gather of the pairs' rows on the host:
    the batch dict of the host-gather path (natively gathered on the native
    path)."""
    flat = _native_flat_pix(view, n_rays, rng, jitter_mode, alpha_thres)
    if flat is None:
        return _outer_sample_np(view, n_rays, rng, jitter_mode=jitter_mode,
                                alpha_thres=alpha_thres)
    return _native.gather_batch(view, flat)


def _prefetch(iterable, depth=2, device=None):
    """The items of ``iterable``, taken by a background thread up to
    ``depth`` ahead of the consumer, so that host sampling, gathering and
    the copy to the device overlap the steps. The items come in order; an
    exception of the worker is raised to the consumer after the items
    before it. On a CUDA ``device`` the worker issues its device work on
    the stream that is current there when ``_prefetch`` is called (the
    consumer's), so that work the consumer issues on that stream after it
    took an item is ordered after the item was made. Closing the generator
    early stops the worker before it takes another item."""
    stream = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(device)
    return _prefetched(iterable, depth, stream)


def _prefetched(iterable, depth, stream):
    items = queue.Queue(maxsize=depth)
    done = object()
    err = []
    stop = threading.Event()

    def worker():
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                it = iter(iterable)
                while not stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    items.put(item)
        except BaseException as e:  # raised in the consumer
            err.append(e)
        finally:
            items.put(done)

    thread = threading.Thread(target=worker, daemon=True,
                              name="batch-prefetch")
    thread.start()
    finished = False
    try:
        while True:
            item = items.get()
            if item is done:
                finished = True
                if err:
                    raise err[0]
                return
            yield item
    finally:
        if not finished:  # closed early: let the worker see stop and end
            stop.set()
            while items.get() is not done:
                pass
        thread.join()


def _make_batch_source(train_views, cfg, jitter_mode, device, mesh=None):
    """(epoch_batches, store). cfg.device_views: 'auto' stages the views on
    the device when they are of one shape and fit its memory budget, 'on'
    forces that, 'u8' forces it with lvis stored as uint8 (within 1/510;
    an opt-in because the batches are then no longer equal to the host
    path's), 'shard' row-shards the store over ``mesh`` (the first device
    ``device``; each device holds 1/n of the rows and the gather selects
    every row from the device that owns it, so the batches are equal bit
    for bit; on one device the same as 'on'), 'off' gathers every batch on
    the host and copies it over. With 'auto', 'on', 'shard' and 'off' the
    batches are equal bit for bit; store is None on the host path."""
    mode = cfg.device_views or "off"
    if mode not in ("auto", "on", "u8", "shard", "off"):
        raise ValueError("device_views must be 'auto', 'on', 'u8', "
                         "'shard' or 'off', got %r" % mode)
    store = None
    if train_views and mode in ("on", "u8", "shard"):
        store = DeviceViewStore(train_views, device, quant=mode == "u8",
                                mesh=mesh, shard=mode == "shard")
    elif train_views and mode == "auto":
        if not views_compatible(train_views):
            print("[vqnerf-torch] device_views=auto: heterogeneous views; "
                  "using the host-gather path")
        elif fits_device_memory(train_views, device):
            store = DeviceViewStore(train_views, device)
        else:
            hint = (" (device_views='u8' would fit by storing lvis as "
                    "uint8, within 1/510)"
                    if fits_device_memory(train_views, device, quant=True)
                    else "")
            print("[vqnerf-torch] device_views=auto: views exceed the "
                  "device-memory budget; using the host-gather path" + hint)

    def epoch_batches(rng):
        """One epoch's batches, sampled, gathered and copied to the device
        by ``_prefetch``'s thread; nothing else may draw from ``rng`` until
        the generator is exhausted."""
        if store is not None:
            return _prefetch(
                (store.gather(vi, sample_view_pix(
                    view, cfg.n_rays_per_step, rng, jitter_mode=jitter_mode))
                 for vi, view in enumerate(train_views)), device=device)
        return _prefetch(
            (_device_batch(outer_sample(
                view, cfg.n_rays_per_step, rng, jitter_mode=jitter_mode),
                device) for view in train_views), device=device)

    return epoch_batches, store


def _resolve_epoch_scan(cfg, store):
    """cfg.epoch_scan: None = auto (scan iff the store is active), on one
    device or a device list alike."""
    want = cfg.epoch_scan
    if want is None:
        return store is not None
    if want and store is None:
        print("[vqnerf-torch] epoch_scan requested but device_views is "
              "off or the views exceed the budget; dispatching step by step")
        return False
    return bool(want)


def _chunk_plan(epoch, epochs, period, chunk):
    """Epochs of the next scanned dispatch: never past the end and never
    across a checkpoint or validation boundary (those need the host)."""
    boundary = period - (epoch % period)
    return max(1, min(chunk, epochs - epoch, boundary))


def _resolve_scan_chunk(cfg, scan_on):
    """cfg.epoch_scan_chunk: None = auto, min(6, the checkpoint period) (the
    JAX package's policy: with _chunk_plan clipping at period boundaries a
    run sees at most two chunk lengths)."""
    if not scan_on:
        return 1
    if cfg.epoch_scan_chunk is not None:
        return max(1, int(cfg.epoch_scan_chunk))
    return min(6, cfg_ckpt_period(cfg))


def _scan_epoch_loop(start_epoch, epochs, period, chunk, sample_xs,
                     dispatch, fetch, post_epoch):
    """The chunked scanned dispatch of the three trainers.

    ``sample_xs(n_epochs)`` samples the next dispatch's inputs on the host
    (reading the trainer's step from its closure) and returns (xs, the host
    random state before it sampled); ``dispatch(xs)`` stages and runs them
    and returns the loss rows on the device, without waiting;
    ``fetch(rows, n_epochs)`` waits and returns one payload an epoch;
    ``post_epoch(e1, payload, wall_s, state_epoch, rng_state)`` logs,
    guards, checkpoints and validates, with ``rng_state`` the host random
    state at the chunk's end (None: the current one). The next chunk's
    sampling overlaps the dispatched one; wall_s is the chunk's wall time
    split over its epochs."""
    pending = None
    epoch = start_epoch
    while epoch < epochs:
        t_chunk = time.time()
        n_ep = _chunk_plan(epoch, epochs, period, chunk)
        xs, _ = pending if pending is not None else sample_xs(n_ep)
        rows = dispatch(xs)
        nxt = epoch + n_ep
        pending = (sample_xs(_chunk_plan(nxt, epochs, period, chunk))
                   if nxt < epochs else None)
        payloads = fetch(rows, n_ep)
        wall = (time.time() - t_chunk) / n_ep
        for j in range(n_ep):
            post_epoch(epoch + j + 1, payloads[j], wall, nxt,
                       None if pending is None else pending[1])
        epoch = nxt


def _resolve_device_sampling(cfg, store, train_views, jitter_mode):
    """cfg.device_sampling -> a device sampler for the scanned dispatch, or
    None (with a notice when the opt-in cannot apply)."""
    if not cfg.device_sampling:
        return None
    why = None
    if store is None:
        why = "the scanned device-store dispatch is not active"
    elif store.sharded:
        why = "device_views='shard' keeps the host index stream"
    elif len({(v.h, v.w) for v in train_views}) != 1:
        why = "views have heterogeneous shapes"
    if why:
        print("[vqnerf-torch] device_sampling requested but %s; sampling on "
              "the host" % why, file=sys.stderr)
        return None
    return make_device_sampler(store, train_views, cfg.n_rays_per_step,
                               jitter_mode=jitter_mode)


def _sampling_base_key(seed):
    """Seed of the device sampling's stream, apart from the dropout stream
    (seeded with ``seed``) by a fixed fold; step s draws from
    ``_sampling_base_key(seed) + s``, so a resumed run draws what the
    uninterrupted one draws."""
    return (int(seed) * (1 << 32) + 0x53616D70) % (1 << 63)


def _epoch_scan_xs_nopix(train_views, cfg, step0, n_epochs=1):
    """(vi [E*K], steps [E*K], lrs [E*K]) of a dispatch: the view of each
    step, its global index, and decomp_lr's value in float32."""
    k = len(train_views)
    vi = np.tile(np.arange(k, dtype=np.int64), n_epochs)
    steps = step0 + np.arange(n_epochs * k, dtype=np.int64)
    lrs = np.asarray([dt.decomp_lr(int(s), cfg) for s in steps], np.float32)
    return vi, steps, lrs


def _epoch_scan_xs(train_views, cfg, rng, jitter_mode, step0, n_epochs=1,
                   sampler=None, seed=0):
    """The host half of a dispatch of ``n_epochs`` whole epochs, as
    ``EpochScan.stage`` takes it: vi, lrs, and the ray indices pix
    [E*K, 2n] sampled epoch by epoch (``sample_view_pix_many``: the
    per-step path's RandomState stream) or, with a device ``sampler``, one
    seed a step."""
    with profiling.span("loop.sample", step=int(step0)):
        vi, steps, lrs = _epoch_scan_xs_nopix(train_views, cfg, step0,
                                              n_epochs)
        if sampler is not None:
            return {"vi": vi, "lrs": lrs,
                    "sampling_seeds": _sampling_base_key(seed) + steps}
        pix = np.stack(sample_view_pix_many(
            [v for _ in range(n_epochs) for v in train_views],
            cfg.n_rays_per_step, rng, jitter_mode=jitter_mode))
        return {"vi": vi, "lrs": lrs, "pix": pix}


def _rows_to_dicts(rows, keys):
    """Loss rows [n, len(keys)] on the device -> n {name: float}, one copy
    from the device."""
    with profiling.span("loop.fetch"):
        mat = rows.cpu().numpy().astype(np.float64)
    return [{k: float(mat[j, i]) for i, k in enumerate(keys)}
            for j in range(mat.shape[0])]


def _split_epochs(items, n_epochs, k_steps):
    return [items[j * k_steps:(j + 1) * k_steps] for j in range(n_epochs)]


def _epoch_dir(outdir, epoch):
    return join(outdir, "vis_vali", "epoch%09d" % epoch)


def _log_scalars(outdir, epoch, scalars):
    """Append an epoch's scalars to train_log.jsonl."""
    os.makedirs(outdir, exist_ok=True)
    with open(join(outdir, "train_log.jsonl"), "a") as f:
        f.write(json.dumps({"epoch": epoch, **scalars}) + "\n")


def _sync_scalar_dicts(dicts):
    """A list of {name: 0-dim tensor} -> a list of {name: float}, with one
    copy from the device for the whole epoch."""
    if not dicts:
        return []
    keys = sorted(dicts[0])
    mat = torch.stack([torch.stack([d[k].to(torch.float32) for k in keys])
                       for d in dicts]).cpu().numpy().astype(np.float64)
    return [{k: float(mat[j, i]) for i, k in enumerate(keys)}
            for j in range(mat.shape[0])]


def _finite_mean(vals):
    """Mean over the healthy steps only: a step skipped by the non-finite
    guard carries a NaN loss but changed nothing. Returns (mean, n_skipped);
    the mean is NaN iff EVERY step was skipped."""
    arr = np.asarray(vals, np.float64)
    finite = np.isfinite(arr)
    mean = float(arr[finite].mean()) if finite.any() else float("nan")
    return mean, int((~finite).sum())


def _check_finite(outdir, phase, epoch, scalars, state, state_epoch=None):
    """Divergence guard: on a non-finite epoch loss, checkpoint the failing
    state under <outdir>/debug_failure/ and raise with context. Under the
    scanned dispatch the state within a chunk cannot be observed;
    ``state_epoch`` names the chunk's end, whose state is saved."""
    bad = {k: v for k, v in scalars.items()
           if not np.isfinite(np.asarray(v)).all()}
    if not bad:
        return
    state_epoch = epoch if state_epoch is None else state_epoch
    dump = join(outdir, "debug_failure")
    ckpt_util.save_ckpt(dump, state_epoch, state)
    _log_scalars(dump, epoch, {"phase": phase, "non_finite": sorted(bad),
                               "state_epoch": state_epoch})
    granularity = ("" if state_epoch == epoch else
                   f" (scanned dispatch: the saved state is that of epoch "
                   f"{state_epoch}, the chunk's end; rerun the window with "
                   "epoch_scan_chunk=1 to see every epoch)")
    raise RuntimeError(
        f"{phase}: non-finite training loss at epoch {epoch}: {bad}; the "
        f"failing state is checkpointed under {dump}{granularity}. Resume "
        f"from the last good checkpoint in {outdir} after lowering the LR "
        "or inspecting the data")


def save_metas(outdir):
    """Roll the per-epoch metadata.json metrics up into metas.json."""
    vali_root = join(outdir, "vis_vali")
    metrics = {k: [] for k in
               ("psnr", "ssim", "lpips", "psnr_luma", "ssim_luma", "mse")}
    if not os.path.isdir(vali_root):
        return metrics
    for e_dir in sorted(os.listdir(vali_root)):
        if not e_dir.startswith("epoch"):
            continue
        epoch_vals = {k: [] for k in metrics}
        for root, _, files in os.walk(join(vali_root, e_dir)):
            if "metadata.json" in files:
                for k, v in vio.read_json(join(root, "metadata.json")).items():
                    if k in epoch_vals:
                        epoch_vals[k].append(v)
        for k in metrics:
            metrics[k].append(
                float(np.mean(epoch_vals[k])) if epoch_vals[k] else None)
    metrics["lpips_impl"] = lpips_impl()
    with open(join(vali_root, "metas.json"), "w") as f:
        json.dump(metrics, f)
    return metrics


def elbow_select(drop_losses, best_thres):
    """The reference's elbow rule: the first i whose loss improves on i-1
    and is within best_thres of every later loss; else the last (all
    codes)."""
    n = len(drop_losses)
    for i in range(1, n - 1):
        if drop_losses[i - 1] > drop_losses[i]:
            if all(drop_losses[i] - drop_losses[j] <= best_thres
                   for j in range(i + 1, n)):
                return i
    return n - 1


def cfg_ckpt_period(cfg):
    return 30 if cfg.epochs >= 30 else max(1, cfg.epochs // 2)


def _forward_chunked(forward, batch, chunk=None):
    """Run a per-ray validation forward in ray chunks and concatenate the
    pred dicts on the host; ``forward(chunk_batch) -> pred`` with every
    entry [N, ...] aligned with the batch rows. Returns numpy arrays."""
    chunk = chunk or _VALI_RAY_CHUNK
    n = next(iter(batch.values())).shape[0]
    preds = [{k: v.cpu().numpy() for k, v in forward(
        {k: v[i:i + chunk] for k, v in batch.items()}).items()}
        for i in range(0, n, chunk)]
    if len(preds) == 1:
        return preds[0]
    return {k: np.concatenate([p[k] for p in preds]) for k in preds[0]}


def _rng_state(rng, gen=None):
    state = {"numpy": rng.get_state()}
    if gen is not None:
        state["torch"] = gen.get_state()
    return state


def _restore_rng(state, rng, gen=None):
    if not state:
        return
    rng.set_state(state["numpy"])
    if gen is not None and "torch" in state:
        gen.set_state(state["torch"])


def _keep(cfg):
    return cfg.keep_recent_epochs if cfg.keep_recent_epochs > 0 else None


def phase_model(cfg: dc.DecompConfig, kind, vq=None, light=None):
    """The blank model of a phase ("nfr_unit", "vq_nfr" or "ref_nfr") as
    its trainer builds it, on the CPU, to ``load_state_dict`` a checkpoint
    into: its parameters are in the order that the checkpoint's optimizer
    state follows. A RefNfr is built on ``vq`` (a VqNfr; a blank one when
    None) and ``light`` [Lh, Lw, 3] (zeros when None)."""
    gen = torch.Generator().manual_seed(cfg.random_seed)
    if kind == "nfr_unit":
        return init_nfr_unit(gen, cfg)
    if kind == "vq_nfr":
        centers = np.zeros((cfg.num_embed, cfg.z_dim), np.float32)
        return init_vq_nfr(gen, cfg, init_nfr_unit(gen, cfg), centers)[0]
    if kind == "ref_nfr":
        if vq is None:
            vq = phase_model(cfg, "vq_nfr")
        if light is None:
            light = np.zeros(cfg.light_res + (3,), np.float32)
        return init_ref_nfr(gen, cfg, vq, torch.as_tensor(light).cpu())
    raise ValueError(f"unknown phase {kind!r}")


def train_nfr_unit(cfg: dc.DecompConfig, train_views, vali_views, outdir,
                   epochs=None, seed=None, jitter_mode="contrast",
                   resume=True, device="cuda", devices=None):
    """Phase 1: train the warm-up model. Returns (model, history), the
    model on ``device`` and the history the mean loss of each epoch."""
    device, mesh = _train_mesh(device, devices)
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)
    model = init_nfr_unit(torch.Generator().manual_seed(seed), cfg).to(device)
    opt, step_fn = dt.make_nfr_unit_step(model, cfg, lxyz, lareas,
                                         mesh=mesh)
    start_epoch = 0

    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng)

    def state_dict(epoch, rng_state=None):
        return {"params": model.state_dict(), "opt_state": opt.state,
                "epoch": epoch, "rng": rng_state or _rng_state(rng)}

    def post_epoch(e1, loss_dicts, wall_s, state_epoch=None,
                   rng_state=None):
        mean_loss, n_skipped = _finite_mean([d["loss"] for d in loss_dicts])
        history.append(mean_loss)
        # wall_s closes over the fetch of the losses, which waits for the
        # device, so it is the whole epoch (the chunk's share when scanned)
        _log_scalars(outdir, e1, {"loss_train": mean_loss,
                                  "skipped_steps": n_skipped,
                                  "wall_s": round(wall_s, 4)})
        _check_finite(outdir, "nfr_unit", e1, {"loss_train": mean_loss},
                      state_dict(state_epoch or e1, rng_state),
                      state_epoch=state_epoch)
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1, rng_state),
                                keep=_keep(cfg))
            _nfr_vali(model, cfg, lxyz, lareas, vali_views,
                      _epoch_dir(outdir, e1), outdir, device)

    history = []
    period = cfg_ckpt_period(cfg)
    _train_epochs(cfg, train_views, jitter_mode, device, mesh, rng, seed,
                  start_epoch, epochs, period, _Steps(step_fn), post_epoch)
    save_metas(outdir)
    return model, history


class _Steps:
    """How ``_train_epochs`` takes the steps of nfr_unit or ref_nfr:
    ``step_fn(batch, step)`` one at a time, or an ``EpochScan`` of it."""

    def __init__(self, step_fn):
        self.step_fn = step_fn

    def __call__(self, batch, step):
        return self.step_fn(batch, step)

    def scan(self, store, rows, n_rays, sampler):
        return dt.make_plain_epoch_scan(self.step_fn, store, rows, n_rays,
                                        sampler=sampler)

    def dispatch(self, scan, xs):
        n = scan.stage(**xs)
        return n, scan.run(n)


class _VqSteps(_Steps):
    """vq_nfr's steps: the EMA state (``ema``) threaded through them, the
    dropout rolls drawn from ``gen``."""

    def __init__(self, step_fn, ema, thres, gen):
        super().__init__(step_fn)
        self.ema, self.thres, self.gen = ema, thres, gen

    def __call__(self, batch, step):
        self.ema, ld = self.step_fn(self.ema, batch, self.thres, self.gen,
                                    step)
        return ld

    def scan(self, store, rows, n_rays, sampler):
        return dt.make_vq_epoch_scan(self.step_fn, store, rows, n_rays,
                                     self.ema, self.thres, sampler=sampler)

    def dispatch(self, scan, xs):
        scan.load_ema(self.ema)
        n = scan.stage(**xs, roll_gen=self.gen)
        rows = scan.run(n)
        self.ema = scan.ema  # updated in place by every later chunk
        return n, rows


def _train_epochs(cfg, train_views, jitter_mode, device, mesh, rng, seed,
                  start_epoch, epochs, period, steps, post_epoch):
    """The epochs of a stage-2 phase, scanned or step by step; ``steps``: a
    ``_Steps``; ``post_epoch(e1, loss_dicts, wall_s, state_epoch,
    rng_state)`` with the epoch's loss terms as floats."""
    if start_epoch >= epochs:  # don't stage the store for a no-op resume
        return
    epoch_batches, store = _make_batch_source(train_views, cfg, jitter_mode,
                                              device, mesh)
    k_steps = max(len(train_views), 1)
    step = start_epoch * k_steps
    scan_on = _resolve_epoch_scan(cfg, store)
    if not scan_on:
        for epoch in range(start_epoch, epochs):
            t_epoch = time.time()
            loss_dicts = []
            for batch in epoch_batches(rng):
                loss_dicts.append(steps(batch, step))  # stays on the device
                step += 1
            post_epoch(epoch + 1, _sync_scalar_dicts(loss_dicts),
                       time.time() - t_epoch)
        return
    sampler = _resolve_device_sampling(cfg, store, train_views, jitter_mode)
    chunk = _resolve_scan_chunk(cfg, scan_on)
    scan = steps.scan(store, chunk * k_steps, cfg.n_rays_per_step, sampler)

    def sample_xs(n_ep):
        before = _rng_state(rng)
        return _epoch_scan_xs(train_views, cfg, rng, jitter_mode, step, n_ep,
                              sampler=sampler, seed=seed), before

    def dispatch(xs):
        nonlocal step
        n, rows = steps.dispatch(scan, xs)
        step += n
        return rows

    def fetch(rows, n_ep):
        return _split_epochs(_rows_to_dicts(rows, scan.keys), n_ep, k_steps)

    _scan_epoch_loop(start_epoch, epochs, period, chunk, sample_xs, dispatch,
                     fetch, post_epoch)


@torch.inference_mode()
def _nfr_vali(model, cfg, lxyz, lareas, vali_views, epoch_dir, outdir,
              device):
    os.makedirs(epoch_dir, exist_ok=True)
    light = dc.get_light(model).cpu().numpy()
    np.save(join(os.path.dirname(epoch_dir), "np_light.npy"), light)
    vio.vis_light(light, outpath=join(os.path.dirname(epoch_dir),
                                      "pred_light.png"), h=256)

    def forward(b):
        pred = nfr_unit_forward(model, b, cfg, lxyz, lareas, mode="vali")[0]
        del pred["z"]  # [N, z_dim], not written
        return pred

    for b_i, view in enumerate(vali_views):
        pred = _forward_chunked(forward,
                                _device_batch(view.as_batch(), device))
        vis = {"pred_" + k: v for k, v in pred.items()}
        vis["gt_rgb"] = view.rgb
        vis["gt_alpha"] = view.alpha
        vis_view(vis, (view.h, view.w), join(epoch_dir, "batch%09d" % b_i),
                 view.id, white_bg=cfg.white_bg, mode="vali")
    write_vali_index(outdir, white_bg=cfg.white_bg)


def _init_centers(cfg, nfr_model, train_views, rng, seed, device):
    """k-means centres [K, z_dim] of the warm-up model's latents over one
    random-jitter batch per train view (foreground rows)."""
    nfr_model = copy.deepcopy(nfr_model).to(device)
    zs = []
    with torch.inference_mode():
        for view in train_views:
            batch = outer_sample(view, cfg.n_rays_per_step, rng,
                                 jitter_mode="random")
            mask = batch["alpha"][:, 0] > 0
            xyz = torch.as_tensor(batch["xyz"][mask], device=device)
            zs.append(dc.apply_encoder(nfr_model, xyz, cfg))
        _, centers = kmeans(torch.cat(zs), cfg.num_embed, seed=seed)
    return centers.cpu().numpy()


def train_vq_nfr(cfg: dc.DecompConfig, nfr_model, train_views, vali_views,
                 outdir, epochs=None, seed=None, cluster_path=None,
                 resume=True, device="cuda", devices=None):
    """Phase 2: train the VQ model from a trained warm-up model. Returns
    (model, ema_state, history), model and state on ``device``."""
    device, mesh = _train_mesh(device, devices)
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)

    # epoch 0: the codebook starts at the k-means centres of the latents
    if cluster_path is None:
        cluster_path = join(outdir, "cluster_centers.npy")
    if os.path.exists(cluster_path):
        centers = np.load(cluster_path)
    else:
        centers = _init_centers(cfg, nfr_model, train_views, rng, seed,
                                device)
        os.makedirs(os.path.dirname(cluster_path) or ".", exist_ok=True)
        np.save(cluster_path, centers)

    model, ema_state = init_vq_nfr(torch.Generator().manual_seed(seed), cfg,
                                   nfr_model, centers)
    model = model.to(device)
    opt, step_fn = dt.make_vq_nfr_step(model, cfg, lxyz, lareas, mesh=mesh)

    # the fixed VQ evaluation set of the drop-loss sweep
    per_view = max(1, cfg.total_sample_vq // max(len(train_views), 1))
    vq_eval = _device_batch(build_vq_eval_set(
        train_views, per_view, cfg.n_rays_per_step, rng), device)

    gen = torch.Generator(device=device).manual_seed(seed)
    start_epoch = 0
    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            ema_state = state["ema"]
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng, gen)
    steps = _VqSteps(step_fn, VqEmaState(*(t.to(device) for t in ema_state)),
                     torch.as_tensor(cfg.train_thres(), device=device), gen)

    def state_dict(epoch, rng_state=None):
        rng_now = _rng_state(rng, gen)
        if rng_state:  # the host stream at the chunk's end; gen is exact
            rng_now["numpy"] = rng_state["numpy"]
        return {"params": model.state_dict(), "ema": steps.ema,
                "opt_state": opt.state, "epoch": epoch, "rng": rng_now}

    val_thres_list = cfg.val_thres_list()
    x_list = list(range(cfg.num_embed - cfg.num_drop, cfg.num_embed + 1))
    history = []
    period = cfg_ckpt_period(cfg)

    def post_epoch(e1, loss_dicts, wall_s, state_epoch=None, rng_state=None):
        mean_loss, n_skipped = _finite_mean([d["loss"] for d in loss_dicts])
        history.append(mean_loss)
        _log_scalars(outdir, e1, {
            **{k: _finite_mean([d[k] for d in loss_dicts])[0]
               for k in loss_dicts[0]},
            "skipped_steps": n_skipped,
            "wall_s": round(wall_s, 4)})
        _check_finite(outdir, "vq_nfr", e1, {"loss": mean_loss},
                      state_dict(state_epoch or e1, rng_state),
                      state_epoch=state_epoch)
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1, rng_state),
                                keep=_keep(cfg))
            _vq_vali(model, cfg, lxyz, lareas, vali_views, vq_eval,
                     val_thres_list, x_list, loss_dicts,
                     _epoch_dir(outdir, e1), seed, device)

    _train_epochs(cfg, train_views, "random", device, mesh, rng, seed,
                  start_epoch, epochs, period, steps, post_epoch)
    save_metas(outdir)
    return model, steps.ema, history


@torch.inference_mode()
def _vq_vali(model, cfg, lxyz, lareas, vali_views, vq_eval, val_thres_list,
             x_list, loss_dicts, epoch_dir, seed, device):
    os.makedirs(epoch_dir, exist_ok=True)
    # loss.json: the epoch's loss terms summed over its batches
    losses = {}
    for d in loss_dicts:
        for k, v in d.items():
            losses[k] = losses.get(k, 0.0) + v
    with open(join(epoch_dir, "loss.json"), "w") as f:
        json.dump(losses, f)

    # the light, which ref_nfr's init reads
    np.save(join(os.path.dirname(epoch_dir), "np_light.npy"),
            dc.get_light(model).cpu().numpy())

    # the dropout sweep on the fixed evaluation set
    gen = torch.Generator(device=device).manual_seed(seed)
    vq_scores = {"vqrgb": [], "chromaticity": []}
    for thres in val_thres_list:
        aux = vq_test(model, vq_eval, cfg, lxyz, lareas,
                      thres=torch.as_tensor(thres, device=device), rng=gen,
                      render_chunk=_VQ_TEST_RENDER_CHUNK)
        mask, gt, vq_rgb = aux["mask"], aux["rgb_gt"], aux["vq_rgb_linear"]
        if cfg.is_nerf:
            linear_gt, vq_srgb = srgb2linear(gt), linear2srgb(vq_rgb)
        else:
            linear_gt, vq_srgb = gt, vq_rgb
        denom = float(torch.clamp(torch.sum(mask), min=1.0))
        vq_scores["vqrgb"].append(float(torch.sum(
            torch.mean((gt - vq_srgb) ** 2, dim=-1) * mask)) / denom)
        vq_scores["chromaticity"].append(float(torch.sum(torch.mean(
            (rgb2chromaticity(linear_gt) - rgb2chromaticity(vq_rgb)) ** 2,
            dim=-1) * mask)) / denom)
    with open(join(epoch_dir, "vq_test_loss.json"), "w") as f:
        json.dump(vq_scores, f)

    drop_losses = np.array(vq_scores["chromaticity"])
    try:  # the elbow plot is optional: matplotlib may be absent
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.clf()
        plt.plot(x_list, drop_losses)
        plt.savefig(join(epoch_dir, "vq_num.png"))
    except Exception:
        pass

    main_vq = elbow_select(list(drop_losses), cfg.best_thres)

    # per-threshold renders into <epoch>/<k or main_k>/batch%09d
    ema0 = init_vq_ema_state(cfg.z_dim, cfg.num_embed, device)
    for i, thres in enumerate(val_thres_list):
        k_codes = cfg.num_embed - cfg.num_drop + i
        sub = ("main_%d" % k_codes) if i == main_vq else str(k_codes)
        thres_t = torch.as_tensor(thres, device=device)
        for b_i, view in enumerate(vali_views):
            # one roll for every chunk of a view: validation-mode dropout
            # masks the CODEBOOK, so the chunks must agree on it
            roll = torch.rand((1, cfg.num_embed), generator=gen,
                              device=device)
            pred = _forward_chunked(
                lambda b: vq_nfr_forward(
                    model, ema0, b, cfg, lxyz, lareas, mode="vali",
                    thres=thres_t, roll=roll)[0],
                _device_batch(view.as_batch(), device))
            vis = {"pred_" + k: v for k, v in pred.items()}
            vis["gt_rgb"] = view.rgb
            vis["gt_alpha"] = view.alpha
            vis_view(vis, (view.h, view.w),
                     join(epoch_dir, sub, "batch%09d" % b_i), view.id,
                     white_bg=cfg.white_bg, mode="vali")
    write_vali_index(os.path.dirname(os.path.dirname(epoch_dir)),
                     white_bg=cfg.white_bg)
    return main_vq


def train_ref_nfr(cfg: dc.DecompConfig, vq_model, light, train_views,
                  vali_views, outdir, epochs=None, seed=None, resume=True,
                  device="cuda", devices=None):
    """Phase 3: train the residual model on top of a trained VqNfr (not
    modified) and its converged light [Lh, Lw, 3]. The views must be loaded
    with ``with_ref=True``. Returns (model, history), the model on
    ``device``."""
    device, mesh = _train_mesh(device, devices)
    if any(v.ref is None for v in list(train_views) + list(vali_views)):
        raise ValueError("train_ref_nfr needs views loaded with "
                         "with_ref=True (the reference RGB buffer)")
    epochs = epochs or cfg.epochs
    seed = cfg.random_seed if seed is None else seed
    rng = np.random.RandomState(seed)
    lxyz, lareas = dc.light_constants(cfg, device)
    model = init_ref_nfr(torch.Generator().manual_seed(seed), cfg,
                         vq_model, torch.as_tensor(light).detach().cpu()
                         ).to(device)
    opt, step_fn = dt.make_ref_nfr_step(model, cfg, lxyz, lareas,
                                        mesh=mesh)
    start_epoch = 0

    if resume:
        latest = ckpt_util.latest_ckpt(outdir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            model.load_state_dict(state["params"])
            opt.state = {k: v.to(device)
                         for k, v in state["opt_state"].items()}
            start_epoch = int(state["epoch"])
            _restore_rng(state.get("rng"), rng)

    def state_dict(epoch, rng_state=None):
        return {"params": model.state_dict(), "opt_state": opt.state,
                "epoch": epoch, "rng": rng_state or _rng_state(rng)}

    def post_epoch(e1, loss_dicts, wall_s, state_epoch=None,
                   rng_state=None):
        mean_loss, n_skipped = _finite_mean([d["loss"] for d in loss_dicts])
        history.append(mean_loss)
        _log_scalars(outdir, e1, {"loss_train": mean_loss,
                                  "skipped_steps": n_skipped,
                                  "wall_s": round(wall_s, 4)})
        _check_finite(outdir, "ref_nfr", e1, {"loss_train": mean_loss},
                      state_dict(state_epoch or e1, rng_state),
                      state_epoch=state_epoch)
        if e1 % period == 0 or e1 == epochs:
            ckpt_util.save_ckpt(outdir, e1, state_dict(e1, rng_state),
                                keep=_keep(cfg))
            _ref_vali(model, cfg, lxyz, lareas, vali_views,
                      _epoch_dir(outdir, e1), outdir, device)

    history = []
    period = cfg_ckpt_period(cfg)
    _train_epochs(cfg, train_views, "contrast", device, mesh, rng, seed,
                  start_epoch, epochs, period, _Steps(step_fn), post_epoch)
    save_metas(outdir)
    return model, history


@torch.inference_mode()
def _ref_vali(model, cfg, lxyz, lareas, vali_views, epoch_dir, outdir,
              device):
    for b_i, view in enumerate(vali_views):
        pred = _forward_chunked(
            lambda b: ref_nfr_forward(model, b, cfg, lxyz, lareas,
                                      mode="vali")[0],
            _device_batch(view.as_batch(), device))
        vis = {"pred_" + k: v for k, v in pred.items()}
        vis["gt_rgb"] = view.rgb
        vis["gt_alpha"] = view.alpha
        vis_view(vis, (view.h, view.w), join(epoch_dir, "batch%09d" % b_i),
                 view.id, white_bg=cfg.white_bg, mode="vali")
    write_vali_index(outdir, white_bg=cfg.white_bg)
