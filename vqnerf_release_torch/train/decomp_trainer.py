"""Decomposition-stage train steps for nfr_unit, vq_nfr and ref_nfr
(counterpart of vqnerf_release_tpu/train/decomp_trainer.py).

  * ``KerasAmsgrad``: the keras ``Adam(amsgrad=True)`` rule the reference
    trains with, which is NOT ``torch.optim.Adam(amsgrad=True)``:

        m_t    = b1 m + (1 - b1) g
        v_t    = b2 v + (1 - b2) g^2
        vhat_t = max(vhat_{t-1}, v_t)            # UNCORRECTED moments
        p     -= lr sqrt(1 - b2^t) / (1 - b1^t) m_t / (sqrt(vhat_t) + eps)

    PyTorch divides sqrt(vhat) by sqrt(1 - b2^t) before it adds eps. The
    learning rate is the continuous ``decomp_lr(step)``.
  * The non-finite guard: a step whose loss or gradients are not finite
    changes nothing (parameters, optimizer state, and for vq_nfr the EMA
    state and the codebook) and is recorded in ``ld["nonfinite_grads"]``.
    It selects with ``torch.where`` on the device, as the JAX package does,
    so a step never waits for the device.
  * vq_nfr keeps the reference's assign-then-optimize order of the
    codebook: the EMA update is proposed in the forward, the sim loss is
    evaluated at the updated codebook, and the optimizer's codebook delta
    (the sim term's alone) is applied on top of the EMA update.
  * ref_nfr optimises its ``trainable`` part only; the frozen encoder,
    spec head and light are neither in the optimizer nor reached by a
    gradient.

The optimizer state is flat: ``m``, ``v`` and ``vhat`` are one vector each
over all parameters in ``model.parameters()`` order, so one step is a dozen
launches whatever the number of layers. ``interop/jax_params.py`` converts
it to and from the JAX package's per-leaf trees.

**Over a mesh** (``mesh``, a list of devices, as ``parallel.get_mesh``
gives; by default the model's device alone, where the JAX package shards
every batch over all its devices): the batch is padded with alpha-0 rows
to a multiple of the device count and split in contiguous row blocks, one
a device, each run by a copy of the model whose parameters are refreshed
from the model at the start of every step (on one device: the batch
itself, run by the model). The step's loss is the loss of the global padded
batch: each device adds up the numerator and the denominator of every
masked-mean term over its rows, the sums are reduced on the first device,
and one backward runs through them; the gradients of the copies are summed
there and the amsgrad update runs once, on the model. For vq_nfr the
latents of all rows are gathered to the first device and the VQ runs there
once, over the whole batch (the fused kernel on a card), so that the
codebook EMA sees the global counts and dw; the terms that pair rows (the
chroma-gated smoothness) or read the codebook are computed there too.
On a card every mesh entry's work runs on a stream of its own
(``parallel.MeshStreams``), also where entries share the card: the refresh
of its copy, its row block's copy to its device, its forward (and so,
autograd running a backward on its forward's stream, its backward) and the
copies of its sums, latents and gradients to the first device, each forked
from the calling stream and joined back to it. So the whole mesh step is
work that a CUDA graph capture on the first device records, and the
scanned dispatch replays it.
"""

import copy

import numpy as np
import torch

from ..models import decomp_common as dc
from ..models.nfr_unit import (nfr_unit_forward, nfr_unit_loss_from_sums,
                               nfr_unit_row_sums)
from ..models.ref_nfr import (ref_nfr_forward, ref_nfr_loss_from_sums,
                              ref_nfr_row_sums)
from ..models.vq_nfr import (vq_encode, vq_nfr_row_sums, vq_nfr_rows,
                             vq_nfr_train_loss)
from ..ops.vq import VqEmaState, vq_ema_apply
from ..parallel.mesh import MeshStreams, pad_rows, shard_batch
from ..utils import profiling
from ..utils.device import resolve_device
from .graphed import StepGraph

__all__ = ["decomp_lr", "KerasAmsgrad", "make_nfr_unit_step",
           "make_vq_nfr_step", "make_ref_nfr_step", "EpochScan",
           "VqEpochScan", "make_plain_epoch_scan", "make_vq_epoch_scan"]


def decomp_lr(step, cfg: dc.DecompConfig):
    """Continuous exponential decay (keras ExponentialDecay's default)."""
    return cfg.lr * cfg.lr_decay_rate ** (step / cfg.lr_decay_steps)


class KerasAmsgrad:
    """Keras-exact amsgrad over ``params`` (a list of leaf tensors that are
    updated in place), optionally preceded by the reference's clipnorm or
    clipvalue. ``state``: count (0-dim int32), m, v, vhat (flat)."""

    def __init__(self, params, cfg: dc.DecompConfig = None, b1=0.9,
                 b2=0.999, eps=1e-7):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.clipnorm = cfg.clipnorm if cfg is not None else -1.0
        self.clipvalue = cfg.clipvalue if cfg is not None else -1.0
        if self.clipnorm > 0 and self.clipvalue > 0:
            raise ValueError(
                "Both `clipnorm` and `clipvalue` are active -- turn one off")
        self.guard = cfg is None or cfg.skip_nonfinite_updates
        device = self.params[0].device
        self.sizes = [p.numel() for p in self.params]
        n = sum(self.sizes)
        self.state = {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "m": torch.zeros((n,), device=device),
            "v": torch.zeros((n,), device=device),
            "vhat": torch.zeros((n,), device=device),
        }

    @torch.no_grad()
    def step(self, grads, lr, loss=None):
        """Apply one update from ``grads`` (a list like params) at learning
        rate ``lr`` (a float, or a 0-dim float32 tensor holding the float's
        float32 value: the same product either way). The state is updated in
        place. Returns ok, a 0-dim bool tensor: False when the guard skipped
        the step."""
        st = self.state
        g = torch.cat([x.reshape(-1) for x in grads])
        ok = torch.isfinite(g).all()
        if loss is not None:
            ok = ok & torch.isfinite(loss.detach())
        if self.clipnorm > 0:
            norm = torch.linalg.vector_norm(g)
            g = torch.where(norm < self.clipnorm, g,
                            g / norm * self.clipnorm)
        if self.clipvalue > 0:
            g = torch.clamp(g, -self.clipvalue, self.clipvalue)
        count = st["count"] + 1
        cf = count.to(torch.float32)
        m = self.b1 * st["m"] + (1 - self.b1) * g
        v = self.b2 * st["v"] + (1 - self.b2) * g * g
        vhat = torch.maximum(st["vhat"], v)
        corr = torch.sqrt(1.0 - self.b2 ** cf) / (1.0 - self.b1 ** cf)
        delta = -lr * (corr * m / (torch.sqrt(vhat) + self.eps))
        if self.guard:
            delta = torch.where(ok, delta, torch.zeros_like(delta))
            count, m, v, vhat = (torch.where(ok, new, st[k]) for new, k in (
                (count, "count"), (m, "m"), (v, "v"), (vhat, "vhat")))
        # in place: a CUDA graph of the step reads and writes these buffers
        for k, new in (("count", count), ("m", m), ("v", v), ("vhat", vhat)):
            st[k].copy_(new)
        torch._foreach_add_(
            self.params,
            [d.view_as(p) for d, p in zip(delta.split(self.sizes),
                                          self.params)])
        return ok


def _finish_ld(ld, ok, guard):
    ld = {k: v.detach() for k, v in ld.items()}
    if guard:
        ld["nonfinite_grads"] = 1.0 - ok.to(torch.float32)
    return ld


class _Replicas:
    """A model and its copies over a mesh: the model itself on mesh[0],
    a deep copy on every further device, and the light constants on each.
    ``trained(model)`` lists the parameters a step optimises. ``mesh``
    None is the model's own device alone."""

    def __init__(self, model, mesh, trained, lxyz, lareas):
        if mesh is None:
            mesh = [next(model.parameters()).device]
        self.mesh = [resolve_device(d) for d in mesh]
        self.models = [model] + [copy.deepcopy(model).to(d)
                                 for d in self.mesh[1:]]
        self.trained = [list(trained(m)) for m in self.models]
        self.lights = [(lxyz.to(d), lareas.to(d)) for d in self.mesh]
        self.streams = MeshStreams(self.mesh)

    def split(self, batch, even=False):
        """The batch padded to a multiple of the mesh size and cut in row
        blocks, all on mesh[0] (``block`` moves one to its device), each
        guarded for the streams that read it. ``even``: where that multiple
        is odd (an odd mesh size), n more alpha-0 rows, so that vq_nfr's
        pair terms (rows [::2] against [1::2]) see whole pairs; the JAX
        package fails there."""
        n_dev = len(self.mesh)
        n = next(iter(batch.values())).shape[0]
        padded = -(-n // n_dev) * n_dev
        if even and padded % 2:
            batch = pad_rows(batch, padded + n_dev - n)
        blocks, _ = shard_batch(batch, [self.mesh[0]] * n_dev)
        self.streams.guard(t for b in blocks for t in b.values())
        return blocks

    def block(self, r, blocks):
        """Row block r on its device, with copy r refreshed from the
        model (also after a resume has loaded it): the first work of mesh
        entry r, on its stream."""
        if r:
            with torch.no_grad():
                for p, q in zip(self.models[r].parameters(),
                                self.models[0].parameters()):
                    p.copy_(q)
        return {k: v.to(self.mesh[r]) for k, v in blocks[r].items()}

    def grads(self, loss):
        """One backward through ``loss``; the gradients of every copy's
        trained parameters summed on the model's, in its parameter
        order."""
        flat = [p for ps in self.trained for p in ps]
        got = torch.autograd.grad(loss, flat, allow_unused=True)
        n = len(self.trained[0])
        dev0 = self.mesh[0]
        # copy r's gradients to the first device on entry r's stream, the
        # stream its backward ran on
        moved = self.streams.map(lambda r: [
            None if g is None else g.to(dev0)
            for g in got[r * n:(r + 1) * n]])
        out = []
        for j, p in enumerate(self.trained[0]):
            g = None
            for gr in (m[j] for m in moved):
                if gr is not None:
                    g = gr if g is None else g + gr
            out.append(torch.zeros_like(p) if g is None else g)
        return out


def _moved(sums, device):
    """One block's {name: (numerator, denominator)} on ``device``."""
    return {k: (a.to(device), b.to(device)) for k, (a, b) in sums.items()}


def _sum_blocks(parts):
    """The blocks' sums added up in mesh order."""
    total = parts[0]
    for sums in parts[1:]:
        total = {k: (total[k][0] + a, total[k][1] + b)
                 for k, (a, b) in sums.items()}
    return total


def _rows_step(model, opt, cfg, lxyz, lareas, mesh, trained, forward,
               row_sums, loss_from_sums):
    """The step of a model whose loss is masked means of its rows
    (nfr_unit, ref_nfr)."""
    reps = _Replicas(model, mesh, trained, lxyz, lareas)

    def step_fn(batch, step, lr=None):
        blocks = reps.split(batch)

        def part(r):
            lx, la = reps.lights[r]
            _, aux = forward(reps.models[r], reps.block(r, blocks), cfg, lx,
                             la, mode="train")
            return _moved(row_sums(aux, cfg), reps.mesh[0])

        loss, ld = loss_from_sums(_sum_blocks(reps.streams.map(part)))
        ok = opt.step(reps.grads(loss),
                      decomp_lr(step, cfg) if lr is None else lr, loss)
        return _finish_ld(ld, ok, opt.guard)

    step_fn.mesh = reps.mesh
    return step_fn


def make_nfr_unit_step(model, cfg: dc.DecompConfig, lxyz, lareas,
                       mesh=None):
    """(optimizer, step_fn); step_fn(batch, step, lr=None) -> loss dict of
    0-dim tensors on the device, after updating ``model`` in place; ``lr``,
    when given, replaces ``decomp_lr(step, cfg)`` (a 0-dim float32 tensor
    staged by the scanned dispatch). ``mesh``: the devices to split every
    batch over (the model on the first; by default the model's device
    alone)."""
    opt = KerasAmsgrad(model.parameters(), cfg)
    return opt, _rows_step(
        model, opt, cfg, lxyz, lareas, mesh, lambda m: m.parameters(),
        nfr_unit_forward, nfr_unit_row_sums, nfr_unit_loss_from_sums)


def _vq_nfr_step(model, opt, cfg, lxyz, lareas, mesh):
    """vq_nfr's step: the encoders on every device, the VQ once on the
    first over the gathered latents of all rows, the decodes and renders
    on every device again."""
    reps = _Replicas(model, mesh, lambda m: m.parameters(), lxyz, lareas)
    dev0 = reps.mesh[0]

    def step_fn(ema_state, batch, thres, rng, step, lr=None):
        batch = dict(batch)
        roll = batch.pop("_roll", None)
        blocks = reps.split(batch, even=True)

        def encode(r):
            b = reps.block(r, blocks)
            z_enc, z_norm = vq_encode(reps.models[r], b["xyz"], cfg)
            return b, z_enc, z_norm.to(dev0)

        encs = reps.streams.map(encode)
        whole = {k: torch.cat([b[k] for b in blocks])
                 for k in ("alpha", "rgb")}
        mask = (whole["alpha"][:, 0] > 0).to(torch.float32)
        vq_outs, new_ema = vq_ema_apply(
            dc.get_codebook(model), torch.cat([e[2] for e in encs]),
            ema_state, commitment_cost=cfg.commitment_cost,
            decay=cfg.vq_decay, is_training=True, thres=thres, rng=rng,
            mask=mask, roll=roll, use_fused=dc.fused_vq_enabled(cfg, dev0))
        starts = np.cumsum([0] + [b["xyz"].shape[0] for b in blocks])

        def decode(r):
            b, z_enc, _ = encs[r]
            rows = slice(int(starts[r]), int(starts[r + 1]))
            dev = reps.mesh[r]
            lx, la = reps.lights[r]
            _, aux = vq_nfr_rows(
                reps.models[r], b, z_enc, vq_outs["quantize"][rows].to(dev),
                vq_outs["encoding_indices"][rows].to(dev), cfg, lx, la)
            return _moved(vq_nfr_row_sums(aux, cfg), dev0)

        sums = _sum_blocks(reps.streams.map(decode))
        loss, ld = vq_nfr_train_loss(model, sums, {
            "mask": mask, "rgb_gt": whole["rgb"],
            "z_vq": vq_outs["quantize"], "vq_loss": vq_outs["loss"],
            "codebook_update": vq_outs["update"]}, cfg)
        old_cb = model.codebook.detach().clone()
        ok = opt.step(reps.grads(loss),
                      decomp_lr(step, cfg) if lr is None else lr, loss)
        with torch.no_grad():
            # the EMA assignment, and the optimizer's delta on top of it
            # (zero when the guard skipped the step)
            new_cb = vq_outs["update"] + (model.codebook - old_cb)
            if opt.guard:
                # a poisoned batch also contaminates the EMA statistics
                # and the proposal: discard them too on a skipped step
                new_cb = torch.where(ok, new_cb, old_cb)
                new_ema = VqEmaState(*(torch.where(ok, a, b) for a, b in
                                       zip(new_ema, ema_state)))
            model.codebook.copy_(new_cb)
        return new_ema, _finish_ld(ld, ok, opt.guard)

    step_fn.mesh = reps.mesh
    return step_fn


def make_vq_nfr_step(model, cfg: dc.DecompConfig, lxyz, lareas, mesh=None):
    """(optimizer, step_fn); step_fn(ema_state, batch, thres, rng, step,
    lr=None) -> (new_ema_state, loss dict), after updating ``model`` in
    place (``lr`` as ``make_nfr_unit_step``'s).
    ``batch["_roll"]`` (optional, [1, K]) gives the dropout uniforms in
    place of a draw from ``rng``. ``mesh``: the devices to split every
    batch over (the model and the EMA state on the first; by default the
    model's device alone)."""
    opt = KerasAmsgrad(model.parameters(), cfg)
    return opt, _vq_nfr_step(model, opt, cfg, lxyz, lareas, mesh)


def make_ref_nfr_step(model, cfg: dc.DecompConfig, lxyz, lareas,
                      mesh=None):
    """(optimizer, step_fn) over ``model.trainable`` only; step_fn(batch,
    step, lr=None) -> loss dict of 0-dim tensors on the device, after
    updating the trainable part in place (``lr`` as
    ``make_nfr_unit_step``'s). ``mesh``: the devices to split every batch
    over (the model on the first; by default the model's device alone)."""
    opt = KerasAmsgrad(model.trainable.parameters(), cfg)
    return opt, _rows_step(
        model, opt, cfg, lxyz, lareas, mesh,
        lambda m: m.trainable.parameters(), ref_nfr_forward,
        ref_nfr_row_sums, ref_nfr_loss_from_sums)


class EpochScan:
    """Chunks of stage-2 steps over a device store, each chunk one dispatch
    (the port of ``make_plain_epoch_scan`` / ``make_vq_epoch_scan`` of the
    JAX package, whose ``lax.scan`` runs the per-step path's jitted step).

    The host stages a chunk's inputs (``stage``): the view index, the ray
    indices (or, with a device ``sampler``, the sampler's draws), the
    learning rate computed on the host in double and stored in float32,
    and for vq_nfr the code-dropout uniforms, drawn from the generator in
    the per-step path's order. ``run(n)`` then takes n steps, each the SAME
    step function as the per-step path, reading entry i of those tensors
    (``graphed.StepGraph``: a CUDA graph replayed on the card, eager on the
    CPU), and returns the loss terms [n, len(keys)] on the device. ``rows``
    is the most steps a chunk takes, ``n_rays`` the pairs a step samples.
    """

    def __init__(self, store, rows, n_rays, sampler=None, n_codes=None):
        dev = store.device
        self.store, self.sampler, self.rows = store, sampler, rows
        self.vi = torch.zeros((rows,), dtype=torch.int64, device=dev)
        self.lr = torch.zeros((rows,), dtype=torch.float32, device=dev)
        self.pix = self.jidx = self.u = self.roll = None
        if sampler is None:
            self.pix = torch.zeros((rows, 2 * n_rays), dtype=torch.int64,
                                   device=dev)
        else:
            if sampler.jitter_mode == "random":
                self.jidx = torch.zeros((rows, sampler.n_interior),
                                        dtype=torch.uint8, device=dev)
            self.u = torch.zeros((rows, sampler.n_rays), device=dev)
            self._sampling_gen = torch.Generator(device=dev)
        if n_codes is not None:
            self.roll = torch.zeros((rows, 1, n_codes), device=dev)
        self.graph = None

    @property
    def keys(self):
        return self.graph.keys

    @staticmethod
    def _at(buf, i):
        return buf.index_select(0, i.reshape(1))[0]

    def batch(self, i):
        """Step i's batch, gathered from the store on the device."""
        vi = self._at(self.vi, i)
        if self.sampler is None:
            pix = self._at(self.pix, i)
        else:
            pix = self.sampler(vi, None if self.jidx is None
                               else self._at(self.jidx, i),
                               self._at(self.u, i))
        batch = self.store.gather_at(vi, pix)
        if self.roll is not None:
            batch["_roll"] = self._at(self.roll, i)
        return batch

    def lr_at(self, i):
        return self._at(self.lr, i)

    def stage(self, vi, lrs, pix=None, sampling_seeds=None, roll_gen=None):
        """Stage a chunk: vi [n] and lrs [n] (host arrays), and pix
        [n, 2 n_rays] (host) or, with a sampler, one seed a step for its
        draws; roll_gen: the generator of vq_nfr's dropout draws."""
        n = len(vi)
        if not 0 < n <= self.rows:
            raise ValueError(f"a chunk of {n} steps; this scan stages 1 to "
                             f"{self.rows}")
        with profiling.span("scan.stage") as sp:
            vi = np.asarray(vi, np.int64)
            lrs = np.asarray(lrs, np.float32)
            self.vi[:n].copy_(torch.from_numpy(vi))
            self.lr[:n].copy_(torch.from_numpy(lrs))
            if self.sampler is None:
                pix = np.asarray(pix, np.int64)
                self.pix[:n].copy_(torch.from_numpy(pix))
            else:
                for j, seed in enumerate(sampling_seeds):
                    self._sampling_gen.manual_seed(int(seed))
                    jidx, u = self.sampler.draw(self._sampling_gen)
                    if jidx is not None:
                        self.jidx[j].copy_(jidx)
                    self.u[j].copy_(u)
            if self.roll is not None:
                k = self.roll.shape[-1]
                for j in range(n):  # _draw_roll's draw, one a step
                    self.roll[j].copy_(torch.rand(
                        (1, k), generator=roll_gen, device=self.roll.device))
            if sp:  # the host arrays copied over
                profiling.count("h2d_bytes", vi.nbytes + lrs.nbytes + (
                    pix.nbytes if self.sampler is None else 0))
        return n

    def run(self, n):
        return self.graph.run(n)


def make_plain_epoch_scan(step_fn, store, rows, n_rays, sampler=None):
    """The ``EpochScan`` of an nfr_unit or ref_nfr ``step_fn``."""
    scan = EpochScan(store, rows, n_rays, sampler=sampler)

    def body(i):
        return step_fn(scan.batch(i), None, lr=scan.lr_at(i))

    scan.graph = StepGraph(body, store.device, rows, mesh=step_fn.mesh)
    return scan


class VqEpochScan(EpochScan):
    """The ``EpochScan`` of vq_nfr: the EMA state in buffers of its own,
    ``ema``, that its steps update in place; ``load_ema`` copies a state
    in."""

    def __init__(self, store, rows, n_rays, ema_state, sampler=None):
        super().__init__(store, rows, n_rays, sampler=sampler,
                         n_codes=ema_state.hidden_cluster_size.shape[0])
        self.ema = VqEmaState(*(t.detach().clone() for t in ema_state))

    def load_ema(self, state):
        for dst, src in zip(self.ema, state):
            if dst is not src:
                dst.copy_(src)


def make_vq_epoch_scan(step_fn, store, rows, n_rays, ema_state, thres,
                       sampler=None):
    """The ``VqEpochScan`` of a vq_nfr ``step_fn`` at dropout threshold
    ``thres``, its EMA buffers starting at ``ema_state``."""
    scan = VqEpochScan(store, rows, n_rays, ema_state, sampler=sampler)

    def body(i):
        new_ema, ld = step_fn(scan.ema, scan.batch(i), thres, None, None,
                              lr=scan.lr_at(i))
        scan.load_ema(new_ema)
        return ld

    scan.graph = StepGraph(body, store.device, rows, mesh=step_fn.mesh)
    return scan
