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
"""

import torch

from ..models import decomp_common as dc
from ..models.nfr_unit import nfr_unit_forward, nfr_unit_loss
from ..models.ref_nfr import ref_nfr_forward, ref_nfr_loss
from ..models.vq_nfr import vq_nfr_forward, vq_nfr_loss
from ..ops.vq import VqEmaState

__all__ = ["decomp_lr", "KerasAmsgrad", "make_nfr_unit_step",
           "make_vq_nfr_step", "make_ref_nfr_step"]


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
        """Apply one update from ``grads`` (a list like params). Returns ok,
        a 0-dim bool tensor: False when the guard skipped the step."""
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
            st["count"] = torch.where(ok, count, st["count"])
            st["m"] = torch.where(ok, m, st["m"])
            st["v"] = torch.where(ok, v, st["v"])
            st["vhat"] = torch.where(ok, vhat, st["vhat"])
        else:
            st.update(count=count, m=m, v=v, vhat=vhat)
        torch._foreach_add_(
            self.params,
            [d.view_as(p) for d, p in zip(delta.split(self.sizes),
                                          self.params)])
        return ok


def _grads(loss, params):
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def _finish_ld(ld, ok, guard):
    ld = {k: v.detach() for k, v in ld.items()}
    if guard:
        ld["nonfinite_grads"] = 1.0 - ok.to(torch.float32)
    return ld


def make_nfr_unit_step(model, cfg: dc.DecompConfig, lxyz, lareas):
    """(optimizer, step_fn); step_fn(batch, step) -> loss dict of 0-dim
    tensors on the device, after updating ``model`` in place."""
    params = list(model.parameters())
    opt = KerasAmsgrad(params, cfg)

    def step_fn(batch, step):
        _, aux = nfr_unit_forward(model, batch, cfg, lxyz, lareas,
                                  mode="train")
        loss, ld = nfr_unit_loss(aux, cfg, mode="train")
        ok = opt.step(_grads(loss, params), decomp_lr(step, cfg), loss)
        return _finish_ld(ld, ok, opt.guard)

    return opt, step_fn


def make_vq_nfr_step(model, cfg: dc.DecompConfig, lxyz, lareas):
    """(optimizer, step_fn); step_fn(ema_state, batch, thres, rng, step) ->
    (new_ema_state, loss dict), after updating ``model`` in place.
    ``batch["_roll"]`` (optional, [1, K]) gives the dropout uniforms in
    place of a draw from ``rng``."""
    params = list(model.parameters())
    opt = KerasAmsgrad(params, cfg)

    def step_fn(ema_state, batch, thres, rng, step):
        batch = dict(batch)
        roll = batch.pop("_roll", None)
        _, aux, new_ema = vq_nfr_forward(
            model, ema_state, batch, cfg, lxyz, lareas, mode="train",
            thres=thres, rng=rng, roll=roll)
        loss, ld = vq_nfr_loss(model, aux, cfg, mode="train")
        cb_update = aux["codebook_update"]
        old_cb = model.codebook.detach().clone()
        ok = opt.step(_grads(loss, params), decomp_lr(step, cfg), loss)
        with torch.no_grad():
            # the EMA assignment, and the optimizer's delta on top of it
            # (zero when the guard skipped the step)
            new_cb = cb_update + (model.codebook - old_cb)
            if opt.guard:
                # a poisoned batch also contaminates the EMA statistics
                # and the proposal: discard them too on a skipped step
                new_cb = torch.where(ok, new_cb, old_cb)
                new_ema = VqEmaState(*(torch.where(ok, a, b) for a, b in
                                       zip(new_ema, ema_state)))
            model.codebook.copy_(new_cb)
        return new_ema, _finish_ld(ld, ok, opt.guard)

    return opt, step_fn


def make_ref_nfr_step(model, cfg: dc.DecompConfig, lxyz, lareas):
    """(optimizer, step_fn) over ``model.trainable`` only; step_fn(batch,
    step) -> loss dict of 0-dim tensors on the device, after updating the
    trainable part in place."""
    params = list(model.trainable.parameters())
    opt = KerasAmsgrad(params, cfg)

    def step_fn(batch, step):
        _, aux = ref_nfr_forward(model, batch, cfg, lxyz, lareas,
                                 mode="train")
        loss, ld = ref_nfr_loss(aux, cfg, mode="train")
        ok = opt.step(_grads(loss, params), decomp_lr(step, cfg), loss)
        return _finish_ld(ld, ok, opt.guard)

    return opt, step_fn
