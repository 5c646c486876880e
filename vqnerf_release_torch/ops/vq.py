"""EMA vector quantisation (counterpart of vqnerf_release_tpu/ops/vq.py).

Kept from the JAX package:
  * L2 distances by one matmul, |z|^2 - 2 z C + |C|^2 with C [D, K];
  * code dropout at the distance level. On the eager path a dropped code's
    distance becomes the largest distance of the WHOLE call, so the fill
    depends on how the caller chunks its rows; the fused path masks with
    1e30 instead (``kernels/vq.py``), as the JAX kernel does;
  * argmin ties go to the first index (torch.argmin does so);
  * the straight-through estimator, and in training the zero-debiased
    Sonnet EMAs of the cluster sizes and of dw = z^T onehot, Laplace
    smoothing and the freeze of unused codes. The eager path debiases with
    ``decay ** counter``, the fused one with ``exp(counter log(decay))``.

The EMA statistics live in an explicit ``VqEmaState`` that the train step
threads through; the caller assigns ``outs["update"]`` to its codebook.
"""

from typing import NamedTuple

import torch

from ..kernels.vq import vq_fused_train

__all__ = ["VqEmaState", "init_vq_ema_state", "vq_lookup", "vq_ema_apply"]


class VqEmaState(NamedTuple):
    hidden_cluster_size: torch.Tensor  # [K]
    hidden_dw: torch.Tensor  # [D, K]
    counter: torch.Tensor  # [] int32, shared by both EMAs


def init_vq_ema_state(z_dim, n_embed, device=None):
    return VqEmaState(
        hidden_cluster_size=torch.zeros((n_embed,), device=device),
        hidden_dw=torch.zeros((z_dim, n_embed), device=device),
        counter=torch.zeros((), dtype=torch.int32, device=device),
    )


def _ema_update(hidden, value, counter, decay):
    """Sonnet ExponentialMovingAverage: (new_hidden, debiased)."""
    new_hidden = hidden - (hidden - value) * (1.0 - decay)
    debiased = new_hidden / (1.0 - decay ** counter.to(torch.float32))
    return new_hidden, debiased


def _draw_roll(roll, rng, k, device):
    if roll is None:
        roll = torch.rand((1, k), generator=rng, device=device)
    return roll


def vq_lookup(codebook, flat_inputs, thres=None, rng=None, mask=None,
              roll=None):
    """Nearest-code assignment with optional code dropout.

    codebook [D, K]; flat_inputs [N, D]; thres None or [K] (or scalar): a
    code is usable only where U(0, 1) >= thres. rng: a torch.Generator on
    the inputs' device, drawn from when thres is given and roll is None;
    roll: explicit [1, K] uniforms. mask: optional [N] validity weights;
    invalid rows still get an argmin, and the caller weights them out of
    any statistics.
    Returns encoding_indices [N] (int64), encodings [N, K], quantized
    [N, D] (no straight-through) and distances [N, K].
    """
    del mask
    distances = (
        torch.sum(flat_inputs**2, dim=1, keepdim=True)
        - 2.0 * flat_inputs @ codebook
        + torch.sum(codebook**2, dim=0, keepdim=True))

    if thres is not None:
        mask_value = torch.max(distances)
        roll = _draw_roll(roll, rng, codebook.shape[1], codebook.device)
        sel_mask = (roll >= thres).to(distances.dtype)
        distances = distances * sel_mask + mask_value * (1.0 - sel_mask)

    encoding_indices = torch.argmin(distances, dim=1)
    encodings = torch.nn.functional.one_hot(
        encoding_indices, codebook.shape[1]).to(flat_inputs.dtype)
    quantized = codebook.T[encoding_indices]
    return {
        "encoding_indices": encoding_indices,
        "encodings": encodings,
        "quantized": quantized,
        "distances": distances,
    }


def vq_ema_apply(codebook, flat_inputs, ema_state, *, commitment_cost,
                 decay=0.999, epsilon=1e-5, is_training=True, thres=None,
                 rng=None, mask=None, roll=None, use_fused=False):
    """The full VQ-EMA step: forward, and in training the proposal of the
    new codebook.

    Returns (outs, new_ema_state). ``outs`` holds quantize (straight-
    through, [N, D]), loss (commitment_cost * e_latent_loss), perplexity,
    encodings, encoding_indices, distances and, in training, update: the
    new codebook value [D, K], without gradient, which the caller assigns
    after its gradient step. ``mask`` [N] weights rows out of the loss, the
    EMA statistics and the perplexity.

    ``use_fused`` (training only) takes assignment, statistics and the EMA
    update through the fused kernel (``kernels/vq.py``): its outs have
    masked per-code ``counts`` in place of ``encodings`` and ``distances``.
    The loss and the straight-through estimator stay here either way.
    """
    n = flat_inputs.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=flat_inputs.dtype,
                          device=flat_inputs.device)

    if use_fused and is_training:
        return _vq_ema_apply_fused(
            codebook, flat_inputs, ema_state, commitment_cost, decay,
            epsilon, thres, rng, mask, roll)
    look = vq_lookup(codebook, flat_inputs, thres=thres, rng=rng, roll=roll)
    encodings = look["encodings"] * mask[:, None]
    quantized = look["quantized"]

    denom = torch.clamp(torch.sum(mask), min=1.0)
    e_latent_loss = torch.sum(
        torch.mean((quantized.detach() - flat_inputs) ** 2, dim=-1)
        * mask) / denom
    avg_probs = torch.sum(encodings, dim=0) / denom
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    outs = {
        "quantize": flat_inputs + (quantized - flat_inputs).detach(),
        "loss": commitment_cost * e_latent_loss,
        "perplexity": perplexity,
        "encodings": encodings,
        "encoding_indices": look["encoding_indices"],
        "distances": look["distances"],
    }
    if not is_training:
        return outs, ema_state

    with torch.no_grad():
        counts = torch.sum(encodings, dim=0)  # [K]
        dw = (flat_inputs * mask[:, None]).T @ look["encodings"]  # [D, K]

        counter = ema_state.counter + 1
        hidden_cs, ema_cs = _ema_update(
            ema_state.hidden_cluster_size, counts, counter, decay)
        hidden_dw, ema_dw = _ema_update(
            ema_state.hidden_dw, dw, counter, decay)

        n_total = torch.sum(ema_cs)
        smoothed_cs = ((ema_cs + epsilon)
                       / (n_total + codebook.shape[1] * epsilon) * n_total)
        normalized_w = ema_dw / smoothed_cs[None, :]

        used = (counts > 0).to(codebook.dtype)  # the freeze of unused codes
        outs["update"] = (normalized_w * used[None, :]
                          + codebook * (1.0 - used[None, :]))
    return outs, VqEmaState(hidden_cs, hidden_dw, counter)


def _vq_ema_apply_fused(codebook, flat_inputs, ema_state, commitment_cost,
                        decay, epsilon, thres, rng, mask, roll):
    """The training step through the fused kernel; the contract of
    vq_ema_apply without the ``distances`` and ``encodings`` outputs."""
    k = codebook.shape[1]
    device = codebook.device
    if thres is None:
        sel = torch.ones((k,), dtype=torch.float32, device=device)
    else:
        roll = _draw_roll(roll, rng, k, device)
        sel = (roll >= thres).to(torch.float32).reshape((k,))

    counter = ema_state.counter + 1
    fused = vq_fused_train(
        codebook, flat_inputs, mask.to(torch.float32), sel,
        ema_state.hidden_cluster_size, ema_state.hidden_dw,
        counter.to(torch.float32), decay=decay, epsilon=epsilon)

    quantized = fused["quantized"]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    e_latent_loss = torch.sum(
        torch.mean((quantized - flat_inputs) ** 2, dim=-1) * mask) / denom
    avg_probs = fused["counts"] / denom
    perplexity = torch.exp(-torch.sum(avg_probs * torch.log(avg_probs + 1e-10)))
    outs = {
        "quantize": flat_inputs + (quantized - flat_inputs).detach(),
        "loss": commitment_cost * e_latent_loss,
        "perplexity": perplexity,
        "counts": fused["counts"],
        "encoding_indices": fused["indices"],
        "update": fused["update"],
    }
    return outs, VqEmaState(fused["hidden_cs"], fused["hidden_dw"], counter)
