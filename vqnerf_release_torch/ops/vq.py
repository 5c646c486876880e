"""Vector-quantisation lookup (counterpart of vqnerf_release_tpu/ops/vq.py),
inference side.

Kept from the JAX package:
  * L2 distances by one matmul, |z|^2 - 2 z C + |C|^2 with C [D, K];
  * code dropout at the distance level, where a dropped code's distance
    becomes the largest distance of the WHOLE call. The fill therefore
    depends on how the caller chunks its rows, and the test driver chunks
    exactly as the JAX driver does;
  * argmin ties go to the first index (torch.argmin does so).

The EMA codebook update of training comes with the trainer port.
"""

from typing import NamedTuple

import torch

__all__ = ["VqEmaState", "init_vq_ema_state", "vq_lookup", "vq_ema_apply"]


class VqEmaState(NamedTuple):
    hidden_cluster_size: torch.Tensor  # [K]
    hidden_dw: torch.Tensor  # [D, K]
    counter: torch.Tensor  # [] int32


def init_vq_ema_state(z_dim, n_embed, device=None):
    return VqEmaState(
        hidden_cluster_size=torch.zeros((n_embed,), device=device),
        hidden_dw=torch.zeros((z_dim, n_embed), device=device),
        counter=torch.zeros((), dtype=torch.int32, device=device),
    )


def vq_lookup(codebook, flat_inputs, thres=None, rng=None, roll=None):
    """Nearest-code assignment with optional code dropout.

    codebook [D, K]; flat_inputs [N, D]; thres None or [K] (or scalar): a
    code is usable only where U(0, 1) >= thres. rng: a torch.Generator on
    the inputs' device, drawn from when thres is given and roll is None;
    roll: explicit [1, K] uniforms.
    Returns encoding_indices [N] (int64), encodings [N, K], quantized
    [N, D] and distances [N, K].
    """
    distances = (
        torch.sum(flat_inputs**2, dim=1, keepdim=True)
        - 2.0 * flat_inputs @ codebook
        + torch.sum(codebook**2, dim=0, keepdim=True))

    if thres is not None:
        mask_value = torch.max(distances)
        if roll is None:
            roll = torch.rand((1, codebook.shape[1]), generator=rng,
                              device=codebook.device)
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
                 is_training=False, thres=None, rng=None, mask=None,
                 roll=None):
    """The VQ step in evaluation mode: lookup, commitment loss, perplexity
    and the straight-through quantized inputs; ``ema_state`` is returned
    unchanged. ``mask`` [N] weights rows out of the loss and statistics.
    """
    if is_training:
        raise NotImplementedError(
            "vq_ema_apply(is_training=True): the EMA codebook update comes "
            "with the port of the stage-2 trainer")
    n = flat_inputs.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=flat_inputs.dtype,
                          device=flat_inputs.device)
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
    return outs, ema_state
