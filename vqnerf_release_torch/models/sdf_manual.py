"""The NeuS SDF's (value, feature, spatial gradient) with a hand-derived
reverse pass (counterpart of vqnerf_release_tpu/models/sdf_manual.py).

The NeuS training loss reads the SDF's spatial gradient (the Eikonal term
and the colour net's normals), so ``fields.sdf_value_feature_gradient(...,
create_graph=True)`` differentiates through a ``torch.autograd.grad``:
reverse over reverse. Here the gradient comes from forward mode instead:
three tangent channels go through the net beside the primal, seeded with
the positional encoding's analytic derivatives. One reverse pass over that
forward program is derived by hand and exposed as a
``torch.autograd.Function``:

  * the forward saves only the points and the parameters; the backward
    runs the forward again, so nothing is held between the two;
  * the only second-order terms are elementwise: softplus100''(z) =
    100 sigmoid(100 z) (1 - sigmoid(100 z)) and the encoding's d^2/dx^2;
  * each layer's cotangents are plain [N*3, D] @ [D, E] products.

The result is differentiable once, in the points and in every ``v``, ``g``
and ``b`` of the net (``fields.sdf_value_feature_gradient`` detaches the
points). The forward's ``sdf`` and ``feature`` are ``fields.sdf_apply``'s,
bit for bit. The training step keeps ``fields.sdf_value_feature_gradient``;
this module is the verified reverse-over-forward program that a
hand-written kernel for the SDF's double backward would be held to.
"""

import math

import torch
from torch.autograd.function import once_differentiable

from ..ops.nn import wn_fold
from .fields import SOFTPLUS_BETA, SDFConfig, _sdf_dims, softplus100

__all__ = ["sdf_vfg_manual"]

_SQRT2 = math.sqrt(2.0)


def _embed_terms(x, cfg: SDFConfig):
    """(e, de, dde), each [N, D]: the encoding of scale * x as
    ``ops.embed.posenc`` lays it out, and its first and second derivatives
    in x. Channel j depends on input component j % d_in alone, so each
    Jacobian and Hessian is stored as that one entry a channel."""
    s = cfg.scale
    xin = x * s
    if cfg.multires == 0:
        return xin, torch.full_like(x, s), torch.zeros_like(x)
    es, des, ddes = [xin], [torch.full_like(x, s)], [torch.zeros_like(x)]
    for k in range(cfg.multires):
        f = float(2**k)
        sin, cos = torch.sin(xin * f), torch.cos(xin * f)
        es += [sin, cos]
        des += [f * s * cos, -f * s * sin]
        ddes += [-(f * s) ** 2 * sin, -(f * s) ** 2 * cos]
    return torch.cat(es, -1), torch.cat(des, -1), torch.cat(ddes, -1)


def _dir_mask(d, d_in, like):
    """[3, D]: 1 where channel j belongs to input component k = j % d_in."""
    j = torch.arange(d, device=like.device)
    k = torch.arange(3, device=like.device)
    return (j % d_in == k[:, None]).to(like.dtype)


def _tmm(t, w):
    """Tangents [N, 3, D] @ [D, E] -> [N, 3, E] as one [N*3, D] product."""
    n, k, d = t.shape
    return (t.reshape(n * k, d) @ w).view(n, k, -1)


def _forward(weights, biases, x, cfg: SDFConfig):
    """The primal and its three tangent channels through the net. Returns
    (sdf, feature, grad) and what the reverse pass reads: each layer's input
    and input tangents, its pre-activation, and the encoding's terms."""
    e, de, dde = _embed_terms(x, cfg)
    t0 = de[:, None, :] * _dir_mask(de.shape[-1], cfg.d_in, de)
    h, t = e, t0
    hs, ts, zs = [], [], []
    last = len(weights) - 1
    for l, (w, b) in enumerate(zip(weights, biases)):
        if l in cfg.skip_in:
            h = torch.cat([h, e], dim=-1) / _SQRT2
            t = torch.cat([t, t0], dim=-1) / _SQRT2
        hs.append(h)
        ts.append(t)
        z = h @ w + b
        zs.append(z)
        if l < last:
            t = torch.sigmoid(SOFTPLUS_BETA * z)[:, None, :] * _tmm(t, w)
            h = softplus100(z)
        else:
            h, t = z, _tmm(t, w)
    out = (h[:, :1] / cfg.scale, h[:, 1:], t[:, :, 0] / cfg.scale)
    return out, (hs, ts, zs, e, de, dde)


def _backward(vs, gs, weights, biases, x, cfg: SDFConfig, s_bar, f_bar,
              g_bar):
    """The hand-derived reverse pass over ``_forward``, which it runs again:
    cotangents of (sdf, feature, grad) -> those of (v, g, b) a layer and of
    x."""
    _, (hs, ts, zs, e, de, dde) = _forward(weights, biases, x, cfg)
    d_embed = _sdf_dims(cfg)[0]
    # the last layer is linear; the gradient reads tangent channel 0 only
    h_bar = torch.cat([s_bar / cfg.scale, f_bar], dim=-1)
    t_bar = torch.zeros(h_bar.shape[0], 3, h_bar.shape[1], dtype=h_bar.dtype,
                        device=h_bar.device)
    t_bar[:, :, 0] = g_bar / cfg.scale
    e_bar = torch.zeros_like(e)
    t0_bar = torch.zeros_like(de)
    mask = _dir_mask(d_embed, cfg.d_in, de)
    last = len(weights) - 1
    param_bars = [None] * len(weights)
    for l in range(last, -1, -1):
        z, h_in, t_in, w = zs[l], hs[l], ts[l], weights[l]
        if l < last:
            sig = torch.sigmoid(SOFTPLUS_BETA * z)
            tz = _tmm(t_in, w)
            z_bar = (h_bar * sig + torch.sum(t_bar * tz, dim=1)
                     * (SOFTPLUS_BETA * sig * (1.0 - sig)))
            tz_bar = sig[:, None, :] * t_bar
        else:
            z_bar, tz_bar = h_bar, t_bar
        n, k, d = t_in.shape
        w_bar = h_in.T @ z_bar + t_in.reshape(n * k, d).T @ tz_bar.reshape(
            n * k, -1)
        # the weight norm's reverse into v and g
        v, g = vs[l], gs[l]
        v_norm = torch.clamp(torch.linalg.norm(v, dim=0, keepdim=True),
                             min=1e-12)
        wv = torch.sum(w_bar * v, dim=0, keepdim=True)
        param_bars[l] = ((g[None, :] / v_norm) * (w_bar - v * wv / v_norm**2),
                         (wv / v_norm)[0], torch.sum(z_bar, dim=0))
        h_bar = z_bar @ w.T
        t_bar = _tmm(tz_bar, w.T)
        if l in cfg.skip_in:
            d_prev = h_bar.shape[-1] - d_embed
            e_bar = e_bar + h_bar[:, d_prev:] / _SQRT2
            # T0's channel j is nonzero in direction j % d_in alone
            t0_bar = t0_bar + torch.sum(t_bar[:, :, d_prev:] * mask,
                                        dim=1) / _SQRT2
            h_bar = h_bar[:, :d_prev] / _SQRT2
            t_bar = t_bar[:, :, :d_prev] / _SQRT2
    e_bar = e_bar + h_bar
    t0_bar = t0_bar + torch.sum(t_bar * mask, dim=1)
    # e reaches x through de, the seed tangents T0 through dde
    x_bar = (e_bar * de + t0_bar * dde) @ mask.T
    return param_bars, x_bar


class _SDFValueFeatureGradient(torch.autograd.Function):
    """(cfg, x, v0, g0, b0, v1, ...) -> (sdf, feature, grad)."""

    @staticmethod
    def forward(ctx, cfg, x, *flat):
        ctx.cfg = cfg
        ctx.save_for_backward(x, *flat)
        weights = [wn_fold(v, g) for v, g in zip(flat[0::3], flat[1::3])]
        out, _ = _forward(weights, flat[2::3], x, cfg)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, s_bar, f_bar, g_bar):
        x, *flat = ctx.saved_tensors
        vs, gs, bs = flat[0::3], flat[1::3], flat[2::3]
        weights = [wn_fold(v, g) for v, g in zip(vs, gs)]
        param_bars, x_bar = _backward(vs, gs, weights, bs, x, ctx.cfg, s_bar,
                                      f_bar, g_bar)
        return (None, x_bar if ctx.needs_input_grad[1] else None,
                *[bar for bars in param_bars for bar in bars])


def sdf_vfg_manual(params, x, cfg: SDFConfig):
    """(sdf [N, 1], feature [N, d_out - 1], d sdf / d x [N, 3]) of the SDF
    net ``params`` (a list of ``ops.nn.WNDense``) at points x [N, 3], with
    the hand-derived backward: a drop-in for
    ``fields.sdf_value_feature_gradient(params, x, cfg, create_graph=True)``
    where the result is differentiated once."""
    flat = [t for p in params for t in (p.v, p.g, p.b)]
    return _SDFValueFeatureGradient.apply(cfg, x, *flat)
