"""Plain PyTorch reference of VQ-NeRF's stage-2 model, vq_nfr, written from
the published equations (JiuTongBro/vqnerf_release, decomp/nerfvq_nfr3):
the posenc encoder, the BRDF heads, the GGX microfacet BRDF, the render
equation over the lat-long light map, the seven-term training loss, the EMA
vector quantiser with code dropout, and keras' amsgrad.

It imports nothing of the program under test: the benchmark hands it the
weights it made, the scene rows and the draws, and it works out everything
else itself. Every product runs in float32 with TF32 off, unless ``lowp``
rounds the operands of every matrix product and contraction to TF32's 10-bit
mantissa: the precision one step below the configuration's, which the
benchmark's control uses.

A parameter is named as the released checkpoint's pytree names it
(``fine_enc.layers.0.weight`` ...), a dense weight stored [d_out, d_in].
"""

import math

import numpy as np
import torch

# keras' Adam(amsgrad=True) constants
B1, B2, EPS = 0.9, 0.999, 1e-7


def tf32(x):
    """x with its float32 mantissa rounded to TF32's 10 bits (to nearest)."""
    bits = x.detach().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class _RoundIn(torch.autograd.Function):
    """A product's operand rounded to TF32; its gradient passes."""

    @staticmethod
    def forward(ctx, x):
        return tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradOut(torch.autograd.Function):
    """A product's result as it is; the gradient that reaches it rounded to
    TF32, so that the backward's products take TF32 operands too."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return tf32(g)


class Prec:
    """Where the reference's products round: ``lowp`` False is float32;
    True gives every matrix product and contraction TF32 operands, forward
    and backward, with float32 accumulation, as the tensor cores compute
    it."""

    def __init__(self, lowp=False):
        self.lowp = lowp

    def r(self, x):
        return _RoundIn.apply(x) if self.lowp else x

    def out(self, y):
        return _RoundGradOut.apply(y) if self.lowp else y

    def linear(self, x, w, b):
        return self.out(self.r(x) @ self.r(w).T) + b

    def ein(self, eq, *ops):
        return self.out(torch.einsum(eq, *(self.r(o) for o in ops)))


def set_exact():
    """Pin float32 products (TF32 off); the reference's precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- layout

def _mlp_layout(prefix, d_in, widths, skip_at):
    out, cur = [], d_in
    for i, w in enumerate(widths):
        out.append((f"{prefix}.layers.{i}.weight", (w, cur)))
        out.append((f"{prefix}.layers.{i}.bias", (w,)))
        cur = w + (d_in if i in skip_at else 0)
    return out


BOTTLENECK_ACTS = [None, "relu", "sigmoid"]
HEAD_ACTS = ["relu", "relu", "sigmoid"]
HEADS = (("diff_main", 3), ("spec_main", 1), ("rough_main", 1),
         ("diff_vq", 3), ("spec_vq", 3), ("rough_vq", 1))


def posenc_dim(n_freqs):
    return 3 + 6 * n_freqs


def layout(cfg):
    """[(name, shape)] of vq_nfr's parameters for the configuration
    ``cfg`` (a dict with mlp_width, z_dim, n_freqs_xyz, light_h,
    num_embed)."""
    w, z = cfg["mlp_width"], cfg["z_dim"]
    d = posenc_dim(cfg["n_freqs_xyz"])
    out = [("light", (cfg["light_h"], 2 * cfg["light_h"], 3)),
           ("codebook", (z, cfg["num_embed"]))]
    out += _mlp_layout("fine_enc", d, [w] * 4, (2,))
    out += _mlp_layout("bottleneck", w, [w, z, z], ())
    for name, d_out in HEADS:
        out += _mlp_layout(name, z, [z, z // 2, d_out], (1,))
    return out


def make_weights(cfg, seed, device):
    """The benchmark's weights of ``layout(cfg)`` from ``seed``: one uniform
    draw on the device, scaled per leaf (glorot-uniform weights, biases in
    +-0.05, light in 0.5 +- 0.2, codebook columns in [0, 1])."""
    lay = layout(cfg)
    sizes = [int(np.prod(s)) for _, s in lay]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.rand((sum(sizes),), generator=gen, device=device) * 2 - 1
    out = {}
    for (name, shape), part in zip(lay, flat.split(sizes)):
        part = part.view(shape)
        if name == "light":
            out[name] = 0.5 + 0.2 * part
        elif name == "codebook":
            out[name] = 0.5 + 0.5 * part
        elif name.endswith(".bias"):
            out[name] = 0.05 * part
        else:
            out[name] = math.sqrt(6.0 / (shape[0] + shape[1])) * part
    return out


# ----------------------------------------------------------- primitives

def clip_pg(x, lo, hi):
    """The value clipped to [lo, hi]; the gradient passes unclipped."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def l2n(x, dim, eps=1e-6):
    return x * torch.rsqrt(torch.clamp(torch.sum(x * x, dim=dim,
                                                 keepdim=True), min=eps))


def div0(x, y):
    ok = y != 0
    return torch.where(ok, x / torch.where(ok, y, torch.ones_like(y)),
                       torch.zeros_like(x))


def chroma(rgb):
    return div0(rgb, torch.sqrt(torch.sum(rgb * rgb, dim=-1, keepdim=True)))


def linear2srgb(x):
    x = torch.clamp(x, 0.0, 1.0)
    nonlin = 1.055 * torch.clamp(x, min=0.0031308) ** (1 / 2.4) - 0.055
    return torch.where(x <= 0.0031308, 12.92 * x, nonlin)


def srgb2linear(x):
    nonlin = torch.clamp((x + 0.055) / 1.055, min=1e-8) ** 2.4
    return torch.where(x <= 0.04045, x / 12.92, nonlin)


def posenc(x, n_freqs):
    feats = [x]
    for k in range(n_freqs):
        feats += [torch.sin(x * float(2 ** k)), torch.cos(x * float(2 ** k))]
    return torch.cat(feats, dim=-1)


ACTS = {None: lambda x: x, "relu": torch.relu, "sigmoid": torch.sigmoid}


def mlp(p, prefix, x, acts, skip_at, pr):
    h = x
    for i, act in enumerate(acts):
        y = ACTS[act](pr.linear(h, p[f"{prefix}.layers.{i}.weight"],
                                p[f"{prefix}.layers.{i}.bias"]))
        h = torch.cat([y, x], dim=-1) if i in skip_at else y
    return h


def light_xyz(light_h, radius=1e2):
    """Lat-long light positions [L, 3] and solid angles [L] (polar rows
    stepped in by one step; the areas sum to 4 pi)."""
    h, w = light_h, 2 * light_h
    lat_step, lng_step = np.pi / (h + 2), 2 * np.pi / (w + 2)
    lats = np.linspace(np.pi / 2 - lat_step, -np.pi / 2 + lat_step, h)
    lngs = np.linspace(np.pi - lng_step, -np.pi + lng_step, w)
    lngs, lats = np.meshgrid(lngs, lats)
    xyz = np.stack([radius * np.cos(lats) * np.cos(lngs),
                    radius * np.cos(lats) * np.sin(lngs),
                    radius * np.sin(lats)], axis=-1)
    sin_colat = np.sin(np.pi / 2 - lats)
    areas = 4 * np.pi * sin_colat / np.sum(sin_colat)
    return (xyz.reshape(-1, 3).astype(np.float32),
            areas.reshape(-1).astype(np.float32))


def microfacet(l, v, n, albedo, rough, f0, pr):
    """GGX: (diffuse + glossy) [N, L, 3] for unit-normalised l [N, L, 3],
    v [N, 3], n [N, 3]."""
    l, v, n = l2n(l, 2), l2n(v, 1), l2n(n, 1)
    h = l2n(l + v[:, None, :], 2)
    cos_vh = clip_pg(pr.ein("nlk,nk->nl", h, v)[:, :, None], 0.0, 1.0)
    f = f0[:, None, :] + (1.0 - f0[:, None, :]) * (1.0 - cos_vh) ** 5
    a = (rough ** 2)[:, None, :]
    cos_nh = clip_pg(pr.ein("nlk,nk->nl", h, n), 0.0, 1.0)
    d = div0(a ** 2, math.pi * ((cos_nh ** 2)[:, :, None] * (a ** 2 - 1.0)
                                + 1.0) ** 2)
    cos_ln = pr.ein("nlk,nk->nl", l, n)[:, :, None]
    cos_vn = pr.ein("nk,nk->n", n, v)[:, None, None]

    def gsub(c):
        c = clip_pg(c, 0.0, 1.0)
        return div0(2.0 * c, c + torch.sqrt(torch.abs(a ** 2 + (1 - a ** 2)
                                                      * c ** 2)))

    glossy = div0(f * gsub(cos_ln) * gsub(cos_vn) * d,
                  4.0 * torch.abs(cos_ln) * torch.abs(cos_vn))
    return glossy + (albedo / math.pi)[:, None, :]


def render(brdf, l, n, lareas, light, lvis, pr):
    """sum over L of brdf * light * front-lit * lvis * cos * area, clipped
    to [0, 1] (value only). ``light`` [L, 3] gives [N, 3]; [E, L, 3] gives
    [N, E, 3]."""
    cos = pr.ein("nlk,nk->nl", l, n)
    w = brdf * ((cos > 0).to(brdf.dtype) * lvis * cos)[:, :, None] \
        * lareas.reshape(1, -1, 1)
    if light.dim() == 3:
        return clip_pg(pr.ein("nlc,elc->nec", w, light), 0.0, 1.0)
    return clip_pg(pr.ein("nlc,lc->nc", w, light), 0.0, 1.0)


def geometry(b, lxyz):
    v = l2n(b["rayo"] - b["xyz"], 1)
    l = l2n(lxyz[None, :, :] - b["xyz"][:, None, :], 2)
    n = b["normal"]
    n = torch.where(torch.sum(n * v, -1, keepdim=True) >= 0, n, -n)
    return v, l, n


def encode(p, xyz, cfg, pr):
    h = mlp(p, "fine_enc", posenc(xyz, cfg["n_freqs_xyz"]), ["relu"] * 4,
            (2,), pr)
    return mlp(p, "bottleneck", h, BOTTLENECK_ACTS, (), pr)


def head(p, name, z, pr):
    return mlp(p, name, z, HEAD_ACTS, (1,), pr)


def decode_main(p, z, cfg, pr):
    base = cfg["albedo_slope"] * head(p, "diff_main", z, pr) \
        + cfg["albedo_bias"]
    ks = head(p, "spec_main", z, pr)
    return base, ks, head(p, "rough_main", z, pr), ks * base, (1 - ks) * base


def codebook_n(cb):
    return l2n(clip_pg(cb, 0.0, 1.0), 0)


def masked_mean(x, m):
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def mse(a, b):
    return torch.mean((a - b) ** 2, dim=-1)


# ------------------------------------------------------------- training

def train_thres(cfg):
    keep = cfg["num_embed"] - cfg["num_drop"]
    return np.array([0.0] * keep + [float(t) for t in
                                     cfg["thres_str"].split(";")], np.float32)


def decomp_lr(step, cfg):
    return cfg["lr"] * cfg["lr_decay_rate"] ** (step / cfg["lr_decay_steps"])


def vq_step(p, ema, z_norm, mask, roll, thres, cfg, pr):
    """EMA VQ with code dropout (the Sonnet EMA, debiased, Laplace
    smoothing, unused codes frozen): (quantize, commitment loss, the
    proposed codebook, the new EMA state)."""
    cbn = codebook_n(p["codebook"])
    dist = (torch.sum(z_norm ** 2, 1, keepdim=True)
            - 2.0 * pr.out(pr.r(z_norm) @ pr.r(cbn))
            + torch.sum(cbn ** 2, 0, keepdim=True))
    sel = (roll.reshape(1, -1) >= thres.reshape(1, -1)).to(dist.dtype)
    dist = dist * sel + torch.max(dist) * (1 - sel)
    idx = torch.argmin(dist, dim=1)
    q = cbn.T[idx]
    denom = torch.clamp(torch.sum(mask), min=1.0)
    loss = cfg["commitment_cost"] * torch.sum(
        torch.mean((q.detach() - z_norm) ** 2, -1) * mask) / denom
    with torch.no_grad():
        onehot = torch.nn.functional.one_hot(idx, cbn.shape[1]).float()
        counts = torch.sum(onehot * mask[:, None], 0)
        dw = pr.r(z_norm * mask[:, None]).T @ pr.r(onehot)
        hcs, hdw, counter = ema
        counter = counter + 1
        decay = cfg["vq_decay"]
        hcs = hcs - (hcs - counts) * (1 - decay)
        hdw = hdw - (hdw - dw) * (1 - decay)
        deb = 1.0 - decay ** float(counter)
        cs, w = hcs / deb, hdw / deb
        n = torch.sum(cs)
        cs = (cs + 1e-5) / (n + cbn.shape[1] * 1e-5) * n
        used = (counts > 0).float()
        update = (w / cs[None, :]) * used[None, :] + cbn * (1 - used[None, :])
    quantize = z_norm + (q - z_norm).detach()
    return quantize, loss, update, (hcs, hdw, counter)


def vq_nfr_loss(p, ema, b, roll, thres, cfg, lxyz, lareas, pr):
    """(loss, terms, codebook update, new EMA state) of one training
    batch ``b``."""
    mask = (b["alpha"][:, 0] > 0).float()
    z_enc = encode(p, b["xyz"], cfg, pr)
    z_norm = l2n(z_enc, 1)
    z_vq, vq_loss, update, ema = vq_step(p, ema, z_norm, mask, roll, thres,
                                         cfg, pr)
    v, l, n = geometry(b, lxyz)
    lvis = b["lvis"]
    light = clip_pg(p["light"], 0.0, float("inf")).reshape(-1, 3)
    _, ks, rough, spec, albedo = decode_main(p, z_enc, cfg, pr)
    rgb = render(microfacet(l, v, n, albedo, rough, spec, pr), l, n, lareas,
                 light, lvis, pr)
    vq_alb = cfg["albedo_slope"] * head(p, "diff_vq", z_vq, pr) \
        + cfg["albedo_bias"]
    vq_rgb = render(microfacet(l, v, n, vq_alb, head(p, "rough_vq", z_vq, pr),
                               head(p, "spec_vq", z_vq, pr), pr),
                    l, n, lareas, light, lvis, pr)
    lin_gt = srgb2linear(b["rgb"])
    t = {"rgb": cfg["combine_weight"] * masked_mean(mse(lin_gt, rgb), mask),
         "vqrgb": masked_mean(mse(lin_gt, vq_rgb), mask),
         "vqloss": cfg["vq_loss_weight"] * vq_loss,
         "chromaticity": cfg["chromaticity_loss_weight"] * masked_mean(
             mse(chroma(lin_gt), chroma(vq_rgb)), mask)}
    schr = chroma(b["rgb"])
    chr_e = torch.sqrt(torch.sum((schr[::2] - schr[1::2]) ** 2, -1))
    chr_e = torch.where(chr_e > cfg["chr_thres"], chr_e,
                        torch.zeros_like(chr_e))
    pair = torch.exp(-cfg["chr_alpha"] * chr_e) * (
        1.0 - torch.sum(z_vq[::2] * z_vq[1::2], -1))
    t["chr_smooth"] = cfg["mat_sloss_weight"] * masked_mean(
        pair, mask[::2] * mask[1::2])
    raw = p["codebook"] + (update - p["codebook"]).detach()
    cb = codebook_n(raw).T
    dist = torch.sqrt(torch.sum((cb[:, None] - cb[None]) ** 2, -1) + 1e-12)
    eye = torch.eye(cb.shape[0], device=cb.device)
    t["sim_smooth"] = cfg["sim_loss_weight"] * -torch.log(torch.min(
        dist * (1 - eye) + eye * torch.max(dist)))
    sg = rough.detach()
    sg = torch.where(sg < 0.5, torch.zeros_like(sg), 2.0 * sg - 1.0)
    t["lambert"] = cfg["lambert_weight"] * masked_mean(
        torch.amax(spec, -1) * sg[:, 0], mask)
    loss = sum(t.values())
    return loss, t, update, ema


class Amsgrad:
    """keras' Adam(amsgrad=True): uncorrected moments, the bias correction
    folded into the step size, eps outside the square root; a step whose
    loss or gradients are not finite changes nothing."""

    def __init__(self, params):
        self.count = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.vhat = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads, lr, loss):
        ok = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if not ok:
            return False
        self.count += 1
        t = float(self.count)
        corr = math.sqrt(1.0 - B2 ** t) / (1.0 - B1 ** t)
        for k, g in grads.items():
            self.m[k] = B1 * self.m[k] + (1 - B1) * g
            self.v[k] = B2 * self.v[k] + (1 - B2) * g * g
            self.vhat[k] = torch.maximum(self.vhat[k], self.v[k])
            params[k] = params[k] - lr * (corr * self.m[k]
                                          / (torch.sqrt(self.vhat[k]) + EPS))
        return True


def train_steps(weights, batches, lrs, rolls, cfg, lowp=False,
                keep_rows=None):
    """Steps of vq_nfr from ``weights`` over ``batches`` (dicts of
    [N, ...] tensors), at learning rates ``lrs`` with dropout uniforms
    ``rolls`` [K] each. ``keep_rows`` trains on the first rows of every
    batch only (a fault the benchmark's own test plants). Returns
    {"loss": [floats], "grad1": {leaf: tensor} (the first step's),
    "params": {leaf: tensor} after the last step}."""
    set_exact()
    pr = Prec(lowp)
    dev = next(iter(weights.values())).device
    lxyz, lareas = (torch.as_tensor(a, device=dev)
                    for a in light_xyz(cfg["light_h"]))
    thres = torch.as_tensor(train_thres(cfg), device=dev)
    p = {k: v.detach().clone() for k, v in weights.items()}
    k_codes = cfg["num_embed"]
    ema = (torch.zeros((k_codes,), device=dev),
           torch.zeros((cfg["z_dim"], k_codes), device=dev), 0)
    opt = Amsgrad(p)
    out = {"loss": [], "grad1": None}
    for b, lr, roll in zip(batches, lrs, rolls):
        if keep_rows is not None:
            b = {k: v[:keep_rows] for k, v in b.items()}
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss, _, update, new_ema = vq_nfr_loss(leaves, ema, b, roll, thres,
                                               cfg, lxyz, lareas, pr)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(
            leaves.values()))))
        out["loss"].append(float(loss.detach()))
        if out["grad1"] is None:
            out["grad1"] = {k: g.detach() for k, g in grads.items()}
        before = p["codebook"]
        if opt.step(p, grads, lr, loss.detach()):
            p["codebook"] = update + (p["codebook"] - before)
            ema = new_ema
        del leaves, grads, loss
    out["params"] = p
    return out


# ------------------------------------------------------------ inference

@torch.no_grad()
def fast_render(p, b, probes, olats, cfg, lowp=False):
    """The relighting render of rows ``b`` under the learned light, the
    probes [E, L, 3] and the OLATs [O, L, 3]: the maps and renders of
    vq_fast_render, background rows zeroed."""
    set_exact()
    pr = Prec(lowp)
    dev = b["xyz"].device
    lxyz, lareas = (torch.as_tensor(a, device=dev)
                    for a in light_xyz(cfg["light_h"]))
    mask = (b["alpha"][:, 0] > 0).float()[:, None]
    z = encode(p, b["xyz"], cfg, pr)
    base, _, rough, spec, albedo = decode_main(p, z, cfg, pr)
    v, l, n = geometry(b, lxyz)
    brdf = microfacet(l, v, n, albedo, rough, spec, pr)
    light = clip_pg(p["light"], 0.0, float("inf")).reshape(-1, 3)
    out = {"basecolor": base * mask, "albedo": albedo * mask,
           "spec": spec * mask, "rough": rough * mask,
           "rgb": linear2srgb(render(brdf, l, n, lareas, light, b["lvis"],
                                     pr)) * mask}
    for key, envs in (("rgb_probes", probes), ("rgb_olat", olats)):
        out[key] = linear2srgb(render(brdf, l, n, lareas, envs, b["lvis"],
                                      pr)) * mask[:, :, None]
    return out
