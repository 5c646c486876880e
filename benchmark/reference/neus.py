"""Plain PyTorch reference of VQ-NeRF's stage 1, NeuS training, written from
the published equations (JiuTongBro/vqnerf_release, geo/NeuS-ours2, and
NeuS, Wang et al. 2021): the weight-normalised SDF MLP with softplus(100)
and its skip, the IDR colour MLP, the logistic density's section alpha with
cos annealing, occupancy-placed first samples, hierarchical up-sampling,
the white background, the Eikonal term by a double backward, the mask BCE,
and Adam with the warm-up and cosine schedule.

It imports nothing of the program under test: the benchmark hands it the
weights it made, the rays and the uniform draws, and it works out the rest,
the occupancy grid included. Products run in float32 with TF32 off, unless
``lowp`` gives them TF32 operands (the benchmark's control).

A parameter is named as the released checkpoint's pytree names it
(``sdf.<layer>.v`` / ``.g`` / ``.b``, ``color.<layer>...``,
``variance.variance``); a weight-normalised layer's ``v`` is [d_in, d_out].
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from .decomp import Prec, set_exact

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.scale_by_adam


def posenc(x, n_freqs):
    feats = [x]
    for k in range(n_freqs):
        feats += [torch.sin(x * float(2 ** k)), torch.cos(x * float(2 ** k))]
    return torch.cat(feats, dim=-1)


def sdf_dims(m):
    s = m["sdf"]
    d0 = s["d_in"] * (1 + 2 * s["multires"])
    return [d0] + [s["d_hidden"]] * s["n_layers"] + [s["d_out"]]


def color_dims(m):
    c = m["color"]
    d0 = c["d_in"] + c["d_feature"] + 3 * 2 * c["multires_view"]
    return [d0] + [c["d_hidden"]] * c["n_layers"] + [c["d_out"]]


def _sdf_out_dims(m):
    dims, skip = sdf_dims(m), m["sdf"]["skip_in"]
    return [(dims[l], dims[l + 1] - (dims[0] if l + 1 in skip else 0))
            for l in range(len(dims) - 1)]


def layout(m):
    """[(name, shape)] of the NeuS parameters of model config ``m``."""
    out = []
    for prefix, io in (("sdf", _sdf_out_dims(m)),
                       ("color", list(zip(color_dims(m)[:-1],
                                          color_dims(m)[1:])))):
        for l, (d_in, d_out) in enumerate(io):
            out += [(f"{prefix}.{l}.v", (d_in, d_out)),
                    (f"{prefix}.{l}.g", (d_out,)),
                    (f"{prefix}.{l}.b", (d_out,))]
    return out + [("variance.variance", ())]


def make_weights(m, seed, device):
    """The benchmark's weights from ``seed``, on the device: the SDF's
    geometric init (a sphere of radius ``bias``; normal draws, the encoded
    inputs beyond xyz zeroed in the first and the skip layer), the colour
    net uniform in +-1/sqrt(d_in), every g the norm of its v (so that each
    layer starts as its plain dense), and the variance at its init."""
    s = m["sdf"]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    dims = sdf_dims(m)
    io = _sdf_out_dims(m)
    out = {}
    n_lin = len(io)
    for l, (d_in, d_out) in enumerate(io):
        z = torch.randn((d_in, d_out), generator=gen, device=device)
        if l == n_lin - 1:
            w = math.sqrt(math.pi) / math.sqrt(d_in) + 1e-4 * z
            b = torch.full((d_out,), -s["bias"], device=device)
        else:
            w = z * (math.sqrt(2) / math.sqrt(d_out))
            if l == 0:
                w[3:] = 0.0
            elif l in s["skip_in"]:
                w[-(dims[0] - 3):] = 0.0
            b = torch.zeros((d_out,), device=device)
        out[f"sdf.{l}.v"], out[f"sdf.{l}.b"] = w, b
        out[f"sdf.{l}.g"] = torch.linalg.vector_norm(w, dim=0)
    cd = color_dims(m)
    for l in range(len(cd) - 1):
        lim = 1.0 / math.sqrt(cd[l])
        v = (torch.rand((cd[l], cd[l + 1]), generator=gen, device=device)
             * 2 - 1) * lim
        out[f"color.{l}.v"] = v
        out[f"color.{l}.b"] = (torch.rand((cd[l + 1],), generator=gen,
                                          device=device) * 2 - 1) * lim
        out[f"color.{l}.g"] = torch.linalg.vector_norm(v, dim=0)
    out["variance.variance"] = torch.tensor(float(m["variance_init"]),
                                            device=device)
    return out


def _wn(p, prefix, l):
    v, g = p[f"{prefix}.{l}.v"], p[f"{prefix}.{l}.g"]
    return g[None, :] * v / torch.clamp(torch.linalg.vector_norm(
        v, dim=0, keepdim=True), min=1e-12), p[f"{prefix}.{l}.b"]


def sdf_net(p, x, m, pr):
    """[N, 257]: the SDF (channel 0) and the feature."""
    s = m["sdf"]
    inputs = posenc(x * s["scale"], s["multires"])
    h = inputs
    n_lin = len(sdf_dims(m)) - 1
    for l in range(n_lin):
        if l in s["skip_in"]:
            h = torch.cat([h, inputs], dim=-1) / math.sqrt(2.0)
        w, b = _wn(p, "sdf", l)
        h = pr.out(pr.r(h) @ pr.r(w)) + b
        if l < n_lin - 1:
            h = F.softplus(h, beta=100.0)
    return torch.cat([h[:, :1] / s["scale"], h[:, 1:]], dim=-1)


def color_net(p, pts, normals, dirs, feature, m, pr):
    c = m["color"]
    h = torch.cat([pts, posenc(dirs, c["multires_view"]), normals, feature],
                  dim=-1)
    n_lin = len(color_dims(m)) - 1
    for l in range(n_lin):
        w, b = _wn(p, "color", l)
        h = pr.out(pr.r(h) @ pr.r(w)) + b
        if l < n_lin - 1:
            h = torch.relu(h)
    return torch.sigmoid(h)


def inv_s(p):
    return torch.clamp(torch.exp(p["variance.variance"] * 10.0), 1e-6, 1e6)


# ------------------------------------------------------------ sampling

def sample_pdf(bins, weights, n, u=None, eps_w=1e-5):
    """Inverse-CDF samples of the piecewise-constant PDF ``weights`` over
    ``bins`` [R, B]; ``u`` None gives the midpoints of [0, 1]."""
    r, b = bins.shape
    w = weights + eps_w
    cdf = torch.cumsum(w / torch.sum(w, -1, keepdim=True), -1)
    cdf = torch.cat([cdf.new_zeros((r, 1)), cdf], -1)
    if u is None:
        u = torch.linspace(0.5 / n, 1 - 0.5 / n, n, device=bins.device
                           ).expand(r, n)
    u = u.contiguous()
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    lo, hi = torch.clamp(idx - 1, min=0), torch.clamp(idx, max=b - 1)
    c0, c1 = torch.gather(cdf, 1, lo), torch.gather(cdf, 1, hi)
    b0, b1 = torch.gather(bins, 1, lo), torch.gather(bins, 1, hi)
    den = torch.where(c1 - c0 < 1e-5, torch.ones_like(c0), c1 - c0)
    return b0 + (u - c0) / den * (b1 - b0)


@torch.no_grad()
def occupancy_grid(p, m, radius, res, margin_factor):
    """[res]^3 cells over the [-radius, radius] cube: 1 where |SDF| at the
    centre is under margin_factor half cell diagonals."""
    c = (torch.arange(res, dtype=torch.float32, device=p["sdf.0.v"].device)
         + 0.5) / res * 2 - 1
    x, y, z = torch.meshgrid(c, c, c, indexing="ij")
    pts = torch.stack([x, y, z], -1).reshape(-1, 3) * radius
    margin = margin_factor * (2.0 * radius / res * math.sqrt(3.0)) / 2.0
    sdf = torch.cat([sdf_net(p, q, m, Prec())[:, 0]
                     for q in torch.split(pts, 1 << 18)])
    return (torch.abs(sdf) < margin).float().reshape(res, res, res)


def occ_samples(o, d, near, far, grid, radius, n, u, floor, n_bins=64):
    """First samples from the PDF occupancy + floor over n_bins bins."""
    res = grid.shape[0]
    t = (torch.arange(n_bins, dtype=torch.float32, device=o.device) + 0.5) \
        / n_bins
    z = near + (far - near) * t[None]
    pts = o[:, None] + d[:, None] * z[..., None]
    f = (pts / radius + 1.0) * 0.5 * res
    idx = torch.clamp(torch.floor(f).long(), 0, res - 1)
    occ = grid[idx[..., 0], idx[..., 1], idx[..., 2]] * torch.all(
        (f >= 0) & (f < res), -1).float()
    w = occ * (1.0 - floor) + floor
    edges = near + (far - near) * (torch.arange(
        n_bins + 1, dtype=torch.float32, device=o.device) / n_bins)[None]
    zs = sample_pdf(edges.expand(o.shape[0], n_bins + 1), w, n, u=u,
                    eps_w=0.0)
    return torch.sort(zs, -1).values


def exclusive_trans(alpha):
    return torch.cumprod(torch.cat([alpha.new_ones((alpha.shape[0], 1)),
                                    1.0 - alpha + 1e-7], -1), -1)[:, :-1]


@torch.no_grad()
def up_sample(p, m, o, d, z, radius, pr):
    """The hierarchical rounds: the SDF at z, then up_sample_steps rounds of
    n_importance / up_sample_steps new samples each (inv_s 64 * 2^i)."""
    r = o.shape[0]

    def sdf_at(zz):
        pts = o[:, None] + d[:, None] * zz[..., None]
        return sdf_net(p, pts.reshape(-1, 3), m, pr)[:, 0].reshape(zz.shape)

    sdf = sdf_at(z)
    steps = m["up_sample_steps"]
    for i in range(steps):
        pts = o[:, None] + d[:, None] * z[..., None]
        rad = torch.linalg.vector_norm(pts, dim=-1)
        inside = ((rad[:, :-1] < radius) | (rad[:, 1:] < radius)).float()
        mid = (sdf[:, :-1] + sdf[:, 1:]) * 0.5
        cos = (sdf[:, 1:] - sdf[:, :-1]) / (z[:, 1:] - z[:, :-1] + 1e-5)
        cos = torch.minimum(torch.cat([cos.new_zeros((r, 1)), cos[:, :-1]],
                                      -1), cos)
        cos = torch.clamp(cos, -1e3, 0.0) * inside
        dist = z[:, 1:] - z[:, :-1]
        s = 64.0 * 2 ** i
        prev = torch.sigmoid((mid - cos * dist * 0.5) * s)
        nxt = torch.sigmoid((mid + cos * dist * 0.5) * s)
        alpha = (prev - nxt + 1e-5) / (prev + 1e-5)
        new = sample_pdf(z, alpha * exclusive_trans(alpha),
                         m["n_importance"] // steps)
        z_all = torch.cat([z, new], -1)
        z, order = torch.sort(z_all, dim=-1, stable=True)
        if i + 1 < steps:
            sdf = torch.gather(torch.cat([sdf, sdf_at(new)], -1), 1, order)
    return z


def render(p, m, o, d, near, far, radius, grid, u, anneal, floor, pr):
    """Colour, weight sum and the Eikonal mean of a batch of rays."""
    r = o.shape[0]
    z = occ_samples(o, d, near, far, grid, radius, m["n_samples"], u, floor)
    if m["n_importance"] > 0:
        z = up_sample(p, m, o, d, z, radius, pr)
    n = z.shape[1]
    dists = torch.cat([z[:, 1:] - z[:, :-1],
                       torch.full_like(z[:, :1], 2.0 * radius
                                       / m["n_samples"])], -1)
    mid = z + dists * 0.5
    pts = o[:, None] + d[:, None] * mid[..., None]
    flat = pts.reshape(-1, 3)
    dirs = d[:, None].expand(pts.shape).reshape(-1, 3)
    x = flat.detach().requires_grad_(True)
    out = sdf_net(p, x, m, pr)
    grad, = torch.autograd.grad(out[:, 0].sum(), x, create_graph=True)
    sdf, feature = out[:, :1], out[:, 1:]
    color = color_net(p, x, grad, dirs, feature, m, pr).reshape(r, n, 3)
    s = inv_s(p)
    true_cos = torch.sum(dirs * grad, -1, keepdim=True)
    it_cos = -(torch.relu(-true_cos * 0.5 + 0.5) * (1.0 - anneal)
               + torch.relu(-true_cos) * anneal)
    dd = dists.reshape(-1, 1)
    prev = torch.sigmoid((sdf - it_cos * dd * 0.5) * s)
    nxt = torch.sigmoid((sdf + it_cos * dd * 0.5) * s)
    alpha = torch.clamp(((prev - nxt + 1e-5) / (prev + 1e-5)).reshape(r, n),
                        0.0, 1.0)
    weights = alpha * exclusive_trans(alpha)
    wsum = weights.sum(-1, keepdim=True)
    rgb = (color * weights[..., None]).sum(1) + (1.0 - wsum)
    rad = torch.linalg.vector_norm(pts, dim=-1).detach()
    relax = (rad < radius * 1.1).float()
    err = (torch.linalg.vector_norm(grad.reshape(r, n, 3), dim=-1) - 1) ** 2
    eik = (relax * err).sum() / (relax.sum() + 1e-5)
    return rgb, wsum, eik


def lr_factor(step, t):
    if step < t["warm_up_end"]:
        return step / t["warm_up_end"]
    end = t["lr_end_iter"] if t["lr_end_iter"] > 0 else t["end_iter"]
    prog = (step - t["warm_up_end"]) / (end - t["warm_up_end"])
    a = t["learning_rate_alpha"]
    return (math.cos(math.pi * prog) + 1.0) * 0.5 * (1 - a) + a


def step_loss(p, m, t, b, radius, grid, u, pr):
    rgb, wsum, eik = render(p, m, b["rays_o"], b["rays_d"], b["near"],
                            b["far"], radius, grid, u, 1.0, t["occ_floor"],
                            pr)
    mask = (b["mask"] > 0.5).float() * b["valid"]
    msum = mask.sum() + 1e-5
    color_loss = torch.abs((rgb - b["rgb"]) * mask).sum() / msum
    w = torch.clamp(wsum, 1e-3, 1.0 - 1e-3)
    bce = -(b["mask"] * torch.log(w) + (1 - b["mask"]) * torch.log(1 - w))
    mask_loss = (bce * b["valid"]).sum() / torch.clamp(b["valid"].sum(),
                                                       min=1.0)
    return color_loss + eik * t["igr_weight"] + mask_loss * t["mask_weight"]


def train_steps(weights, m, t, steps, radius, lowp=False, keep_rows=None):
    """Steps of NeuS training from ``weights``; ``steps``: a list of
    (model config, batch, step index, uniforms [R, n_samples]) the program
    took, in order. The occupancy grid is built from the weights at the
    start, at res ``t["occ_res"]``. ``keep_rows`` trains on the first rows
    of every batch only (a fault the benchmark's test plants). Returns
    {"loss", "grad1", "params"} as ``decomp.train_steps`` does."""
    set_exact()
    pr = Prec(lowp)
    p = {k: v.detach().clone() for k, v in weights.items()}
    grid = occupancy_grid(p, m, radius, t["occ_res"], t["occ_margin"])
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "grad1": None}
    count = 0
    for mc, b, step, u in steps:
        if keep_rows is not None:
            b = {k: v[:keep_rows] for k, v in b.items()}
            u = u[:keep_rows]
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = step_loss(leaves, mc, t, b, radius, grid, u, pr)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()), allow_unused=True)))
        grads = {k: torch.zeros_like(p[k]) if g is None else g
                 for k, g in grads.items()}
        out["loss"].append(float(loss.detach()))
        if out["grad1"] is None:
            out["grad1"] = {k: g.detach() for k, g in grads.items()}
        ok = bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values())
        if ok:
            count += 1
            lr = float(np.float32(t["learning_rate"] * lr_factor(step, t)))
            with torch.no_grad():
                for k, g in grads.items():
                    mu[k] = (1 - B1) * g + B1 * mu[k]
                    nu[k] = (1 - B2) * g * g + B2 * nu[k]
                    mh = mu[k] / (1 - B1 ** count)
                    nh = nu[k] / (1 - B2 ** count)
                    p[k] = p[k] - lr * (mh / (torch.sqrt(nh) + EPS))
        del leaves, grads, loss
    out["params"] = p
    return out
