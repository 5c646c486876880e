"""Ray sampling steered by an occupancy grid (counterpart of
vqnerf_release_tpu/ops/occupancy.py).

A coarse grid over the [-radius, radius]^3 cube marks the cells whose
centre |SDF| lies under a margin: with an Eikonal-trained (~unit-gradient)
SDF the surface cannot cross a cell whose centre |SDF| exceeds half the
cell diagonal, and ``margin_factor`` adds slack. The geometry extractor
uses the grid to tighten shadow rays to their occupied span and to draw
their first samples where the surface can be. The sweeps evaluate the SDF
in slabs, so the peak memory is a slab's activations.
"""

import numpy as np
import torch

from .sampling import sample_pdf

__all__ = ["build_occ_grid", "interior_fraction", "ray_bin_occupancy",
           "ray_occupied_span", "sample_z_occ"]

_SLAB_POINTS = 1 << 18  # points of one SDF evaluation of a grid sweep


@torch.no_grad()
def _grid_sdf(sdf_params, sdf_cfg, radius, res, margin_factor):
    from ..models import fields

    device = next(iter(sdf_params.parameters())).device
    centers_1d = (np.arange(res, dtype=np.float32) + 0.5) / res * 2 - 1
    x, y, z = np.meshgrid(centers_1d, centers_1d, centers_1d, indexing="ij")
    pts = torch.as_tensor(
        np.stack([x, y, z], axis=-1).reshape(-1, 3) * radius,
        dtype=torch.float32, device=device)
    cell_diag = 2.0 * radius / res * np.sqrt(3.0)
    margin = margin_factor * cell_diag / 2.0
    sdf = torch.cat([fields.sdf_only(sdf_params, p, sdf_cfg)
                     for p in torch.split(pts, _SLAB_POINTS)])
    return sdf, margin


def build_occ_grid(sdf_params, sdf_cfg, radius, res=64, margin_factor=3.0):
    """Occupancy over the [-radius, radius]^3 cube: [res, res, res]
    float32 in {0, 1}, cell occupied iff |SDF(center)| < margin."""
    sdf, margin = _grid_sdf(sdf_params, sdf_cfg, radius, res, margin_factor)
    return (torch.abs(sdf) < margin).to(torch.float32).reshape(res, res, res)


def interior_fraction(sdf_params, sdf_cfg, radius, res=128,
                      margin_factor=3.0):
    """Deep-interior share of the occupied volume: interior / (band +
    interior) over the grid and margin of build_occ_grid, where band =
    |SDF| < margin and interior = SDF <= -margin."""
    sdf, margin = _grid_sdf(sdf_params, sdf_cfg, radius, res, margin_factor)
    band = torch.sum(torch.abs(sdf) < margin)
    interior = torch.sum(sdf <= -margin)
    return interior / torch.clamp(band + interior, min=1)


def ray_bin_occupancy(rays_o, rays_d, near, far, grid, radius, n_bins,
                      samples_per_bin=1):
    """Occupancy of n_bins uniform bins of [near, far] per ray: [R, B].

    Each bin reads the MAX over ``samples_per_bin`` equispaced points
    inside it (default 1 = the midpoint). Points outside the cube read 0."""
    res = grid.shape[0]
    s = samples_per_bin
    t = (torch.arange(n_bins * s, dtype=torch.float32, device=rays_o.device)
         + 0.5) / (n_bins * s)
    z = near + (far - near) * t[None, :]  # [R, B*S]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    idx_f = (pts / radius + 1.0) * 0.5 * res
    idx = torch.clamp(torch.floor(idx_f).to(torch.int64), 0, res - 1)
    vals = grid[idx[..., 0], idx[..., 1], idx[..., 2]]  # [R, B*S]
    inside = torch.all((idx_f >= 0) & (idx_f < res), dim=-1)
    vals = vals * inside.to(vals.dtype)
    if s == 1:
        return vals
    return torch.amax(vals.reshape(vals.shape[0], n_bins, s), dim=-1)


def ray_occupied_span(rays_o, rays_d, near, far, grid, radius,
                      n_bins=32, pad_bins=1, samples_per_bin=4):
    """Tighten each ray's [near, far] to the span of grid-occupied bins,
    padded by pad_bins on each side.

    Returns (near', far', any_occupied [R, 1]); rays with no occupied bin
    keep their input span and carry any = 0 (the caller zeroes their
    occlusion: they are provably free)."""
    occ = ray_bin_occupancy(rays_o, rays_d, near, far, grid, radius,
                            n_bins, samples_per_bin=samples_per_bin)
    idx = torch.arange(n_bins, dtype=torch.float32, device=occ.device)
    first = torch.amin(torch.where(occ > 0, idx, float(n_bins)), dim=-1,
                       keepdim=True)  # [R, 1]
    last = torch.amax(torch.where(occ > 0, idx, -1.0), dim=-1, keepdim=True)
    any_occ = (last >= 0).to(torch.float32)
    lo = torch.clamp(first - pad_bins, 0.0, n_bins) / n_bins
    hi = torch.clamp(last + 1 + pad_bins, 0.0, n_bins) / n_bins
    span = far - near
    near2 = torch.where(any_occ > 0, near + lo * span, near)
    far2 = torch.where(any_occ > 0, near + hi * span, far)
    return near2, far2, any_occ


def sample_z_occ(rays_o, rays_d, near, far, grid, radius, n_samples,
                 u=None, floor=0.05, n_bins=64):
    """n_samples sorted z-values per ray from the piecewise-constant PDF
    proportional to occupancy + floor over n_bins uniform bins. u=None ->
    deterministic CDF midpoints; else uniform draws [R, n_samples]."""
    occ = ray_bin_occupancy(rays_o, rays_d, near, far, grid, radius, n_bins)
    # all-empty rays degrade to uniform via the floor
    w = occ * (1.0 - floor) + floor
    edges_t = torch.arange(n_bins + 1, dtype=torch.float32,
                           device=occ.device) / n_bins
    edges = near + (far - near) * edges_t[None, :]  # [R, B+1]
    edges = edges.expand(rays_o.shape[0], n_bins + 1)
    z = sample_pdf(edges, w, n_samples, u=u, eps_w=0.0)
    if u is not None:
        z = torch.sort(z, dim=-1).values  # random u is unordered
    return z.detach()
