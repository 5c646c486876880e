"""Geometry-buffer extraction: render every view's surface buffers and the
512-direction light-visibility map from a NeuS model (counterpart of
vqnerf_release_tpu/pipelines/gen_geo.py).

  * per view writes rgb.png, xyz.npy/png, normal.npy/png, alpha.png
    (+ lvis.npy/png for CG scenes) into
    surf/<family>_surf/<scene>/{train,val}_NNN/, lvis last;
  * alpha = weight_sum > thres (0.5 train / configurable val), normals =
    sum(weights * gradients * inside_sphere) normalised, turned to face the
    camera, and blended onto a normalised-ones background;
  * visibility: per foreground pixel a shadow ray is marched from the
    surface point toward each of the 16x32 light directions; lvis =
    front_lit * (1 - weight_sum); far from the bounding-sphere
    intersection, near = min(0.1, far / 2);
  * resumable: views whose files all exist are skipped; ``num_p`` / ``p_i``
    shard the views over processes;
  * ``mesh`` (a list of devices, as ``parallel.get_mesh`` gives): every ray
    batch of the geometry render, the certification sweeps and the shadow
    pass is split in contiguous row blocks over the devices, each with its
    own copy of the params, and the outputs come back to the first device
    in ray order (the JAX extractor shards its render batches over a
    device mesh). Every ray is independent, so only the blocks' sizes
    differ from the unsplit path.

**On the GPU.** The shadow rays go through ``models.neus.neus_occlusion``,
whose SDF evaluations are the two fused CUDA kernels of ``kernels/sdf.py``
whenever the extractor's device is a GPU (``use_fused_sdf=None``); the
certification sweeps of fast-vis evaluate the SDF through the forward kernel
too, and so does the up-sample chain of the geometry render (its final
pass needs the feature vector and stays on autograd, as in the JAX package).
The SDF is packed for the kernels once per extractor.

**Against the JAX extractor.** Its bit-packed certificate masks, its
bounded window of in-flight dispatches and its padding of every last batch
to a fixed shape exist for a slow host link and for jit's static shapes;
they are not ported. Here the masks stay on the device (``torch.nonzero``
picks the uncertain rays) and ragged batches run as they are. Every ray is
independent in ``neus_occlusion``, so the values do not depend on the
chunking. PNGs are written with the port's own encoder.
"""

import copy
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from .. import config as vcfg
from ..data import io as vio
from ..kernels import sdf as sdf_kernel
from ..models import fields
from ..models.neus import (NeuSConfig, fused_sdf_enabled, init_neus,
                           neus_occlusion, neus_render)
from ..ops.light import gen_light_xyz
from ..parallel.mesh import row_blocks
from ..utils import ckpt as ckpt_util
from ..utils.device import resolve_device

__all__ = ["GeoExtractor", "intersect_sphere_far", "check_finished",
           "run_gen_geo", "VIEW_FILES_CG", "VIEW_FILES_REAL"]

VIEW_FILES_CG = ["lvis.npy", "lvis.png", "alpha.png", "normal.npy",
                 "normal.png", "rgb.png", "xyz.npy", "xyz.png"]
VIEW_FILES_REAL = ["alpha.png", "normal.npy", "normal.png", "rgb.png",
                   "xyz.npy", "xyz.png"]


class _Replica:
    """What one device of an extractor's mesh holds."""

    def __init__(self, device, params, packed, vis_grid, bg):
        self.device, self.params, self.packed = device, params, packed
        self.vis_grid, self.bg = vis_grid, bg


def intersect_sphere_far(x, d, r, eps=1e-7):
    """Far intersection distance [R, 1] of rays (x, d) with the radius-r
    sphere."""
    b = 2.0 * torch.sum(x * d, dim=-1)
    a = torch.sum(d * d, dim=-1)
    c = torch.sum(x * x, dim=-1) - r**2
    denom = torch.clamp(2 * a, min=eps)
    disc = torch.sqrt(torch.clamp(torch.square(b) - 4.0 * a * c, min=0.0))
    t1 = (-b + disc) / denom
    t2 = (-b - disc) / denom
    return torch.maximum(t1, t2)[:, None]


def check_finished(view_dir, with_lvis=True):
    files = VIEW_FILES_CG if with_lvis else VIEW_FILES_REAL
    return all(os.path.exists(os.path.join(view_dir, f)) for f in files)


class GeoExtractor:
    def __init__(self, params, cfg: NeuSConfig, dataset, scene_out_dir,
                 use_white_bkgd=True, batch_size=4096, light_h=16,
                 vis_point_batch=64, alpha_thres_val=0.5,
                 light_tile=None, use_fused_sdf=None,
                 fast_vis=False, fast_vis_factor=2.0, n_coarse=16,
                 fast_vis_occluded=False, fast_vis_refine=64,
                 vis_sampler=None, occ_vis=False,
                 occ_vis_res=64, occ_vis_margin=2.0,
                 span_vis=False, span_bins=32, span_pad=1, device="cuda",
                 mesh=None):
        # a mesh of one device is no mesh; its first device is the device
        self.mesh = list(mesh) if mesh is not None and len(mesh) > 1 \
            else None
        self.device = resolve_device(self.mesh[0] if self.mesh else device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.dataset = dataset
        self.out_dir = scene_out_dir
        self.use_white_bkgd = use_white_bkgd
        self.batch_size = batch_size
        self.vis_point_batch = vis_point_batch
        self.alpha_thres_val = alpha_thres_val
        self.fast_vis = fast_vis
        # the coarse sweep certifies a ray free when its smallest sampled
        # SDF is at least factor * spacing / 2: with a ~unit-gradient SDF a
        # zero crossing between samples of spacing D needs a sampled value
        # below D / 2
        self.fast_vis_factor = fast_vis_factor
        self.n_coarse = n_coarse
        # opt-in second certificate: two consecutive samples <= -c,
        # c = max(margin, 10 / s), mean a provably interior chord: lvis = 0
        # without the fine render
        self.fast_vis_occluded = fast_vis_occluded
        # rays the coarse sweep leaves uncertain get a finer sweep of this
        # many samples before the full occlusion render; 0 = off
        self.fast_vis_refine = fast_vis_refine
        # occlusion-render sampler of the shadow pass: the geometry render's
        # own config unless a reduced one such as "32+16r2" is asked for
        if vis_sampler:
            vis_cfg = replace(cfg, **vcfg.parse_sampler_spec(
                vis_sampler, what="vis_sampler"))
        else:
            vis_cfg = cfg
        self.vis_cfg = vis_cfg
        self.radius = float(dataset.max_radius)
        # occ_vis: the shadow rays' first samples draw from the SDF-occupancy
        # PDF. span_vis: each shadow ray's [near, far] is tightened to its
        # grid-occupied span, and rays crossing no occupied cell are free.
        self.occ_vis = occ_vis
        self.span_vis = span_vis
        self.span_bins, self.span_pad = span_bins, span_pad
        self._occ_vis_res, self._occ_vis_margin = occ_vis_res, occ_vis_margin
        lxyz, _ = gen_light_xyz(light_h, 2 * light_h)
        self.lxyz = torch.as_tensor(lxyz.reshape(-1, 3), dtype=torch.float32,
                                    device=self.device)
        self.n_lights = self.lxyz.shape[0]
        # tile the light axis so that one occlusion render is a bounded batch
        if light_tile is None:
            light_tile = min(self.n_lights, max(
                1, 8192 // max(vis_point_batch, 1)))
        while self.n_lights % light_tile:
            light_tile -= 1
        self.light_tile = light_tile
        self.use_fused_sdf = fused_sdf_enabled(use_fused_sdf, self.lxyz)
        # one replica a device of the mesh: the params, the SDF packed for
        # the kernels once (every SDF evaluation of the shadow pass reuses
        # it), the vis grid and the background; the first is this device's
        self._replicas = [self._replica(self.params, self.device)]
        for dev in (self.mesh or [])[1:]:
            dev = resolve_device(dev)
            self._replicas.append(self._replica(
                copy.deepcopy(self.params).to(dev), dev))
        self._packed = self._replicas[0].packed
        self._writer = None
        self._pending_writes = []
        self.last_fast_vis_stats = None
        # last_fast_vis_stats of every view compute_vis extracted, in order
        self.fast_vis_stats = []
        # host-clock seconds by phase, summed over this extractor's views.
        # Each phase ends where the host waits for the device anyway (a
        # copy to the host, a nonzero, a count), so reading the clock there
        # adds no synchronisation.
        self.phase_seconds = {"geometry": 0.0, "coarse": 0.0, "refine": 0.0,
                              "occlusion": 0.0}

    # -- device pieces ------------------------------------------------------
    def _replica(self, params, device):
        packed = (sdf_kernel.pack_sdf(params.sdf, self.cfg.sdf)
                  if self.use_fused_sdf else None)
        vis_grid = None
        if self.occ_vis or self.span_vis:
            from ..ops.occupancy import build_occ_grid
            vis_grid = build_occ_grid(
                params.sdf, self.cfg.sdf, radius=self.radius,
                res=self._occ_vis_res, margin_factor=self._occ_vis_margin)
        bg = (torch.ones((1, 3), device=device) if self.use_white_bkgd
              else None)
        return _Replica(device, params, packed, vis_grid, bg)

    def _on_mesh(self, fn, *xs):
        """``fn(replica, *blocks)`` over contiguous row blocks of the
        tensors ``xs``, one block a device of the mesh, with the outputs (a
        tensor or a dict of tensors) gathered on the first device in row
        order; without a mesh ``fn(the replica, *xs)``."""
        n = xs[0].shape[0]
        if len(self._replicas) == 1 or n == 0:
            return fn(self._replicas[0], *xs)
        outs = [fn(r, *(x[a:b].to(r.device) for x in xs))
                for r, (a, b) in zip(self._replicas,
                                     row_blocks(n, len(self._replicas)))
                if b > a]
        if isinstance(outs[0], dict):
            return {k: torch.cat([o[k].to(self.device) for o in outs])
                    for k in outs[0]}
        return torch.cat([o.to(self.device) for o in outs])

    def _to_device(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    def _render(self, rays_o, rays_d, near, far):
        return self._on_mesh(self._render_on, rays_o, rays_d, near, far)

    @torch.no_grad()
    def _render_on(self, r, rays_o, rays_d, near, far):
        cfg = self.cfg
        out = neus_render(
            r.params, cfg, rays_o, rays_d, near, far, self.radius,
            cos_anneal_ratio=1.0, background_rgb=r.bg,
            use_fused_sdf=self.use_fused_sdf, packed=r.packed)
        n_core = cfg.n_samples + cfg.n_importance
        normals = (out["gradients"]
                   * out["weights"][:, :n_core, None]
                   * out["inside_sphere"][..., None])
        return {
            "color": out["color_fine"],
            "weight_sum": out["weight_sum"],
            "surf": out["surf"],
            "normal": torch.sum(normals, dim=1),
        }

    def _sdf_only(self, pts):
        """SDF of flat points for the certification sweeps."""
        return self._on_mesh(self._sdf_on, pts)

    def _sdf_on(self, r, pts):
        if self.use_fused_sdf:
            return sdf_kernel.sdf_fwd(r.packed, pts.contiguous())
        return fields.sdf_only(r.params.sdf, pts, self.cfg.sdf)

    def _near_far(self, o, d):
        far = intersect_sphere_far(o, d, self.radius)
        near = torch.minimum(torch.full_like(far, 0.1), far / 2.0)
        return near, far

    def _span(self, o, d, near, far, vis_grid):
        from ..ops.occupancy import ray_occupied_span
        return ray_occupied_span(
            o, d, near, far, vis_grid, self.radius,
            n_bins=self.span_bins, pad_bins=self.span_pad)

    def _occ_chunk(self, o, d):
        """Flat [K] shadow rays -> occlusion [K, 1]."""
        return self._on_mesh(self._occ_on, o, d)

    @torch.no_grad()
    def _occ_on(self, r, o, d):
        near, far = self._near_far(o, d)
        any_occ = None
        if self.span_vis:
            near, far, any_occ = self._span(o, d, near, far, r.vis_grid)
        occ = neus_occlusion(
            r.params, self.vis_cfg, o, d, near, far, self.radius,
            cos_anneal_ratio=1.0, use_fused_sdf=self.use_fused_sdf,
            packed=r.packed,
            occ_grid=r.vis_grid if self.occ_vis else None)
        if any_occ is not None:
            occ = occ * any_occ.reshape(occ.shape)
        return occ

    def _surf2l(self, surf, normal):
        """(unit surface-to-light directions [B, L, 3], front-lit mask [B,
        L] bool)."""
        surf2l = self.lxyz[None, :, :] - surf[:, None, :]
        surf2l = surf2l / torch.linalg.norm(surf2l, dim=-1, keepdim=True)
        lcos = torch.einsum("blk,bk->bl", surf2l, normal)
        return surf2l, lcos > 0

    @torch.no_grad()
    def _vis_batch(self, surf, normal):
        """[B] surface points x all L lights -> [B, L] visibility, one
        occlusion render per tile of lights."""
        b = surf.shape[0]
        surf2l, front_lit = self._surf2l(surf, normal)
        tile = self.light_tile
        o_rep = torch.repeat_interleave(surf, tile, dim=0)  # [B*tile, 3]
        occu = []
        for t in range(0, self.n_lights, tile):
            d_chunk = surf2l[:, t:t + tile].reshape(b * tile, 3)
            occu.append(self._occ_chunk(o_rep, d_chunk).reshape(b, tile))
        return front_lit.to(torch.float32) * (1.0 - torch.cat(occu, dim=1))

    def _certificates(self, o, d, n_sweep, near_far=None):
        """An n_sweep-sample SDF sweep of flat shadow rays: (below-margin
        [K] bool, deep-chord [K] bool). ``below`` false certifies the ray
        free: its smallest sampled SDF is at least factor * spacing / 2.
        ``deep``: two consecutive samples <= -max(margin, 10 / s), an
        interior chord whose transmittance the full render would put below
        5e-5."""
        near, far = near_far if near_far is not None else self._near_far(o, d)
        z = near + (far - near) * torch.linspace(
            0.0, 1.0, n_sweep, device=o.device)[None, :]
        pts = o[:, None, :] + d[:, None, :] * z[..., None]
        sdf = self._sdf_only(pts.reshape(-1, 3)).reshape(o.shape[0], n_sweep)
        spac = (far - near)[:, 0] / (n_sweep - 1)
        margin = 0.5 * self.fast_vis_factor * spac
        below_margin = torch.amin(sdf, dim=1) < margin
        inv_s = fields.inv_s_from(self.params.variance)
        c = torch.maximum(margin, 10.0 / inv_s)[:, None]
        below = sdf <= -c
        deep = torch.any(below[:, :-1] & below[:, 1:], dim=1)
        return below_margin, deep

    @torch.no_grad()
    def _coarse_batch(self, surf, normal):
        """[B] points x all L lights -> (front_lit, uncertain,
        occluded_certified), each [B, L] bool on the device."""
        b = surf.shape[0]
        surf2l, front_lit = self._surf2l(surf, normal)
        o = torch.repeat_interleave(surf, self.n_lights, dim=0)
        lt, dp = self._certificates(o, surf2l.reshape(-1, 3), self.n_coarse)
        lt, dp = lt.reshape(b, -1), dp.reshape(b, -1)
        if self.fast_vis_occluded:
            occluded = front_lit & dp
        else:
            occluded = torch.zeros_like(front_lit)
        uncertain = front_lit & lt & ~occluded
        return front_lit, uncertain, occluded

    @torch.no_grad()
    def _refine_chunk(self, o, d):
        """Flat [K] uncertain shadow rays -> (free [K], deep [K]) bool from
        a fast_vis_refine-sample sweep: the coarse sweep's margin rule at a
        finer spacing."""
        near, far = self._near_far(o, d)
        if self.span_vis:
            near, far, _ = self._span(o, d, near, far,
                                      self._replicas[0].vis_grid)
        below_margin, deep = self._certificates(
            o, d, self.fast_vis_refine, near_far=(near, far))
        return ~below_margin, deep

    def _rays_of(self, surf_fg, idx):
        """Origins and unit directions of the flat shadow rays ``idx`` (ray
        = point * L + light)."""
        o = surf_fg[idx // self.n_lights]
        d = self.lxyz[idx % self.n_lights] - o
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                            min=1e-12)
        return o, d

    # -- geometry ----------------------------------------------------------
    def _render_dispatch(self, rays_o, rays_d):
        """Enqueue every render batch of a view; returns the device outputs
        without waiting for them, so that the host work of the previous view
        overlaps."""
        outs = []
        for i in range(0, rays_o.shape[0], self.batch_size):
            ro = rays_o[i:i + self.batch_size]
            rd = rays_d[i:i + self.batch_size]
            near, far = self.dataset.near_far(ro, rd)
            outs.append(self._render(
                *(self._to_device(x) for x in (ro, rd, near, far))))
        return outs

    @staticmethod
    def _render_pull(device_outs):
        return {k: torch.cat([o[k] for o in device_outs], dim=0).cpu().numpy()
                for k in ("color", "weight_sum", "surf", "normal")}

    def _render_full(self, rays_o, rays_d):
        return self._render_pull(self._render_dispatch(rays_o, rays_d))

    def _submit_write(self, job):
        """Run the host encode/IO job on the background writer thread when
        extract_views has one open (the device renders the next view
        meanwhile), synchronously otherwise."""
        if self._writer is None:
            job()
        else:
            self._pending_writes.append(self._writer.submit(job))

    def compute_geo(self, idx, view_dir, alpha_thres=0.5, _rendered=None):
        """Render and write the per-view geometry buffers; returns (surf
        [h, w, 3], normal [h, w, 3], mask [h, w, 1])."""
        t0 = time.perf_counter()
        rays_o, rays_d = self.dataset.gen_rays_at(idx)
        h, w = rays_o.shape[:2]
        if _rendered is None:
            _rendered = self._render_dispatch(
                rays_o.reshape(-1, 3), rays_d.reshape(-1, 3))
        out = self._render_pull(_rendered)

        img_rgb = (out["color"].reshape(h, w, 3) * 256).clip(0, 255)
        mask = np.where(out["weight_sum"] > alpha_thres, 1.0, 0.0)
        img_mask = (mask.reshape(h, w, 1) * 256).clip(0, 255)
        surf = out["surf"].reshape(h, w, 3)

        normal = out["normal"]
        # zero-norm guard: fill with 1/sqrt(3) instead of NaN on empty rays
        r = np.sqrt(np.sum(normal**2, axis=-1, keepdims=True))
        normal = np.where(r == 0, np.sqrt(1.0 / 3.0), normal / np.maximum(
            r, 1e-12))
        # camera-facing correction
        surf2c = rays_o.reshape(-1, 3) - out["surf"]
        surf2c = surf2c / np.maximum(
            np.linalg.norm(surf2c, axis=-1, keepdims=True), 1e-12)
        cos = np.sum(surf2c * normal, axis=-1, keepdims=True)
        normal = np.where(cos >= 0, normal, -normal).reshape(h, w, 3)
        # blend onto the normalised-ones background
        ones = np.ones_like(normal) / math.sqrt(3.0)
        m = img_mask / 255.0
        rot_normal = normal * m + ones * (1.0 - m)
        normal_img = (rot_normal * 128 + 128).clip(0, 255)

        os.makedirs(view_dir, exist_ok=True)

        def _write():
            vio.write_png(os.path.join(view_dir, "rgb.png"),
                          img_rgb.astype(np.uint8))
            vio.write_png(os.path.join(view_dir, "xyz.png"),
                          surf.clip(0, 255).astype(np.uint8))
            np.save(os.path.join(view_dir, "xyz.npy"),
                    surf.astype(np.float32))
            vio.write_png(os.path.join(view_dir, "alpha.png"),
                          img_mask[..., 0].astype(np.uint8))
            vio.write_png(os.path.join(view_dir, "normal.png"),
                          normal_img.astype(np.uint8))
            np.save(os.path.join(view_dir, "normal.npy"),
                    rot_normal.astype(np.float32))

        self._submit_write(_write)
        self.phase_seconds["geometry"] += time.perf_counter() - t0
        return surf, rot_normal, img_mask / 256.0

    # -- visibility --------------------------------------------------------
    def compute_vis(self, view_dir, surf, normal, mask):
        """512-direction light visibility of the foreground pixels."""
        h, w = surf.shape[:2]
        alpha = mask[..., 0] > 0
        surf_fg = surf[alpha].astype(np.float32)
        normal_fg = normal[alpha].astype(np.float32)

        if self.fast_vis:
            lvis_hit = self._lvis_fast(surf_fg, normal_fg)
            st = self.last_fast_vis_stats
            self.fast_vis_stats.append(dict(st))
            print("[gen-geo] %s: fast-vis certified %.1f%% of %d "
                  "front-lit shadow rays" % (
                      os.path.basename(view_dir),
                      100.0 * st["certified_frac"],
                      st["front_lit_rays"]), file=sys.stderr)
        else:
            lvis_hit = self._lvis_full(surf_fg, normal_fg)

        lvis = np.zeros((h, w, self.n_lights), np.float32)
        lvis[alpha] = lvis_hit

        def _write():
            lvis_img = (np.mean(lvis, axis=-1, keepdims=True)
                        * 256).clip(0, 255)
            vio.write_png(os.path.join(view_dir, "lvis.png"),
                          lvis_img.astype(np.uint8))
            # the big one, h*w*L fp32, off the critical path on the writer
            # thread, and the last file of a view
            np.save(os.path.join(view_dir, "lvis.npy"), lvis)

        os.makedirs(view_dir, exist_ok=True)
        self._submit_write(_write)
        return lvis

    def _lvis_full(self, surf_fg, normal_fg):
        """Every shadow ray through the occlusion render: [n_fg, L]."""
        t0 = time.perf_counter()
        surf_d, normal_d = self._to_device(surf_fg), self._to_device(normal_fg)
        bs = self.vis_point_batch
        out = [self._vis_batch(surf_d[i:i + bs], normal_d[i:i + bs])
               for i in range(0, surf_d.shape[0], bs)]
        if not out:
            return np.zeros((0, self.n_lights), np.float32)
        lvis = torch.cat(out, dim=0).cpu().numpy()
        self.phase_seconds["occlusion"] += time.perf_counter() - t0
        return lvis

    @torch.no_grad()
    def _lvis_fast(self, surf_fg, normal_fg):
        """Two-pass visibility: a coarse SDF sweep certifies free rays, a
        finer sweep the rays that one leaves, and the full occlusion render
        runs only on the rest. Certified-free rays get vis = 1."""
        clock = [time.perf_counter()]

        def lap(phase):  # called where the host has just waited
            clock.append(time.perf_counter())
            self.phase_seconds[phase] += clock[-1] - clock[-2]

        surf_d, normal_d = self._to_device(surf_fg), self._to_device(normal_fg)
        n_fg, L = surf_d.shape[0], self.n_lights
        bs = self.vis_point_batch

        masks = [self._coarse_batch(surf_d[i:i + bs], normal_d[i:i + bs])
                 for i in range(0, n_fg, bs)]
        if masks:
            front, uncertain, occluded = (
                torch.cat([m[j] for m in masks], dim=0) for j in range(3))
        else:
            front = uncertain = occluded = torch.zeros(
                (0, L), dtype=torch.bool, device=self.device)

        occu = occluded.reshape(-1).to(torch.float32)  # certified: lvis = 0
        u_idx = torch.nonzero(uncertain.reshape(-1))[:, 0]
        n_coarse_uncertain = int(u_idx.shape[0])
        lap("coarse")
        chunk = bs * self.light_tile

        # the finer sweep is far cheaper per ray than the occlusion render,
        # so it runs in 8x larger chunks
        n_refined = 0
        if self.fast_vis_refine and u_idx.shape[0]:
            rchunk = 8 * chunk
            keep = []
            for i in range(0, u_idx.shape[0], rchunk):
                idx = u_idx[i:i + rchunk]
                free, deep = self._refine_chunk(*self._rays_of(surf_d, idx))
                if self.fast_vis_occluded:
                    occu[idx[deep]] = 1.0
                    free = free | deep
                keep.append(~free)
            keep = torch.cat(keep)
            n_refined = int((~keep).sum())
            u_idx = u_idx[keep]
            lap("refine")

        # the certificates trust the SDF's unit gradient, which an
        # under-trained SDF can violate: a near-100% certified fraction on a
        # scene with visible shadows is the red flag to look for
        n_front = int(front.sum())
        self.last_fast_vis_stats = {
            "front_lit_rays": n_front,
            "uncertain_rays": int(u_idx.shape[0]),
            "coarse_uncertain_rays": n_coarse_uncertain,
            "refine_certified_rays": n_refined,
            "occluded_certified_rays": int(occluded.sum()),
            "certified_frac": 1.0 - u_idx.shape[0] / max(n_front, 1),
        }

        for i in range(0, u_idx.shape[0], chunk):
            idx = u_idx[i:i + chunk]
            occu[idx] = self._occ_chunk(*self._rays_of(surf_d, idx))[:, 0]
        lvis = front.to(torch.float32) * (1.0 - occu.reshape(n_fg, L))
        lvis = lvis.cpu().numpy()
        lap("occlusion")
        return lvis

    # -- all views ---------------------------------------------------------
    def extract_views(self, is_train=True, num_p=None, p_i=None,
                      no_vis=False, resume=True):
        """Extract all views, or this process's shard of them; returns the
        sorted view directories.

        Pipelined across views: view N+1's render batches are enqueued on
        the device before view N's host post-processing runs, and all PNG
        and npy encoding and IO goes through one background writer thread,
        so writes land in submission order (a view's files appear in the
        same order as on the serial path, lvis last, which is what resume
        relies on). Only the scheduling differs from the serial path.
        """
        n_imgs = self.dataset.n_images
        prefix = "train_" if is_train else "val_"
        if num_p is None:
            frame_range = range(n_imgs)
        else:
            p_step = math.ceil(n_imgs / num_p)
            frame_range = range(p_i * p_step, (p_i + 1) * p_step)

        done = []
        todo = []
        for idx in frame_range:
            if idx >= n_imgs:
                break
            view_dir = os.path.join(self.out_dir, "%s%03d" % (prefix, idx))
            if resume and check_finished(view_dir, with_lvis=not no_vis):
                done.append(view_dir)
                continue
            todo.append((idx, view_dir))

        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="geo-write")
        self._pending_writes = []
        alpha_thres = 0.5 if is_train else self.alpha_thres_val

        def dispatch(idx):
            ro, rd = self.dataset.gen_rays_at(idx)
            return self._render_dispatch(ro.reshape(-1, 3), rd.reshape(-1, 3))

        try:
            lookahead = None  # pre-dispatched render of todo[j]
            for j, (idx, view_dir) in enumerate(todo):
                rendered = lookahead if lookahead is not None \
                    else dispatch(idx)
                lookahead = (dispatch(todo[j + 1][0])
                             if j + 1 < len(todo) else None)
                surf, normal, mask = self.compute_geo(
                    idx, view_dir, alpha_thres=alpha_thres,
                    _rendered=rendered)
                if not no_vis:
                    if is_train:  # the GT mask for train views
                        mask = self.dataset.masks[idx][..., :1]
                    self.compute_vis(view_dir, surf, normal, mask)
                done.append(view_dir)
        finally:
            writer, pending = self._writer, self._pending_writes
            self._writer, self._pending_writes = None, []
            try:
                for f in pending:
                    f.result()  # surface the first write failure
            finally:
                writer.shutdown(wait=True)
        return sorted(done)


def run_gen_geo(scene, data_root, output_root="./output", seed=0,
                no_vis=False, fast_vis=None, fast_vis_factor=2.0,
                fast_vis_occluded=False, fast_vis_refine=64,
                vis_sampler=None, occ_vis=False, span_vis=False,
                num_p=None, p_i=None, overrides=None, near=None, far=None,
                use_fused_sdf=None, device="cuda", mesh=None,
                **extractor_kw):
    """Extract the train and val views of ``scene`` (the single-process
    body of the JAX package's ``gen-geo`` command).

    Loads the newest NeuS checkpoint under <output_root>/exp/<scene>/
    <family> if there is one, else takes ``init_neus(seed)``. Renders with
    the reference sampler 64+64r4 (the fast training sampler is not meant
    for extraction; ``overrides`` still wins). lvis is extracted for CG
    scenes unless ``no_vis``; fast-vis defaults to on whenever lvis is
    extracted. ``near`` / ``far`` replace the family's fixed ray bounds
    (NeRF-convention families only). Returns {"train": [...], "val":
    [...]}, the view directories, under "seconds" the extractors'
    ``phase_seconds`` summed, and under "fast_vis" the
    ``last_fast_vis_stats`` of every view that fast-vis extracted, train
    views first. ``mesh``: a list of devices to split every ray batch over
    (its first device replaces ``device``)."""
    from ..data.neus_dataset import DtuSceneDataset, NerfSceneDataset

    device = resolve_device(mesh[0] if mesh else device)
    base = dict(n_samples=64, n_importance=64, up_sample_steps=4, occ_res=0)
    base.update(overrides or {})
    cfg, tcfg, meta = vcfg.neus_configs_for_scene(scene, **base)
    dtu = meta["family"] in ("dtu", "ours")
    mk = DtuSceneDataset if dtu else NerfSceneDataset
    kwargs = {} if dtu else {
        "near": meta["near"] if near is None else near,
        "far": meta["far"] if far is None else far}
    exp_dir = os.path.join(output_root, "exp", scene, meta["family"])
    params = init_neus(seed or 0, cfg)
    latest = ckpt_util.latest_ckpt(exp_dir)
    if latest:
        params.load_state_dict(ckpt_util.load_ckpt(latest)["params"])
    no_vis = no_vis or scene not in vcfg.CG_SCENES
    out_dir = vcfg.surf_dir(os.path.join(output_root, "surf"), scene)
    if fast_vis is None:
        fast_vis = not no_vis
    done = {"seconds": {}, "fast_vis": []}
    for is_train in (True, False):
        ds = mk(data_root, is_train=is_train, new_h=meta["new_h"], **kwargs)
        ex = GeoExtractor(
            params, cfg, ds, out_dir, use_white_bkgd=tcfg.use_white_bkgd,
            fast_vis=fast_vis, fast_vis_factor=fast_vis_factor,
            fast_vis_occluded=fast_vis_occluded,
            fast_vis_refine=fast_vis_refine, use_fused_sdf=use_fused_sdf,
            vis_sampler=vis_sampler, occ_vis=occ_vis, span_vis=span_vis,
            device=device, mesh=mesh, **extractor_kw)
        done["train" if is_train else "val"] = ex.extract_views(
            is_train=is_train, num_p=num_p, p_i=p_i, no_vis=no_vis)
        for phase, sec in ex.phase_seconds.items():
            done["seconds"][phase] = done["seconds"].get(phase, 0.0) + sec
        done["fast_vis"] += ex.fast_vis_stats
    return done
