"""Stage-1 NeuS training driver (counterpart of
vqnerf_release_tpu/train/neus_loop.py).

``NeuSRunner`` trains a NeuS scene on ``device`` ("cuda" unless the caller
says otherwise; it raises when that is not there):

  * host batches: ``dataset.gen_random_rays`` over a view permutation, all
    drawn from ``np.random.RandomState(seed)``, so that the rays equal the
    JAX runner's for the same seed; the perturbation draws from a seeded
    ``torch.Generator`` on the device;
  * the occupancy grid (``tcfg.occ_res`` > 0) is rebuilt every
    ``occ_update_freq`` steps; ``carve_auto`` probes the interior fraction
    (no random draw) at the first rebuild past ``warm_up_end`` and may
    switch the carve phase to ``carve_alt_sampler``; ``adaptive_empty``
    picks the two-tier step's active capacity after each rebuild;
  * the two-phase schedule: from ``end_iter - round(tail_frac * end_iter)``
    the steps run under ``tail_sampler``, with the occupancy grid only under
    ``tail_occ``;
  * checkpoints every ``save_freq`` steps under ``base_exp_dir`` as
    {"params": state_dict, "opt_state", "iter_step", "rng"}: the layout
    ``pipelines.gen_geo.run_gen_geo`` loads from
    <output_root>/exp/<scene>/<family>. ``rng`` holds the random streams and
    the view permutation, so that a resumed run continues the uninterrupted
    one; the JAX runner draws a new permutation on every ``train`` call;
  * a divergence guard at each logged step (a non-finite loss that the
    step's guard did not skip saves ``debug_failure/`` and raises), image
    validation every ``val_freq`` steps (a PNG through the port's writer)
    and a mesh every ``mesh_freq`` steps (marching tetrahedra, ASCII PLY).

The up-sample chain of every step, and of the validation render, runs
through the fused SDF kernel on the card and through its plain version on
the CPU (``use_fused_sdf=None``; see ``neus_trainer``). The JAX
package's ``steps_per_dispatch`` has no counterpart: a value above 1 prints
one notice, and the runner takes single steps.
"""

import dataclasses
import math
import os
import sys
from os.path import join

import numpy as np
import torch

from ..config import parse_sampler_spec
from ..data import io as vio
from ..models import fields
from ..models.neus import NeuSConfig, init_neus, neus_render
from ..ops.marching_cubes import marching_cubes
from ..ops.occupancy import (build_occ_grid, interior_fraction,
                             ray_occupied_span)
from ..utils import ckpt as ckpt_util
from ..utils.device import resolve_device
from .loop import _sync_scalar_dicts
from .neus_trainer import NeuSTrainConfig, make_neus_train_step

__all__ = ["NeuSRunner"]


class NeuSRunner:
    def __init__(self, cfg: NeuSConfig, tcfg: NeuSTrainConfig, dataset,
                 base_exp_dir, val_dataset=None, seed=0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.val_dataset = val_dataset
        self.base_exp_dir = base_exp_dir
        self.rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_neus(seed, cfg).to(self.device)
        self.iter_step = 0
        self.radius = float(dataset.max_radius)
        self._with_occ = tcfg.occ_res > 0
        self._adaptive = tcfg.adaptive_empty and self._with_occ
        self._active_cap = None
        self._image_perm = None
        self._perm_i = 0
        if tcfg.steps_per_dispatch > 1:
            print("[vqnerf-torch] steps_per_dispatch=%d: several steps per "
                  "dispatch are not part of this package; training runs "
                  "single steps" % tcfg.steps_per_dispatch)

        # the tail of the two-phase schedule trains under tail_sampler
        self._tail_cfg = None
        if tcfg.tail_frac > 0.0 and tcfg.tail_sampler:
            self._tail_cfg = dataclasses.replace(
                cfg, **parse_sampler_spec(tcfg.tail_sampler,
                                          what="tail_sampler"))
        # carve_auto: None = the probe is pending
        self._carve_alt = None if (tcfg.carve_auto
                                   and self._with_occ) else False
        self._alt_cfg = None
        if tcfg.carve_auto and self._with_occ:
            self._alt_cfg = dataclasses.replace(
                cfg, **parse_sampler_spec(tcfg.carve_alt_sampler,
                                          what="carve_alt_sampler"))
        if self._adaptive:
            self._probe_rng = np.random.RandomState(seed + 17)

        # one optimizer, shared by every step variant
        self.opt, step = make_neus_train_step(
            self.params, cfg, tcfg, self.radius, with_occ=self._with_occ)
        self._fn_cache = {(None, False, False): step}
        self._occ_grid = None
        self._occ_built_at = -1
        self.occ_builds = []  # the steps at which the grid was rebuilt

    def _step_fn(self, cap=None, tail=False):
        alt = bool(self._carve_alt) and not tail
        key = (cap, tail, alt)
        if key not in self._fn_cache:
            c = (self._tail_cfg if tail
                 else self._alt_cfg if alt else self.cfg)
            occ = self._with_occ and (not tail or self.tcfg.tail_occ)
            _, self._fn_cache[key] = make_neus_train_step(
                self.params, c, self.tcfg, self.radius, with_occ=occ,
                active_cap=cap, opt=self.opt)
        return self._fn_cache[key]

    def _build_occ(self):
        return build_occ_grid(self.params.sdf, self.cfg.sdf,
                              radius=self.radius, res=self.tcfg.occ_res,
                              margin_factor=self.tcfg.occ_margin)

    def _interior_fraction(self):
        return float(interior_fraction(
            self.params.sdf, self.cfg.sdf, self.radius,
            res=self.tcfg.carve_probe_res or self.tcfg.occ_res,
            margin_factor=self.tcfg.occ_margin))

    def _to_device(self, x):
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _pick_cap(self):
        """Active capacity of the two-tier step: the largest active-ray
        fraction of 4 random views against the fresh grid, plus a margin,
        rounded up to an eighth of the batch; None (the full-budget step)
        when that is the whole batch."""
        ds = self.dataset
        fracs = []
        for _ in range(4):
            img = int(self._probe_rng.randint(ds.n_images))
            data = ds.gen_random_rays(img, self.tcfg.batch_size,
                                      self._probe_rng)
            near, far = ds.near_far(data["rays_o"], data["rays_d"])
            _, _, any_occ = ray_occupied_span(
                *(self._to_device(x) for x in (data["rays_o"],
                                               data["rays_d"], near, far)),
                self._occ_grid, self.radius)
            fracs.append(float(torch.mean(any_occ)))
        cap_frac = min(1.0, max(fracs) * 1.15 + 0.05)
        cap = math.ceil(cap_frac * 8) / 8.0
        if cap >= 1.0:
            return None
        return int(cap * self.tcfg.batch_size)

    # -- checkpoints -------------------------------------------------------
    def _rng_state(self):
        state = {"numpy": self.rng.get_state(),
                 "torch": self.generator.get_state(),
                 "perm": (None if self._image_perm is None
                          else self._image_perm.copy()),
                 "perm_i": self._perm_i}
        if self._adaptive:
            state["probe"] = self._probe_rng.get_state()
        return state

    def save_checkpoint(self, subdir=None):
        outdir = (join(self.base_exp_dir, subdir) if subdir
                  else self.base_exp_dir)
        return ckpt_util.save_ckpt(outdir, self.iter_step, {
            "params": self.params.state_dict(), "opt_state": self.opt.state,
            "iter_step": self.iter_step, "rng": self._rng_state()})

    def try_resume(self):
        latest = ckpt_util.latest_ckpt(self.base_exp_dir)
        if latest:
            state = ckpt_util.load_ckpt(latest)
            self.params.load_state_dict(state["params"])
            self.opt.state = {k: v.to(self.device)
                              for k, v in state["opt_state"].items()}
            self.iter_step = int(state["iter_step"])
            rng = state.get("rng")
            if rng:
                self.rng.set_state(rng["numpy"])
                self.generator.set_state(rng["torch"])
                self._image_perm = rng["perm"]
                self._perm_i = rng["perm_i"]
                if self._adaptive and "probe" in rng:
                    self._probe_rng.set_state(rng["probe"])
        return self.iter_step

    # -- training ----------------------------------------------------------
    def _host_batch(self):
        n = self.dataset.n_images
        img_idx = int(self._image_perm[self._perm_i % n])
        data = self.dataset.gen_random_rays(img_idx, self.tcfg.batch_size,
                                            self.rng)
        near, far = self.dataset.near_far(data["rays_o"], data["rays_d"])
        self._perm_i += 1
        if self._perm_i % n == 0:
            self._image_perm[:] = self.rng.permutation(n)
        batch = {**data, "near": near, "far": far,
                 "valid": np.ones((self.tcfg.batch_size, 1), np.float32)}
        return {k: self._to_device(v) for k, v in batch.items()}

    def tail_start(self, end=None):
        """The first step of the tail phase (``end`` when there is none): a
        fraction of the configured end_iter, so a shorter n_iters run stays
        in one phase."""
        if self._tail_cfg is None:
            return self.tcfg.end_iter if end is None else end
        return self.tcfg.end_iter - int(
            round(self.tcfg.tail_frac * self.tcfg.end_iter))

    def _maybe_rebuild_occ(self):
        if self._occ_grid is not None and (
                self.iter_step - self._occ_built_at
                < self.tcfg.occ_update_freq):
            return
        self._occ_grid = self._build_occ()
        self._occ_built_at = self.iter_step
        self.occ_builds.append(self.iter_step)
        if self._carve_alt is None and self.iter_step >= self.tcfg.warm_up_end:
            frac = self._interior_fraction()
            self._carve_alt = frac >= self.tcfg.carve_auto_thresh
            print("[vqnerf-torch] auto carve tier: interior fraction %.3f at "
                  "iter %d -> %s" % (
                      frac, self.iter_step,
                      ("switching carve to %s" % self.tcfg.carve_alt_sampler)
                      if self._carve_alt else
                      "keeping the configured carve sampler"),
                  file=sys.stderr)
        if self._adaptive:
            self._active_cap = self._pick_cap()

    def train(self, n_iters=None, log_every=0):
        """Train to ``n_iters`` (end_iter when None); returns the metrics
        of every ``log_every``-th step as floats."""
        end = n_iters if n_iters is not None else self.tcfg.end_iter
        if self._image_perm is None:
            self._image_perm = self.rng.permutation(self.dataset.n_images)
            self._perm_i = self.iter_step % max(len(self._image_perm), 1)
        history = []
        tail_start = self.tail_start(end)

        def crossed(freq):
            return freq and self.iter_step % freq == 0

        while self.iter_step < end:
            in_tail = self.iter_step >= tail_start
            use_occ = self._with_occ and (not in_tail or self.tcfg.tail_occ)
            if use_occ:
                self._maybe_rebuild_occ()
            cap = self._active_cap if not in_tail else None
            metrics = self._step_fn(cap, tail=in_tail)(
                self._host_batch(), self.iter_step,
                occ_grid=self._occ_grid if use_occ else None,
                generator=self.generator)
            self.iter_step += 1
            if crossed(log_every):
                history.append(_sync_scalar_dicts([metrics])[0])
                # a NaN loss with the skip marker: the guard dropped the
                # batch and the parameters are intact
                guarded = history[-1].get("nonfinite_grads", 0.0) > 0.5
                if not guarded and not np.isfinite(history[-1]["loss"]):
                    self.save_checkpoint(subdir="debug_failure")
                    raise RuntimeError(
                        f"NeuS: non-finite loss at iter {self.iter_step}: "
                        f"{history[-1]}; the failing state is saved under "
                        "debug_failure/; resume from the last good "
                        "checkpoint")
            if crossed(self.tcfg.save_freq):
                self.save_checkpoint()
            if self.val_dataset is not None and crossed(self.tcfg.val_freq):
                self.validate_image(0)
            if crossed(self.tcfg.mesh_freq):
                self.validate_mesh()
        return history

    # -- validation --------------------------------------------------------
    @torch.no_grad()
    def validate_image(self, idx=0, batch_size=4096):
        """A whole view of the validation dataset (the training one when
        there is none), rendered without perturbation under the training
        sampler, written into validations_fine/; returns (colour [H, W, 3],
        weight_sum [H, W])."""
        ds = self.val_dataset or self.dataset
        rays_o, rays_d = ds.gen_rays_at(idx)
        h, w = rays_o.shape[:2]
        ro, rd = rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
        bg = (torch.ones((1, 3), device=self.device)
              if self.tcfg.use_white_bkgd else None)
        colors, wsums = [], []
        for i in range(0, ro.shape[0], batch_size):
            o, d = ro[i:i + batch_size], rd[i:i + batch_size]
            near, far = ds.near_far(o, d)
            out = neus_render(
                self.params, self.cfg, *(self._to_device(x)
                                         for x in (o, d, near, far)),
                self.radius, cos_anneal_ratio=1.0, background_rgb=bg)
            colors.append(out["color_fine"].cpu().numpy())
            wsums.append(out["weight_sum"].cpu().numpy())
        img = np.concatenate(colors).reshape(h, w, 3)
        outdir = join(self.base_exp_dir, "validations_fine")
        os.makedirs(outdir, exist_ok=True)
        vio.write_png(join(outdir, "%08d_%d.png" % (self.iter_step, idx)),
                      (img * 256).clip(0, 255).astype(np.uint8))
        return img, np.concatenate(wsums).reshape(h, w)

    @torch.no_grad()
    def validate_mesh(self, resolution=64, threshold=0.0, bound=1.1):
        """Isosurface of the SDF on a resolution^3 grid over the bound x
        radius cube, written as meshes/<iter>.ply; returns (verts, tris)."""
        n = resolution
        lin = np.linspace(-bound * self.radius, bound * self.radius, n)
        xs, ys, zs = np.meshgrid(lin, lin, lin, indexing="ij")
        pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(
            np.float32)
        vals = [fields.sdf_only(self.params.sdf, self._to_device(chunk),
                                self.cfg.sdf).cpu().numpy()
                for chunk in np.split(pts, range(65536, len(pts), 65536))]
        u = -np.concatenate(vals).reshape(n, n, n)  # inside where u > 0
        verts, tris = marching_cubes(u, threshold)
        verts = verts / (n - 1.0) * (2 * bound * self.radius) \
            - bound * self.radius
        outdir = join(self.base_exp_dir, "meshes")
        os.makedirs(outdir, exist_ok=True)
        _write_ply(join(outdir, "%08d.ply" % self.iter_step), verts, tris)
        return verts, tris


def _write_ply(path, verts, tris):
    """An ASCII PLY of float vertices and triangles."""
    with open(path, "wb") as fh:
        header = (
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\nend_header\n")
        fh.write(header.encode())
        for v in verts:
            fh.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
        for t in tris:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
