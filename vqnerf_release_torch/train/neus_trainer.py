"""NeuS geometry training: the configuration, the schedules, the Adam
optimizer and the training step (counterpart of
vqnerf_release_tpu/train/neus_trainer.py; a test pins the config's fields
and defaults to the JAX ones).

  * loss = L1 colour over the mask / mask_sum + igr_weight x Eikonal
    + mask_weight x the clipped BCE of weight_sum against the mask;
  * learning rate: a linear warm-up, then a cosine decay to
    ``learning_rate_alpha`` (``neus_lr_factor``); ``cos_anneal_ratio``;
  * ``NeuSAdam``: ``optax.scale_by_adam()`` (b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, bias-corrected moments) followed by ``-lr * update``, with
    the moments kept as flat vectors in ``model.parameters()`` order
    (``interop/jax_params.py`` converts them to and from optax's state);
  * the non-finite guard: a step whose loss or any gradient is not finite
    changes neither the parameters nor the optimizer state and sets
    ``nonfinite_grads``; it selects on the device, so a step never waits.

The Eikonal term differentiates the SDF's spatial gradient again
(``neus_render(..., create_graph=True)``). The up-sample chain carries no
gradient; under ``use_fused_sdf`` (None: on for CUDA tensors) it runs
through the fused SDF kernel (``kernels/sdf.py::sdf_fwd``) on weights packed
by ``pack_sdf`` once per step, before the render, from the parameters of
that step: a pack made before an optimizer step holds the old weights.

``make_neus_multi_step`` runs k steps as one dispatch, as the JAX
package's does: the same step k times, each a replay of ONE captured CUDA
graph (``graphed.StepGraph``; eager on the CPU), reading its batch, its
perturbation draws (drawn beforehand from the generator, in the per-step
order) and its schedule values (computed on the host in double, staged in
float32) from entry i of tensors staged for the dispatch, so that k steps
of it equal k single steps bit for bit. Its metrics are reduced over the k
steps as the JAX package's are.
"""

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..kernels import sdf as sdf_kernel
from ..models.neus import NeuSConfig, fused_sdf_enabled, neus_render
from ..ops.occupancy import ray_occupied_span
from ..utils import profiling
from .graphed import StepGraph

__all__ = ["NeuSTrainConfig", "neus_lr_factor", "cos_anneal_ratio",
           "NeuSAdam", "init_neus_opt_state", "make_neus_train_step",
           "draw_step_rand", "make_neus_multi_step", "reduce_metrics"]


@dataclass(frozen=True)
class NeuSTrainConfig:
    learning_rate: float = 5e-4
    learning_rate_alpha: float = 0.05
    end_iter: int = 300_000
    lr_end_iter: int = -1  # dtu: 300k while end_iter=100k
    warm_up_end: int = 5_000
    anneal_end: int = 0
    batch_size: int = 2560
    igr_weight: float = 0.1
    mask_weight: float = 0.1
    use_white_bkgd: bool = True
    save_freq: int = 10_000
    val_freq: int = 2_500
    mesh_freq: int = 10_000  # in-loop marching-cubes mesh dump; 0 = off
    # the JAX package's opt-in for its fused SDF kernel; the port's switch
    # is ``use_fused_sdf`` on the render functions (on for CUDA tensors)
    use_pallas: bool = False
    # occupancy-grid sampling (ops/occupancy.py): 0 = off
    occ_res: int = 0
    occ_update_freq: int = 250
    occ_margin: float = 3.0
    occ_floor: float = 0.05
    # steps a dispatch (make_neus_multi_step); 1 = single steps
    steps_per_dispatch: int = 1
    # per-ray-adaptive work (requires occ_res > 0): provably empty rays
    # render with a cheap empty_n_samples uniform tier
    adaptive_empty: bool = False
    empty_n_samples: int = 8
    # two-phase sampler schedule: after (1 - tail_frac) * end_iter steps,
    # training switches to tail_sampler (a "64+64r4"-style spec)
    tail_frac: float = 0.0
    tail_sampler: str = ""
    tail_occ: bool = False  # keep occupancy guidance on during the tail
    # auto carve-tier selection from the deep-interior fraction
    carve_auto: bool = False
    carve_alt_sampler: str = "24+16r2"
    carve_auto_thresh: float = 0.30
    carve_probe_res: int = 0
    skip_nonfinite_updates: bool = True


def neus_lr_factor(step, tcfg: NeuSTrainConfig):
    """Linear warm-up to 1 over warm_up_end steps, then a cosine decay to
    learning_rate_alpha at lr_end_iter (end_iter when unset)."""
    if step < tcfg.warm_up_end:
        return step / tcfg.warm_up_end
    end = tcfg.lr_end_iter if tcfg.lr_end_iter > 0 else tcfg.end_iter
    alpha = tcfg.learning_rate_alpha
    progress = (step - tcfg.warm_up_end) / (end - tcfg.warm_up_end)
    return (math.cos(math.pi * progress) + 1.0) * 0.5 * (1 - alpha) + alpha


def cos_anneal_ratio(step, tcfg: NeuSTrainConfig):
    if tcfg.anneal_end == 0:
        return 1.0
    return min(1.0, step / tcfg.anneal_end)


def init_neus_opt_state(params):
    """A fresh Adam state over ``params`` (a list of tensors) on their
    device: count (0-dim int32), mu, nu (flat)."""
    params = list(params)
    device = params[0].device
    n = sum(p.numel() for p in params)
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": torch.zeros((n,), device=device),
            "nu": torch.zeros((n,), device=device)}


class NeuSAdam:
    """``optax.scale_by_adam()`` then ``-lr * update`` over ``params`` (leaf
    tensors updated in place); ``state`` as ``init_neus_opt_state``. With
    ``guard`` a non-finite loss or gradient skips the step."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.scale_by_adam's defaults

    def __init__(self, params, guard=True):
        self.params = list(params)
        self.guard = guard
        self.sizes = [p.numel() for p in self.params]
        self.state = init_neus_opt_state(self.params)

    @torch.no_grad()
    def step(self, grads, lr, loss=None):
        """Apply one update (``lr`` a float or its float32 as a 0-dim
        tensor), the state in place; returns ok, a 0-dim bool tensor (False
        when the guard skipped the step)."""
        st = self.state
        g = torch.cat([x.reshape(-1) for x in grads])
        ok = torch.isfinite(g).all()
        if loss is not None:
            ok = ok & torch.isfinite(loss.detach())
        count = st["count"] + 1
        cf = count.to(torch.float32)
        mu = (1 - self.b1) * g + self.b1 * st["mu"]
        nu = (1 - self.b2) * (g * g) + self.b2 * st["nu"]
        mu_hat = mu / (1 - self.b1 ** cf)
        nu_hat = nu / (1 - self.b2 ** cf)
        delta = -lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
        if self.guard:
            delta = torch.where(ok, delta, torch.zeros_like(delta))
            count, mu, nu = (torch.where(ok, new, st[k]) for new, k in (
                (count, "count"), (mu, "mu"), (nu, "nu")))
        # in place: a CUDA graph of the step reads and writes these buffers
        for k, new in (("count", count), ("mu", mu), ("nu", nu)):
            st[k].copy_(new)
        torch._foreach_add_(
            self.params,
            [d.view_as(p) for d, p in zip(delta.split(self.sizes),
                                          self.params)])
        return ok


def make_neus_train_step(model, cfg: NeuSConfig, tcfg: NeuSTrainConfig,
                         radius, with_occ=False, active_cap=None, opt=None,
                         use_fused_sdf=None):
    """(optimizer, step_fn) over all of ``model``'s parameters; ``opt``: an
    existing ``NeuSAdam`` of the model to share (the runner's step variants
    do), else a new one.

    step_fn(batch, step, occ_grid=None, rand=None, generator=None,
    lr=None, anneal=None) -> metrics, a dict of 0-dim tensors on the
    device, after updating the model in place. ``lr`` and ``anneal`` (the
    pair (1 - ratio, ratio)), 0-dim float32 tensors, replace the schedules
    at ``step`` (None then). batch: rays_o / rays_d [R, 3], rgb [R, 3],
    mask [R, 1], near / far [R, 1], valid [R, 1] (tensors on the model's
    device).
    occ_grid is required with ``with_occ``. The perturbation comes from
    ``rand`` (pre-drawn uniforms as ``neus_render`` takes them; with
    ``active_cap`` a dict {"active": ..., "empty": ...} of one such dict a
    tier) or from ``generator``; with neither the step is deterministic.

    active_cap (requires with_occ): the two-tier render. A stable sort puts
    the rays with an occupied span first; the first active_cap render with
    the full sampler, the rest with a uniform tcfg.empty_n_samples tier.
    The Eikonal term is one mean over the points of both tiers.
    """
    if active_cap is not None and not with_occ:
        raise ValueError("active_cap requires with_occ (the empty-ray "
                         "certificate reads the occupancy grid)")
    params = list(model.parameters())
    if opt is None:
        opt = NeuSAdam(params, guard=tcfg.skip_nonfinite_updates)
    cheap_cfg = replace(cfg, n_samples=tcfg.empty_n_samples, n_importance=0,
                        up_sample_steps=0)

    def render(c, batch, rows, rand, generator, anneal, occ_grid, fused,
               packed):
        bg = (torch.ones((1, 3), device=batch["rays_o"].device)
              if tcfg.use_white_bkgd else None)
        return neus_render(
            model, c, batch["rays_o"][rows], batch["rays_d"][rows],
            batch["near"][rows], batch["far"][rows], radius,
            generator=generator, rand=rand, background_rgb=bg,
            cos_anneal_ratio=anneal, use_fused_sdf=fused, packed=packed,
            occ_grid=occ_grid, occ_floor=tcfg.occ_floor, create_graph=True)

    def two_tier(batch, rand, generator, anneal, occ_grid, fused, packed):
        n = batch["rays_o"].shape[0]
        _, _, any_occ = ray_occupied_span(
            batch["rays_o"], batch["rays_d"], batch["near"], batch["far"],
            occ_grid, radius)
        active = any_occ[:, 0] > 0
        order = torch.argsort(torch.where(active, 0, 1), stable=True)
        batch = {k: v[order] for k, v in batch.items()}
        rand = rand or {}
        out_a = render(cfg, batch, slice(None, active_cap),
                       rand.get("active"), generator, anneal, occ_grid,
                       fused, packed)
        out_b = render(cheap_cfg, batch, slice(active_cap, None),
                       rand.get("empty"), generator, anneal, occ_grid,
                       fused, packed)
        n_active = torch.sum(active.to(torch.float32))
        out = {
            "color_fine": torch.cat([out_a["color_fine"],
                                     out_b["color_fine"]]),
            "weight_sum": torch.cat([out_a["weight_sum"],
                                     out_b["weight_sum"]]),
            # one mean over every sampled point of the batch: the tiers'
            # sums and counts, not the mean of their means
            "gradient_error": (
                (out_a["grad_err_sum"] + out_b["grad_err_sum"])
                / (out_a["grad_err_cnt"] + out_b["grad_err_cnt"] + 1e-5)),
            "s_val": out_a["s_val"],
        }
        extras = {"active_frac": n_active / n,
                  "overflow_frac": torch.relu(n_active - active_cap) / n}
        return out, batch, extras

    def step_fn(batch, step, occ_grid=None, rand=None, generator=None,
                lr=None, anneal=None):
        with profiling.span("neus.step", step=step):
            if with_occ and occ_grid is None:
                raise ValueError("this step takes the occupancy grid")
            if not with_occ:
                occ_grid = None
            if anneal is None:
                anneal = cos_anneal_ratio(step, tcfg)
            fused = fused_sdf_enabled(use_fused_sdf, batch["rays_o"])
            # the current weights, packed once for every chain of this step
            packed = (sdf_kernel.pack_sdf(model.sdf, cfg.sdf)
                      if fused and cfg.n_importance > 0 else None)
            extras = {}
            if active_cap is not None:
                out, batch, extras = two_tier(batch, rand, generator, anneal,
                                              occ_grid, fused, packed)
            else:
                out = render(cfg, batch, slice(None), rand, generator, anneal,
                             occ_grid, fused, packed)
            valid = batch["valid"]
            if tcfg.mask_weight > 0:
                mask = (batch["mask"] > 0.5).to(torch.float32) * valid
            else:
                mask = torch.ones_like(batch["mask"]) * valid
            mask_sum = torch.sum(mask) + 1e-5
            color_err = (out["color_fine"] - batch["rgb"]) * mask
            color_loss = torch.sum(torch.abs(color_err)) / mask_sum
            mse = torch.sum(color_err ** 2) / (mask_sum * 3.0)
            psnr = 20.0 * torch.log10(1.0 / torch.sqrt(mse))
            eikonal_loss = out["gradient_error"]
            w = torch.clamp(out["weight_sum"], 1e-3, 1.0 - 1e-3)
            bce = -(batch["mask"] * torch.log(w)
                    + (1.0 - batch["mask"]) * torch.log(1.0 - w))
            mask_loss = torch.sum(bce * valid) / torch.clamp(torch.sum(valid),
                                                             min=1.0)
            loss = (color_loss + eikonal_loss * tcfg.igr_weight
                    + mask_loss * tcfg.mask_weight)

            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, params)]
            if lr is None:
                lr = tcfg.learning_rate * neus_lr_factor(step, tcfg)
            ok = opt.step(grads, lr, loss)
            metrics = {"loss": loss, "color_loss": color_loss,
                       "eikonal_loss": eikonal_loss, "mask_loss": mask_loss,
                       "psnr": psnr, "s_val": torch.mean(out["s_val"]),
                       **extras}
            metrics = {k: v.detach() for k, v in metrics.items()}
            if opt.guard:
                metrics["nonfinite_grads"] = 1.0 - ok.to(torch.float32)
            metrics["lr"] = (lr if torch.is_tensor(lr) else torch.tensor(
                lr, dtype=torch.float32, device=loss.device))
            return metrics

    return opt, step_fn


def _render_draws(c, rows, generator, with_grid, device):
    """The uniforms ``neus_render`` draws for ``rows`` rays under config c,
    in its order (see ``models.neus.neus_render``)."""
    if c.perturb <= 0:
        return {}

    def draw(shape):
        return torch.rand(shape, generator=generator,
                          device=generator.device).to(device)

    out = {}
    if with_grid:
        out["occ_u"] = draw((rows, c.n_samples))
    else:
        out["t_rand"] = draw((rows, 1))
    if c.n_outside > 0:
        out["outside"] = draw((rows, c.n_outside))
    return out


def draw_step_rand(generator, cfg: NeuSConfig, tcfg: NeuSTrainConfig,
                   batch_size, with_occ=False, active_cap=None, device=None):
    """The perturbation draws one step of ``make_neus_train_step(cfg, tcfg,
    with_occ=, active_cap=)`` makes from ``generator``, in its order, as
    its ``rand`` argument takes them: a step given them equals a step given
    the generator, and leaves the generator where that step leaves it."""
    device = device or generator.device
    if active_cap is None:
        return _render_draws(cfg, batch_size, generator, with_occ, device)
    cheap = replace(cfg, n_samples=tcfg.empty_n_samples, n_importance=0,
                    up_sample_steps=0)
    return {"active": _render_draws(cfg, active_cap, generator, True,
                                    device),
            "empty": _render_draws(cheap, batch_size - active_cap,
                                   generator, True, device)}


def reduce_metrics(rows, keys):
    """The metrics of k steps [k, len(keys)] (device) reduced as the JAX
    package's multi-step reduces them: nonfinite_grads summed, lr the last
    step's, every other metric the mean over its finite steps (the last
    step's value when none is finite)."""
    out = {}
    for j, name in enumerate(keys):
        x = rows[:, j]
        if name == "nonfinite_grads":
            out[name] = torch.sum(x)
        elif name == "lr":
            out[name] = x[-1]
        else:
            finite = torch.isfinite(x)
            n = torch.sum(finite.to(torch.float32))
            mean = (torch.sum(torch.where(finite, x, torch.zeros_like(x)))
                    / torch.clamp(n, min=1.0))
            out[name] = torch.where(n > 0, mean, x[-1])
    return out


def _flatten(tree, path=()):
    """A nested dict of tensors -> {key path: tensor}."""
    if not isinstance(tree, dict):
        return {path: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, path + (k,)))
    return out


def _unflatten(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def make_neus_multi_step(model, cfg: NeuSConfig, tcfg: NeuSTrainConfig,
                         radius, k, with_occ=False, active_cap=None, opt=None,
                         use_fused_sdf=None):
    """(optimizer, multi_fn): k chained steps of ``make_neus_train_step``
    (same arguments) in one dispatch.

    multi_fn(batches, base_step, occ_grid=None, generator=None) -> metrics
    reduced over the k steps (``reduce_metrics``; 0-dim tensors on the
    device), after updating the model in place. ``batches``: k batch dicts
    as the single step takes them (numpy arrays or tensors), the steps
    base_step .. base_step + k - 1. The perturbation of each step is drawn
    from ``generator`` before the dispatch, as k single steps would draw
    it (none without a generator)."""
    opt, step_fn = make_neus_train_step(
        model, cfg, tcfg, radius, with_occ=with_occ, active_cap=active_cap,
        opt=opt, use_fused_sdf=use_fused_sdf)
    device = next(model.parameters()).device
    # ("batch", key), ("rand",) + key path, ("sched",): [k, ...] buffers;
    # "occ": the grid; "drawn": whether the steps take draws
    stage = {}

    def body(i):
        at = {name: buf.index_select(0, i.reshape(1))[0]
              for name, buf in stage.items() if isinstance(name, tuple)}
        rand = {name[1:]: v for name, v in at.items() if name[0] == "rand"}
        sched = at[("sched",)]  # lr, 1 - anneal, anneal
        return step_fn(
            {name[1]: v for name, v in at.items() if name[0] == "batch"},
            None, occ_grid=stage.get("occ"),
            rand=_unflatten(rand) if rand else None, lr=sched[0],
            anneal=(sched[1], sched[2]))

    graph = StepGraph(body, device, k)

    def put(name, values):
        stacked = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                               .to(device) for v in values])
        if name in stage:
            stage[name].copy_(stacked)  # the graph reads this buffer
        else:
            stage[name] = stacked

    def multi_fn(batches, base_step, occ_grid=None, generator=None):
        if len(batches) != k:
            raise ValueError(f"{len(batches)} batches for {k} steps")
        if with_occ and occ_grid is None:
            raise ValueError("this step takes the occupancy grid")
        drawn = generator is not None
        if stage.setdefault("drawn", drawn) != drawn:
            raise ValueError("a dispatch with a generator and one without")
        for key in batches[0]:
            put(("batch", key), [b[key] for b in batches])
        if drawn:
            n = next(iter(batches[0].values())).shape[0]
            draws = [_flatten(draw_step_rand(
                generator, cfg, tcfg, n, with_occ=with_occ,
                active_cap=active_cap, device=device)) for _ in range(k)]
            for path in draws[0]:
                put(("rand",) + path, [d[path] for d in draws])
        steps = [base_step + j for j in range(k)]
        put(("sched",), np.asarray(
            [[tcfg.learning_rate * neus_lr_factor(s, tcfg),
              1.0 - cos_anneal_ratio(s, tcfg), cos_anneal_ratio(s, tcfg)]
             for s in steps], np.float32))
        if with_occ:
            if "occ" in stage:
                stage["occ"].copy_(occ_grid)
            else:
                stage["occ"] = occ_grid.detach().clone()
        return reduce_metrics(graph.run(k), graph.keys)

    multi_fn.graph = graph
    return opt, multi_fn
