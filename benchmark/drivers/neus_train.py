"""Generator of stage-1 training traffic: NeuS training of the shipped
configuration through the program's runner, carve and tail in the
schedule's ratio, closed loop.

Set-up makes the scene (``Scene``: NeRF-synthetic cameras around a textured
sphere, every view rendered on the device) and the weights
(``reference.neus.make_weights``: the SDF's geometric init) from the seed,
and builds the program's ``NeuSRunner`` over the program's
``NerfSceneDataset`` holding those views: the arrays its file reader would
hold, set on it in place of reading PNGs, so that no run pays for encoding
and decoding 100 views. ``runner.train`` then takes every step as the
``geo-train`` command does: a host batch a step (``_host_batch``: the
dataset's random rays, copied to the device), the occupancy grid rebuilt
every ``occ_update_freq`` steps (``_maybe_rebuild_occ``), the perturbation
drawn from the runner's generator, at the runner's step index from
``base_step``. The tail phase is entered by handing the runner its
configuration with ``tail_frac`` 1 (every step in the tail) for the tail's
steps, and the carve phase by handing it back: the step index, the grid and
its cadence, the optimizer and the random streams run on across both.

The first three steps, two carve steps and one tail step, are the checked
ones: their losses, the first step's gradient as the optimizer's state
holds it, and the parameters after the third. For each the benchmark keeps
the host sampler's draw (the view and the pixels, read from the runner's
random state before the batch) and the perturbation's uniforms (from the
generator's state before the step); the reference takes its own rays and
colours at those pixels. The window runs cycles of ``carve_steps`` carve
steps then ``tail_steps`` tail steps (the schedule's 3 : 1 of end_iter).

The mix's keys: ``metric`` (the name of the cell's rate of rays),
``carve_steps``, ``tail_steps``, ``base_step``,
``trace_skip`` and ``trace_cycles`` (in cycles), ``change_by``
(``compare``'s), ``limits``.
"""

import dataclasses
import gc
import math
import re
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark.compare import compare
from benchmark.counts import neus as counts
from benchmark.inputs import seed32
from benchmark.reference import neus as ref

CARVE_CHECKED, TAIL_CHECKED = 2, 1
SIDES = ("lowp", "half_batch")


def sampler(spec):
    """'64+32r2' -> {n_samples, n_importance, up_sample_steps}."""
    a, b, c = re.fullmatch(r"(\d+)\+(\d+)r(\d+)", spec).groups()
    return {"n_samples": int(a), "n_importance": int(b),
            "up_sample_steps": int(c)}


class Scene:
    """NeRF-synthetic cameras (``n_views`` on the upper hemisphere at
    ``distance``, ``image_hw`` pixels, field of view ``camera_angle_x``,
    the principal point at the image's centre pixel) around a sphere of
    ``sphere_radius`` with a texture of four random waves, white
    background."""

    def __init__(self, s, seed, device):
        self.s, self.device = s, device
        gen = torch.Generator(device=device).manual_seed(seed)
        n = s["n_views"]
        u = torch.rand((n, 2), generator=gen, device=device,
                       dtype=torch.float64)
        az = 2 * math.pi * u[:, 0]
        el = torch.asin(u[:, 1])  # uniform over the hemisphere's area
        z = torch.stack([torch.cos(el) * torch.cos(az),
                         torch.cos(el) * torch.sin(az), torch.sin(el)], -1)
        up = torch.tensor([0.0, 0.0, 1.0], device=device,
                          dtype=torch.float64).expand_as(z)
        x = torch.linalg.cross(up, z)
        x = x / torch.clamp(x.norm(dim=-1, keepdim=True), min=1e-6)
        self.rot = torch.stack([x, torch.linalg.cross(z, x), z], -1)
        self.origin = z * s["distance"]
        self.hw = s["image_hw"]
        self.focal = 0.5 * self.hw / math.tan(0.5 * s["camera_angle_x"])
        self.freq = (torch.rand((4, 3), generator=gen, device=device)
                     - 0.5) * 12
        self.phase = torch.rand((4, 3), generator=gen,
                                device=device) * 2 * math.pi
        # the bounding radius of the rays' [near, far] frustum axes, as the
        # NeRF loader computes it
        ends = [self.origin - s["near"] * z, self.origin - s["far"] * z]
        self.radius = float(max(e.norm(dim=-1).max() for e in ends))
        self.rgba = None

    def poses(self):
        """The cameras' 4x4 camera-to-world matrices, float64 on the
        host."""
        c2w = torch.zeros((len(self.rot), 4, 4), dtype=torch.float64,
                          device=self.device)
        c2w[:, :3, :3] = self.rot
        c2w[:, :3, 3] = self.origin
        c2w[:, 3, 3] = 1.0
        return list(c2w.cpu().numpy())

    def rays(self, v, xs, ys):
        """Rays (float32 origins and unit directions) through pixels
        ``xs``, ``ys`` (long tensors) of view ``v``."""
        c = self.hw // 2
        p = torch.stack([(xs - c) / self.focal, -(ys - c) / self.focal,
                         -torch.ones_like(xs, dtype=torch.float64)], -1)
        d = p.double() @ self.rot[v].T
        d = d / d.norm(dim=-1, keepdim=True)
        o = self.origin[v].expand_as(d)
        return o.float().contiguous(), d.float()

    def render(self):
        """Every view's RGBA as uint8 [n, hw, hw, 4] on the host, the
        colour of the textured sphere where a pixel's ray hits it and white
        elsewhere, the alpha its hit; also kept for ``batch``."""
        dev, hw, n = self.device, self.hw, len(self.rot)
        ys, xs = torch.meshgrid(torch.arange(hw, device=dev),
                                torch.arange(hw, device=dev), indexing="ij")
        xs, ys = xs.reshape(-1), ys.reshape(-1)
        out = torch.empty((n, hw * hw, 4), dtype=torch.uint8, device=dev)
        for v in range(n):
            o, d = self.rays(v, xs, ys)
            b = (o * d).sum(-1)
            disc = b * b - (self.s["distance"] ** 2
                            - self.s["sphere_radius"] ** 2)
            hit = disc > 0
            xyz = o + (-b - torch.sqrt(torch.clamp(disc, min=0)))[:, None] * d
            tex = 0.5 + 0.1 * torch.sin(xyz[:, None] * self.freq[None]
                                        + self.phase[None]).sum(-1)[:, :3]
            rgb = torch.where(hit[:, None], tex.clamp(0, 1),
                              torch.ones_like(tex))
            rgba = torch.cat([rgb, hit[:, None].float()], -1)
            out[v] = torch.round(rgba * 255).to(torch.uint8)
        self.rgba = out.view(n, hw, hw, 4)
        return self.rgba.cpu().numpy()

    def batch(self, v, xs, ys):
        """A training batch at pixels ``xs``, ``ys`` (host arrays) of view
        ``v``, as the NeRF loader makes it: dicts of [R, C] float32."""
        dev = self.device
        xs = torch.as_tensor(xs, device=dev)
        ys = torch.as_tensor(ys, device=dev)
        o, d = self.rays(v, xs, ys)
        px = self.rgba[v][ys, xs].float() / 255.0
        ones = torch.ones((len(xs), 1), device=dev)
        return {"rays_o": o, "rays_d": d, "rgb": px[:, :3],
                "mask": px[:, 3:], "near": ones * self.s["near"],
                "far": ones * self.s["far"], "valid": ones}


def program_dataset(scene, rgba):
    """The program's ``NerfSceneDataset`` holding ``rgba`` [n, H, W, 4]
    uint8 and the scene's cameras, as its reader leaves it for 8-bit
    PNGs."""
    from vqnerf_release_torch.data import rays as vrays
    from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
    s = scene.s
    ds = NerfSceneDataset.__new__(NerfSceneDataset)
    ds.near_v, ds.far_v = s["near"], s["far"]
    ds.cx = ds.cy = None
    ds.images_lis = [f"train_{i:03d}" for i in range(len(rgba))]
    ds.n_images = len(rgba)
    ds.images = rgba[..., :3] / 255.0
    ds.masks = np.repeat(rgba[..., 3:], 3, axis=-1) / 255.0
    ds.poses = scene.poses()
    ds.H, ds.W = rgba.shape[1:3]
    ds.focal = 0.5 * ds.W / np.tan(0.5 * s["camera_angle_x"])
    ds.max_radius = vrays.max_radius_from_poses(ds.poses, s["near"],
                                                s["far"])
    return ds


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.m = config["model"]
        self.t = config["train"]
        self.device = torch.device(device)
        self.m_tail = dict(self.m, **sampler(self.t["tail_sampler"]))

    def _program_cfgs(self):
        from vqnerf_release_torch.models import fields
        from vqnerf_release_torch.models.neus import NeuSConfig
        from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig
        m, t = self.m, self.t
        cfg = NeuSConfig(
            sdf=fields.SDFConfig(**dict(m["sdf"], skip_in=tuple(
                m["sdf"]["skip_in"]))),
            color=fields.ColorConfig(**m["color"]),
            **{k: m[k] for k in ("n_samples", "n_importance", "n_outside",
                                 "up_sample_steps", "perturb",
                                 "variance_init")})
        tcfg = NeuSTrainConfig(**{k: v for k, v in t.items() if k in
                                  NeuSTrainConfig.__dataclass_fields__})
        return cfg, tcfg

    def setup(self):
        from vqnerf_release_torch.train.neus_loop import NeuSRunner
        dev = self.device
        self.scene = Scene(self.config["scene"], seed32(self.seed, 1), dev)
        self.radius = self.scene.radius
        dataset = program_dataset(self.scene, self.scene.render())
        self.weights = ref.make_weights(self.m, seed32(self.seed, 2), dev)
        cfg, self.tcfg = self._program_cfgs()
        # every step in the tail: the runner's tail phase at any step
        self.tcfg_tail = dataclasses.replace(self.tcfg, tail_frac=1.0)
        self.exp_dir = tempfile.mkdtemp(prefix="bench_neus_")
        runner = NeuSRunner(cfg, self.tcfg, dataset, self.exp_dir,
                            seed=seed32(self.seed, 3), device=dev)
        runner.params.load_state_dict(self.weights)
        runner.iter_step = int(self.mix["base_step"])
        self.runner = runner
        self.skipped = torch.zeros((), device=dev)
        self.recording = True
        self.checked, self.losses = [], []
        self._hook(runner)

        names = [k for k, _ in runner.params.named_parameters()]
        sizes = [p.numel() for _, p in runner.params.named_parameters()]
        self._run(CARVE_CHECKED, tail=False)
        mu = self.mu1
        self._run(TAIL_CHECKED, tail=True)
        self.recording = False
        self.prog = {
            "loss": [float(x) for x in torch.stack(self.losses).double()
                     .cpu()],
            "grad1": {k: (g / (1 - ref.B1)).view_as(p) for k, g, p in
                      zip(names, mu.split(sizes),
                          runner.params.parameters())},
            "params": {k: p.detach().clone()
                       for k, p in runner.params.named_parameters()}}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _hook(self, runner):
        """Wrap the runner's host batch and step to count skipped steps
        and, while ``recording``, keep what the check needs; the runner's
        own calls are unchanged."""
        host_batch, step_fn = runner._host_batch, runner._step_fn

        def hooked_batch():
            if self.recording:
                n = runner.dataset.n_images
                view = int(runner._image_perm[runner._perm_i % n])
                draw = np.random.RandomState()
                draw.set_state(runner.rng.get_state())
                self.checked.append({"view": view, "rng": draw})
            return host_batch()

        def hooked_step_fn(*a, **k):
            fn = step_fn(*a, **k)

            def step(batch, step, **kw):
                gen_state = (kw["generator"].get_state()
                             if self.recording else None)
                metrics = fn(batch, step, **kw)
                if "nonfinite_grads" in metrics:
                    self.skipped += metrics["nonfinite_grads"]
                if self.recording:
                    rec = self.checked[-1]
                    rec.update(step=step, gen=gen_state,
                               tail=bool(k.get("tail")), rows=len(
                                   batch["rays_o"]))
                    self.losses.append(metrics["loss"])
                    if len(self.losses) == 1:
                        self.mu1 = runner.opt.state["mu"].detach().clone()
                return metrics
            return step

        runner._host_batch = hooked_batch
        runner._step_fn = hooked_step_fn

    def _run(self, n, tail):
        """``n`` steps of the runner in a phase."""
        r = self.runner
        r.tcfg = self.tcfg_tail if tail else self.tcfg
        r.train(n_iters=r.iter_step + n)

    def window(self, seconds, tracer=None):
        """Cycles until ``seconds`` have passed. With ``tracer``, the slice
        is the ``trace_cycles`` cycles after the first ``trace_skip``; the
        rate of operations is taken over the rest of the window."""
        n_c, n_t = int(self.mix["carve_steps"]), int(self.mix["tail_steps"])
        rays = self.t["batch_size"]
        flops_cycle = (n_c * counts.train_step_flops(self.m, rays)
                       + n_t * counts.train_step_flops(self.m_tail, rays))
        flops_cycle += (n_c + n_t) * counts.grid_flops(
            self.m, self.t["occ_res"]) / self.t["occ_update_freq"]
        start_at = int(self.mix["trace_skip"])
        stop_at = start_at + int(self.mix["trace_cycles"])
        skipped0 = float(self.skipped)
        steps = cycles = 0
        traced = None  # (cycles, seconds) of the slice
        t0 = time.perf_counter()
        while True:
            if tracer is not None and cycles == start_at:
                tracer.start()
                traced = (cycles, time.perf_counter())
            self._run(n_c, tail=False)
            self._run(n_t, tail=True)
            steps += n_c + n_t
            cycles += 1
            if tracer is not None and cycles == stop_at:
                done = cycles - traced[0]
                tracer.stop({"steps": done * (n_c + n_t),
                             "flops": done * flops_cycle,
                             "sdf_fwd_points": done * rays * (
                                 n_c * counts.chain_points(self.m)
                                 + n_t * counts.chain_points(self.m_tail))})
                traced = (done, time.perf_counter() - traced[1])
            if time.perf_counter() - t0 >= seconds and (
                    tracer is None or cycles >= stop_at):
                break
        failed = int(round(float(self.skipped) - skipped0))
        window_s = time.perf_counter() - t0
        spans = {}
        if traced is not None:
            spans["flops_per_s"] = ((cycles - traced[0]) * flops_cycle
                                    / (window_s - traced[1]))
        return {"attempted": steps, "failed": failed,
                "metrics": {self.mix["metric"]: steps * rays / window_s},
                "spans": spans}

    def release(self):
        del self.runner
        shutil.rmtree(self.exp_dir, ignore_errors=True)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked_steps(self):
        """(model config, batch, step index, uniforms) of each checked
        step: the benchmark's own rays and colours at the pixels that the
        program's host sampler drew (``NerfSceneDataset.gen_random_rays``
        draws the columns, then the rows), and the uniforms that the step
        drew from the runner's generator (``occ_u`` first)."""
        out = []
        hw = self.scene.hw
        for rec in self.checked:
            xs = rec["rng"].randint(0, hw, size=rec["rows"])
            ys = rec["rng"].randint(0, hw, size=rec["rows"])
            mc = self.m_tail if rec["tail"] else self.m
            gen = torch.Generator(device=self.device)
            gen.set_state(rec["gen"])
            u = torch.rand((rec["rows"], mc["n_samples"]), generator=gen,
                           device=self.device)
            out.append((mc, self.scene.batch(rec["view"], xs, ys),
                        rec["step"], u))
        return out

    def reference(self, lowp=False, keep_rows=None):
        return ref.train_steps(self.weights, self.m, self.t,
                               self._checked_steps(), self.radius,
                               lowp=lowp, keep_rows=keep_rows)

    def check(self, side=None):
        """loss_gap, grad_gap and change_gap as the stage-2 training cell
        reads them (``compare``), and ``tail_loss_gap``: the relative gap of
        the tail step's loss. ``side``: "lowp" or "half_batch" put a
        variant of the reference in the program's place."""
        exact = self.reference()
        if side is None:
            prog = self.prog
        elif side == "lowp":
            prog = self.reference(lowp=True)
        elif side == "half_batch":
            prog = self.reference(keep_rows=self.t["batch_size"] // 2)
        else:
            raise ValueError(side)
        self.detail = {}
        nums = compare(prog, exact, self.weights,
                       change_by=self.mix.get("change_by", "worst"),
                       detail=self.detail)
        tail = CARVE_CHECKED  # the index of the tail step
        nums["tail_loss_gap"] = (abs(prog["loss"][tail] - exact["loss"][tail])
                                 / abs(exact["loss"][tail]))
        limits = self.mix["limits"]
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in nums.items()]
