"""Generator of stage-2 training traffic: the scanned epoch dispatch of
vq_nfr as ``decomp-train`` runs it, closed loop, chunk after chunk.

Set-up makes the scene (``inputs.sphere_views``) and the weights
(``reference.decomp.make_weights``) from the seed, and builds what the
program's ``train_vq_nfr`` builds: the step, the device store by the
configuration's ``device_views`` policy (``loop._make_batch_source``), the
chunk length (``loop._resolve_scan_chunk``) and the scanned dispatch of the
step (``loop._VqSteps``). It takes the first three steps through that
dispatch, one step and then two: their losses, the first step's gradient as
the optimizer's state holds it, and the parameters after the third are kept
for the check. One chunk through the program's loop warms every shape.

The window is the program's own chunk loop, ``loop._scan_epoch_loop``, with
the callbacks ``loop._train_epochs`` gives it: the host samples the next
chunk's ray pairs (``loop._epoch_scan_xs``) while the device replays this
one, and a chunk's losses are read back at its end. The benchmark's
``post_epoch`` only counts steps and skipped steps, times the sampling, and
closes the window at the end of the first chunk that ends past
``--seconds``; validation and checkpoints are left out.

The mix's keys: ``metric`` (the name of the cell's rate of rays),
``trace_chunks`` (chunks in the traced slice, after
``trace_skip`` chunks of the window), ``change_by`` (``compare``'s),
``limits`` of the checked numbers.
"""

import gc
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.compare import compare
from benchmark.counts import decomp as counts
from benchmark.reference import decomp as ref

CHECKED_STEPS = 3
# the variants of the reference put in the program's place by calibrate.py
SIDES = ("lowp", "half_batch")


class _WindowClosed(Exception):
    """Raised by the benchmark's ``post_epoch`` to leave the program's
    chunk loop once the window has closed."""


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.model_cfg = config["model"]
        self.device = torch.device(device)

    # ------------------------------------------------------------ set-up
    def setup(self):
        from vqnerf_release_torch.models import decomp_common as dc
        from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
        from vqnerf_release_torch.models.vq_nfr import init_vq_nfr
        from vqnerf_release_torch.ops.vq import init_vq_ema_state
        from vqnerf_release_torch.train import decomp_trainer as dt
        from vqnerf_release_torch.train import loop

        self.loop, self.decomp_lr = loop, dt.decomp_lr
        mc = self.model_cfg
        fields = dc.DecompConfig.__dataclass_fields__
        self.cfg = cfg = dc.DecompConfig(
            **{k: v for k, v in mc.items() if k in fields})
        dev = self.device
        scene = self.config["scene"]
        self.views = inputs.sphere_views(
            scene["n_train_views"], cfg.imh, cfg.imh, cfg.light_h,
            inputs.seed32(self.seed, 1), dev)
        self.weights = ref.make_weights(mc, inputs.seed32(self.seed, 2), dev)

        gen = torch.Generator().manual_seed(0)
        centers = np.zeros((cfg.num_embed, cfg.z_dim), np.float32)
        model = init_vq_nfr(gen, cfg, init_nfr_unit(gen, cfg), centers)[0]
        model = model.to(dev)
        model.load_state_dict(self.weights)
        self.model = model
        lxyz, lareas = dc.light_constants(cfg, dev)
        self.opt, step_fn = dt.make_vq_nfr_step(model, cfg, lxyz, lareas)

        _, self.store = loop._make_batch_source(self.views, cfg, "random",
                                                dev)
        scan_on = loop._resolve_epoch_scan(cfg, self.store)
        if not scan_on:
            raise RuntimeError("the program does not take the scanned "
                               "dispatch for this configuration")
        if loop._resolve_device_sampling(cfg, self.store, self.views,
                                         "random") is not None:
            raise NotImplementedError("the check reads the host sampler's "
                                      "ray pairs")
        self.n_views = k = len(self.views)
        self.rows_per_step = 2 * cfg.n_rays_per_step
        self.chunk = loop._resolve_scan_chunk(cfg, scan_on)  # epochs
        self.period = loop.cfg_ckpt_period(cfg)
        self.roll_seed = inputs.seed32(self.seed, 4)
        self.steps = loop._VqSteps(
            step_fn, init_vq_ema_state(cfg.z_dim, cfg.num_embed, dev),
            torch.as_tensor(cfg.train_thres(), device=dev),
            torch.Generator(device=dev).manual_seed(self.roll_seed))
        self.scan = self.steps.scan(self.store, self.chunk * k,
                                    cfg.n_rays_per_step, None)
        self.rng = np.random.RandomState(inputs.seed32(self.seed, 3))
        self.step = 0

        # the checked steps: one dispatch of one step, then one of two
        names = [n for n, _ in model.named_parameters()]
        sizes = [p.numel() for _, p in model.named_parameters()]
        xs = self._first_steps(1)
        self.checked_pix = list(xs["pix"])
        losses = [self._dispatch(xs).clone()]  # the rows are reused
        m = self.opt.state["m"].detach().clone()
        xs = self._first_steps(CHECKED_STEPS - 1)
        self.checked_pix += list(xs["pix"])
        losses.append(self._dispatch(xs).clone())
        self.prog = {
            "loss": torch.cat(losses)[:, self.scan.keys.index("loss")]
            .double().cpu().tolist(),
            "grad1": {n: (g / (1 - ref.B1)).view_as(p) for n, g, p in
                      zip(names, m.split(sizes), model.parameters())},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()}}
        # warm-up: one chunk through the program's loop, the window's shapes
        self.epoch = 0
        self._loop(self.chunk, lambda *a: None)

    def _first_steps(self, n):
        """The host half of a dispatch of the first ``n`` steps of an epoch,
        as ``loop._epoch_scan_xs`` makes a whole epoch's."""
        steps = self.step + np.arange(n)
        vi = steps % self.n_views
        lrs = np.asarray([self.decomp_lr(int(s), self.cfg) for s in steps],
                         np.float32)
        pix = np.stack(self.loop.sample_view_pix_many(
            [self.views[i] for i in vi], self.cfg.n_rays_per_step, self.rng,
            jitter_mode="random"))
        return {"vi": vi, "lrs": lrs, "pix": pix}

    def _dispatch(self, xs):
        n, rows = self.steps.dispatch(self.scan, xs)
        self.step += n
        return rows

    def _loop(self, epochs, post_epoch, sample_s=None):
        """The program's chunk loop from ``self.epoch`` up to ``epochs``,
        with ``loop._train_epochs``'s callbacks; ``sample_s`` collects the
        host clock of every chunk's sampling."""
        loop, k = self.loop, self.n_views

        def sample_xs(n_ep):
            t = time.perf_counter()
            xs = loop._epoch_scan_xs(self.views, self.cfg, self.rng,
                                     "random", self.step, n_ep)
            if sample_s is not None:
                sample_s.append(time.perf_counter() - t)
            return xs, None

        def fetch(rows, n_ep):
            return loop._split_epochs(
                loop._rows_to_dicts(rows, self.scan.keys), n_ep, k)

        loop._scan_epoch_loop(self.epoch, epochs, self.period, self.chunk,
                              sample_xs, self._dispatch, fetch, post_epoch)
        self.epoch = epochs

    # ------------------------------------------------------------ window
    def window(self, seconds, tracer=None):
        """Chunks of the program's loop until ``seconds`` have passed. With
        ``tracer``, the slice is the ``trace_chunks`` chunks after the first
        ``trace_skip``; the rate of operations is taken over the rest of the
        window."""
        flops_step = counts.vq_train_step_flops(self.model_cfg,
                                                self.rows_per_step)
        start_at = int(self.mix["trace_skip"])
        stop_at = start_at + int(self.mix["trace_chunks"])
        st = {"steps": 0, "failed": 0.0, "chunks": 0, "traced": None}
        sample_s = []

        def post_epoch(e1, loss_dicts, wall_s, state_epoch=None,
                       rng_state=None):
            st["steps"] += len(loss_dicts)
            st["failed"] += sum(d["nonfinite_grads"] for d in loss_dicts)
            if e1 != state_epoch:  # not the last epoch of its chunk
                return
            st["chunks"] += 1
            now = time.perf_counter()
            if tracer is not None and st["chunks"] == start_at:
                tracer.start()
                st["traced"] = (st["steps"], time.perf_counter())
            if tracer is not None and st["chunks"] == stop_at:
                done = st["steps"] - st["traced"][0]
                tracer.stop({"steps": done, "flops": done * flops_step})
                st["traced"] = (done, time.perf_counter() - st["traced"][1])
            if now - t0 >= seconds and (tracer is None
                                        or st["chunks"] >= stop_at):
                st["window_s"] = time.perf_counter() - t0
                raise _WindowClosed

        t0 = time.perf_counter()
        try:
            self._loop(1 << 40, post_epoch, sample_s)
        except _WindowClosed:
            pass
        window_s, steps = st["window_s"], st["steps"]
        # the last chunk's sampling is for a chunk the window never runs
        spans = {"sample_s": sample_s[:st["chunks"]]}
        if st["traced"] is not None:
            spans["flops_per_s"] = ((steps - st["traced"][0]) * flops_step
                                    / (window_s - st["traced"][1]))
        return {"attempted": steps, "failed": int(round(st["failed"])),
                "metrics": {self.mix["metric"]:
                            steps * self.rows_per_step / window_s},
                "spans": spans}

    # ------------------------------------------------------------- check
    def release(self):
        """Free the program's state before the reference runs."""
        del self.scan, self.steps, self.opt, self.model, self.store
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batches(self):
        keys = ("rayo", "rgb", "alpha", "xyz", "normal", "lvis")
        out = []
        for s, pix in enumerate(self.checked_pix):
            v = self.views[s % self.n_views]
            out.append({k: torch.as_tensor(getattr(v, k)[pix],
                                           device=self.device) for k in keys})
        return out

    def _pairs_bad(self):
        """Ray pairs of the checked steps that break the sampler's contract:
        an interior foreground pixel and one of its 8 neighbours, both of
        alpha above 0.9."""
        bad = 0
        for s, pix in enumerate(self.checked_pix):
            v = self.views[s % self.n_views]
            y, x = pix // v.w, pix % v.w
            a = v.alpha[:, 0]
            dy = np.abs(y[0::2] - y[1::2])
            dx = np.abs(x[0::2] - x[1::2])
            ok = ((pix >= 0) & (pix < v.h * v.w)).all()
            if not ok:
                bad += len(pix) // 2
                continue
            good = ((y[0::2] >= 1) & (y[0::2] <= v.h - 2) & (x[0::2] >= 1)
                    & (x[0::2] <= v.w - 2) & (dy <= 1) & (dx <= 1)
                    & (dy + dx > 0) & (a[pix[0::2]] > 0.9)
                    & (a[pix[1::2]] > 0.9))
            bad += int((~good).sum())
        return bad

    def reference(self, lowp=False, keep_rows=None):
        """The reference's three steps from the same weights, rows, learning
        rates and dropout draws."""
        gen = torch.Generator(device=self.device).manual_seed(self.roll_seed)
        k = self.model_cfg["num_embed"]
        rolls = [torch.rand((1, k), generator=gen, device=self.device)
                 for _ in range(CHECKED_STEPS)]
        lrs = [float(np.float32(self.decomp_lr(s, self.cfg)))
               for s in range(CHECKED_STEPS)]
        return ref.train_steps(self.weights, self._batches(), lrs, rolls,
                               self.model_cfg, lowp=lowp,
                               keep_rows=keep_rows)

    def check(self, side=None):
        """The numbers that decide ``correct``, each with its limit. ``side``
        (the benchmark's control and planted faults) puts a variant of the
        reference in the program's place: "lowp" (TF32) or "half_batch"."""
        exact = self.reference()
        if side is None:
            prog = self.prog
        elif side == "lowp":
            prog = self.reference(lowp=True)
        elif side == "half_batch":
            prog = self.reference(keep_rows=self.rows_per_step // 2)
        else:
            raise ValueError(side)
        self.detail = {}
        nums = compare(prog, exact, self.weights,
                       change_by=self.mix.get("change_by", "worst"),
                       detail=self.detail)
        nums["pairs_bad"] = float(self._pairs_bad())
        limits = self.mix["limits"]
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in nums.items()]
