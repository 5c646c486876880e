"""Generator of relighting traffic: ``run_test``'s relight pass without its
PNG writes, one client in a closed loop.

Set-up makes the weights (``reference.decomp.make_weights``), ``n_test_views``
test views as device tensors (``inputs.sphere_view_tensors``) and the
probes and OLATs (``inputs.probes``) from the seed, and builds the program's
model. A request is one whole view, drawn from the seed out of the staged
set: the program's ``vq_fast_render`` under every probe and OLAT, over the
view's rows in chunks of ``ray_chunk``, as ``run_test`` calls it; its outputs
stay on the device. A request's latency runs from its start to the device's
end of it (a synchronise); the next starts then. One request warms every
shape in set-up.

The check: the requests at ``sample`` positions of the window (drawn from
the seed before it, among the first ``sample_within``) keep their outputs;
once the window has closed, the reference renders the same views again and
the largest gap of any output value is compared.

The mix's keys: ``n_probes``, ``n_olats``, ``ray_chunk``, ``sample``,
``sample_within``, ``trace_requests`` (requests in the traced slice, after
``trace_skip``), ``limits``.
"""

import gc
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.counts import decomp as counts
from benchmark.reference import decomp as ref

SIDES = ("lowp", "altered")
_OUT_KEYS = ("basecolor", "albedo", "spec", "rough", "rgb", "rgb_probes",
             "rgb_olat")


class Driver:
    def __init__(self, config, mix, seed, device):
        self.config, self.mix, self.seed = config, mix, int(seed)
        self.model_cfg = config["model"]
        self.device = torch.device(device)

    def setup(self):
        from vqnerf_release_torch.models import decomp_common as dc
        from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
        from vqnerf_release_torch.models.vq_nfr import (init_vq_nfr,
                                                        vq_fast_render)
        mc, mix, dev = self.model_cfg, self.mix, self.device
        fields = dc.DecompConfig.__dataclass_fields__
        self.cfg = cfg = dc.DecompConfig(
            **{k: v for k, v in mc.items() if k in fields})
        n_views = self.config["scene"]["n_test_views"]
        gen = torch.Generator(device=dev).manual_seed(inputs.seed32(self.seed, 1))
        keys = ("rayo", "rgb", "alpha", "pred_alpha", "xyz", "normal",
                "lvis")
        self.views = []
        for i in range(n_views):
            t = inputs.sphere_view_tensors(i, n_views, cfg.imh, cfg.imh,
                                           cfg.light_h, gen, device=dev)
            self.views.append({k: t[k] for k in keys})
        self.probes, self.olats = inputs.probes(
            mix["n_probes"], mix["n_olats"], cfg.light_h,
            inputs.seed32(self.seed, 2), dev)
        self.weights = ref.make_weights(mc, inputs.seed32(self.seed, 3), dev)
        g = torch.Generator().manual_seed(0)
        centers = np.zeros((cfg.num_embed, cfg.z_dim), np.float32)
        model = init_vq_nfr(g, cfg, init_nfr_unit(g, cfg), centers)[0]
        model = model.to(dev)
        model.load_state_dict(self.weights)
        model.eval()
        self.model = model
        lxyz, lareas = dc.light_constants(cfg, dev)
        chunk = int(mix["ray_chunk"])

        @torch.inference_mode()
        def serve(view):
            n = view["xyz"].shape[0]
            preds = [vq_fast_render(model, {k: v[i:i + chunk]
                                            for k, v in view.items()},
                                    cfg, lxyz, lareas,
                                    novel_probes=self.probes,
                                    novel_olat=self.olats)
                     for i in range(0, n, chunk)]
            return {k: torch.cat([p[k] for p in preds]) for k in _OUT_KEYS}

        self.serve = serve
        rng = np.random.RandomState(inputs.seed32(self.seed, 4))
        self.order = rng.randint(0, n_views, size=1 << 16)
        self.sample = sorted(rng.choice(int(mix["sample_within"]),
                                        size=int(mix["sample"]),
                                        replace=False).tolist())
        self.kept = {}
        self.serve(self.views[0])  # warm-up: every chunk shape
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def window(self, seconds, tracer=None):
        """Requests until ``seconds`` have passed and every sampled one has
        come. With ``tracer``, the slice is the ``trace_requests`` requests
        after the first ``trace_skip``; the rate of operations is taken over
        the rest of the window."""
        cuda = self.device.type == "cuda"
        rows = self.views[0]["xyz"].shape[0]
        flops_req = counts.relight_view_flops(
            self.model_cfg, rows, self.mix["n_probes"] + self.mix["n_olats"])
        start_at = int(self.mix["trace_skip"])
        stop_at = start_at + int(self.mix["trace_requests"])
        lat, failed, i = [], 0, 0
        traced = None  # (requests, seconds) of the slice
        t0 = time.perf_counter()
        while True:
            if tracer is not None and i == start_at:
                tracer.start()
                traced = (i, time.perf_counter())
            ts = time.perf_counter()
            out = self.serve(self.views[self.order[i]])
            if cuda:
                torch.cuda.synchronize(self.device)
            lat.append(time.perf_counter() - ts)
            failed += not all(bool(torch.isfinite(out[k]).all()) for k in
                              ("rgb", "rgb_probes", "rgb_olat"))
            if i in self.sample:
                self.kept[i] = out
            del out
            i += 1
            if tracer is not None and i == stop_at:
                done = i - traced[0]
                tracer.stop({"requests": done, "flops": done * flops_req})
                traced = (done, time.perf_counter() - traced[1])
            # past the window, on until every sampled request has come (a
            # minute at most: a request that never comes is missing)
            late = time.perf_counter() - t0 - seconds
            if late >= 0 and ((tracer is None or i >= stop_at)
                              and i > self.sample[-1] or late >= 60):
                break
        window_s = time.perf_counter() - t0
        p95 = float(np.percentile(np.asarray(lat) * 1e3, 95))
        spans = {}
        if traced is not None:
            spans["flops_per_s"] = ((i - traced[0]) * flops_req
                                    / (window_s - traced[1]))
        return {"attempted": i, "failed": failed,
                "metrics": {"relight_views_per_s": i / window_s,
                            "relight_p95_ms": p95},
                "spans": spans}

    def release(self):
        del self.model, self.serve
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, i, lowp=False):
        view = self.views[self.order[i]]
        chunk = int(self.mix["ray_chunk"])
        n = view["xyz"].shape[0]
        parts = [ref.fast_render(self.weights, {k: v[j:j + chunk]
                                                for k, v in view.items()},
                                 self.probes, self.olats, self.model_cfg,
                                 lowp=lowp)
                 for j in range(0, n, chunk)]
        return {k: torch.cat([p[k] for p in parts]) for k in _OUT_KEYS}

    def check(self, side=None):
        """max_gap_maps: the largest gap of the BRDF maps (basecolor,
        albedo, spec, rough); max_gap_render: of the sRGB renders under the
        learned light, the probes and the OLATs; missing: sampled requests
        that never completed. ``side`` puts a variant of the reference in
        the program's place: "lowp" (TF32) or "altered" (one output value
        changed where it is produced)."""
        gaps = {"max_gap_maps": 0.0, "max_gap_render": 0.0}
        missing = 0
        for i in self.sample:
            if side is None:
                if i not in self.kept:
                    missing += 1
                    continue
                got = self.kept[i]
            else:
                got = self._reference(i, lowp=side == "lowp")
                if side == "altered":
                    got["rgb_probes"].view(-1)[7] += 0.25
            want = self._reference(i)
            for k in _OUT_KEYS:
                g = float((got[k] - want[k]).abs().max())
                name = "max_gap_render" if k.startswith("rgb") \
                    else "max_gap_maps"
                gaps[name] = max(gaps[name], g)
        nums = dict(gaps, missing=float(missing))
        limits = self.mix["limits"]
        return [{"name": k, "value": v, "limit": limits[k]}
                for k, v in nums.items()]
