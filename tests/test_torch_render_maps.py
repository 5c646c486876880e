"""The multi-map render (kernels/render.py::fused_brdf_render_maps, its op
ops/render.py::fused_render_maps) and vq_fast_render's relight through it,
on the CPU.

The multi-map kernel renders a relight request's learned light, probes and
OLATs in one launch: a ray-light pair's BRDF once, added into every map. Its
plain twin (the plain relight path it replaces) and its regrouped twin (the
kernel's FMAs, approximate operations and order of the sum over L, as kernel
1's, with the plain path's rounding of the chain into the GGX term) are held
here to the plain path that vq_fast_render took before, ``render_equation``
over ``microfacet_brdf`` (one map, and a stack with ``probe_batch``), at
kernel 1's tolerance. The card's kernel is held to the plain twin in
tests/test_torch_cuda.py.

Tolerance rtol=2e-4, atol=1e-5: the render kernel's (the JAX kernel test's
own, for a sum over L in another order). Roughness from 0.05 to 0.95.
"""

import numpy as np
import pytest
import torch

from vqnerf_release_torch.kernels import render as kr
from vqnerf_release_torch.models import decomp_common as dc
from vqnerf_release_torch.models import vq_nfr
from vqnerf_release_torch.models.nfr_unit import init_nfr_unit
from vqnerf_release_torch.ops import render as ops_render
from vqnerf_release_torch.ops.light import gen_light_xyz
from vqnerf_release_torch.ops.microfacet import microfacet_brdf
from vqnerf_release_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 2e-4, 1e-5
GAMMA = (torch.tensor([1.2]), torch.tensor([0.9]))


def _inputs(n, n_lights, n_maps, seed=0):
    """n rays against the first ``n_lights`` lights of a 16 x 32 map, and
    ``n_maps`` maps: a sky with a bright sun, and OLATs of 200 (the relight
    traffic's kinds)."""
    rs = np.random.RandomState(seed)
    lxyz, lareas = gen_light_xyz(16, 32)
    normal = rs.randn(n, 3)
    surf2c = rs.randn(n, 3)
    maps = rs.rand(n_maps, n_lights, 3) * 0.5
    for e in range(n_maps):
        if e % 3 == 2:  # an OLAT
            maps[e] = 0.0
            maps[e, rs.randint(n_lights)] = 200.0
        else:
            maps[e, rs.randint(n_lights)] += 20.0 * rs.rand(3)
    arrays = dict(
        xyz=rs.rand(n, 3) - 0.5,
        normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        surf2c=surf2c / np.linalg.norm(surf2c, axis=1, keepdims=True),
        albedo=rs.rand(n, 3), rough=0.05 + 0.9 * rs.rand(n, 1),
        f0=rs.rand(n, 3), lvis=rs.rand(n, n_lights),
        lxyz=lxyz.reshape(-1, 3)[:n_lights],
        lareas=lareas.reshape(-1)[:n_lights], maps=maps)
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in arrays.items()}


_PER_RAY = ("xyz", "normal", "surf2c", "albedo", "rough", "f0")


def _plain(t, lvis, gamma):
    """vq_fast_render's plain path: [N, E, 3] after gamma and the clip."""
    surf2l = dc.calc_ldir(t["lxyz"], t["xyz"])
    brdf, _, _ = microfacet_brdf(surf2l, t["surf2c"], t["normal"],
                                 albedo=t["albedo"], rough=t["rough"],
                                 f0=t["f0"])
    return ops_render.render_equation(
        brdf, surf2l, t["normal"], t["lareas"], t["maps"], light_vis=lvis,
        gamma=gamma, probe_batch=True), (brdf, surf2l)


def _assert_within(got, want):
    assert got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert not (err > ATOL + RTOL * want.abs()).any(), float(err.max())


@pytest.mark.parametrize("twin", ["plain", "regrouped"])
@pytest.mark.parametrize("gamma", [False, True])
@pytest.mark.parametrize("with_lvis", [True, False])
@pytest.mark.parametrize("n_lights", [512, 510])
@pytest.mark.parametrize("n_maps", [1, 21])
def test_maps_twins_match_render_equation(n_maps, n_lights, with_lvis, gamma,
                                          twin):
    """Both twins against render_equation under one map (the learned
    light's call) and under the stack (``probe_batch``), with and without
    lvis, with the learned gamma of non-'nerf' data, at an L that is and
    one that is no multiple of four (the scalar instance's order)."""
    t = _inputs(48, n_lights, n_maps, seed=n_maps + n_lights)
    lvis = t["lvis"] if with_lvis else None
    gamma = GAMMA if gamma else None
    want, (brdf, surf2l) = _plain(t, lvis, gamma)
    table = kr.pack_light_maps(t["lxyz"], t["lareas"], t["maps"])
    args = [t[k] for k in _PER_RAY] + [lvis, table]
    if twin == "plain":
        launches = dict(kr.LAUNCHES_BY_INSTANCE)
        got = ops_render.fused_render_maps(
            *[t[k] for k in _PER_RAY], lvis, t["lareas"], t["lxyz"],
            t["maps"], gamma=gamma)
        assert kr.LAUNCHES_BY_INSTANCE == launches  # CPU: the plain twin
    else:
        got = ops_render._finish(kr.fused_brdf_render_maps_regrouped(*args),
                                 gamma)
    _assert_within(got, want)
    one = ops_render.render_equation(brdf, surf2l, t["normal"], t["lareas"],
                                     t["maps"][0], light_vis=lvis,
                                     gamma=gamma)
    _assert_within(got[:, 0], one)


def test_pack_light_maps_layout():
    t = _inputs(4, 32, 3)
    table = kr.pack_light_maps(t["lxyz"], t["lareas"], t["maps"])
    assert table.shape == (4 + 3 * 3, 32) and table.is_contiguous()
    np.testing.assert_array_equal(table[0:3].T.numpy(), t["lxyz"].numpy())
    np.testing.assert_array_equal(table[3].numpy(), t["lareas"].numpy())
    for e in range(3):
        np.testing.assert_array_equal(table[4 + 3 * e:7 + 3 * e].T.numpy(),
                                      t["maps"][e].numpy())


def _model_and_batch(data_type, n=40, light_h=16, seed=0):
    cfg = dc.DecompConfig(data_type=data_type, light_h=light_h, z_dim=16,
                          mlp_width=8, num_embed=4, num_drop=2)
    gen = torch.Generator().manual_seed(seed)
    nfr = init_nfr_unit(gen, cfg)
    centers = torch.rand((cfg.num_embed, cfg.z_dim), generator=gen)
    model, _ = vq_nfr.init_vq_nfr(gen, cfg, nfr, centers)
    if not cfg.is_nerf:
        with torch.no_grad():
            model.gamma_bias.fill_(1.1)
            model.gamma_index.fill_(0.8)
    rs = np.random.RandomState(seed + 1)
    normal = rs.randn(n, 3)
    batch = dict(
        rayo=np.tile([0.0, 0.0, 3.0], (n, 1)), xyz=rs.rand(n, 3) - 0.5,
        normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        alpha=(rs.rand(n, 1) > 0.2), lvis=rs.rand(n, cfg.n_lights))
    batch = {k: torch.as_tensor(np.asarray(v, np.float32))
             for k, v in batch.items()}
    return cfg, model, batch


_MAP_KEYS = ("alpha", "basecolor", "albedo", "spec", "rough")


@pytest.mark.parametrize("case", ["probes_olat", "probes", "olat",
                                  "dst_env", "opt_scale", "edit",
                                  "real_data"])
def test_vq_fast_render_relight_fused_matches_plain(case, monkeypatch):
    """vq_fast_render with probes and OLATs through the multi-map path
    (``use_fused_render`` on, so CPU tensors take its plain twin) against
    the plain path: the maps bit for bit, every render within the
    tolerance; one counter call a render with the path and its maps."""
    cfg, model, batch = _model_and_batch(
        "hw" if case == "real_data" else "nerf")
    l = cfg.n_lights
    rs = np.random.RandomState(3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    probes = f32(rs.rand(16, l, 3) * 0.5 + 0.1)
    olats = torch.zeros((4, l, 3))
    for k in range(4):
        olats[k, 64 + 8 * k] = 200.0
    kw = {"probes": dict(novel_probes=probes),
          "olat": dict(novel_olat=olats),
          "dst_env": dict(novel_probes=probes,
                          dst_env=f32(rs.rand(l, 3)))}.get(
        case, dict(novel_probes=probes, novel_olat=olats))
    if case == "opt_scale":
        kw["opt_scale"] = f32([1.2, 0.9, 1.05])
    if case == "edit":
        kw["edit_mask"] = f32(rs.rand(40, 1) > 0.5)
        kw["edit_material"] = {"diff": [0.2, 0.5, 0.7],
                               "spec": [0.04, 0.04, 0.04], "rough": [0.3]}
    calls = []
    monkeypatch.setattr(profiling, "count",
                        lambda name, n=1: calls.append((name, n)))
    lxyz, lareas = dc.light_constants(cfg, "cpu")
    out = {}
    for fused in (True, False):
        c = dc.DecompConfig(**{**cfg.__dict__, "use_fused_render": fused})
        with torch.inference_mode():
            out[fused] = vq_nfr.vq_fast_render(model, batch, c, lxyz, lareas,
                                               **kw)
    n_maps = 1 + sum(kw[k].shape[0] for k in ("novel_probes", "novel_olat")
                     if k in kw)
    assert calls == [("render.relight_fused", 1),
                     ("render.relight_fused.maps", n_maps),
                     ("render.relight_plain", 1),
                     ("render.relight_plain.maps", n_maps)]
    got, want = out[True], out[False]
    assert list(got) == list(want)
    for k in _MAP_KEYS:
        assert torch.equal(got[k], want[k]), k
    for k in ("rgb", "rgb_probes", "rgb_olat"):
        if k in want:
            _assert_within(got[k], want[k])
    assert ("rgb_probes" in got) == ("novel_probes" in kw)
    assert ("rgb_olat" in got) == ("novel_olat" in kw)


def test_vq_fast_render_without_maps_counts_nothing(monkeypatch):
    """A render without probes or OLATs is no relight: no counter call,
    and the fused path's learned-light render matches the plain one."""
    cfg, model, batch = _model_and_batch("nerf", light_h=4)
    calls = []
    monkeypatch.setattr(profiling, "count",
                        lambda name, n=1: calls.append((name, n)))
    lxyz, lareas = dc.light_constants(cfg, "cpu")
    out = {}
    for fused in (True, False):
        c = dc.DecompConfig(**{**cfg.__dict__, "use_fused_render": fused})
        with torch.inference_mode():
            out[fused] = vq_nfr.vq_fast_render(model, batch, c, lxyz, lareas)
    assert calls == []
    _assert_within(out[True]["rgb"], out[False]["rgb"])


def test_vq_fast_render_relight_on_the_cpu_never_captures(monkeypatch):
    """A relight call on the CPU (the fused render on, probes and OLATs
    given) never reaches the CUDA graphs, under inference mode, under
    no_grad or with grad on: the same outputs bit for bit in all three, in
    the order they always had, with the caller's alpha."""
    cfg, model, batch = _model_and_batch("nerf", light_h=4)
    batch["pred_alpha"] = batch["alpha"].clone()
    l = cfg.n_lights
    probes = torch.rand((16, l, 3), generator=torch.Generator().manual_seed(2))
    olats = torch.zeros((4, l, 3))
    olats[:, 5] = 200.0

    def no_graph(*args, **kw):
        raise AssertionError("a CPU call reached the CUDA graphs")

    monkeypatch.setattr(vq_nfr, "_RELIGHT_GRAPHS", no_graph)
    c = dc.DecompConfig(**{**cfg.__dict__, "use_fused_render": True})
    lxyz, lareas = dc.light_constants(c, "cpu")
    out = {}
    for mode in (torch.inference_mode, torch.no_grad, torch.enable_grad):
        with mode():
            out[mode] = vq_nfr.vq_fast_render(
                model, batch, c, lxyz, lareas, novel_probes=probes,
                novel_olat=olats)
    want = out[torch.enable_grad]
    assert want["rgb"].requires_grad
    for got in out.values():
        assert got["alpha"] is batch["pred_alpha"]
        assert list(got) == ["alpha", "basecolor", "albedo", "spec", "rough",
                             "rgb", "rgb_probes", "rgb_olat"]
        for k, v in want.items():
            assert torch.equal(got[k], v), k
