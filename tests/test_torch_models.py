"""The port's stage-2 models against the JAX package's, on the CPU.

Parameters are made by the JAX init functions and converted with
``interop.jax_params.from_jax``; batches are seeded numpy. Tolerance
rtol=1e-4, atol=1e-5: MLPs, microfacet BRDF and a sum over L lights, fp32
on both sides, with sums taken in another order (and, on the fused path, a
Pallas kernel in interpret mode against the CUDA kernel's plain twin).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.models import ref_nfr as j_ref
from vqnerf_release_tpu.models import vq_nfr as j_vq
from vqnerf_release_tpu.models.nfr_unit import init_nfr_unit
from vqnerf_release_tpu.ops.light import olat_envmaps
from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models import ref_nfr as t_ref
from vqnerf_release_torch.models import vq_nfr as t_vq

RTOL, ATOL = 1e-4, 1e-5
SMALL = dict(light_h=2, num_embed=4, num_drop=2, z_dim=16, mlp_width=8,
             imh=16, thres_str="0.1;0.2")


@functools.lru_cache(maxsize=None)
def jax_params(data_type="nerf", seed=0, light_h=SMALL["light_h"]):
    """(nfr, vq, ref) JAX pytrees of numpy arrays at the small config
    (cached: callers convert them, never mutate them)."""
    cfg = j_dc.DecompConfig(**dict(SMALL, data_type=data_type,
                                   light_h=light_h))
    rs = np.random.RandomState(seed)
    nfr = init_nfr_unit(seed, cfg)
    if not cfg.is_nerf:
        nfr["gamma_bias"] = jnp.asarray([1.3])
        nfr["gamma_index"] = jnp.asarray([0.8])
    centers = rs.rand(cfg.num_embed, cfg.z_dim).astype(np.float32)
    vq, _ = j_vq.init_vq_nfr(seed, cfg, nfr, centers)
    light = (rs.rand(*cfg.light_res, 3) * 0.5).astype(np.float32)
    ref = j_ref.init_ref_nfr(seed, cfg, vq, light)
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    return to_np(nfr), to_np(vq), to_np(ref)


def batch_np(n, n_lights, seed=1):
    rs = np.random.RandomState(seed)
    normal = rs.randn(n, 3)
    alpha = (rs.rand(n, 1) > 0.2).astype(np.float32)
    b = dict(rayo=np.tile([0.0, 0.0, 3.0], (n, 1)) + 0.1 * rs.randn(n, 3),
             rayd=rs.randn(n, 3), xyz=rs.rand(n, 3) - 0.5,
             normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
             alpha=alpha, pred_alpha=alpha, rgb=rs.rand(n, 3),
             lvis=rs.rand(n, n_lights), ref=rs.rand(n, 3))
    return {k: v.astype(np.float32) for k, v in b.items()}


def _cfgs(data_type="nerf", **kw):
    return (j_dc.DecompConfig(data_type=data_type, **SMALL, **kw),
            t_dc.DecompConfig(data_type=data_type, **SMALL, **kw))


def _consts(jcfg, tcfg):
    jl = j_dc.light_constants(jcfg)
    tl = t_dc.light_constants(tcfg, "cpu")
    return jl, tl


def _compare(t_pred, j_pred, exact=()):
    assert set(t_pred) == set(j_pred)
    for k in j_pred:
        want = np.asarray(j_pred[k])
        got = t_pred[k].numpy()
        assert got.shape == want.shape, k
        if k in exact:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def _split(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


VQ_CASES = ["plain", "edit", "opt_scale", "vis_scale", "dst_env",
            "relight", "fused", "gen_embed", "real_data"]


@pytest.mark.parametrize("case", VQ_CASES)
def test_vq_fast_render_matches_jax(case):
    data_type = "hw" if case == "real_data" else "nerf"
    jcfg, tcfg = _cfgs(data_type, use_fused_render=(case == "fused"))
    _, vq_np, _ = jax_params(data_type)
    model = from_jax(vq_np, "vq_nfr")
    jvq = jax.tree_util.tree_map(jnp.asarray, vq_np)
    (jlxyz, jlareas), (tlxyz, tlareas) = _consts(jcfg, tcfg)
    n, l = 40, jcfg.n_lights
    b = batch_np(n, l)
    del b["ref"]
    jb, tb = _split(b)
    rs = np.random.RandomState(5)
    jkw, tkw = {}, {}

    def both(key, arr):
        jkw[key] = jnp.asarray(arr)
        tkw[key] = torch.from_numpy(np.asarray(arr, np.float32))

    if case == "edit":
        both("edit_mask", (rs.rand(n, 1) > 0.5).astype(np.float32))
        mat = {"diff": [0.2, 0.5, 0.7], "spec": [-1.0, 0.0, 0.0],
               "rough": [0.3]}
        jkw["edit_material"] = tkw["edit_material"] = mat
    elif case in ("opt_scale", "vis_scale"):
        both("opt_scale", np.array([1.2, 0.9, 1.05], np.float32))
        jkw["vis_scale"] = tkw["vis_scale"] = case == "vis_scale"
    elif case == "dst_env":
        both("dst_env", rs.rand(l, 3).astype(np.float32))
    elif case == "relight":
        both("novel_probes", rs.rand(3, l, 3).astype(np.float32))
        olats = olat_envmaps(jcfg.light_h)
        both("novel_olat", np.stack([v.reshape(-1, 3)
                                     for v in olats.values()]))
        both("opt_scale", np.array([1.2, 0.9, 1.05], np.float32))
    elif case == "gen_embed":
        jkw["gen_embed"] = tkw["gen_embed"] = True
    want = j_vq.vq_fast_render(jvq, jb, jcfg, jlxyz, jlareas, **jkw)
    with torch.inference_mode():
        got = t_vq.vq_fast_render(model, tb, tcfg, tlxyz, tlareas, **tkw)
    _compare(got, want, exact=("embed",))


@pytest.mark.parametrize("n_keep", [4, 2])
def test_vq_fast_embed_matches_jax(n_keep):
    jcfg, tcfg = _cfgs()
    _, vq_np, _ = jax_params()
    model = from_jax(vq_np, "vq_nfr")
    jvq = jax.tree_util.tree_map(jnp.asarray, vq_np)
    b = batch_np(300, jcfg.n_lights)
    jb, tb = _split(b)
    thres = np.array([0.0] * n_keep + [1.0] * (4 - n_keep), np.float32)
    want = j_vq.vq_fast_embed(jvq, jb, jcfg, thres=jnp.asarray(thres),
                              rng=jax.random.PRNGKey(0))
    with torch.inference_mode():
        got = t_vq.vq_fast_embed(model, tb, tcfg,
                                 thres=torch.from_numpy(thres),
                                 rng=torch.Generator().manual_seed(0))
    _compare(got, want, exact=("embed", "alpha"))
    assert got["embed"].max() <= n_keep


@pytest.mark.parametrize("case", ["plain", "relight", "fused", "edit",
                                  "real_data"])
def test_ref_fast_render_matches_jax(case):
    data_type = "hw" if case == "real_data" else "nerf"
    jcfg, tcfg = _cfgs(data_type, use_fused_render=(case == "fused"))
    _, _, ref_np = jax_params(data_type)
    model = from_jax(ref_np, "ref_nfr")
    jref = jax.tree_util.tree_map(jnp.asarray, ref_np)
    (jlxyz, jlareas), (tlxyz, tlareas) = _consts(jcfg, tcfg)
    n, l = 40, jcfg.n_lights
    jb, tb = _split(batch_np(n, l))
    rs = np.random.RandomState(6)
    jkw, tkw = {}, {}
    if case == "relight":
        probes = rs.rand(2, l, 3).astype(np.float32)
        scale = np.array([1.1, 0.8, 1.0], np.float32)
        jkw = dict(novel_probes=jnp.asarray(probes),
                   opt_scale=jnp.asarray(scale))
        tkw = dict(novel_probes=torch.from_numpy(probes),
                   opt_scale=torch.from_numpy(scale))
    elif case == "edit":
        em = (rs.rand(n, 1) > 0.5).astype(np.float32)
        mat = {"diff": [0.2, 0.5, 0.7], "spec": [0.1, 0.1, 0.1],
               "rough": [-1.0]}
        jkw = dict(edit_mask=jnp.asarray(em), edit_material=mat)
        tkw = dict(edit_mask=torch.from_numpy(em), edit_material=mat)
    want = j_ref.ref_fast_render(jref, jb, jcfg, jlxyz, jlareas, **jkw)
    with torch.inference_mode():
        got = t_ref.ref_fast_render(model, tb, tcfg, tlxyz, tlareas, **tkw)
    _compare(got, want)


def _assert_tree_equal(a, b, path="root"):
    assert type(a) is type(b) or not isinstance(a, (dict, list)), path
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}/{i}")
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), path)


@pytest.mark.parametrize("kind,data_type", [
    ("nfr_unit", "nerf"), ("vq_nfr", "nerf"), ("ref_nfr", "nerf"),
    ("vq_nfr", "hw")])
def test_jax_params_round_trip(kind, data_type):
    nfr, vq, ref = jax_params(data_type)
    tree = {"nfr_unit": nfr, "vq_nfr": vq, "ref_nfr": ref}[kind]
    _assert_tree_equal(to_jax(from_jax(tree, kind), kind), tree)


def test_port_init_matches_jax_param_tree():
    """The port's init builds the JAX pytree's structure and shapes."""
    from vqnerf_release_torch.models.nfr_unit import init_nfr_unit as t_init
    jcfg, tcfg = _cfgs()
    nfr_j, vq_j, ref_j = jax_params()
    gen = torch.Generator().manual_seed(0)
    nfr = t_init(gen, tcfg)
    vq, ema = t_vq.init_vq_nfr(gen, tcfg, nfr,
                               torch.rand((tcfg.num_embed, tcfg.z_dim),
                                          generator=gen))
    ref = t_ref.init_ref_nfr(gen, tcfg, vq, vq.light.detach())
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)  # noqa: E731
    for mine, theirs, kind in ((nfr, nfr_j, "nfr_unit"), (vq, vq_j, "vq_nfr"),
                               (ref, ref_j, "ref_nfr")):
        assert shapes(to_jax(mine, kind)) == shapes(theirs), kind
    assert ema.hidden_dw.shape == (tcfg.z_dim, tcfg.num_embed)
    # vq_nfr's copies of the nfr_unit parts are copies, not shared
    assert vq.fine_enc.layers[0].weight is not nfr.fine_enc.layers[0].weight


def test_decomp_config_matches_jax():
    j_fields = {f.name: f.default for f in dataclasses.fields(
        j_dc.DecompConfig)}
    t_fields = {f.name: f.default for f in dataclasses.fields(
        t_dc.DecompConfig)}
    assert list(t_fields) == list(j_fields)
    assert t_fields == j_fields
    j, t = j_dc.DecompConfig(), t_dc.DecompConfig()
    assert (t.light_res, t.is_nerf, t.n_lights) == (
        j.light_res, j.is_nerf, j.n_lights)
