"""The port's nfr_unit and vq_nfr training forwards, losses and gradients
against the JAX package's, on the CPU.

Parameters come from the JAX init, converted by ``from_jax``; the batch is
seeded numpy with background rows (alpha 0) and jitter pairs. Values: rtol
1e-5 with atol 1e-6, and rtol 1e-4 / atol 1e-5 on what passes through the
GGX BRDF and the sum over the lights (the conditioning note of
tests/test_torch_ops.py). Gradients of the loss for every parameter leaf
against ``jax.grad``: rtol 1e-4, atol 1e-7.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import SMALL, batch_np, jax_params
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.models import nfr_unit as j_nfr
from vqnerf_release_tpu.models import vq_nfr as j_vq
from vqnerf_release_tpu.ops.vq import VqEmaState as JVqEmaState
from vqnerf_release_torch.interop.jax_params import (ema_from_jax, from_jax,
                                                     to_jax)
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models import nfr_unit as t_nfr
from vqnerf_release_torch.models import vq_nfr as t_vq


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RENDERED = ("rgb", "rgb_diff", "rgb_spec", "vq_rgb", "rgb_pred_linear",
            "vq_rgb_linear")
N = 24  # 12 jitter pairs


def _cfgs(data_type, **kw):
    return (j_dc.DecompConfig(data_type=data_type, **SMALL, **kw),
            t_dc.DecompConfig(data_type=data_type, **SMALL, **kw))


def _batches(jcfg):
    b = batch_np(N, jcfg.n_lights)
    del b["ref"]
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _compare(got, want, exact=()):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape, k
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        elif k in RENDERED:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=k)


def _grads_as_jax(model, kind):
    holder = copy.deepcopy(model)
    with torch.no_grad():
        for h, p in zip(holder.parameters(), model.parameters()):
            h.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return to_jax(holder, kind)


def _compare_grads(model, kind, want):
    g_leaves, g_def = jax.tree_util.tree_flatten(_grads_as_jax(model, kind))
    w_leaves, w_def = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert g_def == w_def
    assert any(np.abs(w).max() > 0 for _, w in w_leaves)
    for g, (path, w) in zip(g_leaves, w_leaves):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(w).all(), name
        # gamma_index: one scalar, the sum of N x 3 signed terms
        # x^g log(x) (pred - gt) that cancels to a few thousandths of their
        # size, so fp32 rounding shows at 1e-6; in float64 the port gives
        # the JAX value
        atol = 5e-6 if "gamma_index" in name else 1e-7
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=name)


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
@pytest.mark.parametrize("mode", ["train", "vali"])
def test_nfr_unit_forward_and_loss_match_jax(data_type, mode):
    jcfg, tcfg = _cfgs(data_type)
    nfr_np, _, _ = jax_params(data_type)
    model = from_jax(nfr_np, "nfr_unit")
    jb, tb = _batches(jcfg)
    jl = j_dc.light_constants(jcfg)
    tl = t_dc.light_constants(tcfg, "cpu")
    j_pred, j_aux = j_nfr.nfr_unit_forward(_tree(nfr_np), jb, jcfg, *jl,
                                           mode=mode)
    t_pred, t_aux = t_nfr.nfr_unit_forward(model, tb, tcfg, *tl, mode=mode)
    _compare(t_pred, j_pred, exact=("alpha",))
    _compare(t_aux, j_aux, exact=("mask", "rgb_gt"))
    j_loss, j_ld = j_nfr.nfr_unit_loss(j_aux, jcfg, mode=mode)
    t_loss, t_ld = t_nfr.nfr_unit_loss(t_aux, tcfg, mode=mode)
    assert set(t_ld) == set(j_ld)
    for k in j_ld:
        np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)


def test_nfr_unit_light_override_matches_jax():
    jcfg, tcfg = _cfgs("nerf")
    nfr_np, _, _ = jax_params("nerf")
    light = np.random.RandomState(2).rand(*jcfg.light_res, 3).astype(
        np.float32)
    jb, tb = _batches(jcfg)
    j_pred, _ = j_nfr.nfr_unit_forward(
        _tree(nfr_np), jb, jcfg, *j_dc.light_constants(jcfg), mode="vali",
        light_override=jnp.asarray(light))
    t_pred, _ = t_nfr.nfr_unit_forward(
        from_jax(nfr_np, "nfr_unit"), tb, tcfg,
        *t_dc.light_constants(tcfg, "cpu"), mode="vali",
        light_override=torch.from_numpy(light))
    _compare(t_pred, j_pred, exact=("alpha",))


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
def test_nfr_unit_gradients_match_jax(data_type):
    jcfg, tcfg = _cfgs(data_type)
    nfr_np, _, _ = jax_params(data_type)
    model = from_jax(nfr_np, "nfr_unit")
    jb, tb = _batches(jcfg)
    jl = j_dc.light_constants(jcfg)

    def j_loss(params):
        _, aux = j_nfr.nfr_unit_forward(params, jb, jcfg, *jl, mode="train")
        return j_nfr.nfr_unit_loss(aux, jcfg, mode="train")[0]

    want = jax.grad(j_loss)(_tree(nfr_np))
    _, aux = t_nfr.nfr_unit_forward(
        model, tb, tcfg, *t_dc.light_constants(tcfg, "cpu"), mode="train")
    t_nfr.nfr_unit_loss(aux, tcfg, mode="train")[0].backward()
    _compare_grads(model, "nfr_unit", want)


def _vq_setup(data_type, fused):
    jcfg, tcfg = _cfgs(data_type, use_fused_vq=fused)
    _, vq_np, _ = jax_params(data_type)
    rs = np.random.RandomState(11)
    k, d = jcfg.num_embed, jcfg.z_dim
    j_ema = JVqEmaState(jnp.asarray(rs.rand(k).astype(np.float32) * 3),
                        jnp.asarray(rs.rand(d, k).astype(np.float32)),
                        jnp.asarray(5, jnp.int32))
    roll = rs.rand(1, k).astype(np.float32)
    return jcfg, tcfg, vq_np, j_ema, ema_from_jax(j_ema), roll


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
@pytest.mark.parametrize("mode,fused", [
    ("train", False), ("train", True), ("vali", False)])
def test_vq_nfr_forward_and_loss_match_jax(monkeypatch, data_type, mode,
                                           fused):
    # the JAX switch is off under the test suite's 8 virtual devices
    monkeypatch.setattr(j_dc, "fused_vq_enabled",
                        lambda cfg: bool(cfg.use_fused_vq))
    jcfg, tcfg, vq_np, j_ema, t_ema, roll = _vq_setup(data_type, fused)
    model = from_jax(vq_np, "vq_nfr")
    jb, tb = _batches(jcfg)
    jl = j_dc.light_constants(jcfg)
    tl = t_dc.light_constants(tcfg, "cpu")
    thres = jcfg.train_thres() if mode == "train" else \
        jcfg.val_thres_list()[0]
    np.testing.assert_array_equal(
        thres, tcfg.train_thres() if mode == "train"
        else tcfg.val_thres_list()[0])
    j_pred, j_aux, j_new = j_vq.vq_nfr_forward(
        _tree(vq_np), j_ema, jb, jcfg, *jl, mode=mode,
        thres=jnp.asarray(thres), roll=jnp.asarray(roll))
    t_pred, t_aux, t_new = t_vq.vq_nfr_forward(
        model, t_ema, tb, tcfg, *tl, mode=mode,
        thres=torch.from_numpy(thres), roll=torch.from_numpy(roll))
    _compare(t_pred, j_pred, exact=("alpha", "embed"))
    _compare(t_aux, j_aux, exact=("mask", "rgb_gt", "usage"))
    for got, want in zip(t_new, j_new):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    j_loss, j_ld = j_vq.vq_nfr_loss(_tree(vq_np), j_aux, jcfg, mode=mode)
    t_loss, t_ld = t_vq.vq_nfr_loss(model, t_aux, tcfg, mode=mode)
    assert set(t_ld) == set(j_ld)
    if mode == "train":
        assert set(t_ld) == {"rgb", "vqrgb", "vqloss", "chromaticity",
                             "chr_smooth", "sim_smooth", "lambert", "loss"}
    for k in j_ld:
        np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
@pytest.mark.parametrize("fused", [False, True])
def test_vq_nfr_gradients_match_jax(monkeypatch, data_type, fused):
    monkeypatch.setattr(j_dc, "fused_vq_enabled",
                        lambda cfg: bool(cfg.use_fused_vq))
    jcfg, tcfg, vq_np, j_ema, t_ema, roll = _vq_setup(data_type, fused)
    model = from_jax(vq_np, "vq_nfr")
    jb, tb = _batches(jcfg)
    jl = j_dc.light_constants(jcfg)
    thres = jcfg.train_thres()

    def j_loss(params):
        _, aux, _ = j_vq.vq_nfr_forward(
            params, j_ema, jb, jcfg, *jl, mode="train",
            thres=jnp.asarray(thres), roll=jnp.asarray(roll))
        return j_vq.vq_nfr_loss(params, aux, jcfg, mode="train")[0]

    want = jax.grad(j_loss)(_tree(vq_np))
    _, aux, _ = t_vq.vq_nfr_forward(
        model, t_ema, tb, tcfg, *t_dc.light_constants(tcfg, "cpu"),
        mode="train", thres=torch.from_numpy(thres),
        roll=torch.from_numpy(roll))
    t_vq.vq_nfr_loss(model, aux, tcfg, mode="train")[0].backward()
    # the codebook's gradient is the sim term's alone
    assert float(model.codebook.grad.abs().max()) > 0
    _compare_grads(model, "vq_nfr", want)


@pytest.mark.parametrize("n_keep,chunk", [(4, None), (2, None), (2, 7)])
def test_vq_test_matches_jax(n_keep, chunk):
    """The lookup is one call; the render after it may be chunked with the
    same result."""
    jcfg, tcfg = _cfgs("nerf")
    _, vq_np, _ = jax_params("nerf")
    jb, tb = _batches(jcfg)
    thres = np.array([0.0] * n_keep + [1.0] * (4 - n_keep), np.float32)
    want = j_vq.vq_test(_tree(vq_np), jb, jcfg, *j_dc.light_constants(jcfg),
                        thres=jnp.asarray(thres), rng=jax.random.PRNGKey(0))
    with torch.inference_mode():
        got = t_vq.vq_test(from_jax(vq_np, "vq_nfr"), tb, tcfg,
                           *t_dc.light_constants(tcfg, "cpu"),
                           thres=torch.from_numpy(thres),
                           rng=torch.Generator().manual_seed(0),
                           render_chunk=chunk)
    _compare(got, want, exact=("mask", "rgb_gt", "usage"))
    assert got["usage"][n_keep:].sum() == 0
