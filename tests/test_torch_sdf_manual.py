"""models/sdf_manual.py (the SDF's hand-derived reverse-over-forward VJP)
against the port's nested autograd and the JAX package's sdf_vfg_manual,
on the CPU.

Parameters come from the JAX init through interop.jax_params, points from
a numpy seed. Tolerances: the manual forward's sdf and feature equal
sdf_value_feature_gradient's bit for bit, its grad within atol 1e-6;
gradients of a loss over all three outputs within atol 2e-5 of nested
autograd's after scaling each by its max (the JAX test's own). Against
JAX: values at rtol 1e-5 / atol 1e-6 and grad at rtol 1e-4 / atol 1e-5
(test_torch_fields.py's; the two softplus forms differ in the last bit),
and the VJP of fixed cotangents at scaled atol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import (nested_vfg, sdf_manual_against_nested,
                                   sdf_manual_loss)
from vqnerf_release_tpu.models import fields as jf
from vqnerf_release_tpu.models.sdf_manual import sdf_vfg_manual as j_manual
from vqnerf_release_torch.interop.jax_params import from_jax
from vqnerf_release_torch.models import fields as tf
from vqnerf_release_torch.models import sdf_manual
from vqnerf_release_torch.models.sdf_manual import sdf_vfg_manual


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BASE = dict(d_hidden=64, n_layers=4, d_out=65, multires=6, skip_in=(2,),
            scale=1.5)
CASES = {"jax_test": {}, "multires0": dict(multires=0),
         "skip_at_1": dict(skip_in=(1,))}
N = 48


def _case(name, seed=0):
    """(JAX params, port params, JAX cfg, port cfg, points [N, 3])."""
    kw = dict(BASE, **CASES[name])
    jcfg, tcfg = jf.SDFConfig(**kw), tf.SDFConfig(**kw)
    jp = jf.init_sdf(0, jcfg)
    tp = from_jax({"sdf": jax.tree_util.tree_map(np.asarray, jp),
                   "color": [], "variance": {"variance": 0.3}}, "neus").sdf
    x = np.random.RandomState(seed).rand(N, 3).astype(np.float32) - 0.5
    return jp, tp, jcfg, tcfg, x


def _cotangents(d_out):
    rs = np.random.RandomState(7)
    return (rs.randn(N, 1).astype(np.float32),
            rs.randn(N, d_out - 1).astype(np.float32),
            rs.randn(N, 3).astype(np.float32))


@pytest.fixture(scope="module")
def jax_vjps():
    """JAX's sdf_vfg_manual outputs and its VJP of _cotangents, per case,
    each one jitted call."""
    out = {}
    for name in CASES:
        jp, _, jcfg, _, x = _case(name)

        def fwd_vjp(p, x, cots, jcfg=jcfg):
            primals, vjp = jax.vjp(lambda p, x: j_manual(p, x, jcfg), p, x)
            return primals, vjp(cots)

        cots = tuple(jnp.asarray(c) for c in _cotangents(jcfg.d_out))
        primals, (p_bar, x_bar) = jax.jit(fwd_vjp)(jp, jnp.asarray(x), cots)
        out[name] = jax.tree_util.tree_map(np.asarray,
                                           (primals, p_bar, x_bar))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_equals_sdf_value_feature_gradient(case):
    _, tp, _, cfg, x = _case(case)
    x = torch.from_numpy(x)
    sdf, feat, grad = sdf_vfg_manual(tp, x, cfg)
    want_sdf, want_feat, want_grad = tf.sdf_value_feature_gradient(
        tp, x, cfg, create_graph=True)
    assert sdf.shape == (N, 1) and feat.shape == (N, cfg.d_out - 1)
    torch.testing.assert_close(sdf, want_sdf, rtol=0, atol=0)
    torch.testing.assert_close(feat, want_feat, rtol=0, atol=0)
    torch.testing.assert_close(grad, want_grad, rtol=0, atol=1e-6)
    with torch.no_grad():  # sdf_apply's channels, bit for bit
        full = tf.sdf_apply(tp, x, cfg)
    torch.testing.assert_close(torch.cat([sdf, feat], -1), full, rtol=0,
                               atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_nested_autograd(case):
    _, tp, _, cfg, x = _case(case, seed=1)
    _, err = sdf_manual_against_nested(tp, torch.from_numpy(x), cfg)
    assert err < 2e-5, err


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_vjp_match_jax(case, jax_vjps):
    _, tp, _, cfg, x = _case(case)
    (j_sdf, j_feat, j_grad), j_pbar, j_xbar = jax_vjps[case]
    xt = torch.from_numpy(x).requires_grad_(True)
    sdf, feat, grad = sdf_vfg_manual(tp, xt, cfg)
    for got, want in ((sdf, j_sdf), (feat, j_feat)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(grad.detach().numpy(), j_grad, rtol=1e-4,
                               atol=1e-5)
    names = [n for n, _ in tp.named_parameters()]
    cots = [torch.from_numpy(c) for c in _cotangents(cfg.d_out)]
    got = torch.autograd.grad((sdf, feat, grad),
                              list(tp.parameters()) + [xt], cots)
    want = [j_pbar[int(n.split(".")[0])][n.split(".")[1]] for n in names]
    for name, g, w in zip(names + ["x"], got, want + [j_xbar]):
        scale = np.abs(w).max() + 1e-8
        np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", ["jax_test", "multires0"])
def test_gradients_are_finite_far_from_the_surface(case):
    """Points up to 3 out, where softplus100 saturates: every gradient of
    the Eikonal loss alone and of the full loss is finite."""
    _, tp, _, cfg, _ = _case(case)
    x = torch.from_numpy(np.random.RandomState(3).randn(128, 3).astype(
        np.float32)).requires_grad_(True)
    sdf, feat, grad = sdf_vfg_manual(tp, x, cfg)
    eik = torch.mean((torch.linalg.norm(grad, dim=-1) - 1.0) ** 2)
    wrt = list(tp.parameters()) + [x]
    for loss in (eik, sdf_manual_loss(sdf, feat, grad)):
        assert torch.isfinite(loss)
        for g in torch.autograd.grad(loss, wrt, retain_graph=True):
            assert torch.isfinite(g).all()


@pytest.mark.parametrize("kw", [
    dict(d_hidden=12, n_layers=3, d_out=4, multires=1, skip_in=(2,),
         scale=1.5),
    dict(d_hidden=5, n_layers=2, d_out=3, multires=0, skip_in=(1,))])
def test_gradcheck_float64(kw):
    """The hand-derived VJP against finite differences, in float64, of a
    net small enough for gradcheck (every v, g, b and x)."""
    cfg = tf.SDFConfig(**kw)
    params = tf.init_sdf(0, cfg)
    # off the init's zeros: without an encoding the skip layer's v is 0,
    # where ||v|| has no derivative
    rs = np.random.RandomState(4)
    flat = [torch.from_numpy(p.detach().numpy()
                             + 0.05 * rs.randn(*p.shape)).requires_grad_(True)
            for layer in params for p in (layer.v, layer.g, layer.b)]
    x = torch.from_numpy(rs.rand(5, 3) - 0.5).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda x, *flat: sdf_manual._SDFValueFeatureGradient.apply(
            cfg, x, *flat), (x, *flat))


def test_nested_reference_is_the_training_path():
    """The nested reference above gives sdf_value_feature_gradient's
    parameter gradients, the ones the NeuS training step takes."""
    _, tp, _, cfg, x = _case("jax_test", seed=2)
    x = torch.from_numpy(x)
    wrt = list(tp.parameters())
    a = torch.autograd.grad(sdf_manual_loss(*tf.sdf_value_feature_gradient(
        tp, x, cfg, create_graph=True)), wrt)
    b = torch.autograd.grad(sdf_manual_loss(*nested_vfg(
        tp, x.clone().requires_grad_(True), cfg)), wrt)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)
