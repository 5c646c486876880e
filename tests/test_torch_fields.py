"""The port's stage-1 fields, configs and converters against the JAX
package's, on the CPU.

The same parameters (JAX init, converted by from_jax) and the same inputs
(numpy, seeded) go through both. Values are held at rtol 1e-5 / atol 1e-6
(fp32 matmuls summed in another order); gradients at rtol 1e-4 / atol 1e-5,
since softplus(beta=100) amplifies last-bit differences of the
pre-activations a hundredfold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu import config as j_config
from vqnerf_release_tpu.models import fields as jf
from vqnerf_release_tpu.models import neus as jn
from vqnerf_release_tpu.ops.pallas import sdf_kernel as j_kernel
from vqnerf_release_tpu.train import neus_trainer as j_trainer
from vqnerf_release_torch import config as t_config
from vqnerf_release_torch.interop.jax_params import from_jax, to_jax
from vqnerf_release_torch.models import fields as tf
from vqnerf_release_torch.models import neus as tn
from vqnerf_release_torch.train import neus_trainer as t_trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-5, 1e-6
SMALL_SDF = dict(d_hidden=32, n_layers=4, skip_in=(2,), multires=2, d_out=33)
SMALL_COLOR = dict(d_feature=32, d_hidden=16, n_layers=2)
SMALL_BG = dict(depth=3, width=16, skips=(1,), multires=2, multires_view=2)


def small_cfgs(n_outside=0, **kw):
    """(JAX NeuSConfig, port NeuSConfig) of the same tiny model."""
    kw = dict(dict(n_samples=8, n_importance=8, up_sample_steps=2,
                   n_outside=n_outside), **kw)
    j = jn.NeuSConfig(sdf=jf.SDFConfig(**SMALL_SDF),
                      color=jf.ColorConfig(**SMALL_COLOR),
                      bg=jf.BgNeRFConfig(**SMALL_BG) if n_outside else None,
                      **kw)
    t = tn.NeuSConfig(sdf=tf.SDFConfig(**SMALL_SDF),
                      color=tf.ColorConfig(**SMALL_COLOR),
                      bg=tf.BgNeRFConfig(**SMALL_BG) if n_outside else None,
                      **kw)
    return j, t


def neus_pair(seed=0, n_outside=0, **kw):
    """(JAX params, port model, JAX cfg, port cfg) sharing weights."""
    jcfg, tcfg = small_cfgs(n_outside, **kw)
    jp = jn.init_neus(seed, jcfg)
    model = from_jax(jax.tree_util.tree_map(np.asarray, jp), "neus")
    return jp, model, jcfg, tcfg


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("j_cls,t_cls", [
    (jf.SDFConfig, tf.SDFConfig), (jf.ColorConfig, tf.ColorConfig),
    (jf.BgNeRFConfig, tf.BgNeRFConfig),
    (j_trainer.NeuSTrainConfig, t_trainer.NeuSTrainConfig)])
def test_config_fields_and_defaults_match_jax(j_cls, t_cls):
    assert _fields(t_cls) == _fields(j_cls)


def test_neus_config_matches_jax():
    j, t = jn.NeuSConfig(), tn.NeuSConfig()
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("scene", ["lego_3072", "chair0_3072", "dtu_scan24",
                                   "colmap_bottle", "hwchair_-1", "other"])
def test_stage1_config_tables_match_jax(scene):
    assert t_config.scene_family(scene) == j_config.scene_family(scene)
    assert t_config.CG_SCENES == j_config.CG_SCENES
    assert t_config.SCENE_FAMILY == j_config.SCENE_FAMILY
    assert t_config._FAMILY_GEO == j_config._FAMILY_GEO
    assert t_config._GEO_FAST_SAMPLER == j_config._GEO_FAST_SAMPLER
    assert t_config.surf_dir("o", scene) == j_config.surf_dir("o", scene)
    assert t_config.parse_sampler_spec("32+16r2") == \
        j_config.parse_sampler_spec("32+16r2")
    with pytest.raises(ValueError, match="vis_sampler"):
        t_config.parse_sampler_spec("bogus", what="vis_sampler")
    for kw in ({}, dict(n_samples=64, n_importance=64, up_sample_steps=4,
                        occ_res=0)):
        jc, jt, jm = j_config.neus_configs_for_scene(scene, **kw)
        tc, tt, tm = t_config.neus_configs_for_scene(scene, **kw)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
        assert tm == jm
    with pytest.raises(ValueError, match="unknown override"):
        t_config.neus_configs_for_scene(scene, nonsense=1)


@pytest.mark.parametrize("kw", [dict(), dict(SMALL_SDF),
                                dict(inside_outside=True, bias=0.3)])
def test_init_sdf_gives_the_jax_weights(kw):
    """v and b bit for bit (the same numpy draws); g, the column norm of v,
    to a few ulp (rtol 1e-6): XLA and PyTorch sum the squares in different
    orders."""
    want = jf.init_sdf(3, jf.SDFConfig(**kw))
    got = tf.init_sdf(3, tf.SDFConfig(**kw))
    assert len(got) == len(want)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t.v.detach().numpy(), np.asarray(j["v"]))
        np.testing.assert_array_equal(t.b.detach().numpy(), np.asarray(j["b"]))
        np.testing.assert_allclose(t.g.detach().numpy(), np.asarray(j["g"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("n_outside", [0, 4])
def test_neus_tree_round_trips(n_outside):
    jp, model, _, _ = neus_pair(n_outside=n_outside)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    back = to_jax(model, "neus")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert model.has_bg == bool(n_outside)


def test_neus_checkpoint_round_trips(tmp_path):
    from vqnerf_release_torch.utils import ckpt
    _, model, _, tcfg = neus_pair(n_outside=4)
    ckpt.save_ckpt(str(tmp_path), 7, {"params": model.state_dict(),
                                      "iter_step": 7})
    state = ckpt.load_ckpt(ckpt.latest_ckpt(str(tmp_path)))
    fresh = tn.init_neus(5, tcfg)
    fresh.load_state_dict(state["params"])
    want = model.state_dict()
    assert set(fresh.state_dict()) == set(want)
    for k, a in fresh.state_dict().items():
        assert torch.equal(a, want[k]), k
    assert state["iter_step"] == 7


def _pts(n, seed=0, spread=0.5):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * spread


@pytest.mark.parametrize("kw", [dict(SMALL_SDF), dict(SMALL_SDF, scale=2.0),
                                dict()])
def test_sdf_functions_match_jax(kw):
    jcfg, tcfg = jf.SDFConfig(**kw), tf.SDFConfig(**kw)
    jp = jf.init_sdf(1, jcfg)
    tp = from_jax({"sdf": jax.tree_util.tree_map(np.asarray, jp),
                   "color": [], "variance": {"variance": 0.3}}, "neus").sdf
    x = _pts(64)
    with torch.no_grad():
        got = tf.sdf_apply(tp, torch.from_numpy(x), tcfg).numpy()
        only = tf.sdf_only(tp, torch.from_numpy(x), tcfg).numpy()
    want = np.asarray(jf.sdf_apply(jp, jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(only, got[:, 0])

    want_g = np.asarray(jf.sdf_gradient(jp, jnp.asarray(x), jcfg))
    for inside_no_grad in (False, True):
        with torch.set_grad_enabled(not inside_no_grad):
            g = tf.sdf_gradient(tp, torch.from_numpy(x), tcfg)
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-4, atol=1e-5)

    j_sdf, j_feat, j_grad = jf.sdf_value_feature_gradient(
        jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        sdf, feat, grad = tf.sdf_value_feature_gradient(
            tp, torch.from_numpy(x), tcfg)
    assert sdf.shape == (64, 1) and not feat.requires_grad
    np.testing.assert_allclose(sdf.numpy(), np.asarray(j_sdf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(j_feat), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-4,
                               atol=1e-5)

    for (w, b), (jw, jb) in zip(tf.pack_sdf_params(tp),
                                j_kernel.pack_sdf_params(jp)):
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_softplus100_derivatives_match_jax_softplus():
    """softplus100's value is the stable form's, bit for bit; its first and
    second derivatives are jax.nn.softplus(100 x) / 100's, at 0 too, where
    autograd through the stable form would give 1 in place of 1/2."""
    x = np.array([-0.05, -1e-3, 0.0, 1e-3, 0.05, 0.3], np.float32)

    def f(v):
        return jax.nn.softplus(100.0 * v) / 100.0

    d1 = jax.vmap(jax.grad(f))(jnp.asarray(x))
    d2 = jax.vmap(jax.grad(jax.grad(f)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tf.softplus100(xt)
    with torch.no_grad():
        stable = torch.clamp(xt, min=0.0) + torch.log1p(
            torch.exp(-torch.abs(100.0 * xt))) / 100.0
    assert torch.equal(y, stable)
    (g1,) = torch.autograd.grad(y.sum(), xt, create_graph=True)
    (g2,) = torch.autograd.grad(g1.sum(), xt)
    assert float(g1[2]) == 0.5
    np.testing.assert_allclose(g1.detach().numpy(), np.asarray(d1),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g2.numpy(), np.asarray(d2), rtol=1e-5,
                               atol=1e-5)


def test_sdf_gradient_create_graph_is_differentiable():
    """The training slice's Eikonal term differentiates the gradient: with
    create_graph the result carries a graph to the parameters."""
    cfg = tf.SDFConfig(**SMALL_SDF)
    params = tf.init_sdf(0, cfg)
    x = torch.from_numpy(_pts(16))
    g = tf.sdf_gradient(params, x, cfg, create_graph=True)
    loss = torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in params[0].parameters())
    sdf, feat, g2 = tf.sdf_value_feature_gradient(params, x, cfg,
                                                  create_graph=True)
    assert sdf.requires_grad and feat.requires_grad and g2.requires_grad


@pytest.mark.parametrize("mode", ["idr", "no_view_dir", "no_normal"])
def test_color_apply_matches_jax(mode):
    d_in = 9 if mode == "idr" else 6
    multires_view = 0 if mode == "no_view_dir" else 4
    kw = dict(SMALL_COLOR, mode=mode, d_in=d_in, multires_view=multires_view)
    jcfg, tcfg = jf.ColorConfig(**kw), tf.ColorConfig(**kw)
    jp = jf.init_color(jax.random.PRNGKey(0), jcfg)
    tp = from_jax({"sdf": [], "variance": {"variance": 0.3},
                   "color": jax.tree_util.tree_map(np.asarray, jp)},
                  "neus").color
    rs = np.random.RandomState(0)
    args = [rs.randn(40, 3).astype(np.float32) for _ in range(3)] \
        + [rs.randn(40, 32).astype(np.float32)]
    want = np.asarray(jf.color_apply(jp, *map(jnp.asarray, args), jcfg))
    with torch.no_grad():
        got = tf.color_apply(tp, *map(torch.from_numpy, args), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the port's own init: the JAX shapes, its own random stream
    mine = tf.init_color(torch.Generator().manual_seed(0), tcfg)
    assert [tuple(p.v.shape) for p in mine] == \
        [np.shape(p["v"]) for p in jp]
    for p in mine:
        np.testing.assert_allclose(p.g.detach().numpy(),
                                   p.v.detach().norm(dim=0).numpy(),
                                   rtol=1e-6)


def test_bg_nerf_and_variance_match_jax():
    jp, model, jcfg, tcfg = neus_pair(n_outside=4)
    rs = np.random.RandomState(0)
    pts = rs.randn(30, 4).astype(np.float32)
    views = rs.randn(30, 3).astype(np.float32)
    j_alpha, j_rgb = jf.bg_nerf_apply(jp["bg"], jnp.asarray(pts),
                                      jnp.asarray(views), jcfg.bg)
    with torch.no_grad():
        alpha, rgb = tf.bg_nerf_apply(model.bg, torch.from_numpy(pts),
                                      torch.from_numpy(views), tcfg.bg)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(j_alpha), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), rtol=RTOL,
                               atol=ATOL)
    mine = tf.init_bg_nerf(torch.Generator().manual_seed(0), tcfg.bg)
    assert {k: tuple(v.shape) for k, v in mine.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in model.bg.state_dict().items()}
    for v in (0.3, -2.0, 2.0):  # the last two reach the clip
        want = float(jf.inv_s_from({"variance": jnp.asarray(v, jnp.float32)}))
        got = float(tf.inv_s_from(tf.init_variance(v)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
