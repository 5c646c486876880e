"""The port's numeric ops (vqnerf_release_torch/ops) against the JAX
package's on the same seeded numpy inputs, on the CPU.

Tolerance rtol=1e-5, atol=1e-6: both sides are fp32 on the CPU and differ
only in the order of sums and in last-bit library differences of
sin/cos/pow/rsqrt."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.ops import colorspace as j_cs
from vqnerf_release_tpu.ops import embed as j_embed
from vqnerf_release_tpu.ops import math as j_math
from vqnerf_release_tpu.ops import nn as j_nn
from vqnerf_release_tpu.ops.light import gen_light_xyz
from vqnerf_release_tpu.ops.microfacet import microfacet_brdf as j_brdf
from vqnerf_release_tpu.ops.render import render_equation as j_render
from vqnerf_release_tpu.ops import vq as j_vq
from vqnerf_release_torch.interop.jax_params import _mlp_from_jax
from vqnerf_release_torch.ops import colorspace as t_cs
from vqnerf_release_torch.ops import embed as t_embed
from vqnerf_release_torch.ops import math as t_math
from vqnerf_release_torch.ops.microfacet import microfacet_brdf as t_brdf
from vqnerf_release_torch.ops.render import render_equation as t_render
from vqnerf_release_torch.ops import vq as t_vq

RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _both(*arrays):
    return ([torch.from_numpy(np.asarray(a, np.float32)) for a in arrays],
            [jnp.asarray(a, jnp.float32) for a in arrays])


@pytest.mark.parametrize("name", [
    "divide_no_nan", "clip_preserve_gradient", "safe_l2_normalize",
    "safe_l2_normalize_short", "rgb2chromaticity", "linear2srgb",
    "srgb2linear"])
def test_elementwise_ops_match_jax(name):
    rs = np.random.RandomState(0)
    x = rs.randn(64, 3).astype(np.float32)
    y = rs.randn(64, 3).astype(np.float32)
    y[::5] = 0.0  # zero denominators
    x[::7] = 0.0  # zero vectors / zero rgb
    (tx, ty), (jx, jy) = _both(x, y)
    if name == "divide_no_nan":
        _close(t_math.divide_no_nan(tx, ty), j_math.divide_no_nan(jx, jy))
    elif name == "clip_preserve_gradient":
        _close(t_math.clip_preserve_gradient(tx, -0.5, 0.7),
               j_math.clip_preserve_gradient(jx, -0.5, 0.7))
    elif name == "safe_l2_normalize":
        _close(t_math.safe_l2_normalize(tx, axis=1),
               j_math.safe_l2_normalize(jx, axis=1))
    elif name == "safe_l2_normalize_short":
        # |x| < 1e-3: the max(sum, 1e-6) floor differs from F.normalize
        (ts,), (js,) = _both(x * 1e-4)
        _close(t_math.safe_l2_normalize(ts, axis=1),
               j_math.safe_l2_normalize(js, axis=1))
        assert not np.allclose(
            t_math.safe_l2_normalize(ts, axis=1).numpy(),
            torch.nn.functional.normalize(ts, dim=1).numpy(), rtol=1e-3)
    elif name == "rgb2chromaticity":
        _close(t_math.rgb2chromaticity(tx.abs()),
               j_math.rgb2chromaticity(jnp.abs(jx)))
    elif name == "linear2srgb":
        (tu,), (ju,) = _both(rs.rand(256, 3) * 1.2 - 0.1)
        _close(t_cs.linear2srgb(tu), j_cs.linear2srgb(ju))
    else:
        (tu,), (ju,) = _both(rs.rand(256, 3) * 1.2 - 0.1)
        _close(t_cs.srgb2linear(tu), j_cs.srgb2linear(ju))


@pytest.mark.parametrize("n_freqs", [0, 4, 10])
def test_posenc_matches_jax(n_freqs):
    rs = np.random.RandomState(1)
    (t,), (j,) = _both(rs.rand(32, 3) - 0.5)
    got = t_embed.posenc(t, n_freqs)
    assert got.shape[-1] == t_embed.posenc_dim(3, n_freqs)
    _close(got, j_embed.posenc(j, n_freqs))


@pytest.mark.parametrize("acts,skip_at", [
    (["relu"] * 4, (2,)), ([None, "relu", "sigmoid"], ()),
    (["relu", "relu", "sigmoid"], (1,))])
def test_skip_mlp_matches_jax(acts, skip_at):
    import jax
    rs = np.random.RandomState(2)
    d_in, widths = 9, [8, 8, 6, 5][:len(acts)]
    params = j_nn.mlp_init(jax.random.PRNGKey(0), d_in, widths,
                           skip_at=skip_at)
    params = jax.tree_util.tree_map(np.asarray, params)
    mlp = _mlp_from_jax(params, acts, skip_at)
    (t,), (j,) = _both(rs.randn(16, d_in))
    with torch.no_grad():
        _close(mlp(t), j_nn.mlp_apply(params, j, acts, skip_at=skip_at))


# Below rough ~0.6 the GGX D term is ill-conditioned near its peak: in
# cos_nh^2 (alpha^2 - 1) + 1 the last-bit differences of the dot products
# (XLA's CPU dot fuses them with FMA, torch does not) grow past 1e-5
# relative. So the rough >= 0.6 cases hold the ops to rtol=1e-5, and the
# low-roughness cases to rtol=1e-4 (measured worst: 4.9e-5).
ROUGH = {"rough": ((0.6, 0.95), RTOL), "smooth": ((0.05, 0.6), 1e-4)}


def _brdf_inputs(rough_range, n=48, light_h=2, seed=3):
    rs = np.random.RandomState(seed)
    lxyz, lareas = gen_light_xyz(light_h, 2 * light_h)
    lxyz = lxyz.reshape(-1, 3)
    xyz = rs.rand(n, 3) - 0.5
    pts2l = lxyz[None] - xyz[:, None]
    pts2l /= np.linalg.norm(pts2l, axis=-1, keepdims=True)
    normal = rs.randn(n, 3)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    lo, hi = rough_range
    return dict(
        pts2l=pts2l, pts2c=rs.randn(n, 3), normal=normal,
        albedo=rs.rand(n, 3), rough=lo + (hi - lo) * rs.rand(n, 1),
        f0=rs.rand(n, 3), lareas=lareas.reshape(-1),
        lvis=rs.rand(n, pts2l.shape[1]))


@pytest.mark.parametrize("case", ["defaults", "rough", "smooth"])
def test_microfacet_brdf_matches_jax(case):
    keys = ["pts2l", "pts2c", "normal"]
    if case == "defaults":
        d, rtol = _brdf_inputs(ROUGH["rough"][0]), RTOL
    else:
        (rough_range, rtol), keys = ROUGH[case], keys + ["albedo", "rough",
                                                         "f0"]
        d = _brdf_inputs(rough_range)
    t, j = _both(*[d[k] for k in keys])
    for got, want in zip(t_brdf(*t), j_brdf(*j)):
        _close(got, want, rtol=rtol)


@pytest.mark.parametrize("roughness", ["rough", "smooth"])
@pytest.mark.parametrize("case", ["lvis", "no_lvis", "gamma", "probes"])
def test_render_equation_matches_jax(case, roughness):
    rough_range, rtol = ROUGH[roughness]
    d = _brdf_inputs(rough_range)
    rs = np.random.RandomState(4)
    l = d["pts2l"].shape[1]
    light = rs.rand(4, l, 3) * 2 if case == "probes" else rs.rand(l, 3) * 2
    (tp, tc, tn, ta, tr, tf, tareas, tlv, tlight), (
        jp, jc, jn, ja, jr, jf, jareas, jlv, jlight) = _both(
        d["pts2l"], d["pts2c"], d["normal"], d["albedo"], d["rough"],
        d["f0"], d["lareas"], d["lvis"], light * 0.2)
    tb, _, _ = t_brdf(tp, tc, tn, ta, tr, tf)
    jb, _, _ = j_brdf(jp, jc, jn, ja, jr, jf)
    kw_t = dict(light_vis=None if case == "no_lvis" else tlv,
                probe_batch=case == "probes")
    kw_j = dict(light_vis=None if case == "no_lvis" else jlv,
                probe_batch=case == "probes")
    if case == "gamma":
        (gb, gi), (jgb, jgi) = _both([1.3], [0.8])
        kw_t["gamma"], kw_j["gamma"] = (gb, gi), (jgb, jgi)
    got = t_render(tb, tp, tn, tareas, tlight, **kw_t)
    want = j_render(jb, jp, jn, jareas, jlight, **kw_j)
    assert got.shape == want.shape
    _close(got, want, rtol=rtol)


@pytest.mark.parametrize("case", ["plain", "dropout", "mask"])
def test_vq_eval_matches_jax(case):
    """vq_lookup / vq_ema_apply(is_training=False): indices exact (first
    index on ties), the dropped codes filled with the call's largest
    distance, and the commitment loss and perplexity."""
    rs = np.random.RandomState(5)
    z = rs.rand(200, 16)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    cb = rs.rand(16, 6)
    cb /= np.linalg.norm(cb, axis=0, keepdims=True)
    cb[:, 5] = cb[:, 4]  # a tie: the first of the two codes wins
    (tz, tcb), (jz, jcb) = _both(z, cb)
    kw_t, kw_j = {}, {}
    if case == "dropout":
        (tt, tr), (jt, jr) = _both([0.0, 0.5, 0.0, 0.5, 0.0, 0.0],
                                   [[0.3, 0.2, 0.9, 0.7, 0.1, 0.4]])
        kw_t, kw_j = dict(thres=tt, roll=tr), dict(thres=jt, roll=jr)
    elif case == "mask":
        m = (rs.rand(200) > 0.3).astype(np.float32)
        kw_t, kw_j = dict(mask=torch.from_numpy(m)), dict(mask=jnp.asarray(m))
    t_out, _ = t_vq.vq_ema_apply(
        tcb, tz, t_vq.init_vq_ema_state(16, 6), commitment_cost=0.1,
        **kw_t)
    j_out, _ = j_vq.vq_ema_apply(
        jcb, jz, j_vq.init_vq_ema_state(16, 6), commitment_cost=0.1,
        is_training=False, **kw_j)
    np.testing.assert_array_equal(t_out["encoding_indices"].numpy(),
                                  np.asarray(j_out["encoding_indices"]))
    assert not (t_out["encoding_indices"] == 5).any()
    for k in ("quantize", "loss", "perplexity", "encodings", "distances"):
        _close(t_out[k], j_out[k], rtol=1e-5, atol=1e-6)
