"""The plain versions of the port's two SDF kernels against the JAX
package's Pallas kernels, on the CPU.

The Pallas kernels run with interpret=True, as tests/test_sdf_kernel.py
runs them, on the same weights (JAX init, converted by from_jax) and points
(numpy, seeded). The CUDA kernels themselves are held to these plain
versions on the card (tests/test_torch_cuda.py). Tolerances: the JAX
kernel test's own (sdf rtol 2e-4 / atol 2e-5, gradient rtol 3e-3 / atol
3e-4) against the jnp reference, and ten times tighter between the two
forward-mode paths, which do the same arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.models import fields as jf
from vqnerf_release_tpu.ops.pallas import sdf_kernel as jk
from vqnerf_release_torch.interop.jax_params import from_jax
from vqnerf_release_torch.kernels import sdf as ks
from vqnerf_release_torch.models import fields as tf

NETS = {
    "default": dict(),
    "scale2": dict(scale=2.0),
    "small": dict(d_hidden=32, n_layers=4, skip_in=(2,), multires=2,
                  d_out=33),
}


def _pair(name, seed=0):
    kw = NETS[name]
    jcfg, tcfg = jf.SDFConfig(**kw), tf.SDFConfig(**kw)
    jp = jf.init_sdf(seed, jcfg)
    tp = from_jax({"sdf": jax.tree_util.tree_map(np.asarray, jp),
                   "color": [], "variance": {"variance": 0.3}}, "neus").sdf
    return jp, jcfg, tp, tcfg, ks.pack_sdf(tp, tcfg)


def _pts(n, seed, spread):
    return np.random.RandomState(seed).randn(n, 3).astype(np.float32) * spread


@pytest.mark.parametrize("net,spread", [("default", 0.5), ("scale2", 0.3),
                                        ("small", 0.5)])
def test_plain_versions_match_the_pallas_kernels(net, spread):
    jp, jcfg, tp, tcfg, packed = _pair(net)
    x = _pts(jk.BLOCK, 1, spread)
    k_sdf = np.asarray(jk.sdf_fwd_pallas(jp, jnp.asarray(x), jcfg,
                                         interpret=True))
    kg_sdf, kg_grad = jk.sdf_fwdgrad_pallas(jp, jnp.asarray(x), jcfg,
                                            interpret=True)
    ref_sdf, ref_grad = jk.sdf_fwdgrad_jnp(jp, jnp.asarray(x), jcfg)

    xt = torch.from_numpy(x)
    fwd = ks.sdf_fwd_plain(packed, xt, tcfg).numpy()
    sdf, grad = (t.numpy() for t in ks.sdf_fwdgrad_plain(packed, xt, tcfg))
    assert fwd.shape == (jk.BLOCK,) and grad.shape == (jk.BLOCK, 3)
    # forward-mode against forward-mode: the same arithmetic
    np.testing.assert_allclose(fwd, k_sdf, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(sdf, np.asarray(kg_sdf), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(grad, np.asarray(kg_grad), rtol=3e-4,
                               atol=3e-5)
    # and against the jnp reference at the JAX kernel test's tolerance
    np.testing.assert_allclose(sdf, np.asarray(ref_sdf), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(grad, np.asarray(ref_grad), rtol=3e-3,
                               atol=3e-4)
    np.testing.assert_allclose(fwd, sdf, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("net,n", [("default", 77), ("small", 1),
                                   ("scale2", 300)])
def test_plain_forward_mode_matches_autograd(net, n):
    """Any N (no block multiple), against the port's own autograd path."""
    _, _, tp, tcfg, packed = _pair(net, seed=2)
    x = torch.from_numpy(_pts(n, 3, 0.4))
    sdf, grad = ks.sdf_fwdgrad_plain(packed, x, tcfg)
    with torch.no_grad():
        want_sdf = tf.sdf_only(tp, x, tcfg)
    want_grad = tf.sdf_gradient(tp, x, tcfg)
    torch.testing.assert_close(sdf, want_sdf, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(grad, want_grad, rtol=3e-3, atol=3e-4)


def test_wrappers_take_the_plain_version_on_cpu_tensors_only():
    _, _, tp, tcfg, packed = _pair("small")
    x = torch.from_numpy(_pts(10, 0, 0.5))
    before = dict(ks.LAUNCHES)
    torch.testing.assert_close(ks.sdf_fwd(packed, x),
                               ks.sdf_fwd_plain(packed, x))
    sdf, grad = ks.sdf_fwdgrad(packed, x)
    want = ks.sdf_fwdgrad_plain(packed, x)
    assert torch.equal(sdf, want[0]) and torch.equal(grad, want[1])
    assert ks.LAUNCHES == before  # no kernel was launched
    assert not sdf.requires_grad and not grad.requires_grad


def test_pack_layout_and_flops():
    _, _, tp, tcfg, packed = _pair("default")
    dims = [(39, 256)] * 1 + [(256, 256)] * 2 + [(256, 217)] \
        + [(256, 256)] * 4 + [(256, 257)]
    assert [tuple(w.shape) for w, _ in packed.layers] == dims
    assert sum(w.numel() for w, _ in packed.layers) == 524544  # 2.1 MB fp32
    assert list(packed.skip) == [0, 0, 0, 0, 1, 0, 0, 0, 0]
    assert all(off % 4 == 0 for off in packed.w_off)
    # hidden weights zero-padded to 256 columns; the last layer's column 0
    w3 = packed.buffer[packed.w_off[3]:packed.w_off[3] + 256 * 256]
    w3 = w3.reshape(256, 256)
    assert torch.equal(w3[:, :217], packed.layers[3][0])
    assert not w3[:, 217:].any()
    last = packed.buffer[packed.w_off[8]:packed.w_off[8] + 256]
    assert torch.equal(last, packed.layers[8][0][:, 0])
    assert float(packed.buffer[packed.b_off[8]]) == \
        float(packed.layers[8][1][0])
    assert ks.flops_per_point(packed, False) == 918016
    assert ks.flops_per_point(packed, True) == 4 * 918016


@pytest.mark.parametrize("kw,match", [
    (dict(d_hidden=300, n_layers=2, skip_in=(), multires=2), "widths up to"),
    (dict(d_hidden=16, n_layers=2, skip_in=(), multires=0), "frequencies"),
    (dict(d_hidden=16, n_layers=20, skip_in=(), multires=2), "dense layers")])
def test_pack_refuses_what_the_kernel_does_not_take(kw, match):
    cfg = tf.SDFConfig(**kw)
    with pytest.raises(ValueError, match=match):
        ks.pack_sdf(tf.init_sdf(0, cfg), cfg)


def test_posenc_layout_and_derivatives():
    """[x, sin(2^0 x), cos(2^0 x), ...] in 3-channel blocks, as the JAX
    make_embedder lays it out, and its derivative channels against
    autograd."""
    from vqnerf_release_tpu.ops.embed import make_embedder
    from vqnerf_release_torch.ops.embed import posenc
    x = _pts(9, 4, 0.7)
    want = np.asarray(make_embedder(6)(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    embed, d_embed = ks._posenc_with_grad(xt, 6)
    assert embed.shape == (9, 39)
    np.testing.assert_allclose(embed.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(posenc(xt, 6).numpy(), embed.numpy())
    np.testing.assert_array_equal(embed[:, :3].numpy(), x)
    jac = torch.autograd.functional.jacobian(
        lambda p: posenc(p, 6).sum(0), xt)  # [39, 9, 3]
    for k in range(3):
        torch.testing.assert_close(d_embed[k], jac[:, :, k].T, rtol=1e-5,
                                   atol=1e-6)
