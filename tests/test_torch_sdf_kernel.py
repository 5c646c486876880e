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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NETS = {
    "default": dict(),
    "scale2": dict(scale=2.0),
    "small": dict(d_hidden=32, n_layers=4, skip_in=(2,), multires=2,
                  d_out=33),
    "odd": dict(d_hidden=100, n_layers=3, skip_in=(1, 3), multires=4,
                d_out=7, scale=0.5),
}


def _pair(name, seed=0):
    kw = NETS[name]
    jcfg, tcfg = jf.SDFConfig(**kw), tf.SDFConfig(**kw)
    jp = jf.init_sdf(seed, jcfg)
    tp = from_jax({"sdf": jax.tree_util.tree_map(np.asarray, jp),
                   "color": [], "variance": {"variance": 0.3}}, "neus").sdf
    return jp, jcfg, tp, tcfg, ks.pack_sdf(tp, tcfg)


def _hidden_tiles(packed, l):
    """(W_hi, W_lo) [256, 8 tiles] of hidden layer ``l``, read back from the
    packed buffer: the inverse of pack_sdf's tiling, n by k."""
    tiles = -(-packed.in_dim[l] // ks.TILE_K)
    flat = packed.buffer[packed.w_off[l]:
                         packed.w_off[l] + tiles * ks.TILE_FLOATS]
    t = flat.reshape(tiles, 2, 2, ks.MAX_WIDTH, ks.TILE_K // 2)
    return tuple(t[:, i].permute(2, 0, 1, 3).reshape(ks.MAX_WIDTH, -1)
                 for i in range(2))


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
    # hidden weights as depth-8 tiles of W^T, hi then lo, n by k inside a
    # tile; zero rows past the layer's width; the last layer's column 0
    assert ks.TILE_FLOATS * 4 == 16384
    assert packed.b_off[3] - packed.w_off[3] == 32 * ks.TILE_FLOATS
    assert packed.b_off[0] - packed.w_off[0] == 5 * ks.TILE_FLOATS
    tile = packed.buffer[packed.w_off[3] + 2 * ks.TILE_FLOATS:
                         packed.w_off[3] + 3 * ks.TILE_FLOATS]
    tile = tile.reshape(2, 2, 256, 4)  # [hi | lo][k // 4][n][k % 4]
    w3 = packed.layers[3][0]
    hi, lo = ks.split_tf32(w3)
    assert torch.equal(tile[0, 1, 5], hi[20:24, 5])
    assert torch.equal(tile[1, 0, 216], lo[16:20, 216])
    assert not tile[:, :, 217:].any()
    w3_hi, w3_lo = _hidden_tiles(packed, 3)
    assert torch.equal(w3_hi[:217], hi.T) and torch.equal(w3_lo[:217], lo.T)
    assert packed.buffer.numel() == 940256  # 3.8 MB: hi and lo of 8 layers
    last = packed.buffer[packed.w_off[8]:packed.w_off[8] + 256]
    assert torch.equal(last, packed.layers[8][0][:, 0])
    assert float(packed.buffer[packed.b_off[8]]) == \
        float(packed.layers[8][1][0])
    assert ks.flops_per_point(packed, False) == 918016
    assert ks.flops_per_point(packed, True) == 4 * 918016


def _low_bits(t):
    return t.contiguous().view(torch.int32) & 0x1FFF


def test_split_tf32_rounds_to_nearest_and_keeps_the_rest():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(np.concatenate([
        rs.randn(4096) * 10.0 ** rs.randint(-6, 6, 4096),
        [0.0, 1.0, -1.0, 1.0 + 2.0**-11, -1.0 - 2.0**-11, 1.0 + 2.0**-12,
         3.0e-30, 1.0e30]]).astype(np.float32))
    hi, lo = ks.split_tf32(x)
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    # to nearest at 10 mantissa bits, ties away from zero
    assert (hi.double() - x.double()).abs().le(
        x.double().abs() * 2.0**-11).all()
    assert float(hi[-5]) == 1.0 + 2.0**-10
    assert float(hi[-4]) == -1.0 - 2.0**-10
    assert float(hi[-3]) == 1.0 and float(lo[-3]) == 2.0**-12
    back = hi.double() + lo.double()
    assert (back - x.double()).abs().le(x.double().abs() * 2.0**-21).all()


def test_three_tf32_products_keep_fp32_accuracy_and_one_does_not():
    """The kernel's a_lo b_hi + a_hi b_lo + a_hi b_hi, emulated in fp32 on
    the widest layer of the default net, against the fp64 product."""
    packed = _pair("default")[4]
    w = packed.layers[5][0]  # [256, 256]
    a = torch.from_numpy(np.random.RandomState(6).randn(64, 256)
                         .astype(np.float32) * 0.05)
    want = a.double() @ w.double()
    size = (a.double().abs() @ w.double().abs()).max(dim=1, keepdim=True)[0]
    a_hi, a_lo = ks.split_tf32(a)
    w_hi, w_lo = ks.split_tf32(w)
    three = (a_lo @ w_hi + a_hi @ w_lo) + a_hi @ w_hi
    one = a_hi @ w_hi
    err3 = ((three.double() - want).abs() / size).max()
    err1 = ((one.double() - want).abs() / size).max()
    assert float(err3) < 1e-6
    assert float(err1) > 2e-5


@pytest.mark.parametrize("net", ["default", "small", "odd"])
def test_packed_tiles_reconstruct_every_hidden_layer(net):
    packed = _pair(net)[4]
    assert packed.buffer.dtype == torch.float32
    assert packed.buffer.is_contiguous()
    n = len(packed.layers)
    for l, (w, b) in enumerate(packed.layers[:-1]):
        d_in, d_out = w.shape
        tiles = -(-d_in // ks.TILE_K)
        # 16-byte offsets for the bulk copies, whole tiles, then the bias
        assert packed.w_off[l] % 4 == 0 and packed.b_off[l] % 4 == 0
        assert packed.b_off[l] == packed.w_off[l] + tiles * ks.TILE_FLOATS
        assert torch.equal(
            packed.buffer[packed.b_off[l]:packed.b_off[l] + d_out], b)
        w_hi, w_lo = _hidden_tiles(packed, l)
        assert w_hi.shape == (ks.MAX_WIDTH, tiles * ks.TILE_K)
        assert not _low_bits(w_hi).any() and not _low_bits(w_lo).any()
        back = (w_hi.double() + w_lo.double())[:d_out, :d_in].T
        assert (back - w.double()).abs().le(w.double().abs() * 2.0**-21).all()
        for part in (w_hi, w_lo):  # zero past the widths
            assert not part[d_out:].any() and not part[:, d_in:].any()
    assert packed.in_dim[n - 1] == packed.layers[-1][0].shape[0]
    assert packed.b_off[n - 1] + 1 <= packed.buffer.numel()


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
