"""The port's NeuS sampler and renderer against the JAX package's, on the
CPU: sample_pdf, the occupancy functions, _up_sample, neus_render with and
without a background net, neus_occlusion with and without an occupancy grid.

Shared weights (JAX init -> from_jax), seeded numpy inputs. Tolerance rtol
1e-4 / atol 2e-5 unless said: fp32 matmuls and cumulative products in
another order, through two up-sample rounds whose inverse-CDF positions
move with them. The JAX side also runs once with use_pallas="interpret",
the port's once with the fused switch forced on (its plain version, on CPU
tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_fields import neus_pair
from vqnerf_release_tpu.models import neus as jn
from vqnerf_release_tpu.ops import occupancy as j_occ
from vqnerf_release_tpu.ops.sampling import sample_pdf as j_sample_pdf
from vqnerf_release_torch.kernels import sdf as ks
from vqnerf_release_torch.models import neus as tn
from vqnerf_release_torch.ops import occupancy as t_occ
from vqnerf_release_torch.ops.sampling import sample_pdf as t_sample_pdf


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    thousands of small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

RTOL, ATOL = 1e-4, 2e-5
RADIUS = 2.5


def rays(n, seed=0):
    """Rays from around (0, 0, 2) toward the init sphere, some missing it."""
    rs = np.random.RandomState(seed)
    o = (rs.randn(n, 3) * 0.1 + [0.0, 0.0, 2.0]).astype(np.float32)
    d = -o + rs.randn(n, 3).astype(np.float32) * 0.3
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.5, np.float32)
    far = np.full((n, 1), 3.5, np.float32)
    return o, d, near, far


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("eps_w", [1e-5, 0.0])
def test_sample_pdf_matches_jax(eps_w):
    rs = np.random.RandomState(0)
    bins = np.sort(rs.rand(12, 9).astype(np.float32) * 3, axis=1)
    w = rs.rand(12, 8).astype(np.float32)
    w[3] = 0.0  # the denom guard: with eps_w 0 every bin is empty
    w[5, 2:6] = 0.0  # a flat stretch of the cdf
    if eps_w == 0.0:
        w[3, 0] = 1.0
    want = np.asarray(j_sample_pdf(*_j(bins, w), 7, eps_w=eps_w))
    got = t_sample_pdf(*_t(bins, w), 7, eps_w=eps_w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # random draws are an input
    u = rs.rand(12, 7).astype(np.float32)
    r, b = bins.shape
    got = t_sample_pdf(*_t(bins, w), 7, u=torch.from_numpy(u),
                       eps_w=eps_w).numpy()
    cdf = np.cumsum((w + eps_w) / (w + eps_w).sum(-1, keepdims=True), -1)
    cdf = np.concatenate([np.zeros((r, 1), np.float32), cdf], -1)
    inds = (cdf[:, None, :] <= u[:, :, None]).sum(-1)  # right=True
    below, above = np.maximum(inds - 1, 0), np.minimum(inds, b - 1)
    take = np.take_along_axis
    denom = take(cdf, above, 1) - take(cdf, below, 1)
    denom = np.where(denom < 1e-5, 1.0, denom)
    want = take(bins, below, 1) + (u - take(cdf, below, 1)) / denom * (
        take(bins, above, 1) - take(bins, below, 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_occupancy_functions_match_jax():
    jp, model, jcfg, tcfg = neus_pair()
    j_grid = j_occ.build_occ_grid(jp["sdf"], jcfg.sdf, RADIUS, res=16,
                                  margin_factor=2.0)
    t_grid = t_occ.build_occ_grid(model.sdf, tcfg.sdf, RADIUS, res=16,
                                  margin_factor=2.0)
    assert 0 < float(t_grid.sum()) < t_grid.numel()
    np.testing.assert_array_equal(t_grid.numpy(), np.asarray(j_grid))
    np.testing.assert_allclose(
        float(t_occ.interior_fraction(model.sdf, tcfg.sdf, RADIUS, res=16,
                                      margin_factor=0.5)),
        float(j_occ.interior_fraction(jp["sdf"], jcfg.sdf, RADIUS, res=16,
                                      margin_factor=0.5)), rtol=1e-6)
    # the grid-reading functions on one shared grid
    grid = np.asarray(j_grid)
    o, d, near, far = rays(24)
    d[::3] = -d[::3]  # a third of the rays look away from the object
    for s in (1, 4):
        want = j_occ.ray_bin_occupancy(*_j(o, d, near, far, grid), RADIUS,
                                       8, samples_per_bin=s)
        got = t_occ.ray_bin_occupancy(*_t(o, d, near, far, grid), RADIUS, 8,
                                      samples_per_bin=s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = j_occ.ray_occupied_span(*_j(o, d, near, far, grid), RADIUS,
                                   n_bins=8, pad_bins=1)
    got = t_occ.ray_occupied_span(*_t(o, d, near, far, grid), RADIUS,
                                  n_bins=8, pad_bins=1)
    assert 0 < float(got[2].sum()) < 24  # some rays miss the band
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    want = j_occ.sample_z_occ(*_j(o, d, near, far, grid), RADIUS, 8,
                              n_bins=16)
    got = t_occ.sample_z_occ(*_t(o, d, near, far, grid), RADIUS, 8,
                             n_bins=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    u = torch.rand((24, 8), generator=torch.Generator().manual_seed(0))
    z = t_occ.sample_z_occ(*_t(o, d, near, far, grid), RADIUS, 8, u=u,
                           n_bins=16)
    assert bool((z[:, 1:] >= z[:, :-1]).all())
    assert bool(((z >= 0.5) & (z <= 3.5)).all())


def test_up_sample_and_stable_merge_match_jax():
    jp, model, jcfg, tcfg = neus_pair()
    o, d, near, far = rays(16)
    z = near + (far - near) * np.linspace(0, 1, 8, dtype=np.float32)[None]
    pts = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    from vqnerf_release_tpu.models import fields as jf
    sdf = np.asarray(jf.sdf_only(jp["sdf"], jnp.asarray(pts),
                                 jcfg.sdf)).reshape(16, 8)
    want = jn._up_sample(*_j(o, d, z, sdf), RADIUS, 4, 64)
    got = tn._up_sample(*_t(o, d, z, sdf), RADIUS, 4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # equal z values: the carried SDF must follow old-then-new order
    new_z = np.asarray(want).copy()
    new_z[:, 0] = z[:, 3]
    fake = lambda p: jnp.arange(p.shape[0], dtype=jnp.float32) + 100.0
    jz, js = jn._cat_z_vals(jp, jcfg, *_j(o, d, z, new_z, sdf), sdf_fn=fake)
    tz, ts = tn._cat_z_vals(
        lambda p: torch.arange(p.shape[0], dtype=torch.float32) + 100.0,
        *_t(o, d, z, new_z, sdf))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


_RENDER_KEYS = ("color_fine", "grad_err_sum", "grad_err_cnt", "s_val",
                "cdf_fine", "weight_sum", "weight_max", "gradients",
                "weights", "gradient_error", "inside_sphere", "surf",
                "depth")


@pytest.mark.parametrize("n_outside,cos_anneal,white", [
    (0, 1.0, True), (0, 0.3, False), (4, 1.0, True)])
def test_neus_render_matches_jax(n_outside, cos_anneal, white):
    jp, model, jcfg, tcfg = neus_pair(n_outside=n_outside)
    o, d, near, far = rays(32)
    want = jn.neus_render(
        jp, jcfg, *_j(o, d, near, far), RADIUS, key=None,
        cos_anneal_ratio=cos_anneal,
        background_rgb=jnp.ones((1, 3)) if white else None)
    with torch.no_grad():
        got = tn.neus_render(
            model, tcfg, *_t(o, d, near, far), RADIUS,
            cos_anneal_ratio=cos_anneal,
            background_rgb=torch.ones((1, 3)) if white else None)
    assert set(got) == set(want) == set(_RENDER_KEYS)
    assert float(got["weight_sum"].max()) > 0.5  # rays do hit the sphere
    for k in _RENDER_KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_neus_render_fused_switch_and_pallas_interpret():
    """The up-sample chain through the kernels' plain version (the switch
    forced on, CPU tensors) and through Pallas in interpret mode: both equal
    the default path within the tolerance."""
    jp, model, jcfg, tcfg = neus_pair()
    o, d, near, far = rays(32)  # 32 x 8 = 256 points: the Pallas gate opens
    want = jn.neus_render(jp, jcfg, *_j(o, d, near, far), RADIUS, key=None,
                          cos_anneal_ratio=1.0, use_pallas="interpret")
    packed = ks.pack_sdf(model.sdf, tcfg.sdf)
    with torch.no_grad():
        fused = tn.neus_render(model, tcfg, *_t(o, d, near, far), RADIUS,
                               cos_anneal_ratio=1.0, use_fused_sdf=True,
                               packed=packed)
        plain = tn.neus_render(model, tcfg, *_t(o, d, near, far), RADIUS,
                               cos_anneal_ratio=1.0, use_fused_sdf=False)
    for k in ("color_fine", "weight_sum", "surf", "weights"):
        np.testing.assert_allclose(fused[k].numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(fused[k].numpy(), plain[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_neus_render_perturbation_is_an_input():
    _, model, _, tcfg = neus_pair(n_outside=4)
    o, d, near, far = rays(8)
    args = _t(o, d, near, far)
    with torch.no_grad():
        base = tn.neus_render(model, tcfg, *args, RADIUS)
        same = tn.neus_render(model, tcfg, *args, RADIUS,
                              generator=torch.Generator().manual_seed(1),
                              perturb_overwrite=0.0)
        rand = {"t_rand": torch.full((8, 1), 0.9),
                "outside": torch.full((8, 4), 0.25)}
        moved = tn.neus_render(model, tcfg, *args, RADIUS, rand=rand)
        again = tn.neus_render(model, tcfg, *args, RADIUS, rand=rand)
        drawn = tn.neus_render(model, tcfg, *args, RADIUS,
                               generator=torch.Generator().manual_seed(1))
    assert torch.equal(base["weights"], same["weights"])
    assert torch.equal(moved["weights"], again["weights"])
    assert not torch.equal(moved["weights"], base["weights"])
    assert not torch.equal(drawn["weights"], base["weights"])
    assert all(torch.isfinite(v).all() for v in drawn.values())


@pytest.mark.parametrize("with_grid,j_pallas,t_fused", [
    (False, False, False), (False, "interpret", True), (True, False, None),
    (True, "interpret", True)])
def test_neus_occlusion_matches_jax(with_grid, j_pallas, t_fused):
    jp, model, jcfg, tcfg = neus_pair()
    # shadow rays from points on the init sphere, half of them back through it
    rs = np.random.RandomState(2)
    n = 64  # 64 x 8 and 64 x 4 points: multiples of the Pallas block
    p = rs.randn(n, 3).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    o = 0.55 * p
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    near = np.full((n, 1), 0.1, np.float32)
    far = np.full((n, 1), 2.0, np.float32)
    grid = None
    if with_grid:
        grid = np.asarray(j_occ.build_occ_grid(
            jp["sdf"], jcfg.sdf, RADIUS, res=16, margin_factor=2.0))
    want = jn.neus_occlusion(
        jp, jcfg, *_j(o, d, near, far), RADIUS, use_pallas=j_pallas,
        occ_grid=None if grid is None else jnp.asarray(grid))
    before = dict(ks.LAUNCHES)
    got = tn.neus_occlusion(
        model, tcfg, *_t(o, d, near, far), RADIUS, use_fused_sdf=t_fused,
        occ_grid=None if grid is None else torch.from_numpy(grid))
    assert ks.LAUNCHES == before  # CPU tensors never launch a kernel
    assert got.shape == (n, 1) and not got.requires_grad
    assert float(got.max()) > 0.5 and float(got.min()) < 0.05
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_neus_occlusion_takes_any_number_of_rays():
    """No block-multiple gate and no fallback: 37 rays through the fused
    switch equal the same rays inside a batch of 64."""
    _, model, _, tcfg = neus_pair()
    o, d, near, far = rays(64, seed=5)
    o = o * 0.3  # start near the sphere
    args = _t(o, d, near * 0.2, far * 0.6)
    full = tn.neus_occlusion(model, tcfg, *args, RADIUS, use_fused_sdf=True)
    part = tn.neus_occlusion(model, tcfg, *[a[:37] for a in args], RADIUS,
                             use_fused_sdf=True)
    torch.testing.assert_close(part, full[:37], rtol=1e-6, atol=1e-7)


def test_init_neus_shapes_match_jax_and_seed_the_sdf():
    jcfg, tcfg = jn.NeuSConfig(), tn.NeuSConfig()
    jp = jax.eval_shape(lambda: jn.init_neus(0, jcfg))
    model = tn.init_neus(0, tcfg)
    assert [tuple(p.v.shape) for p in model.sdf] == \
        [p["v"].shape for p in jp["sdf"]]
    assert [tuple(p.v.shape) for p in model.color] == \
        [p["v"].shape for p in jp["color"]]
    assert not model.has_bg
    assert float(model.variance.variance) == pytest.approx(0.3)
    again = tn.init_neus(0, tcfg)
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
