"""The port's training-mode VQ against the JAX package's, on the CPU.

(a) the eager ``vq_ema_apply(is_training=True)`` against the jnp path, over
    three successive steps that thread the EMA state;
(b) the plain version of the CUDA kernel (``vq_fused_train_reference``) and
    the port's fused ``vq_ema_apply`` against the Pallas kernel in interpret
    mode, as tests/test_pallas_vq.py runs it;
(c) ``kmeans`` against the JAX k-means on separated blobs.

Tolerance rtol=1e-5 (atol 1e-6, or 1e-5 on sums over N rows): fp32 on both
sides, matmuls and sums taken in another order. Indices must be equal: the
inputs are random, so no row has two codes within rounding of each other.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.ops import kmeans as j_kmeans
from vqnerf_release_tpu.ops import vq as j_vq
from vqnerf_release_tpu.ops.pallas.vq_kernel import \
    vq_fused_train as j_fused_train
from vqnerf_release_torch.kernels import vq as t_kernel
from vqnerf_release_torch.ops import kmeans as t_kmeans
from vqnerf_release_torch.ops import vq as t_vq


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
KW = dict(commitment_cost=0.1, decay=0.999, epsilon=1e-5, is_training=True)


def _inputs(n, k, d, seed):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    cb = rs.rand(d, k).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=0, keepdims=True)
    mask = (rs.rand(n) > 0.3).astype(np.float32)
    thres = np.concatenate(
        [np.zeros(k - k // 2), 0.5 * np.ones(k // 2)]).astype(np.float32)
    roll = rs.rand(1, k).astype(np.float32)
    return x, cb, mask, thres, roll


def _close(got, want, what, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _check_state(t_state, j_state):
    _close(t_state.hidden_cluster_size, j_state.hidden_cluster_size, "hcs")
    _close(t_state.hidden_dw, j_state.hidden_dw, "hdw")
    assert int(t_state.counter) == int(j_state.counter)
    assert t_state.counter.dtype == torch.int32


@pytest.mark.parametrize("dropout,masked", [
    (False, False), (True, False), (False, True), (True, True)])
def test_eager_training_steps_match_jax(dropout, masked):
    n, k, d = 203, 6, 16
    j_state = j_vq.init_vq_ema_state(d, k)
    t_state = t_vq.init_vq_ema_state(d, k)
    for step in range(3):
        x, cb, mask, thres, roll = _inputs(n, k, d, seed=step)
        jkw, tkw = dict(KW), dict(KW)
        if dropout:
            jkw.update(thres=jnp.asarray(thres), roll=jnp.asarray(roll))
            tkw.update(thres=torch.from_numpy(thres),
                       roll=torch.from_numpy(roll))
        if masked:
            jkw["mask"] = jnp.asarray(mask)
            tkw["mask"] = torch.from_numpy(mask)
        want, j_state = j_vq.vq_ema_apply(
            jnp.asarray(cb), jnp.asarray(x), j_state, **jkw)
        got, t_state = t_vq.vq_ema_apply(
            torch.from_numpy(cb), torch.from_numpy(x), t_state, **tkw)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["encoding_indices"].numpy(),
                                      np.asarray(want["encoding_indices"]))
        np.testing.assert_array_equal(got["encodings"].numpy(),
                                      np.asarray(want["encodings"]))
        for key in ("quantize", "loss", "perplexity", "update", "distances"):
            _close(got[key], want[key], f"step {step} {key}")
        _check_state(t_state, j_state)
        assert not got["update"].requires_grad


def test_eager_training_gradients_match_jax():
    """The commitment loss and the straight-through estimator carry the
    gradient to the inputs; none reaches the codebook."""
    import jax
    n, k, d = 64, 5, 16
    x, cb, mask, thres, roll = _inputs(n, k, d, seed=7)
    state = j_vq.init_vq_ema_state(d, k)

    def j_loss(xx, cbv):
        o, _ = j_vq.vq_ema_apply(cbv, xx, state, thres=jnp.asarray(thres),
                                 roll=jnp.asarray(roll),
                                 mask=jnp.asarray(mask), **KW)
        return o["loss"] + jnp.sum(o["quantize"] * 0.003)

    want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(cb))
    for fused in (False, True):
        tx = torch.from_numpy(x).requires_grad_()
        tcb = torch.from_numpy(cb).requires_grad_()
        o, _ = t_vq.vq_ema_apply(
            tcb, tx, t_vq.init_vq_ema_state(d, k),
            thres=torch.from_numpy(thres), roll=torch.from_numpy(roll),
            mask=torch.from_numpy(mask), use_fused=fused, **KW)
        (o["loss"] + torch.sum(o["quantize"] * 0.003)).backward()
        _close(tx.grad, want[0], f"d/dx fused={fused}", atol=1e-7)
        assert tcb.grad is None or float(tcb.grad.abs().max()) == 0.0
        assert float(jnp.max(jnp.abs(want[1]))) == 0.0


@pytest.mark.parametrize("n,k,dropout", [
    (700, 15, True), (203, 8, False), (1, 4, True)])
def test_kernel_reference_matches_pallas_kernel(n, k, dropout):
    """N is no multiple of the Pallas block of 512: the JAX wrapper pads,
    the port masks."""
    d = 32
    x, cb, mask, thres, roll = _inputs(n, k, d, seed=n)
    rs = np.random.RandomState(1)
    sel = ((roll >= thres).astype(np.float32).reshape(k) if dropout
           else np.ones(k, np.float32))
    hcs = (rs.rand(k) * 50).astype(np.float32)
    hdw = (rs.rand(d, k) * 5).astype(np.float32)
    want = j_fused_train(
        jnp.asarray(cb), jnp.asarray(x), jnp.asarray(mask), jnp.asarray(sel),
        jnp.asarray(hcs), jnp.asarray(hdw), jnp.asarray(4.0, jnp.float32),
        decay=0.999, epsilon=1e-5, interpret=True)
    args = [torch.from_numpy(a) for a in (cb, x, mask, sel, hcs, hdw)]
    launches = t_kernel.LAUNCHES
    got = t_kernel.vq_fused_train(*args, torch.tensor(4.0), decay=0.999,
                                  epsilon=1e-5)
    assert t_kernel.LAUNCHES == launches  # CPU tensors: the plain version
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["indices"].numpy(),
                                  np.asarray(want["indices"]))
    assert got["indices"].dtype == torch.int32
    for key in ("quantized", "counts", "hidden_cs", "hidden_dw", "update"):
        _close(got[key], want[key], key, atol=1e-5)
    # the indices override: the statistics of a given assignment
    fed = t_kernel.vq_fused_train_reference(
        *args, torch.tensor(4.0), decay=0.999, epsilon=1e-5,
        indices=got["indices"])
    for key in got:
        np.testing.assert_array_equal(fed[key].numpy(), got[key].numpy())


@pytest.mark.parametrize("dropout", [False, True])
def test_fused_training_steps_match_jax(dropout):
    n, k, d = 203, 6, 16
    j_state = j_vq.init_vq_ema_state(d, k)
    t_state = t_vq.init_vq_ema_state(d, k)
    for step in range(3):
        x, cb, mask, thres, roll = _inputs(n, k, d, seed=10 + step)
        jkw = dict(KW, mask=jnp.asarray(mask))
        tkw = dict(KW, mask=torch.from_numpy(mask))
        if dropout:
            jkw.update(thres=jnp.asarray(thres), roll=jnp.asarray(roll))
            tkw.update(thres=torch.from_numpy(thres),
                       roll=torch.from_numpy(roll))
        want, j_state = j_vq.vq_ema_apply(
            jnp.asarray(cb), jnp.asarray(x), j_state, use_pallas=True,
            interpret=True, **jkw)
        got, t_state = t_vq.vq_ema_apply(
            torch.from_numpy(cb), torch.from_numpy(x), t_state,
            use_fused=True, **tkw)
        assert set(got) == set(want)
        assert "encodings" not in got and "distances" not in got
        np.testing.assert_array_equal(got["encoding_indices"].numpy(),
                                      np.asarray(want["encoding_indices"]))
        for key in ("quantize", "loss", "perplexity", "update", "counts"):
            _close(got[key], want[key], f"step {step} {key}")
        _check_state(t_state, j_state)


def test_all_codes_dropped_gives_index_zero():
    x, cb, mask, _, _ = _inputs(50, 8, 16, seed=3)
    got, _ = t_vq.vq_ema_apply(
        torch.from_numpy(cb), torch.from_numpy(x),
        t_vq.init_vq_ema_state(16, 8), thres=torch.full((8,), 2.0),
        roll=torch.zeros((1, 8)), mask=torch.from_numpy(mask),
        use_fused=True, **KW)
    assert int(got["encoding_indices"].max()) == 0


def test_lookup_takes_mask_argument_as_jax():
    x, cb, mask, thres, roll = _inputs(40, 5, 16, seed=4)
    want = j_vq.vq_lookup(jnp.asarray(cb), jnp.asarray(x),
                          thres=jnp.asarray(thres), roll=jnp.asarray(roll),
                          mask=jnp.asarray(mask))
    got = t_vq.vq_lookup(torch.from_numpy(cb), torch.from_numpy(x),
                         thres=torch.from_numpy(thres),
                         roll=torch.from_numpy(roll),
                         mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got["encoding_indices"].numpy(),
                                  np.asarray(want["encoding_indices"]))
    _close(got["distances"], want["distances"], "distances")


@pytest.mark.parametrize("k,seed", [(4, 1), (7, 2)])
def test_kmeans_matches_jax_on_blobs(k, seed):
    rs = np.random.RandomState(seed)
    centres = rs.rand(k, 12).astype(np.float32) * 10
    labels = rs.randint(0, k, size=400)
    # one initial centre in each blob (k-means draws its initial rows with
    # RandomState(seed).choice): two in one blob would split it along a
    # boundary that fp32 rounding decides
    labels[np.random.RandomState(seed).choice(400, k, replace=False)] = \
        np.arange(k)
    x = (centres[labels] + 0.05 * rs.randn(400, 12)).astype(np.float32)
    j_assign, j_centers = j_kmeans.kmeans(x, k, seed=seed)
    t_assign, t_centers = t_kmeans.kmeans(torch.from_numpy(x), k, seed=seed)
    np.testing.assert_array_equal(t_assign.numpy(), np.asarray(j_assign))
    assert len(set(zip(labels, t_assign.numpy()))) == k  # one code a blob
    np.testing.assert_allclose(t_centers.numpy(), np.asarray(j_centers),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        t_kmeans.kmeans_predict(torch.from_numpy(x), t_centers).numpy(),
        np.asarray(j_kmeans.kmeans_predict(x, j_centers)))
