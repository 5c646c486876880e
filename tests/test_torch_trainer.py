"""The port's stage-2 train steps against the JAX package's, on the CPU.

  * ``KerasAmsgrad`` against ``_scale_by_keras_amsgrad`` for 20 steps on
    fixed gradients (1e-6), with clipnorm and clipvalue too;
  * ``decomp_lr``;
  * ``make_nfr_unit_step`` and ``make_vq_nfr_step`` for 5 steps on shared
    parameters, shared batches and explicit dropout rolls: parameters,
    codebook, EMA state, optimizer state and the loss dict at rtol 1e-4
    with atol 2e-6 on parameters (amsgrad divides by sqrt(vhat) + 1e-7,
    which turns the gradients' fp32 rounding into differences of that size
    whatever the parameter's own size), 2e-7 on the first moments (a
    gradient is a sum of signed per-ray terms, so elements that cancel
    carry the rounding of the larger terms) and 1e-9 on the second; once on
    the eager VQ path and once on the fused one;
  * a step with a NaN in its batch changes nothing and sets
    ``nonfinite_grads``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import SMALL, batch_np, jax_params
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.ops.vq import init_vq_ema_state as j_init_ema
from vqnerf_release_tpu.train import decomp_trainer as j_dt
from vqnerf_release_torch.interop.jax_params import (ema_to_jax, from_jax,
                                                     opt_state_to_jax,
                                                     to_jax)
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.ops.vq import init_vq_ema_state as t_init_ema
from vqnerf_release_torch.train import decomp_trainer as t_dt


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_STEPS = 5
N = 24


def _tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _assert_trees_close(got, want, rtol, atol, what):
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert g_def == w_def, what
    for g, (path, w) in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol,
            err_msg=what + jax.tree_util.keystr(path))


@pytest.mark.parametrize("clip", [{}, {"clipnorm": 0.5}, {"clipvalue": 0.01}])
def test_amsgrad_rule_matches_jax(clip):
    jcfg, tcfg = j_dc.DecompConfig(**clip), t_dc.DecompConfig(**clip)
    rs = np.random.RandomState(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    p0 = [rs.randn(*s).astype(np.float32) for s in shapes]
    tx = j_dt._amsgrad(jcfg)
    j_params = [jnp.asarray(p) for p in p0]
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(p.copy()) for p in p0]
    opt = t_dt.KerasAmsgrad(t_params, tcfg)
    for step in range(20):
        # gradients that shrink, so that vhat's running maximum matters
        grads = [(rs.randn(*s) * 0.1 / (1 + step % 7)).astype(np.float32)
                 for s in shapes]
        lr = 1e-2
        updates, j_state = tx.update([jnp.asarray(g) for g in grads],
                                     j_state, j_params)
        j_params = [p - lr * u for p, u in zip(j_params, updates)]
        ok = opt.step([torch.from_numpy(g) for g in grads], lr)
        assert bool(ok)
    for t, j in zip(t_params, j_params):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    j_ams = j_state[-1] if clip else j_state
    assert int(opt.state["count"]) == int(j_ams["count"]) == 20
    for key in ("m", "v", "vhat"):
        want = np.concatenate([np.asarray(x).reshape(-1)
                               for x in j_ams[key]])
        np.testing.assert_allclose(opt.state[key].numpy(), want, rtol=1e-6,
                                   atol=1e-9, err_msg=key)


def test_amsgrad_rejects_both_clips():
    with pytest.raises(ValueError, match="clipnorm"):
        t_dt.KerasAmsgrad([torch.zeros(2)],
                          t_dc.DecompConfig(clipnorm=1.0, clipvalue=1.0))


@pytest.mark.parametrize("step", [0, 1, 12345, 500_000, 1_250_000])
def test_decomp_lr_matches_jax(step):
    jcfg, tcfg = j_dc.DecompConfig(), t_dc.DecompConfig()
    np.testing.assert_allclose(
        t_dt.decomp_lr(step, tcfg),
        float(j_dt.decomp_lr(jnp.asarray(step, jnp.float32), jcfg)),
        rtol=1e-6)


def _batch(step, n_lights, nan=False):
    b = batch_np(N, n_lights, seed=100 + step)
    del b["ref"]
    if nan:
        b["rgb"][3, 1] = np.nan
    return b


def _split(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _compare_state(model, opt, kind, j_params, j_opt, what):
    _assert_trees_close(to_jax(model, kind), j_params, 1e-4, 2e-6,
                        what + " params")
    got = opt_state_to_jax(opt.state, model, kind)
    assert int(got["count"]) == int(j_opt["count"]), what
    for key, atol in (("m", 2e-7), ("v", 1e-9), ("vhat", 1e-9)):
        _assert_trees_close(got[key], j_opt[key], 1e-4, atol,
                            f"{what} {key}")


def _compare_ld(t_ld, j_ld, what):
    assert set(t_ld) == set(j_ld), what
    for k in j_ld:
        np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=f"{what} {k}")


def _snapshot(model, opt, ema=None):
    snap = {"params": copy.deepcopy(model.state_dict()),
            "opt": {k: v.clone() for k, v in opt.state.items()}}
    if ema is not None:
        snap["ema"] = [t.clone() for t in ema]
    return snap


def _assert_unchanged(snap, model, opt, ema=None):
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap["params"][k]), k
    for k, v in opt.state.items():
        assert torch.equal(v, snap["opt"][k]), k
    if ema is not None:
        for a, b in zip(ema, snap["ema"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
def test_nfr_unit_steps_match_jax(data_type):
    jcfg = j_dc.DecompConfig(data_type=data_type, **SMALL)
    tcfg = t_dc.DecompConfig(data_type=data_type, **SMALL)
    nfr_np, _, _ = jax_params(data_type)
    tx, j_step = j_dt.make_nfr_unit_step(jcfg, *j_dc.light_constants(jcfg))
    j_params = _tree(nfr_np)
    j_opt = tx.init(j_params)
    model = from_jax(nfr_np, "nfr_unit")
    opt, t_step = t_dt.make_nfr_unit_step(
        model, tcfg, *t_dc.light_constants(tcfg, "cpu"))
    for step in range(N_STEPS):
        jb, tb = _split(_batch(step, jcfg.n_lights))
        j_params, j_opt, j_ld = j_step(j_params, j_opt, jb,
                                       jnp.asarray(step, jnp.float32))
        t_ld = t_step(tb, step)
        _compare_ld(t_ld, j_ld, f"step {step}")
        assert float(t_ld["nonfinite_grads"]) == 0.0
    _compare_state(model, opt, "nfr_unit", j_params, j_opt, "nfr_unit")

    # a poisoned batch: nothing moves, on either side
    snap = _snapshot(model, opt)
    jb, tb = _split(_batch(99, jcfg.n_lights, nan=True))
    before = jax.tree_util.tree_map(np.asarray, j_params)
    j_params, j_opt, j_ld = j_step(j_params, j_opt, jb,
                                   jnp.asarray(5, jnp.float32))
    t_ld = t_step(tb, 5)
    assert float(t_ld["nonfinite_grads"]) == float(
        j_ld["nonfinite_grads"]) == 1.0
    assert not np.isfinite(float(t_ld["loss"]))
    _assert_unchanged(snap, model, opt)
    _assert_trees_close(jax.tree_util.tree_map(np.asarray, j_params), before,
                        0, 0, "jax params after the skipped step")


@pytest.mark.parametrize("data_type,fused", [
    ("nerf", False), ("nerf", True), ("dtu", False)])
def test_vq_nfr_steps_match_jax(monkeypatch, data_type, fused):
    # the JAX switch is off under the test suite's 8 virtual devices
    monkeypatch.setattr(j_dc, "fused_vq_enabled",
                        lambda cfg: bool(cfg.use_fused_vq))
    kw = dict(SMALL, data_type=data_type, use_fused_vq=fused)
    jcfg, tcfg = j_dc.DecompConfig(**kw), t_dc.DecompConfig(**kw)
    _, vq_np, _ = jax_params(data_type)
    tx, j_step = j_dt.make_vq_nfr_step(jcfg, *j_dc.light_constants(jcfg))
    j_params = _tree(vq_np)
    j_opt = tx.init(j_params)
    j_ema = j_init_ema(jcfg.z_dim, jcfg.num_embed)
    model = from_jax(vq_np, "vq_nfr")
    opt, t_step = t_dt.make_vq_nfr_step(
        model, tcfg, *t_dc.light_constants(tcfg, "cpu"))
    t_ema = t_init_ema(tcfg.z_dim, tcfg.num_embed)
    thres = jcfg.train_thres()
    rs = np.random.RandomState(8)
    cb0 = model.codebook.detach().clone()

    def run(step, nan=False):
        nonlocal j_params, j_ema, j_opt, t_ema
        b = _batch(step, jcfg.n_lights, nan=nan)
        b["_roll"] = rs.rand(1, jcfg.num_embed).astype(np.float32)
        jb, tb = _split(b)
        j_params, j_ema, j_opt, j_ld = j_step(
            j_params, j_ema, j_opt, jb, jnp.asarray(thres),
            jax.random.PRNGKey(0), jnp.asarray(step, jnp.float32))
        t_ema, t_ld = t_step(t_ema, tb, torch.from_numpy(thres), None, step)
        return t_ld, j_ld

    for step in range(N_STEPS):
        t_ld, j_ld = run(step)
        _compare_ld(t_ld, j_ld, f"step {step}")
        assert float(t_ld["nonfinite_grads"]) == 0.0
    assert not torch.equal(model.codebook, cb0)
    _compare_state(model, opt, "vq_nfr", j_params, j_opt, "vq_nfr")
    got_ema = ema_to_jax(t_ema)
    for name, want in zip(got_ema, j_ema):
        np.testing.assert_allclose(got_ema[name], np.asarray(want),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    assert int(t_ema.counter) == N_STEPS

    snap = _snapshot(model, opt, t_ema)
    t_ld, j_ld = run(99, nan=True)
    assert float(t_ld["nonfinite_grads"]) == float(
        j_ld["nonfinite_grads"]) == 1.0
    _assert_unchanged(snap, model, opt, t_ema)
    assert int(j_ema.counter) == N_STEPS
