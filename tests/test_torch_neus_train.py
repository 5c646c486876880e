"""The port's NeuS geometry training against the JAX package's, on the CPU.

Shared weights (JAX init -> ``from_jax``) at the tiny widths of
``tests/test_torch_fields.py``, seeded numpy rays. The JAX steps are
compiled once for the module. The perturbation draws are inputs: the port's
step takes the uniforms that the JAX step draws from its key.

  * ``neus_lr_factor`` and ``cos_anneal_ratio`` over a range of steps;
  * one step in three variants (no grid, an occupancy grid, the two-tier
    ``active_cap`` render): the metrics at rtol 1e-4; the gradients, read
    from the Adam moments after the step (mu is 0.1 x the gradient, nu
    0.001 x its square), within 2e-3 of each leaf's largest entry (4e-3 for
    nu): a gradient here sums the double-backward terms of 512 points,
    whose sample positions move with the up-sample chain's rounding, and
    its small entries are what is left after they cancel; the new
    parameters at rtol 1e-4, atol 2e-6 (the first Adam step moves each
    element by about lr x sign(g));
  * five steps from an Adam state converted by ``adam_state_from_jax``;
  * a poisoned batch changes nothing and sets ``nonfinite_grads``; the CPU
    path launches no kernel;
  * ``NeuSRunner`` against the JAX runner without perturbation: the same
    rays, occupancy rebuilds, carve decision, tail switch and losses;
    checkpoint and resume; ``validate_mesh`` and ``_write_ply``;
  * ``import_neus`` against the JAX importer on a state dict in the
    reference's layout.
"""

import copy
import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_gen_geo import _make_stage1_scene
from tests.test_torch_fields import neus_pair, small_cfgs
from tests.test_torch_neus import rays
from vqnerf_release_tpu.data.neus_dataset import \
    NerfSceneDataset as JNerfSceneDataset
from vqnerf_release_tpu.interop import torch_import as j_import
from vqnerf_release_tpu.train import neus_loop as j_loop
from vqnerf_release_tpu.train import neus_trainer as j_tr
from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
from vqnerf_release_torch.interop import torch_import as t_import
from vqnerf_release_torch.interop.jax_params import (adam_state_from_jax,
                                                     adam_state_to_jax,
                                                     from_jax, to_jax)
from vqnerf_release_torch.kernels import sdf as ks
from vqnerf_release_torch.train import neus_loop as t_loop
from vqnerf_release_torch.train import neus_trainer as t_tr
from vqnerf_release_torch.utils import ckpt as t_ckpt

RADIUS = 2.5
N = 32
CAP = 16
TRAIN = dict(warm_up_end=5, end_iter=40, igr_weight=0.1, mask_weight=0.1,
             occ_res=8, empty_n_samples=4)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False


def _tcfgs(**kw):
    kw = dict(TRAIN, **kw)
    return j_tr.NeuSTrainConfig(**kw), t_tr.NeuSTrainConfig(**kw)


@pytest.mark.parametrize("kw", [
    {}, {"lr_end_iter": 100}, {"warm_up_end": 0}, {"anneal_end": 7}])
def test_schedules_match_jax(kw):
    jt, tt = _tcfgs(**kw)
    for step in [0, 1, 3, 4, 5, 6, 7, 11, 20, 39, 40]:
        np.testing.assert_allclose(
            t_tr.neus_lr_factor(step, tt),
            float(j_tr.neus_lr_factor(jnp.asarray(step, jnp.float32), jt)),
            rtol=1e-6, atol=1e-7, err_msg=str(step))
        np.testing.assert_allclose(
            t_tr.cos_anneal_ratio(step, tt),
            float(j_tr.cos_anneal_ratio(jnp.asarray(step, jnp.float32), jt)),
            rtol=1e-6, err_msg=str(step))


def _batch(seed, nan=False):
    """N rays, every third one sideways past the object: the two-tier step
    finds them empty."""
    o, d, near, far = rays(N, seed)
    rs = np.random.RandomState(100 + seed)
    side = np.stack([np.ones(N), rs.randn(N) * 0.2, np.full(N, 0.05)], 1)
    d[::3] = (side / np.linalg.norm(side, axis=1, keepdims=True))[::3]
    mask = (rs.rand(N, 1) > 0.4).astype(np.float32)
    rgb = rs.rand(N, 3).astype(np.float32)
    if nan:
        rgb[5, 1] = np.nan
    return {"rays_o": o, "rays_d": d, "rgb": rgb, "mask": mask,
            "near": near, "far": far, "valid": np.ones((N, 1), np.float32)}


def _draws(variant, key, cfg, tcfg):
    """The uniforms the JAX step draws from ``key``, as the port's rand."""
    def occ_u(k, n, n_samples):
        _, sub = jax.random.split(k)
        return {"occ_u": torch.from_numpy(np.array(
            jax.random.uniform(sub, (n, n_samples))))}
    if variant == "plain":
        _, sub = jax.random.split(key)
        return {"t_rand": torch.from_numpy(np.array(
            jax.random.uniform(sub, (N, 1))))}
    if variant == "grid":
        return occ_u(key, N, cfg.n_samples)
    ka, kb = jax.random.split(key)
    return {"active": occ_u(ka, CAP, cfg.n_samples),
            "empty": occ_u(kb, N - CAP, tcfg.empty_n_samples)}


@pytest.fixture(scope="module")
def setup():
    """Configs, shared weights, the occupancy grid, and the three JAX steps
    compiled once."""
    jp, _, jcfg, tcfg_m = neus_pair()
    jt, tt = _tcfgs()
    # an occupancy grid of the central cube [-1.25, 1.25]^3: the sideways
    # rays of _batch miss it
    grid = np.zeros((8, 8, 8), np.float32)
    grid[2:6, 2:6, 2:6] = 1.0
    steps = {
        "plain": jax.jit(j_tr.make_neus_train_step(jcfg, jt, RADIUS)),
        "grid": jax.jit(j_tr.make_neus_train_step(jcfg, jt, RADIUS,
                                                  with_occ=True)),
        "two_tier": jax.jit(j_tr.make_neus_train_step(
            jcfg, jt, RADIUS, with_occ=True, active_cap=CAP)),
    }
    return {"jp": jax.tree_util.tree_map(np.asarray, jp), "jcfg": jcfg,
            "tcfg_m": tcfg_m, "jt": jt, "tt": tt, "grid": grid,
            "steps": steps}


def _port(setup, variant, use_fused_sdf=None):
    model = from_jax(setup["jp"], "neus")
    opt, step = t_tr.make_neus_train_step(
        model, setup["tcfg_m"], setup["tt"], RADIUS,
        with_occ=variant != "plain",
        active_cap=CAP if variant == "two_tier" else None,
        use_fused_sdf=use_fused_sdf)
    return model, opt, step


def _run_both(setup, variant, model, t_step, j_params, j_opt, step, seed,
              nan=False):
    b = _batch(seed, nan=nan)
    key = jax.random.PRNGKey(seed)
    grid = setup["grid"] if variant != "plain" else None
    j_args = (j_params, j_opt, {k: jnp.asarray(v) for k, v in b.items()},
              key, jnp.asarray(step, jnp.float32))
    if grid is not None:
        j_args += (jnp.asarray(grid),)
    j_params, j_opt, j_m = setup["steps"][variant](*j_args)
    t_m = t_step({k: torch.from_numpy(v) for k, v in b.items()}, step,
                 occ_grid=None if grid is None else torch.from_numpy(grid),
                 rand=_draws(variant, key, setup["jcfg"], setup["jt"]))
    return j_params, j_opt, j_m, t_m


def _compare_metrics(t_m, j_m, what):
    assert set(t_m) == set(j_m), what
    for k in j_m:
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=f"{what} {k}")


def _compare_tree(got, want, rtol, atol, what):
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert g_def == w_def, what
    for g, (path, w) in zip(g_leaves, w_leaves):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=what + jax.tree_util.keystr(path))


def _compare_scaled(got, want, tol, what):
    """Every leaf within tol of its largest entry."""
    g_leaves, g_def = jax.tree_util.tree_flatten(got)
    w_leaves, w_def = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert g_def == w_def, what
    for g, (path, w) in zip(g_leaves, w_leaves):
        err = float(np.abs(g - w).max())
        assert err <= tol * float(np.abs(w).max()), (
            what + jax.tree_util.keystr(path), err, float(np.abs(w).max()))


def _compare_adam(opt, model, j_opt, what):
    got = adam_state_to_jax(opt.state, model)
    assert int(got["count"]) == int(j_opt.count), what
    _compare_scaled(got["mu"], j_opt.mu, 2e-3, what + " mu")
    _compare_scaled(got["nu"], j_opt.nu, 4e-3, what + " nu")


@pytest.mark.parametrize("variant,fused", [
    ("plain", None), ("plain", True), ("grid", None), ("two_tier", None)])
def test_one_step_matches_jax(setup, variant, fused):
    model, opt, t_step = _port(setup, variant, use_fused_sdf=fused)
    j_params = jax.tree_util.tree_map(jnp.asarray, setup["jp"])
    j_opt = j_tr.init_neus_opt_state(j_params)
    before = dict(ks.LAUNCHES)
    j_params, j_opt, j_m, t_m = _run_both(setup, variant, model, t_step,
                                          j_params, j_opt, 3, seed=1)
    assert ks.LAUNCHES == before  # CPU tensors never launch a kernel
    want_keys = {"loss", "color_loss", "eikonal_loss", "mask_loss", "psnr",
                 "s_val", "lr", "nonfinite_grads"}
    if variant == "two_tier":
        want_keys |= {"active_frac", "overflow_frac"}
        assert 0.0 < float(t_m["active_frac"]) < 1.0
    assert set(t_m) == want_keys
    assert float(t_m["nonfinite_grads"]) == 0.0
    _compare_metrics(t_m, j_m, variant)
    _compare_adam(opt, model, j_opt, variant)
    # the gradient reaches all but a few elements
    assert (opt.state["mu"] != 0).float().mean() > 0.95
    _compare_tree(to_jax(model, "neus"), j_params, 1e-4, 2e-6,
                  variant + " params")


def test_five_steps_from_a_converted_adam_state(setup):
    jp = setup["jp"]
    rs = np.random.RandomState(4)
    j_params = jax.tree_util.tree_map(jnp.asarray, jp)
    j_opt = optax.ScaleByAdamState(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.float32(1e-2) * rs.randn(
                *np.shape(x)), jnp.float32), jp),
        nu=jax.tree_util.tree_map(
            lambda x: jnp.asarray(np.float32(1e-3) * rs.rand(
                *np.shape(x)) + 1e-4, jnp.float32), jp))
    model, opt, t_step = _port(setup, "grid")
    opt.state = adam_state_from_jax(j_opt, model)
    assert opt.state["mu"].shape == (sum(p.numel()
                                         for p in model.parameters()),)
    back = adam_state_to_jax(opt.state, model)
    _compare_tree(back["mu"], j_opt.mu, 0, 0, "round trip mu")
    _compare_tree(back["nu"], j_opt.nu, 0, 0, "round trip nu")
    for i in range(5):
        j_params, j_opt, j_m, t_m = _run_both(setup, "grid", model, t_step,
                                              j_params, j_opt, 4 + i,
                                              seed=10 + i)
        _compare_metrics(t_m, j_m, f"step {i}")
    _compare_adam(opt, model, j_opt, "five steps")
    _compare_tree(to_jax(model, "neus"), j_params, 1e-4, 2e-6,
                  "five steps params")

    # a poisoned batch: nothing moves on either side
    snap = copy.deepcopy(model.state_dict())
    opt_snap = {k: v.clone() for k, v in opt.state.items()}
    j_before = jax.tree_util.tree_map(np.asarray, j_params)
    j_params, j_opt, j_m, t_m = _run_both(setup, "grid", model, t_step,
                                          j_params, j_opt, 9, seed=20,
                                          nan=True)
    assert float(t_m["nonfinite_grads"]) == float(
        j_m["nonfinite_grads"]) == 1.0
    assert not np.isfinite(float(t_m["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, snap[k]), k
    for k, v in opt.state.items():
        assert torch.equal(v, opt_snap[k]), k
    _compare_tree(jax.tree_util.tree_map(np.asarray, j_params), j_before, 0,
                  0, "jax params after the skipped step")


def test_active_cap_needs_the_grid():
    _, model, _, tcfg_m = neus_pair()
    with pytest.raises(ValueError, match="with_occ"):
        t_tr.make_neus_train_step(model, tcfg_m, t_tr.NeuSTrainConfig(),
                                  RADIUS, active_cap=8)


# -- the runner ------------------------------------------------------------

RUNNER = dict(batch_size=32, end_iter=8, warm_up_end=2, save_freq=4,
              val_freq=10**9, mesh_freq=10**9, occ_res=8, occ_update_freq=2,
              carve_auto=True, carve_alt_sampler="12+4r1",
              carve_auto_thresh=0.0, carve_probe_res=16, tail_frac=0.25,
              tail_sampler="8+4r1", tail_occ=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("neus_scene"))
    _make_stage1_scene(root, n_train=2, n_val=1)
    return root


def _carve_lines(text):
    return re.findall(r"interior fraction ([0-9.]+) at iter (\d+) -> (\w+)",
                      text)


def test_runner_follows_the_jax_runner(scene, tmp_path, capsys):
    """Without perturbation, on shared initial weights: the same rays, the
    same occupancy rebuilds, the carve decision at the same iteration, the
    tail from the same step, and the same losses step by step."""
    jcfg, tcfg_m = small_cfgs(perturb=0.0, n_importance=4,
                              up_sample_steps=1)
    jt, tt = (j_tr.NeuSTrainConfig(**RUNNER), t_tr.NeuSTrainConfig(**RUNNER))
    j_ds = JNerfSceneDataset(scene, is_train=True, near=0.5, far=3.5)
    t_ds = NerfSceneDataset(scene, is_train=True, near=0.5, far=3.5)
    j_run = j_loop.NeuSRunner(jcfg, jt, j_ds, str(tmp_path / "j"), seed=3)
    t_run = t_loop.NeuSRunner(tcfg_m, tt, t_ds, str(tmp_path / "t"), seed=3,
                              device="cpu")
    t_run.params.load_state_dict(from_jax(
        jax.tree_util.tree_map(np.asarray, j_run.params),
        "neus").state_dict())
    capsys.readouterr()
    j_hist = j_run.train(log_every=1)
    j_lines = _carve_lines(capsys.readouterr().err)
    t_hist = t_run.train(log_every=1)
    t_lines = _carve_lines(capsys.readouterr().err)
    assert len(j_lines) == len(t_lines) == 1
    assert t_lines[0][1:] == j_lines[0][1:] == ("2", "switching")
    np.testing.assert_allclose(float(t_lines[0][0]), float(j_lines[0][0]),
                               atol=2e-3)
    assert t_run._carve_alt is True and j_run._carve_alt is True
    assert t_run.tail_start() == 6
    assert t_run.occ_builds == [0, 2, 4, 6]
    assert {k[1:] for k in t_run._fn_cache} == {
        (False, False), (False, True), (True, False)}
    assert len(t_hist) == len(j_hist) == 8
    for i, (t, j) in enumerate(zip(t_hist, j_hist)):
        assert set(t) == set(j)
        for k in ("loss", "color_loss", "eikonal_loss", "mask_loss", "s_val",
                  "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-3,
                                       err_msg=f"iter {i} {k}")
    _compare_tree(to_jax(t_run.params, "neus"), j_run.params, 1e-2, 1e-4,
                  "runner params")
    # the checkpoints: same steps, the layout run_gen_geo loads
    assert [os.path.basename(p) for p in t_ckpt.list_ckpts(
        str(tmp_path / "t"))] == ["ckpt-4", "ckpt-8"]
    state = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(str(tmp_path / "t")))
    assert state["iter_step"] == 8 and int(state["opt_state"]["count"]) == 8
    assert set(state) >= {"params", "opt_state", "iter_step"}
    assert os.path.isdir(tmp_path / "j" / "checkpoints" / "ckpt-8")

    # the mesh on shared weights, and the PLY writer byte for byte
    t_run.params.load_state_dict(from_jax(
        jax.tree_util.tree_map(np.asarray, j_run.params),
        "neus").state_dict())
    j_v, j_f = j_run.validate_mesh(resolution=16)
    t_v, t_f = t_run.validate_mesh(resolution=16)
    # the same triangles; the welded vertices' numbering may differ where a
    # corner rounds to the other side of the weld grid
    assert len(j_f) > 50 and t_f.shape == j_f.shape and t_v.shape == j_v.shape
    np.testing.assert_allclose(t_v[t_f], j_v[j_f], atol=1e-5)
    assert os.path.exists(tmp_path / "t" / "meshes" / "00000008.ply")
    j_loop._write_ply(str(tmp_path / "j.ply"), j_v, j_f)
    t_loop._write_ply(str(tmp_path / "t.ply"), j_v, j_f)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_runner_resumes_where_it_stopped(scene, tmp_path):
    """Eight steps in one go equal four, a checkpoint, and four more after
    a resume (perturbation on, the adaptive two-tier step too); the image
    validation writes a PNG; asking for CUDA without it raises."""
    _, tcfg_m = small_cfgs()
    tt = t_tr.NeuSTrainConfig(**dict(RUNNER, adaptive_empty=True,
                                     empty_n_samples=4))
    ds = NerfSceneDataset(scene, is_train=True, near=0.5, far=3.5)
    full = t_loop.NeuSRunner(tcfg_m, tt, ds, str(tmp_path / "full"),
                             val_dataset=ds, device="cpu")
    hist = full.train(log_every=4)
    assert full.iter_step == 8 and len(hist) == 2
    assert all(np.isfinite(h["loss"]) and h["nonfinite_grads"] == 0
               for h in hist)
    first = t_loop.NeuSRunner(tcfg_m, tt, ds, str(tmp_path / "part"),
                              device="cpu")
    first.train(n_iters=4)
    again = t_loop.NeuSRunner(tcfg_m, tt, ds, str(tmp_path / "part"),
                              device="cpu")
    assert again.try_resume() == 4
    again.train()
    for (k, a), b in zip(again.params.state_dict().items(),
                         full.params.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in full.opt.state.items():
        assert torch.equal(again.opt.state[k], v), k

    img, wsum = full.validate_image(0)
    assert img.shape == (ds.H, ds.W, 3) and wsum.shape == (ds.H, ds.W)
    assert os.path.exists(tmp_path / "full" / "validations_fine"
                          / "00000008_0.png")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_loop.NeuSRunner(tcfg_m, tt, ds, str(tmp_path / "x"))


def _reference_state_dict(jp, with_bg):
    """A reference-layout NeuS checkpoint of the JAX tree ``jp``."""
    def wn(layers):
        sd = {}
        for l, p in enumerate(layers):
            sd[f"lin{l}.weight_v"] = torch.from_numpy(np.asarray(p["v"]).T
                                                      .copy())
            sd[f"lin{l}.weight_g"] = torch.from_numpy(
                np.asarray(p["g"]).reshape(-1, 1).copy())
            sd[f"lin{l}.bias"] = torch.from_numpy(np.asarray(p["b"]).copy())
        return sd

    def dense(name, p):
        return {f"{name}.weight": torch.from_numpy(np.asarray(p["w"]).T
                                                   .copy()),
                f"{name}.bias": torch.from_numpy(np.asarray(p["b"]).copy())}

    ckpt = {"sdf_network_fine": wn(jp["sdf"]),
            "color_network_fine": wn(jp["color"]),
            "variance_network_fine": {"variance": torch.tensor(
                float(jp["variance"]["variance"]) + 0.1)},
            "iter_step": 1234}
    if with_bg:
        bg, sd = jp["bg"], {}
        for i, p in enumerate(bg["pts"]):
            sd.update(dense(f"pts_linears.{i}", p))
        sd.update(dense("views_linears.0", bg["views"][0]))
        for name in ("feature", "alpha", "rgb"):
            sd.update(dense(f"{name}_linear", bg[name]))
        ckpt["nerf"] = sd
    return ckpt


@pytest.mark.parametrize("n_outside", [0, 4])
def test_import_neus_matches_the_jax_importer(tmp_path, n_outside):
    jp, _, jcfg, tcfg_m = neus_pair(seed=5, n_outside=n_outside)
    ckpt = _reference_state_dict(jp, n_outside > 0)
    exp = tmp_path / "exp" / "checkpoints"
    exp.mkdir(parents=True)
    torch.save(ckpt, str(exp / "ckpt_001234.pth"))
    want, j_iter = j_import.import_neus(str(tmp_path / "exp"), jcfg)
    model, t_iter = t_import.import_neus(str(tmp_path / "exp"), tcfg_m,
                                         device="cpu")
    assert t_iter == j_iter == 1234
    assert model.has_bg == (n_outside > 0)
    _compare_tree(to_jax(model, "neus"), want, 0, 0, "imported")
    # a checkpoint of other widths is refused
    wide = dataclasses.replace(
        tcfg_m, sdf=dataclasses.replace(tcfg_m.sdf, d_hidden=48))
    with pytest.raises(ValueError, match="config mismatch"):
        t_import.import_neus(str(exp / "ckpt_001234.pth"), wide,
                             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_import.import_neus(str(tmp_path / "exp"), tcfg_m)


def test_runner_divergence_guard_and_dispatch_notice(scene, tmp_path, capsys):
    """A non-finite loss that the step's guard does not skip saves the
    failing state under debug_failure/ and raises; with the guard on, the
    same batch is skipped and training goes on. steps_per_dispatch > 1
    prints one notice and trains single steps."""
    _, tcfg_m = small_cfgs()
    ds = NerfSceneDataset(scene, is_train=True, near=0.5, far=3.5)
    base = dict(RUNNER, end_iter=2, save_freq=10**9, carve_auto=False,
                tail_frac=0.0)
    for guard in (False, True):
        tt = t_tr.NeuSTrainConfig(**base, skip_nonfinite_updates=guard,
                                  steps_per_dispatch=4)
        run = t_loop.NeuSRunner(tcfg_m, tt, ds, str(tmp_path / str(guard)),
                                device="cpu")
        assert "steps_per_dispatch=4" in capsys.readouterr().out
        host_batch = run._host_batch

        def poisoned():
            b = host_batch()
            b["rgb"][0, 0] = float("nan")
            return b
        run._host_batch = poisoned
        if guard:
            hist = run.train(log_every=1)
            assert [h["nonfinite_grads"] for h in hist] == [1.0, 1.0]
            assert run.iter_step == 2
        else:
            with pytest.raises(RuntimeError, match="non-finite loss"):
                run.train(log_every=1)
            assert t_ckpt.latest_ckpt(str(tmp_path / "False"
                                          / "debug_failure")) is not None
