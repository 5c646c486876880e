"""The port's phase 3 (ref_nfr training) against the JAX package's, on the
CPU.

Parameters come from the JAX init (``tests/test_torch_models.jax_params``,
tiny widths), converted by ``from_jax(kind="ref_nfr")``; batches are seeded
numpy with background rows.

  * ``ref_nfr_forward`` in the train, vali and test modes (test with
    opt_scale, probes and OLATs) and ``ref_nfr_loss``, for CG and real
    data: rtol 1e-5, atol 1e-6 (the residual heads' roughness sits near
    0.5, where the GGX term keeps fp32's digits);
  * gradients of the loss: every trainable leaf against ``jax.grad`` at
    rtol 1e-4 (atol 1e-7; 5e-6 on the one-scalar gamma_index, whose
    gradient is a sum of terms that cancel), and none at all for the frozen
    encoder, spec head and light, even with their ``requires_grad`` on;
  * five steps of ``make_ref_nfr_step`` against the JAX step: parameters at
    rtol 1e-4 / atol 2e-6, moments as ``tests/test_torch_trainer.py``
    holds them; the frozen part bitwise unchanged; a NaN batch skipped;
  * ``train_ref_nfr``: the JAX loop's file tree; finite losses, and a run
    stopped after epoch 1 and resumed equal to the uninterrupted one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL, batch_np, jax_params
from tests.test_torch_train_loop import _tree_names
from tests.test_torch_trainer import (_assert_trees_close, _compare_ld,
                                      _compare_state)
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.models import ref_nfr as j_ref
from vqnerf_release_tpu.ops.light import olat_envmaps
from vqnerf_release_tpu.train import decomp_trainer as j_dt
from vqnerf_release_tpu.train import loop as j_loop
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.interop.jax_params import (from_jax,
                                                     opt_state_to_jax,
                                                     to_jax)
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.models import ref_nfr as t_ref
from vqnerf_release_torch.train import decomp_trainer as t_dt
from vqnerf_release_torch.train import loop as t_loop
from vqnerf_release_torch.utils import ckpt as t_ckpt


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 24
N_STEPS = 5
TRAIN = dict(SMALL, epochs=2, n_rays_per_step=16)


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False


def _cfgs(data_type):
    return (j_dc.DecompConfig(data_type=data_type, **SMALL),
            t_dc.DecompConfig(data_type=data_type, **SMALL))


def _tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def _split(b):
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _mode_kwargs(mode, n_lights, light_h):
    """(JAX kwargs, port kwargs) of a mode: test mode takes an albedo
    scale, three probes and the OLATs."""
    if mode != "test":
        return {}, {}
    rs = np.random.RandomState(3)
    olats = olat_envmaps(light_h)
    arrays = {
        "opt_scale": np.array([1.2, 0.9, 1.05], np.float32),
        "novel_probes": rs.rand(3, n_lights, 3).astype(np.float32),
        "novel_olat": np.stack([v.reshape(-1, 3) for v in olats.values()]
                               ).astype(np.float32),
    }
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
@pytest.mark.parametrize("mode", ["train", "vali", "test"])
def test_ref_nfr_forward_and_loss_match_jax(data_type, mode):
    jcfg, tcfg = _cfgs(data_type)
    _, _, ref_np = jax_params(data_type)
    model = from_jax(ref_np, "ref_nfr")
    jb, tb = _split(batch_np(N, jcfg.n_lights))
    jl = j_dc.light_constants(jcfg)
    tl = t_dc.light_constants(tcfg, "cpu")
    jkw, tkw = _mode_kwargs(mode, jcfg.n_lights, jcfg.light_h)
    j_pred, j_aux = j_ref.ref_nfr_forward(_tree(ref_np), jb, jcfg, *jl,
                                          mode=mode, **jkw)
    with torch.no_grad():
        t_pred, t_aux = t_ref.ref_nfr_forward(model, tb, tcfg, *tl,
                                              mode=mode, **tkw)
    want_keys = {"rgb", "normal", "albedo", "basecolor", "spec", "rough",
                 "ks", "alpha"}
    if mode != "train":
        want_keys |= {"rgb_diff", "rgb_spec"}
    if mode == "test":
        want_keys |= {"rgb_probes", "rgb_olat"}
    assert set(t_pred) == set(j_pred) == want_keys
    for got, want in ((t_pred, j_pred), (t_aux, j_aux)):
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].shape == w.shape, k
            np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    j_loss, j_ld = j_ref.ref_nfr_loss(j_aux, jcfg, mode=mode)
    t_loss, t_ld = t_ref.ref_nfr_loss(t_aux, tcfg, mode=mode)
    assert set(t_ld) == set(j_ld) == {"rgb", "loss"}
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for k in j_ld:
        np.testing.assert_allclose(float(t_ld[k]), float(j_ld[k]), rtol=1e-5)


def _grads_as_jax(module, kind):
    holder = copy.deepcopy(module)
    with torch.no_grad():
        for h, p in zip(holder.parameters(), module.parameters()):
            h.copy_(torch.zeros_like(p) if p.grad is None else p.grad)
    return to_jax(holder, kind)


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
def test_ref_nfr_gradients_reach_the_trainable_part_only(data_type):
    jcfg, tcfg = _cfgs(data_type)
    _, _, ref_np = jax_params(data_type)
    model = from_jax(ref_np, "ref_nfr")
    jb, tb = _split(batch_np(N, jcfg.n_lights))
    jl = j_dc.light_constants(jcfg)

    def j_loss(train, frozen):
        _, aux = j_ref.ref_nfr_forward({"frozen": frozen, "train": train},
                                       jb, jcfg, *jl, mode="train")
        return j_ref.ref_nfr_loss(aux, jcfg)[0]

    j_params = _tree(ref_np)
    want, want_frozen = jax.grad(j_loss, argnums=(0, 1))(
        j_params["train"], j_params["frozen"])
    # JAX's stop_gradient: no cotangent reaches the frozen leaves
    assert all(not np.asarray(x).any()
               for x in jax.tree_util.tree_leaves(want_frozen))

    # even a frozen part whose requires_grad was turned back on gets none
    model.frozen.requires_grad_(True)
    _, aux = t_ref.ref_nfr_forward(model, tb, tcfg,
                                   *t_dc.light_constants(tcfg, "cpu"),
                                   mode="train")
    t_ref.ref_nfr_loss(aux, tcfg)[0].backward()
    for name, p in model.frozen.named_parameters():
        assert p.grad is None, name
    g_leaves, g_def = jax.tree_util.tree_flatten(
        _grads_as_jax(model.trainable, "ref_nfr/train"))
    w_leaves, w_def = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, want))
    assert g_def == w_def
    assert all(p.grad is not None for p in model.trainable.parameters())
    for g, (path, w) in zip(g_leaves, w_leaves):
        name = jax.tree_util.keystr(path)
        assert np.isfinite(w).all() and np.abs(w).max() > 0, name
        atol = 5e-6 if "gamma_index" in name else 1e-7
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol, err_msg=name)


def _batch(step, n_lights, nan=False):
    b = batch_np(N, n_lights, seed=200 + step)
    if nan:
        b["ref"][4, 0] = np.nan
    return b


@pytest.mark.parametrize("data_type", ["nerf", "dtu"])
def test_ref_nfr_steps_match_jax(data_type):
    jcfg, tcfg = _cfgs(data_type)
    _, _, ref_np = jax_params(data_type)
    tx, j_step = j_dt.make_ref_nfr_step(jcfg, *j_dc.light_constants(jcfg))
    j_params = _tree(ref_np)
    j_opt = tx.init(j_params["train"])
    model = from_jax(ref_np, "ref_nfr")
    frozen0 = copy.deepcopy(model.frozen.state_dict())
    opt, t_step = t_dt.make_ref_nfr_step(
        model, tcfg, *t_dc.light_constants(tcfg, "cpu"))
    assert len(opt.params) == len(list(model.trainable.parameters()))
    for step in range(N_STEPS):
        jb, tb = _split(_batch(step, jcfg.n_lights))
        j_params, j_opt, j_ld = j_step(j_params, j_opt, jb,
                                       jnp.asarray(step, jnp.float32))
        t_ld = t_step(tb, step)
        _compare_ld(t_ld, j_ld, f"step {step}")
        assert float(t_ld["nonfinite_grads"]) == 0.0
    _compare_state(model.trainable, opt, "ref_nfr/train", j_params["train"],
                   j_opt, "ref_nfr")
    for k, v in model.frozen.state_dict().items():
        assert torch.equal(v, frozen0[k]), k
    _assert_trees_close(to_jax(model, "ref_nfr")["frozen"],
                        j_params["frozen"], 0, 0, "frozen")

    # a poisoned reference buffer: nothing moves, on either side
    before = copy.deepcopy(model.state_dict())
    opt_before = {k: v.clone() for k, v in opt.state.items()}
    jb, tb = _split(_batch(99, jcfg.n_lights, nan=True))
    _, _, j_ld = j_step(j_params, j_opt, jb, jnp.asarray(5, jnp.float32))
    t_ld = t_step(tb, 5)
    assert float(t_ld["nonfinite_grads"]) == float(
        j_ld["nonfinite_grads"]) == 1.0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in opt.state.items():
        assert torch.equal(v, opt_before[k]), k
    got = opt_state_to_jax(opt.state, model.trainable, "ref_nfr/train")
    assert int(got["count"]) == N_STEPS


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_scene")
    data_root, surf_root = _make_synth_scene(str(root), n_train=2, n_val=1)
    load = lambda mode: [  # noqa: E731
        ds.load_view(f) for ds in [ShapeDataset(
            data_root, surf_root, imh=16, mode=mode, with_ref=True)]
        for f in ds.files]
    return {"train": load("train"), "vali": load("vali")}


def test_train_ref_nfr_writes_the_file_tree_of_jax(scene, tmp_path):
    """train_ref_nfr for 2 epochs from a converted VqNfr and a light writes
    the JAX loop's file names."""
    _, vq_np, ref_np = jax_params()
    light = np.asarray(ref_np["frozen"]["light"])
    jcfg = j_dc.DecompConfig(**TRAIN, device_views="off")
    j_loop.train_ref_nfr(jcfg, _tree(vq_np), light, scene["train"],
                         scene["vali"], str(tmp_path / "j_ref"))
    t_loop.train_ref_nfr(t_dc.DecompConfig(**TRAIN), from_jax(vq_np, "vq_nfr"),
                         light, scene["train"], scene["vali"],
                         str(tmp_path / "t_ref"), device="cpu")
    want = _tree_names(tmp_path / "j_ref")
    got = _tree_names(tmp_path / "t_ref")
    assert got == want, (sorted(got - want), sorted(want - got))
    assert "vis_vali/epoch000000002/batch000000000/pred_rgb_diff.png" in got


def test_train_ref_nfr_checkpoints_and_resumes(scene, tmp_path):
    """train_ref_nfr for 2 epochs: finite losses, a checkpoint that holds the
    returned model with the frozen part unchanged; a run stopped after epoch
    1 and resumed equals the uninterrupted one; views without the reference
    buffer are refused, and so is a card that is not there."""
    _, vq_np, ref_np = jax_params()
    light = np.asarray(ref_np["frozen"]["light"])
    tcfg = t_dc.DecompConfig(**TRAIN)
    vq = from_jax(vq_np, "vq_nfr")
    vq0 = copy.deepcopy(vq.state_dict())
    model, hist = t_loop.train_ref_nfr(
        tcfg, vq, light, scene["train"], scene["vali"],
        str(tmp_path / "t_ref"), device="cpu")
    assert len(hist) == 2 and np.isfinite(hist).all()
    for k, v in vq.state_dict().items():
        assert torch.equal(v, vq0[k]), k
    frozen = model.frozen
    assert torch.equal(frozen.light, torch.from_numpy(light))
    for name in ("fine_enc", "bottleneck"):
        for a, b in zip(getattr(frozen, name).parameters(),
                        getattr(vq, name).parameters()):
            assert torch.equal(a, b), name
    for a, b in zip(frozen.spec_out.parameters(), vq.spec_main.parameters()):
        assert torch.equal(a, b)
    state = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(str(tmp_path / "t_ref")))
    assert state["epoch"] == 2 and int(state["opt_state"]["count"]) == 4
    for k, v in model.state_dict().items():
        assert torch.equal(state["params"][k], v), k

    t_loop.train_ref_nfr(tcfg, vq, light, scene["train"], scene["vali"],
                         str(tmp_path / "r_ref"), epochs=1, device="cpu")
    resumed, hist_r = t_loop.train_ref_nfr(
        tcfg, vq, light, scene["train"], scene["vali"],
        str(tmp_path / "r_ref"), device="cpu")
    assert len(hist_r) == 1
    for (k, a), b in zip(resumed.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), k

    no_ref = [copy.copy(v) for v in scene["train"]]
    for v in no_ref:
        v.ref = None
    with pytest.raises(ValueError, match="with_ref"):
        t_loop.train_ref_nfr(tcfg, vq, light, no_ref, scene["vali"],
                             str(tmp_path / "x"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_loop.train_ref_nfr(tcfg, vq, light, scene["train"],
                                 scene["vali"], str(tmp_path / "y"))
