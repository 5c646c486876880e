"""JAX checkpoints into the port's, on the CPU: for each of the four kinds
(nfr_unit, vq_nfr, ref_nfr, neus) a JAX state is saved with the JAX
package's own orbax ``save_ckpt``, exported by
``scripts/export_jax_ckpt.py`` and imported by
``vqnerf_release_torch.interop.jax_ckpt``. The port's checkpoint, taken
back through ``to_jax`` and the ``*_to_jax`` converters, equals the JAX
state bit for bit: parameters, VQ EMA state and optimizer state. The
states are the JAX init functions' with every optimizer and EMA leaf
filled with seeded noise, so that no leaf is trivially zero.

Then the port takes the imports as its own: the CLI's loader builds the
served models from them (strict), ``NeuSRunner.try_resume`` resumes the
NeuS one, and one resumed epoch of ``train_nfr_unit`` starts from the
imported epoch with fresh random streams (a JAX checkpoint holds none).
Last, a vq_nfr and a ref_nfr each one JAX training step past their init,
checkpointed by the JAX package, are served by the port's ``cli test``
and by the JAX ``cli test``: every written array within rtol 1e-4 /
atol 1e-5 and every PNG within 1 LSB, as tests/test_torch_test_driver.py
holds the two drivers.
"""

import importlib.util
import json
import os
from os.path import join

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL
from vqnerf_release_tpu import config as j_config
from vqnerf_release_tpu.utils import ckpt as j_ckpt
from vqnerf_release_torch import cli as t_cli
from vqnerf_release_torch import config as t_config
from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.interop import jax_ckpt
from vqnerf_release_torch.interop import jax_params as jp
from vqnerf_release_torch.train import loop as t_loop
from vqnerf_release_torch.train.neus_loop import NeuSRunner
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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "lego_3072"
OVERRIDE = ",".join("%s=%s" % kv for kv in SMALL.items())


def _exporter():
    spec = importlib.util.spec_from_file_location(
        "export_jax_ckpt", join(REPO, "scripts", "export_jax_ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXPORT = _exporter()


def _configs(kind, data_type="nerf", **extra):
    """(JAX config, port config) of a kind at the test's widths."""
    if kind == "neus":
        return (j_config.neus_configs_for_scene(SCENE)[0],
                t_config.neus_configs_for_scene(SCENE)[0])
    kw = dict(SMALL, data_type=data_type, **extra)
    return (j_config.decomp_config_for_scene(SCENE, **kw)[0],
            t_config.decomp_config_for_scene(SCENE, **kw)[0])


def _noisy_state(kind, cfg, step, seed=5):
    """The JAX init state of ``kind`` with every optimizer and EMA leaf
    replaced by seeded noise of its shape and dtype."""
    rs = np.random.RandomState(seed)
    state = EXPORT.example_state(kind, cfg, seed=seed)

    def noise(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.asarray(rs.randint(1, 1000), x.dtype).reshape(x.shape)
        return np.abs(rs.standard_normal(x.shape)).astype(x.dtype)

    for key in ("opt_state", "ema"):
        if key in state:
            state[key] = jax.tree_util.tree_map(noise, state[key])
    state["iter_step" if kind == "neus" else "epoch"] = step
    return jax.tree_util.tree_map(np.asarray, state)


def _round_trip(kind, cfg, path):
    """The port's checkpoint at ``path`` taken back to a JAX-layout state
    with numpy leaves."""
    state = t_ckpt.load_ckpt(path)
    if kind == "neus":
        from vqnerf_release_torch.models.neus import init_neus
        model = init_neus(0, cfg)
        model.load_state_dict(state["params"])
        return {"params": jp.to_jax(model, "neus"),
                "opt_state": jp.adam_state_to_jax(state["opt_state"], model),
                "iter_step": state["iter_step"]}
    model = t_loop.phase_model(cfg, kind)
    model.load_state_dict(state["params"])
    opt_model, opt_kind = ((model.trainable, "ref_nfr/train")
                           if kind == "ref_nfr" else (model, kind))
    out = {"params": jp.to_jax(model, kind),
           "opt_state": jp.opt_state_to_jax(state["opt_state"], opt_model,
                                            opt_kind),
           "epoch": state["epoch"]}
    if kind == "vq_nfr":
        out["ema"] = jp.ema_to_jax(state["ema"])
    return out


def _assert_bit_equal(got, want):
    g = jax_ckpt.flatten_tree(got)
    w = jax_ckpt.flatten_tree(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert np.array_equal(g[key], w[key]), key


@pytest.mark.parametrize("kind,data_type,extra", [
    ("nfr_unit", "nerf", {}), ("vq_nfr", "nerf", {}), ("ref_nfr", "nerf", {}),
    ("nfr_unit", "hw", {}), ("vq_nfr", "hw", {}), ("ref_nfr", "hw", {}),
    # an INI's clipnorm chains a clip before amsgrad: a state of two parts
    ("vq_nfr", "nerf", {"clipnorm": 1.0}),
    ("neus", None, {})])
def test_exported_and_imported_state_equals_jax(tmp_path, kind, data_type,
                                                extra):
    j_cfg, t_cfg = _configs(kind, data_type, **extra)
    state = _noisy_state(kind, j_cfg, 7)
    j_dir = str(tmp_path / "jax")
    j_ckpt.save_ckpt(j_dir, 7, state)
    npz = str(tmp_path / "state.npz")
    EXPORT.export(j_dir, npz, kind, j_cfg)
    path = jax_ckpt.import_npz(npz, str(tmp_path / "port"), kind, t_cfg)
    assert os.path.basename(path) == "ckpt-7"
    ported = t_ckpt.load_ckpt(path)
    assert "rng" not in ported  # a JAX checkpoint holds no stream state
    want = dict(state)
    if extra:  # the clip's state has no leaves; amsgrad's is the second
        assert jax.tree_util.tree_leaves(state["opt_state"][0]) == []
        want["opt_state"] = state["opt_state"][1]
    _assert_bit_equal(_round_trip(kind, t_cfg, path), want)
    if kind == "vq_nfr":  # ref_nfr's input, as the validation writes it
        light = np.load(tmp_path / "port" / "vis_vali" / "np_light.npy")
        np.testing.assert_array_equal(
            light, np.maximum(state["params"]["light"], 0))


def test_command_lines_and_the_cli_loaders(tmp_path, capsys):
    """Both halves through their command lines, vq_nfr and ref_nfr into
    the tree the CLI reads; the CLI's loader builds the served models from
    them, strict, and the RefNfr's frozen part is the checkpoint's."""
    j_cfg, t_cfg = _configs("vq_nfr")
    out = str(tmp_path / "output")
    for seed, kind in enumerate(("vq_nfr", "ref_nfr")):
        state = _noisy_state(kind, j_cfg, 3, seed=11 + seed)
        j_dir = str(tmp_path / ("jax_" + kind))
        j_ckpt.save_ckpt(j_dir, 3, state)
        npz = str(tmp_path / (kind + ".npz"))
        EXPORT.main([j_dir, npz, "--kind", kind, "--scene", SCENE,
                     "--preset-override", OVERRIDE])
        said = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert said["written"] == npz and said["kind"] == kind
        jax_ckpt.main([npz, t_config.train_outdir(out, SCENE, kind),
                       "--kind", kind, "--scene", SCENE,
                       "--preset-override", OVERRIDE])
    vq_out = t_config.train_outdir(out, SCENE, "vq_nfr")
    vq = t_cli._load_phase_model(vq_out, t_cfg, "vq_nfr", torch.device("cpu"))
    ref = t_cli._load_phase_model(
        t_config.train_outdir(out, SCENE, "ref_nfr"), t_cfg, "ref_nfr",
        torch.device("cpu"), vq=vq, light=t_cli._np_light(vq_out))
    want = state["params"]
    _assert_bit_equal(jp.to_jax(ref, "ref_nfr"), want)
    assert not torch.equal(ref.frozen.fine_enc.layers[0].weight,
                           vq.fine_enc.layers[0].weight)


def test_neus_import_resumes_in_the_runner(tmp_path):
    j_cfg, t_cfg = _configs("neus")
    state = _noisy_state("neus", j_cfg, 40)
    j_ckpt.save_ckpt(str(tmp_path / "jax"), 40, state)
    EXPORT.export(str(tmp_path / "jax"), str(tmp_path / "n.npz"), "neus",
                  j_cfg)
    exp_dir = str(tmp_path / "out" / "exp" / SCENE / "nerf")
    jax_ckpt.import_npz(str(tmp_path / "n.npz"), exp_dir, "neus", t_cfg)
    data = chip_smoke.write_stage1_scene(str(tmp_path / "scene"), 12, 1, 1, 0)
    _, tcfg, _ = t_config.neus_configs_for_scene(SCENE)
    runner = NeuSRunner(t_cfg, tcfg, NerfSceneDataset(data, near=0.5,
                                                      far=3.5),
                        exp_dir, device="cpu")
    assert runner.try_resume() == 40
    _assert_bit_equal(jp.to_jax(runner.params, "neus"), state["params"])
    _assert_bit_equal(jp.adam_state_to_jax(runner.opt.state, runner.params),
                      state["opt_state"]._asdict())


def test_resumed_epoch_starts_from_the_import_and_follows_jax(tmp_path):
    """A JAX nfr_unit checkpoint of epoch 1, imported, and trained one more
    epoch by the port: the port resumes at epoch 2 from the imported
    optimizer count, with fresh streams (the checkpoint has none, as a JAX
    loop resumes), and writes that epoch's log, checkpoint and
    validation."""
    data_root, surf_root = _make_synth_scene(str(tmp_path / "s"), n_train=2,
                                             n_val=1)
    views = {m: [ds.load_view(f) for ds in [ShapeDataset(
        data_root, surf_root, imh=16, mode=m)] for f in ds.files]
        for m in ("train", "vali")}
    kw = dict(SMALL, epochs=2, n_rays_per_step=16, total_sample_vq=64)
    j_cfg = j_config.decomp_config_for_scene(SCENE, **kw)[0]
    t_cfg = t_config.decomp_config_for_scene(SCENE, **kw)[0]
    j_dir = str(tmp_path / "jax")
    state = _noisy_state("nfr_unit", j_cfg, 1)
    state["opt_state"]["count"] = np.asarray(2, np.int32)  # 2 views, 1 epoch
    j_ckpt.save_ckpt(j_dir, 1, state)
    EXPORT.export(j_dir, str(tmp_path / "e1.npz"), "nfr_unit", j_cfg)
    t_dir = str(tmp_path / "port")
    jax_ckpt.import_npz(str(tmp_path / "e1.npz"), t_dir, "nfr_unit", t_cfg)

    model, hist = t_loop.train_nfr_unit(t_cfg, views["train"],
                                        views["vali"], t_dir, device="cpu")
    rows = [json.loads(x) for x in open(join(t_dir, "train_log.jsonl"))]
    assert [r["epoch"] for r in rows] == [2] and len(hist) == 1
    resumed = t_ckpt.load_ckpt(t_ckpt.latest_ckpt(t_dir))
    assert resumed["epoch"] == 2
    assert int(resumed["opt_state"]["count"]) == 2 * len(views["train"])
    assert os.path.isdir(join(t_dir, "vis_vali", "epoch000000002"))

    moved = jax_ckpt.flatten_tree(jp.to_jax(model, "nfr_unit"))
    for key, start in jax_ckpt.flatten_tree(state["params"]).items():
        assert moved[key].shape == start.shape, key
    assert any(not np.array_equal(moved[k], v) for k, v in
               jax_ckpt.flatten_tree(state["params"]).items())


def _one_jax_step(kind, cfg, params, seed):
    """(params, opt_state, ema) after one JAX training step of ``kind``
    from ``params`` on a seeded batch."""
    import jax.numpy as jnp
    from tests.test_torch_models import batch_np
    from vqnerf_release_tpu.models import decomp_common as j_dc
    from vqnerf_release_tpu.ops.vq import init_vq_ema_state
    from vqnerf_release_tpu.train import decomp_trainer as j_dt

    lxyz, lareas = j_dc.light_constants(cfg)
    batch = {k: jnp.asarray(v) for k, v in
             batch_np(64, cfg.n_lights, seed=seed).items()}
    params = jax.tree_util.tree_map(jnp.asarray, params)
    step = jnp.asarray(0, jnp.float32)
    if kind == "vq_nfr":
        tx, fn = j_dt.make_vq_nfr_step(cfg, lxyz, lareas)
        del batch["ref"]
        params, ema, opt, _ = fn(
            params, init_vq_ema_state(cfg.z_dim, cfg.num_embed),
            tx.init(params), batch, jnp.asarray(cfg.train_thres()),
            jax.random.PRNGKey(seed), step)
        return params, opt, ema
    tx, fn = j_dt.make_ref_nfr_step(cfg, lxyz, lareas)
    params, opt, _ = fn(params, tx.init(params["train"]), batch, step)
    return params, opt, None


def test_jax_checkpoint_served_by_the_port_as_by_jax(tmp_path):
    import cv2
    from vqnerf_release_tpu import cli as j_cli
    from vqnerf_release_tpu.models.ref_nfr import init_ref_nfr

    data_root, surf_root = _make_synth_scene(
        str(tmp_path / "data" / "nfr_blender"), n_val=1)  # one served view
    rs = np.random.RandomState(3)
    d = tmp_path / "data" / "vis_comps" / "scene" / "val_000"
    os.makedirs(d)
    for name in ("albedo.png", "metal.png"):  # the albedo scale's GT maps
        cv2.imwrite(str(d / name), (rs.rand(16, 16, 3) * 255).astype(
            np.uint8))
    env_dir = str(tmp_path / "envs")
    os.makedirs(env_dir)
    cv2.imwrite(join(env_dir, "city.hdr"),
                (rs.rand(2, 4, 3) * 3).astype(np.float32))
    j_cfg, t_cfg = _configs("vq_nfr")
    from tests.test_torch_models import jax_params
    _, vq0, _ = jax_params()
    vq, vq_opt, ema = _one_jax_step("vq_nfr", j_cfg, vq0, 1)
    light = (rs.rand(*j_cfg.light_res, 3) * 0.5).astype(np.float32)
    ref0 = init_ref_nfr(0, j_cfg, jax.tree_util.tree_map(np.asarray, vq),
                        light)
    ref, ref_opt, _ = _one_jax_step("ref_nfr", j_cfg, ref0, 2)
    states = {"vq_nfr": {"params": vq, "ema": ema, "opt_state": vq_opt,
                         "epoch": 1},
              "ref_nfr": {"params": ref, "opt_state": ref_opt, "epoch": 1}}

    j_out, t_out = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    for kind, state in states.items():
        j_dir = t_config.train_outdir(j_out, SCENE, kind)
        j_ckpt.save_ckpt(j_dir, 1, state)
        npz = str(tmp_path / (kind + ".npz"))
        EXPORT.export(j_dir, npz, kind, j_cfg)
        jax_ckpt.import_npz(npz, t_config.train_outdir(t_out, SCENE, kind),
                            kind, t_cfg)
    for out in (j_out, t_out):  # the selected code count, main_3
        os.makedirs(join(t_config.train_outdir(out, SCENE, "vq_nfr"),
                         "vis_vali", "epoch000000001", "main_3"))
    common = ["test", SCENE, "--data-root", data_root, "--surf-root",
              surf_root, "--test-envmap-dir", env_dir, "--preset-override",
              OVERRIDE]
    j_cli.main([*common, "--output-root", j_out])
    t_cli.main([*common, "--output-root", t_out, "--device", "cpu"])

    served = [join(t_config.train_outdir(out, SCENE, "ref_nfr"), "vis_test",
                   "latest") for out in (j_out, t_out)]
    files = sorted(os.path.relpath(join(d, n), served[0])
                   for d, _, names in os.walk(served[0]) for n in names)
    assert len(files) > 30 and any("pd_relit" in f for f in files)
    got = sorted(os.path.relpath(join(d, n), served[1])
                 for d, _, names in os.walk(served[1]) for n in names)
    assert got == files
    for f in files:
        jp, tp = join(served[0], f), join(served[1], f)
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(tp), np.load(jp), rtol=1e-4,
                                       atol=1e-5, err_msg=f)
        elif f.endswith(".png"):
            want = cv2.imread(jp, cv2.IMREAD_UNCHANGED).astype(int)
            have = cv2.imread(tp, cv2.IMREAD_UNCHANGED).astype(int)
            assert have.shape == want.shape, f
            assert np.abs(have - want).max() <= 1, f
        else:
            assert json.load(open(tp)) == json.load(open(jp)), f
