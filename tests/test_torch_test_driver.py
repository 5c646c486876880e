"""The port's four-pass run_test against the JAX package's, end to end on
the CPU, and the port's import isolation from jax and cv2.

Both drivers run on the same synthetic scene (written with cv2 in the
reference layout, with a vis_comps GT-albedo mirror so that pd_test scales)
and the same parameters (JAX init, converted by from_jax). Every .npy they
write must agree at rtol=1e-4 (atol=1e-5, for values in [0, 1]) and every
PNG within 1 LSB: the 8-bit rounding of a value that differs in its last
float bits can flip by one.
"""

import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL, jax_params


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
LIGHT_H = 4  # 8-pixel-wide probes: cv2 writes them run-length encoded


def _scene(tmp_path):
    data_root, surf_root = _make_synth_scene(
        str(tmp_path / "data" / "nfr_blender"), light_h=LIGHT_H)
    rs = np.random.RandomState(3)
    for i in range(2):
        d = tmp_path / "data" / "vis_comps" / "scene" / ("val_%03d" % i)
        os.makedirs(d)
        cv2.imwrite(str(d / "albedo.png"),
                    (rs.rand(16, 16, 3) * 255).astype(np.uint8))
    env_dir = tmp_path / "test_envs"
    os.makedirs(env_dir)
    for name in ("city", "studio"):
        hdr = rs.rand(LIGHT_H, 2 * LIGHT_H, 3).astype(np.float32) * 3
        cv2.imwrite(str(env_dir / f"{name}.hdr"), hdr[..., ::-1])
    vali_dir = tmp_path / "vis_vali" / "epoch000000150"
    os.makedirs(vali_dir / "main_3")
    return data_root, surf_root, str(env_dir), str(vali_dir)


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        out.update(os.path.relpath(os.path.join(d, n), root) for n in names)
    return out


def test_run_test_matches_jax(tmp_path):
    _run_test_matches_jax(tmp_path, *_scene(tmp_path))


def test_run_test_exr_probes_matches_jax(tmp_path):
    """A probe directory of .exr files (float32, ZIP and half, ZIPS): both
    drivers glob hdr and exr, and the port reads the EXRs as JAX does."""
    from vqnerf_release_torch.data import exr as t_exr
    from vqnerf_release_torch.data import io as t_io
    data_root, surf_root, env_dir, vali_dir = _scene(tmp_path)
    exr_dir = tmp_path / "exr_envs"
    os.makedirs(exr_dir)
    for name, comp, dtype in (("city", "zip", np.float32),
                              ("studio", "zips", np.float16)):
        t_exr.write_exr(str(exr_dir / f"{name}.exr"),
                        t_io.read_hdr(os.path.join(env_dir, f"{name}.hdr")),
                        compression=comp, dtype=dtype)
    _run_test_matches_jax(tmp_path, data_root, surf_root, str(exr_dir),
                          vali_dir)


def _run_test_matches_jax(tmp_path, data_root, surf_root, env_dir,
                          vali_dir):
    from vqnerf_release_tpu.data.shape_dataset import \
        ShapeDataset as JShapeDataset
    from vqnerf_release_tpu.models import decomp_common as j_dc
    from vqnerf_release_tpu.pipelines import test_driver as j_driver
    from vqnerf_release_torch.data.shape_dataset import \
        ShapeDataset as TShapeDataset
    from vqnerf_release_torch.interop.jax_params import from_jax
    from vqnerf_release_torch.models import decomp_common as t_dc
    from vqnerf_release_torch.pipelines import test_driver as t_driver

    small = dict(SMALL, light_h=LIGHT_H)
    jcfg, tcfg = j_dc.DecompConfig(**small), t_dc.DecompConfig(**small)
    _, vq_np, ref_np = jax_params(light_h=LIGHT_H)

    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_info = j_driver.run_test(
        jax.tree_util.tree_map(jnp.asarray, ref_np),
        jax.tree_util.tree_map(jnp.asarray, vq_np), jcfg,
        JShapeDataset(data_root, surf_root, imh=16, mode="test",
                      with_ref=True),
        j_out, env_dir, vali_epoch_dir=vali_dir, data_root=data_root,
        scene_name="scene")
    t_info = t_driver.run_test(
        from_jax(ref_np, "ref_nfr"), from_jax(vq_np, "vq_nfr"), tcfg,
        TShapeDataset(data_root, surf_root, imh=16, mode="test",
                      with_ref=True),
        t_out, env_dir, vali_epoch_dir=vali_dir, data_root=data_root,
        scene_name="scene", device="cpu")

    assert t_info["n_vq"] == j_info["n_vq"] == 3
    np.testing.assert_allclose(t_info["opt_scale"], j_info["opt_scale"],
                               rtol=1e-4)
    files = _files(j_out)
    assert _files(t_out) == files
    assert any(f.endswith("pred_rgb_probes_city.png") for f in files)
    for f in sorted(files):
        jp, tp = os.path.join(j_out, f), os.path.join(t_out, f)
        if f.endswith(".npy"):
            np.testing.assert_allclose(np.load(tp), np.load(jp), rtol=1e-4,
                                       atol=1e-5, err_msg=f)
        elif f.endswith(".png"):
            want = cv2.imread(jp, cv2.IMREAD_UNCHANGED).astype(int)
            got = cv2.imread(tp, cv2.IMREAD_UNCHANGED).astype(int)
            assert got.shape == want.shape, f
            assert np.abs(got - want).max() <= 1, f
        else:
            with open(jp) as a, open(tp) as b:
                assert json.load(a) == json.load(b), f


def test_chunked_embed_matches_jax():
    """The VQ dropout fill is the largest distance of one call, so the
    segmentation depends on the chunking: the port chunks as JAX does."""
    from vqnerf_release_tpu.models import decomp_common as j_dc
    from vqnerf_release_tpu.models.vq_nfr import vq_fast_embed as j_embed
    from vqnerf_release_tpu.pipelines import test_driver as j_driver
    from vqnerf_release_tpu.train.loop import _forward_chunked as j_chunked
    from vqnerf_release_torch.interop.jax_params import from_jax
    from vqnerf_release_torch.models import decomp_common as t_dc
    from vqnerf_release_torch.models.vq_nfr import vq_fast_embed as t_embed
    from vqnerf_release_torch.pipelines import test_driver as t_driver
    import torch
    from tests.test_torch_models import batch_np

    assert t_driver._RAY_CHUNK == j_driver._RAY_CHUNK
    _, vq_np, _ = jax_params()
    model = from_jax(vq_np, "vq_nfr")
    jvq = jax.tree_util.tree_map(jnp.asarray, vq_np)
    b = batch_np(250, 8)
    thres = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    jcfg, tcfg = j_dc.DecompConfig(**SMALL), t_dc.DecompConfig(**SMALL)
    want = j_chunked(
        lambda bb: j_embed(jvq, bb, jcfg, thres=jnp.asarray(thres),
                           rng=jax.random.PRNGKey(0)),
        {k: jnp.asarray(v) for k, v in b.items()}, chunk=100)
    with torch.inference_mode():
        got = t_driver._forward_chunked(
            lambda bb: t_embed(model, bb, tcfg, thres=torch.from_numpy(thres),
                               rng=torch.Generator().manual_seed(0)),
            {k: torch.from_numpy(v) for k, v in b.items()}, 100)
    np.testing.assert_array_equal(got["embed"].numpy(), want["embed"])
    np.testing.assert_array_equal(got["alpha"].numpy(), want["alpha"])


_ISOLATION = """
import json, os, sys, tempfile
import chip_smoke as cs
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.models.decomp_common import DecompConfig
from vqnerf_release_torch.pipelines.test_driver import find_vq, run_test
from vqnerf_release_torch.train.loop import (train_nfr_unit, train_ref_nfr,
                                             train_vq_nfr)
cfg = DecompConfig(light_h=2, num_embed=4, num_drop=2, z_dim=16,
                   mlp_width=8, imh=16, thres_str="0.1;0.2", epochs=2,
                   n_rays_per_step=16, total_sample_vq=64)
with tempfile.TemporaryDirectory() as root:
    p = cs.write_scene(root, 16, 2, cfg.light_h, 2, 3, 0, n_train=2)
    ref, vq = cs.build_models(cfg, 0, "cpu")
    ds = ShapeDataset(p["data_root"], p["surf_root"], imh=16, mode="test",
                      with_ref=True)
    out = os.path.join(root, "out")
    info = run_test(ref, vq, cfg, ds, out, p["env_dir"],
                    vali_epoch_dir=p["vali_dir"], data_root=p["data_root"],
                    scene_name="sphere", device="cpu")
    n = cs.check_outputs(out, cs.expected_files(cfg, p["env_dir"]), 2, 3)

    views = {}
    for mode in ("train", "vali"):
        sd = ShapeDataset(p["data_root"], p["surf_root"], imh=16, mode=mode)
        views[mode] = [sd.load_view(f) for f in sd.files]
    nfr, h1 = train_nfr_unit(cfg, views["train"], views["vali"][:1],
                             os.path.join(root, "nfr"), epochs=1,
                             device="cpu")
    vq_model, ema, h2 = train_vq_nfr(cfg, nfr, views["train"],
                                     views["vali"][:1],
                                     os.path.join(root, "vq"), epochs=1,
                                     device="cpu")
    k = find_vq(os.path.join(root, "vq", "vis_vali", "epoch000000001"))
    for mode in ("train", "vali"):
        sd = ShapeDataset(p["data_root"], p["surf_root"], imh=16, mode=mode,
                          with_ref=True)
        views[mode] = [sd.load_view(f) for f in sd.files]
    import numpy as np
    light = np.load(os.path.join(root, "vq", "vis_vali", "np_light.npy"))
    _, h3 = train_ref_nfr(cfg, vq_model, light, views["train"],
                          views["vali"][:1], os.path.join(root, "ref"),
                          epochs=1, device="cpu")

    # a tiny stage-1 geometry extraction from the smoke's own scene writer
    from vqnerf_release_torch.models import fields
    from vqnerf_release_torch.pipelines import gen_geo
    data = cs.write_stage1_scene(os.path.join(root, "s1", cs.GEO_SCENE), 12,
                                 1, 1, 0)
    small = dict(sdf=fields.SDFConfig(d_hidden=32, n_layers=4, skip_in=(2,),
                                      multires=2, d_out=33),
                 color=fields.ColorConfig(d_feature=32, d_hidden=16,
                                          n_layers=2),
                 n_samples=8, n_importance=8, up_sample_steps=2)
    # stage-1 training first: run_gen_geo extracts from its checkpoint
    from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
    from vqnerf_release_torch.models.neus import NeuSConfig
    from vqnerf_release_torch.train.neus_loop import NeuSRunner
    from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig
    tcfg = NeuSTrainConfig(batch_size=32, end_iter=4, warm_up_end=1,
                           save_freq=4, val_freq=4, mesh_freq=4, occ_res=8,
                           occ_update_freq=2, tail_frac=0.25,
                           tail_sampler="8+8r2", tail_occ=True)
    nds = NerfSceneDataset(data, near=cs.GEO_NEAR, far=cs.GEO_FAR)
    runner = NeuSRunner(NeuSConfig(**small), tcfg, nds,
                        os.path.join(root, "s1o", "exp", cs.GEO_SCENE, "nerf"),
                        val_dataset=nds, device="cpu")
    h4 = [h["loss"] for h in runner.train(log_every=1)]
    done = gen_geo.run_gen_geo(cs.GEO_SCENE, data, os.path.join(root, "s1o"),
                               overrides=small, near=cs.GEO_NEAR,
                               far=cs.GEO_FAR, device="cpu", light_h=2,
                               vis_point_batch=16, batch_size=64)
    geo_ok = all(gen_geo.check_finished(d)
                 for d in done["train"] + done["val"])

    # the capture front end and the file formats
    from vqnerf_release_torch.data import io as vio
    from vqnerf_release_torch.data import exr, merl, nerf_rays_dataset
    from vqnerf_release_torch.models import shape_refine
    from vqnerf_release_torch.ops import geom, sphere_render
    from vqnerf_release_torch.preprocess import (aruco_cameras, colmap_model,
                                                 colmap_wrapper, data_gen)
    from vqnerf_release_torch.utils import backup
    jpg = vio.read_image(os.path.join("tests", "data", "torch_jpeg",
                                      "progressive_420_q90_512.jpg"))
    exr.write_exr(os.path.join(root, "probe.exr"),
                  np.ones((4, 8, 3), np.float32))
    env = vio.read_envmap(os.path.join(root, "probe.exr"), new_h=2)
    sphere = sphere_render.render_brdf_sphere(
        [0.5] * 3, 0.5, [0.04] * 3, np.ones((4, 8, 3), np.float32), imh=8,
        light_h=4, device="cpu")
    formats_ok = (jpg.shape == (512, 512, 3) and env.shape == (2, 4, 3)
                  and sphere.shape == (8, 8, 3))
print(json.dumps({"n_vq": info["n_vq"], "arrays": n, "trained_k": k,
                  "geo_views": len(done["train"] + done["val"]),
                  "geo_ok": geo_ok,
                  "steps": int(ema.counter), "losses": h1 + h2 + h3,
                  "neus_losses": h4, "formats_ok": formats_ok,
                  "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "cv2", "optax", "orbax", "vqnerf_release_tpu"))}))
"""


def test_port_runs_without_jax_or_cv2():
    """A tiny CPU run_test through the port, from chip_smoke's own scene
    writer and ``build_models``, a 1-epoch CPU training of nfr_unit, vq_nfr
    and ref_nfr, a tiny stage-1 NeuS training and the geometry extraction
    from its checkpoint, and the capture front end and file formats (the
    preprocessing modules, a JPEG decode, an EXR probe, the BRDF sphere)
    load neither jax nor cv2 nor any module of the JAX package."""
    # one thread, as the module pins it: the suite's workers share the host
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["loaded"] == []
    assert result["n_vq"] == 3 and result["arrays"] > 0
    assert result["geo_views"] == 2 and result["geo_ok"] is True
    assert result["steps"] == 2 and 2 <= result["trained_k"] <= 4
    assert len(result["losses"]) == 3 and np.isfinite(result["losses"]).all()
    assert len(result["neus_losses"]) == 4
    assert np.isfinite(result["neus_losses"]).all()
    assert result["formats_ok"] is True


def test_port_sources_do_not_import_the_jax_package():
    """No file of the port, nor chip_smoke.py, scripts/torch_acceptance.py
    or scripts/torch_vq_step_time.py, has an import of jax, optax, orbax,
    cv2, PIL, imageio, sklearn, pandas, tensorflow or the JAX package."""
    import ast
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_acceptance.py"),
             os.path.join(REPO, "scripts", "torch_vq_step_time.py")]
    for d, _, names in os.walk(os.path.join(REPO, "vqnerf_release_torch")):
        paths += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(paths) > 40
    assert any(p.endswith(os.path.join("pipelines", "gen_geo.py"))
               for p in paths)
    for name in ("cli.py", os.path.join("interop", "jax_ckpt.py"),
                 os.path.join("pipelines", "edit.py"),
                 os.path.join("pipelines", "edit_client.py"),
                 os.path.join("pipelines", "edit_web.py"),
                 os.path.join("pipelines", "gen_video.py"),
                 os.path.join("eval", "metric_eval.py"),
                 os.path.join("eval", "cluster_eval.py"),
                 os.path.join("eval", "meanshift.py"),
                 os.path.join("eval", "vis_csv.py"),
                 os.path.join("interop", "tf_bundle.py"),
                 os.path.join("interop", "tf_import.py"),
                 os.path.join("data", "jpeg.py"),
                 os.path.join("data", "exr.py"),
                 os.path.join("data", "merl.py"),
                 os.path.join("data", "nerf_rays_dataset.py"),
                 os.path.join("preprocess", "colmap_model.py"),
                 os.path.join("preprocess", "colmap_wrapper.py"),
                 os.path.join("preprocess", "aruco_cameras.py"),
                 os.path.join("preprocess", "data_gen.py"),
                 os.path.join("ops", "geom.py"),
                 os.path.join("ops", "sphere_render.py"),
                 os.path.join("models", "shape_refine.py"),
                 os.path.join("utils", "backup.py"),
                 os.path.join("interop", "torch_import.py"),
                 os.path.join("parallel", "__init__.py"),
                 os.path.join("parallel", "distributed.py"),
                 os.path.join("parallel", "mesh.py")):
        assert any(p.endswith(os.path.join("vqnerf_release_torch", name))
                   for p in paths), name
    banned = {"jax", "jaxlib", "optax", "orbax", "cv2", "PIL", "imageio",
              "sklearn", "pandas", "tensorflow", "vqnerf_release_tpu"}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            bad = [m for m in mods if m.split(".")[0] in banned]
            assert not bad, f"{path} imports {bad}"
