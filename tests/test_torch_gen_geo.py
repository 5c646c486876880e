"""The port's stage-1 datasets and geometry extractor against the JAX
package's, on the CPU, on one tiny written scene and shared weights.

A whole ``extract_views`` runs through both packages and is compared file
by file: every .npy at rtol 1e-4 / atol 1e-4 (fp32 through two up-sample
rounds and a 16-sample composite; the JAX extractor pads its last batches
to fixed shapes and the port runs them ragged, which must not change a
value) and every PNG within 1 LSB (the 8-bit truncation of a value that
differs in its last float bits can flip by one).
"""

import json
import os

import cv2
import jax
import numpy as np
import pytest
import torch

from tests.test_gen_geo import H, W, _make_stage1_scene
from tests.test_torch_fields import neus_pair
from vqnerf_release_tpu.data import io as j_io
from vqnerf_release_tpu.data import neus_dataset as j_ds
from vqnerf_release_tpu.data import rays as j_rays
from vqnerf_release_tpu.pipelines import gen_geo as j_geo
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.data import neus_dataset as t_ds
from vqnerf_release_torch.data import rays as t_rays
from vqnerf_release_torch.data.shape_dataset import ShapeDataset
from vqnerf_release_torch.kernels import sdf as ks
from vqnerf_release_torch.pipelines import gen_geo as t_geo

LIGHT_H = 2
NEAR, FAR = 0.5, 3.5
KW = dict(batch_size=64, light_h=LIGHT_H, vis_point_batch=16)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return _make_stage1_scene(str(tmp_path_factory.mktemp("scene")))


def _datasets(root, is_train=True, **kw):
    return (j_ds.NerfSceneDataset(root, is_train=is_train, near=NEAR,
                                  far=FAR, **kw),
            t_ds.NerfSceneDataset(root, is_train=is_train, near=NEAR,
                                  far=FAR, **kw))


def test_stage1_ray_helpers_are_bit_equal_copies():
    rs = np.random.RandomState(0)
    o, d = rs.randn(9, 3), rs.randn(9, 3)
    poses = [rs.randn(4, 4) for _ in range(3)]
    for got, want in zip(t_rays.near_far_fixed(5, 0.5, 3.5),
                         j_rays.near_far_fixed(5, 0.5, 3.5)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(t_rays.near_far_sphere(o, d),
                         j_rays.near_far_sphere(o, d)):
        np.testing.assert_array_equal(got, want)
    assert t_rays.max_radius_from_poses(poses, 2.0, 6.0) == \
        j_rays.max_radius_from_poses(poses, 2.0, 6.0)


def test_read_rgba16_matches_jax(scene, tmp_path):
    path = os.path.join(scene, "train_000", "rgba.png")
    for longint in (True, False):
        want = j_io.read_rgba16(path, longint=longint)
        got = t_io.read_rgba16(path, longint=longint)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    rgb8 = (np.random.RandomState(1).rand(5, 7, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "rgb8.png"), rgb8[..., ::-1])
    np.testing.assert_array_equal(
        t_io.read_rgba16(str(tmp_path / "rgb8.png")), rgb8)
    with pytest.raises(FileNotFoundError):
        t_io.read_rgba16(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("h,w,new_h", [(12, 12, 8), (12, 16, 20),
                                       (37, 53, 24), (64, 48, 100),
                                       (30, 30, 45), (16, 16, 16)])
def test_resize_u8_linear_is_within_one_of_cv2(h, w, new_h):
    img = (np.random.RandomState(h).rand(h, w, 4) * 255).astype(np.uint8)
    k = new_h / h
    want = cv2.resize(img, (int(w * k), int(new_h)))
    got = t_io.resize_u8_linear(img, int(new_h), int(w * k))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    gray = t_io.resize_u8_linear(img[..., 0], int(new_h), int(w * k))
    np.testing.assert_array_equal(gray, got[..., 0])


@pytest.mark.parametrize("is_train,new_h", [(True, 0), (False, 0), (True, 8)])
def test_nerf_scene_dataset_matches_jax(scene, is_train, new_h):
    jd, td = _datasets(scene, is_train, new_h=new_h)
    assert (td.n_images, td.H, td.W) == (jd.n_images, jd.H, jd.W)
    assert td.max_radius == jd.max_radius and td.focal == jd.focal
    assert [os.path.basename(p) for p in td.images_lis] == \
        [os.path.basename(p) for p in jd.images_lis]
    # resized images within 1 LSB of cv2's; unresized equal
    tol = 1.01 / 255 if new_h else 0
    np.testing.assert_allclose(td.images, jd.images, rtol=0, atol=tol)
    np.testing.assert_allclose(td.masks, jd.masks, rtol=0, atol=tol)
    for got, want in zip(td.gen_rays_at(0), jd.gen_rays_at(0)):
        np.testing.assert_array_equal(got, want)
    got = td.gen_random_rays(0, 10, np.random.RandomState(3))
    want = jd.gen_random_rays(0, 10, np.random.RandomState(3))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol)
    ro, rd = td.gen_rays_at(0)
    for got, want in zip(td.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3)),
                         jd.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3))):
        np.testing.assert_array_equal(got, want)


def test_dtu_scene_dataset_matches_jax(tmp_path):
    root = str(tmp_path)
    rs = np.random.RandomState(0)
    world, scale = [], []
    for i in range(2):
        d = os.path.join(root, "train_%03d" % i)
        os.makedirs(d)
        rgba = (rs.rand(10, 14, 4) * 65535).astype(np.uint16)
        cv2.imwrite(os.path.join(d, "rgba.png"), rgba[..., [2, 1, 0, 3]])
        K = np.array([[20.0, 0, 7], [0, 20.0, 5], [0, 0, 1]])
        ang = 0.4 * i
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        P = np.eye(4)
        P[:3, :4] = K @ np.concatenate([R, [[0.1], [0.0], [3.0]]], axis=1)
        world.append(P.tolist())
        scale.append(np.diag([1.2, 1.2, 1.2, 1.0]).tolist())
    with open(os.path.join(root, "train.json"), "w") as f:
        json.dump({"world_mat": world, "scale_mat": scale}, f)
    for new_h in (0, 20):
        jd = j_ds.DtuSceneDataset(root, is_train=True, new_h=new_h)
        td = t_ds.DtuSceneDataset(root, is_train=True, new_h=new_h)
        assert (td.n_images, td.H, td.W, td.k) == (jd.n_images, jd.H, jd.W,
                                                   jd.k)
        np.testing.assert_allclose(td.images, jd.images, rtol=0,
                                   atol=1.01 / 255 if new_h else 0)
        for got, want in zip(td.gen_rays_at(1), jd.gen_rays_at(1)):
            np.testing.assert_array_equal(got, want)
        ro, rd = td.gen_rays_at(1)
        for got, want in zip(
                td.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3)),
                jd.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3))):
            np.testing.assert_array_equal(got, want)


def test_intersect_sphere_far_matches_jax():
    import jax.numpy as jnp
    rs = np.random.RandomState(0)
    x = (rs.rand(20, 3).astype(np.float32) - 0.5)
    d = rs.randn(20, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = j_geo.intersect_sphere_far(jnp.asarray(x), jnp.asarray(d), 1.5)
    got = t_geo.intersect_sphere_far(torch.from_numpy(x),
                                     torch.from_numpy(d), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert t_geo.VIEW_FILES_CG == j_geo.VIEW_FILES_CG
    assert t_geo.VIEW_FILES_REAL == j_geo.VIEW_FILES_REAL


def _extractors(scene, out_j, out_t, is_train=True, **kw):
    jp, model, jcfg, tcfg = neus_pair()
    jd, td = _datasets(scene, is_train)
    kw = dict(KW, **kw)
    return (j_geo.GeoExtractor(jp, jcfg, jd, out_j, **kw),
            t_geo.GeoExtractor(model, tcfg, td, out_t, device="cpu", **kw))


def _compare_trees(out_j, out_t, files):
    for view in sorted(os.listdir(out_j)):
        assert sorted(os.listdir(os.path.join(out_t, view))) == sorted(files)
        for f in files:
            jp, tp = os.path.join(out_j, view, f), os.path.join(out_t, view, f)
            if f.endswith(".npy"):
                got, want = np.load(tp), np.load(jp)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                           err_msg=view + "/" + f)
            else:
                want = cv2.imread(jp, cv2.IMREAD_UNCHANGED)
                got = cv2.imread(tp, cv2.IMREAD_UNCHANGED)
                assert got.shape == want.shape and got.dtype == want.dtype, f
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, \
                    view + "/" + f


@pytest.fixture(scope="module")
def extracted(scene, tmp_path_factory):
    out = tmp_path_factory.mktemp("surf")
    out_j, out_t = str(out / "jax"), str(out / "torch")
    ex_j, ex_t = _extractors(scene, out_j, out_t)
    dirs_j = ex_j.extract_views(is_train=True)
    dirs_t = ex_t.extract_views(is_train=True)
    return out_j, out_t, dirs_j, dirs_t, ex_t


def test_extract_views_matches_jax_file_by_file(extracted):
    out_j, out_t, dirs_j, dirs_t, ex_t = extracted
    assert [os.path.basename(d) for d in dirs_t] == \
        [os.path.basename(d) for d in dirs_j] == ["train_000", "train_001"]
    assert all(t_geo.check_finished(d) for d in dirs_t)
    _compare_trees(out_j, out_t, t_geo.VIEW_FILES_CG)
    lvis = np.load(os.path.join(dirs_t[0], "lvis.npy"))
    assert lvis.shape == (H, W, 2 * LIGHT_H * LIGHT_H)
    assert lvis.min() >= 0 and lvis.max() > 0.5
    assert ex_t.phase_seconds["geometry"] > 0
    assert ex_t.phase_seconds["occlusion"] > 0


def test_extract_val_views_with_fast_vis_and_options_matches_jax(
        scene, tmp_path):
    """The val path (rendered mask, alpha_thres_val), fast_vis with the
    occluded certificate, the occupancy options and a reduced vis_sampler,
    through both packages."""
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(fast_vis=True, fast_vis_occluded=True, fast_vis_refine=16,
              n_coarse=8, occ_vis=True, span_vis=True, occ_vis_res=16,
              vis_sampler="8+4r1", alpha_thres_val=0.4, light_tile=4)
    ex_j, ex_t = _extractors(scene, out_j, out_t, is_train=False, **kw)
    assert ex_t.vis_cfg.n_importance == 4 and ex_t.light_tile == 4
    ex_j.extract_views(is_train=False)
    ex_t.extract_views(is_train=False)
    _compare_trees(out_j, out_t, t_geo.VIEW_FILES_CG)
    assert set(ex_t.last_fast_vis_stats) == set(ex_j.last_fast_vis_stats)
    with pytest.raises(ValueError, match="vis_sampler"):
        _extractors(scene, out_j, out_t, vis_sampler="bogus")


def test_no_vis_resume_and_view_sharding(extracted, scene, tmp_path):
    out_j, out_t, _, dirs_t, ex_t = extracted
    stamp = {d: os.path.getmtime(os.path.join(d, "lvis.npy")) for d in dirs_t}
    assert ex_t.extract_views(is_train=True) == dirs_t  # all skipped
    for d in dirs_t:
        assert os.path.getmtime(os.path.join(d, "lvis.npy")) == stamp[d]
    # a view whose last file is missing is redone, and only that one
    os.remove(os.path.join(dirs_t[1], "lvis.npy"))
    assert ex_t.extract_views(is_train=True) == dirs_t
    assert os.path.getmtime(os.path.join(dirs_t[0], "lvis.npy")) == \
        stamp[dirs_t[0]]
    assert t_geo.check_finished(dirs_t[1])
    _compare_trees(out_j, out_t, t_geo.VIEW_FILES_CG)
    # num_p / p_i shard the views; no_vis writes the six geometry files
    _, ex = _extractors(scene, str(tmp_path / "j"), str(tmp_path / "t"))
    shard0 = ex.extract_views(is_train=True, num_p=2, p_i=0, no_vis=True)
    shard1 = ex.extract_views(is_train=True, num_p=2, p_i=1, no_vis=True)
    assert len(shard0) == len(shard1) == 1 and shard0 != shard1
    assert sorted(os.listdir(shard0[0])) == sorted(t_geo.VIEW_FILES_REAL)
    assert t_geo.check_finished(shard0[0], with_lvis=False)
    assert not t_geo.check_finished(shard0[0], with_lvis=True)


def test_lvis_fast_matches_full_and_reports_stats(scene, tmp_path):
    """fast against full at the JAX test's own gate (atol 0.05); the fused
    switch (the kernels' plain versions on CPU tensors) against the
    autograd path; ragged batches against whole ones."""
    jp, model, jcfg, tcfg = neus_pair()
    _, td = _datasets(scene)
    mk = lambda **kw: t_geo.GeoExtractor(
        model, tcfg, td, str(tmp_path), light_h=LIGHT_H, device="cpu", **kw)
    ex_full = mk(vis_point_batch=8)
    ex_fast0 = mk(vis_point_batch=8, fast_vis=True, fast_vis_refine=0)
    ex_fast = mk(vis_point_batch=8, fast_vis=True, fast_vis_refine=64)
    ex_fused = mk(vis_point_batch=5, use_fused_sdf=True)
    assert ex_full.use_fused_sdf is False and ex_full._packed is None
    assert ex_fused._packed is not None

    rs = np.random.RandomState(0)
    n = 12
    p = rs.randn(n, 3).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    surf, normal = 0.55 * p, p.copy()
    full = ex_full._lvis_full(surf, normal)
    fast0 = ex_fast0._lvis_fast(surf, normal)
    fast = ex_fast._lvis_fast(surf, normal)
    before = dict(ks.LAUNCHES)
    fused = ex_fused._lvis_full(surf, normal)  # 12 points in batches of 5
    assert ks.LAUNCHES == before
    assert full.shape == fast.shape == (n, 2 * LIGHT_H * LIGHT_H)
    np.testing.assert_allclose(fast, full, atol=0.05)
    np.testing.assert_allclose(fast0, full, atol=0.05)
    np.testing.assert_allclose(fused, full, rtol=1e-4, atol=2e-5)
    st0, st = ex_fast0.last_fast_vis_stats, ex_fast.last_fast_vis_stats
    assert set(st) == {"front_lit_rays", "uncertain_rays",
                       "coarse_uncertain_rays", "refine_certified_rays",
                       "occluded_certified_rays", "certified_frac"}
    assert st0["refine_certified_rays"] == 0
    assert st["coarse_uncertain_rays"] == st0["uncertain_rays"]
    assert st["uncertain_rays"] == (st["coarse_uncertain_rays"]
                                    - st["refine_certified_rays"])
    assert st["certified_frac"] >= st0["certified_frac"]
    assert st["certified_frac"] > 0 and st["refine_certified_rays"] > 0
    assert ex_fast._lvis_fast(surf[:0], normal[:0]).shape == (0, 8)
    assert ex_full._lvis_full(surf[:0], normal[:0]).shape == (0, 8)


def test_lvis_matches_jax_on_probe_points(scene, tmp_path):
    ex_j, ex_t = _extractors(scene, str(tmp_path / "j"), str(tmp_path / "t"),
                             fast_vis=True)
    rs = np.random.RandomState(1)
    p = rs.randn(20, 3).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    surf, normal = 0.55 * p, p.copy()
    np.testing.assert_allclose(ex_t._lvis_full(surf, normal),
                               ex_j._lvis_full(surf, normal), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(ex_t._lvis_fast(surf, normal),
                               ex_j._lvis_fast(surf, normal), rtol=1e-4,
                               atol=2e-5)
    assert ex_t.last_fast_vis_stats == ex_j.last_fast_vis_stats


def test_extracted_view_feeds_the_ports_stage2_dataset(extracted, scene):
    _, out_t, _, _, _ = extracted
    with open(os.path.join(scene, "transforms_train.json")) as f:
        tj = json.load(f)
    for i, fr in enumerate(tj["frames"]):
        meta = {"imh": H, "imw": W, "cam_angle_x": tj["camera_angle_x"],
                "cam_transform_mat": ",".join(
                    str(x) for x in np.asarray(
                        fr["transform_matrix"]).reshape(-1))}
        with open(os.path.join(scene, "train_%03d" % i, "metadata.json"),
                  "w") as f:
            json.dump(meta, f)
    ds = ShapeDataset(scene, out_t, data_type="nerf", imh=H, mode="train")
    assert len(ds) == 2
    view = ds.load_view(ds.files[0])
    assert view.lvis.shape == (H * W, 2 * LIGHT_H * LIGHT_H)
    assert np.isfinite(view.xyz).all() and np.isfinite(view.normal).all()


def test_run_gen_geo_entry(scene, tmp_path):
    """The extraction entry: family preset, the 64+64r4 sampler unless
    overridden, lvis only for CG scenes, a checkpoint in place of the init,
    and a refusal to run on a card that is not there."""
    from vqnerf_release_torch.models import fields as tf
    from vqnerf_release_torch.models.neus import init_neus
    from vqnerf_release_torch.utils import ckpt
    small = dict(sdf=tf.SDFConfig(d_hidden=16, n_layers=2, skip_in=(),
                                  multires=2, d_out=9),
                 color=tf.ColorConfig(d_feature=8, d_hidden=8, n_layers=1),
                 n_samples=8, n_importance=8, up_sample_steps=2)
    out = str(tmp_path / "out")
    done = t_geo.run_gen_geo(
        "lego_3072", scene, out, seed=0, overrides=small, near=NEAR, far=FAR,
        device="cpu", **KW)
    surf = os.path.join(out, "surf", "nerf_surf", "lego_3072")
    assert [os.path.relpath(d, surf) for d in done["train"] + done["val"]] \
        == ["train_000", "train_001", "val_000"]
    assert all(t_geo.check_finished(d) for d in done["train"] + done["val"])
    assert set(done["seconds"]) == {"geometry", "coarse", "refine",
                                    "occlusion"}
    assert done["seconds"]["coarse"] > 0  # fast_vis is on by default
    assert len(done["fast_vis"]) == 3  # one record a view, in order
    assert all(0.0 <= st["certified_frac"] <= 1.0 for st in done["fast_vis"])

    # a scene that is not CG gets no lvis; a checkpoint replaces the init
    from vqnerf_release_torch import config as vcfg
    cfg, _, meta = vcfg.neus_configs_for_scene(
        "myscene", **dict(small, occ_res=0))
    model = init_neus(0, cfg)
    with torch.no_grad():
        model.sdf[-1].b += 0.2  # a smaller sphere than the init's
    ckpt.save_ckpt(os.path.join(out, "exp", "myscene", meta["family"]), 3,
                   {"params": model.state_dict()})
    done2 = t_geo.run_gen_geo("myscene", scene, out, seed=0, overrides=small,
                              near=NEAR, far=FAR, device="cpu", **KW)
    assert sorted(os.listdir(done2["val"][0])) == \
        sorted(t_geo.VIEW_FILES_REAL)
    a = cv2.imread(os.path.join(done["val"][0], "alpha.png"), -1)
    b = cv2.imread(os.path.join(done2["val"][0], "alpha.png"), -1)
    assert (b > 0).sum() < (a > 0).sum()

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_geo.run_gen_geo("lego_3072", scene, out, overrides=small)
