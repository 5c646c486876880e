"""The port's real-capture front end against the JAX package, on the CPU:
the COLMAP model readers and pose conversion, imgs2poses and run_colmap,
the ArUco camera conversion, make_real_dataset (PNG and JPEG frames), the
MERL reader and converter, and the source backup with
``NeuSRunner.train(backup_sources=True)``.

Every output is held bit for bit: the copies compute in the same numpy
order, and the images the port writes through its own PNG codec decode
to the pixels cv2 writes.
"""

import json
import os
import shutil
import struct
from os.path import join

import cv2
import numpy as np
import pytest
import torch

from tests.test_preprocess import _write_colmap_model
from vqnerf_release_tpu.data import merl as j_merl
from vqnerf_release_tpu.preprocess import aruco_cameras as j_aruco
from vqnerf_release_tpu.preprocess import colmap_model as j_cm
from vqnerf_release_tpu.preprocess import colmap_wrapper as j_cw
from vqnerf_release_tpu.preprocess import data_gen as j_gen
from vqnerf_release_tpu.utils import backup as j_backup
from vqnerf_release_torch.data import merl as t_merl
from vqnerf_release_torch.preprocess import aruco_cameras as t_aruco
from vqnerf_release_torch.preprocess import colmap_model as t_cm
from vqnerf_release_torch.preprocess import colmap_wrapper as t_cw
from vqnerf_release_torch.preprocess import data_gen as t_gen
from vqnerf_release_torch.utils import backup as t_backup


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(got, want, what=""):
    """Equal, recursively through namedtuples, dicts and arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__, what
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


def _write_pinhole_model(d, n_images=4, n_points=60, seed=1):
    """A PINHOLE camera, points on a sphere, every point tracked in every
    image it lies in front of."""
    rs = np.random.RandomState(seed)
    os.makedirs(d, exist_ok=True)
    with open(join(d, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 3, 1, 64, 48))
        f.write(struct.pack("<4d", 70.0, 72.0, 31.5, 24.0))
    pts = rs.randn(n_points, 3)
    pts = 0.5 * pts / np.linalg.norm(pts, axis=1, keepdims=True) + 0.1
    qs = rs.randn(n_images, 4)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    ts = np.stack([rs.uniform(-0.2, 0.2, n_images),
                   rs.uniform(-0.2, 0.2, n_images),
                   rs.uniform(3, 4, n_images)], 1)
    seen = {i: [] for i in range(n_points)}
    with open(join(d, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            f.write(struct.pack("<i", 10 + i))
            f.write(struct.pack("<4d", *qs[i]))
            f.write(struct.pack("<3d", *ts[i]))
            f.write(struct.pack("<i", 3))
            f.write(b"view%02d.jpg\x00" % (n_images - i))  # name order
            z = (pts @ j_cm.qvec2rotmat(qs[i]).T + ts[i])[:, 2]
            vis = np.flatnonzero(z > 3.3)
            f.write(struct.pack("<Q", len(vis) + 1))
            for k, p in enumerate(vis):
                f.write(struct.pack("<3d", rs.rand() * 64, rs.rand() * 48,
                                    float(p + 1)))
                seen[p].append((10 + i, k))
            f.write(struct.pack("<3d", 1.0, 2.0, -1.0))  # untracked
    with open(join(d, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_points))
        for p in range(n_points):
            f.write(struct.pack("<Q", p + 1))
            f.write(struct.pack("<3d", *pts[p]))
            f.write(struct.pack("<3B", *rs.randint(0, 255, 3)))
            f.write(struct.pack("<d", rs.rand()))
            f.write(struct.pack("<Q", len(seen[p])))
            for img_id, k in seen[p]:
                f.write(struct.pack("<2i", img_id, k))


@pytest.mark.parametrize("kind", ["simple_pinhole", "pinhole"])
def test_colmap_model_equals_jax(tmp_path, kind):
    d = str(tmp_path / "sparse" / "0")
    if kind == "pinhole":
        _write_pinhole_model(d)
    else:
        _write_colmap_model(d)
    models = []
    for cm in (t_cm, j_cm):
        cams = cm.read_cameras_binary(join(d, "cameras.bin"))
        imgs = cm.read_images_binary(join(d, "images.bin"))
        p3d = cm.read_points3d_binary(join(d, "points3D.bin"))
        models.append((cams, imgs, p3d, cm.compute_poses_bounds(
            cams, imgs, p3d), cm.neus_cameras_from_colmap(cams, imgs, p3d)))
    for got, want, what in zip(models[0], models[1],
                               ("cameras", "images", "points", "poses_bounds",
                                "neus")):
        _assert_same(got, want, what)
    q = np.random.RandomState(2).randn(4)
    np.testing.assert_array_equal(t_cm.qvec2rotmat(q), j_cm.qvec2rotmat(q))


def test_imgs2poses_equals_jax(tmp_path):
    """imgs2poses(run_sfm=False) on an existing sparse model writes the
    same poses_bounds.npy and cameras_sphere.npz; run_colmap without the
    binary raises in both."""
    outs = []
    for name, cw in (("torch", t_cw), ("jax", j_cw)):
        scene = str(tmp_path / name)
        _write_pinhole_model(join(scene, "sparse", "0"))
        pb = cw.imgs2poses(scene, run_sfm=False)
        np.testing.assert_array_equal(
            np.load(join(scene, "poses_bounds.npy")), pb)
        outs.append((pb, dict(np.load(join(scene, "preprocessed",
                                           "cameras_sphere.npz")))))
        with pytest.raises(FileNotFoundError, match="colmap"):
            cw.run_colmap(scene, colmap_bin="colmap-not-installed")
    _assert_same(outs[0][0], outs[1][0], "poses_bounds")
    _assert_same(outs[0][1], outs[1][1], "cameras_sphere")


def _write_aruco_work(work, rs):
    os.makedirs(join(work, "tmp", "image_undistort"))
    poses = rs.randn(4, 2, 3)
    np.save(join(work, "tmp", "poses.npy"), poses)
    np.save(join(work, "tmp", "intrinsic.npy"),
            np.array([[500.0, 0, 40], [0, 510.0, 30], [0, 0, 1]]))
    und = join(work, "tmp", "image_undistort")
    cv2.imwrite(join(und, "000.png"), (rs.rand(60, 80, 3) * 255).astype(
        np.uint8))
    cv2.imwrite(join(und, "001.png"), (rs.rand(60, 80) * 255).astype(
        np.uint8))  # gray
    cv2.imwrite(join(und, "002.png"), (rs.rand(60, 80, 4) * 255).astype(
        np.uint8))  # with alpha
    cv2.imwrite(join(und, "003.png"), (rs.rand(60, 80, 3) * 65535).astype(
        np.uint16))  # 16 bits


@pytest.mark.parametrize("crop", [0, 7])
def test_aruco_convert_cameras_equals_jax(tmp_path, crop):
    rs = np.random.RandomState(crop)
    works = [str(tmp_path / "torch"), str(tmp_path / "jax")]
    _write_aruco_work(works[0], rs)
    shutil.copytree(join(works[0], "tmp"), join(works[1], "tmp"))
    outs = [t_aruco.convert_cameras(works[0], crop_pixels=crop),
            j_aruco.convert_cameras(works[1], crop_pixels=crop)]
    _assert_same(dict(np.load(join(outs[0], "cameras_sphere.npz"))),
                 dict(np.load(join(outs[1], "cameras_sphere.npz"))))
    for sub in ("image", "mask"):
        names = sorted(os.listdir(join(outs[1], sub)))
        assert sorted(os.listdir(join(outs[0], sub))) == names
        assert len(names) == 4
        for n in names:
            got = cv2.imread(join(outs[0], sub, n), cv2.IMREAD_UNCHANGED)
            want = cv2.imread(join(outs[1], sub, n), cv2.IMREAD_UNCHANGED)
            assert got.dtype == want.dtype == np.uint8, n
            np.testing.assert_array_equal(got, want, err_msg=n)
    r = rs.randn(3)
    np.testing.assert_array_equal(t_aruco.rodrigues(r), j_aruco.rodrigues(r))


@pytest.mark.parametrize("frames,imh", [("png", None), ("jpeg", 16),
                                        ("png_rgba", 12), ("jpeg", None)])
def test_make_real_dataset_equals_jax(tmp_path, frames, imh):
    """Frames (8-bit PNG, JPEG, or RGBA PNG that carries its own alpha)
    with gray masks, optionally resized: the 16-bit rgba.png of every view
    decodes to JAX's pixels, and metadata and transforms are equal."""
    rs = np.random.RandomState(len(frames) + (imh or 0))
    paths, masks = [], []
    for i in range(5):
        p = str(tmp_path / ("f%d.%s" % (i, "jpg" if frames == "jpeg"
                                        else "png")))
        ch = 4 if frames == "png_rgba" else 3
        img = (rs.rand(20, 24, ch) * 255).astype(np.uint8)
        cv2.imwrite(p, img)
        paths.append(p)
        m = str(tmp_path / ("m%d.png" % i))
        cv2.imwrite(m, ((rs.rand(20, 24) > 0.3) * 255).astype(np.uint8))
        masks.append(m)
    c2ws = [np.eye(4) + 0.01 * rs.randn(4, 4) for _ in range(5)]
    outs = [str(tmp_path / "torch"), str(tmp_path / "jax")]
    got = t_gen.make_real_dataset(paths, c2ws, 0.7, outs[0], masks=masks,
                                  val_every=3, imh=imh)
    want = j_gen.make_real_dataset(paths, c2ws, 0.7, outs[1], masks=masks,
                                   val_every=3, imh=imh)
    assert got == want == {"train": 4, "val": 1}
    names = sorted(os.listdir(outs[1]))
    assert sorted(os.listdir(outs[0])) == names
    for n in names:
        if n.endswith(".json"):
            with open(join(outs[0], n)) as a, open(join(outs[1], n)) as b:
                assert json.load(a) == json.load(b), n
            continue
        for f in ("metadata.json", "rgba.png"):
            ga, wa = join(outs[0], n, f), join(outs[1], n, f)
            if f.endswith(".json"):
                assert json.load(open(ga)) == json.load(open(wa))
            else:
                g = cv2.imread(ga, cv2.IMREAD_UNCHANGED)
                w = cv2.imread(wa, cv2.IMREAD_UNCHANGED)
                assert g.dtype == w.dtype == np.uint16 and g.shape[2] == 4
                np.testing.assert_array_equal(g, w, err_msg=ga)
    with pytest.raises(RuntimeError, match="Blender"):
        t_gen.blender_render_scene()


@pytest.fixture(scope="module")
def merl_file(tmp_path_factory):
    raw = np.random.RandomState(0).rand(3, *j_merl.MERL_DIMS)
    p = str(tmp_path_factory.mktemp("merl") / "red-paint.binary")
    with open(p, "wb") as f:
        f.write(struct.pack("3i", *j_merl.MERL_DIMS))
        f.write(raw.astype(np.float64).tobytes())
    return p


def test_merl_read_and_lookup_equal_jax(merl_file):
    got, want = t_merl.read_merl(merl_file), j_merl.read_merl(merl_file)
    np.testing.assert_array_equal(got, want)
    rs = np.random.RandomState(1)
    wi, wo, n = rs.randn(3, 200, 3)
    n[:50] = [0.0, 0.0, 1.0]  # the tangent's other branch
    for t in (None, np.cross(n, rs.randn(200, 3))):
        angles = t_merl.rusink_angles(wi, wo, n, t)
        for g, w in zip(angles, j_merl.rusink_angles(wi, wo, n, t)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(t_merl.merl_lookup(got, *angles),
                                      j_merl.merl_lookup(want, *angles))
    bad = merl_file + ".bad"
    with open(bad, "wb") as f:
        f.write(struct.pack("3i", 90, 90, 90))
    with pytest.raises(ValueError, match="MERL dims"):
        t_merl.read_merl(bad)


@pytest.mark.parametrize("subsample", [1, 3])
def test_merl_to_npz_equals_jax(tmp_path, merl_file, subsample):
    tp, jp = str(tmp_path / "t" / "m.npz"), str(tmp_path / "j" / "m.npz")
    assert t_gen.merl_to_npz(merl_file, tp, subsample=subsample) == \
        j_gen.merl_to_npz(merl_file, jp, subsample=subsample)
    got, want = np.load(tp), np.load(jp)
    assert str(got["name"]) == str(want["name"]) == "red-paint"
    np.testing.assert_array_equal(got["cube"], want["cube"])


def test_file_backup_equals_jax(tmp_path):
    src = tmp_path / "src"
    for rel in ("a.py", "pkg/b.py", "pkg/c.txt", "pkg/__pycache__/d.py"):
        os.makedirs(os.path.dirname(src / rel), exist_ok=True)
        (src / rel).write_text(rel)
    got = t_backup.file_backup(str(tmp_path / "t"), src_root=str(src))
    want = j_backup.file_backup(str(tmp_path / "j"), src_root=str(src))

    def tree(root):
        return sorted(os.path.relpath(join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(got) == tree(want) == ["a.py", "pkg/b.py"]
    default = t_backup.file_backup(str(tmp_path / "own"))
    assert "cli.py" in tree(default)
    assert os.path.join("preprocess", "colmap_model.py") in tree(default)


def test_neus_runner_backs_up_its_sources(tmp_path):
    """NeuSRunner.train(backup_sources=True) records the port's sources
    under <exp_dir>/recording before it trains, as the JAX runner does."""
    import chip_smoke as cs
    from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
    from vqnerf_release_torch.models import fields
    from vqnerf_release_torch.models.neus import NeuSConfig
    from vqnerf_release_torch.train.neus_loop import NeuSRunner
    from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig

    data = cs.write_stage1_scene(str(tmp_path / "scene"), 12, 1, 0, 0)
    cfg = NeuSConfig(
        sdf=fields.SDFConfig(d_hidden=16, n_layers=2, skip_in=(), multires=2,
                             d_out=17),
        color=fields.ColorConfig(d_feature=16, d_hidden=8, n_layers=1),
        n_samples=4, n_importance=4, up_sample_steps=1)
    tcfg = NeuSTrainConfig(batch_size=8, end_iter=1, warm_up_end=1,
                           save_freq=0, val_freq=0, mesh_freq=0, occ_res=0)
    exp = str(tmp_path / "exp")
    runner = NeuSRunner(cfg, tcfg, NerfSceneDataset(data, near=0.5, far=3.5),
                        exp, device="cpu")
    runner.train(backup_sources=True)
    assert runner.iter_step == 1
    rec = join(exp, "recording")
    assert os.path.isfile(join(rec, "train", "neus_loop.py"))
    assert os.path.isfile(join(rec, "data", "jpeg.py"))
    assert not os.path.exists(join(rec, "__pycache__"))
