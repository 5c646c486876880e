"""The port's video path against the JAX package's, on the CPU: the
trajectory datasets, ``extract_trajectory``, ``VideoDataset``,
``render_video`` in all five modes and ``compose_video``.

Inputs are seeded numpy; the stage-2 parameters are the JAX init
functions' converted by ``from_jax``, the NeuS ones ``neus_pair``'s.
Tolerances: rays, near/far, metadata and datasets read from the same files
exactly; extracted buffers at rtol 1e-4 / atol 1e-4 (fp32 through two
up-sample rounds, as tests/test_torch_gen_geo.py holds them); rendered
arrays in [0, 1] at rtol 1e-4 / atol 1e-5 and embed ids exactly; PNGs
within 1 LSB (the 8-bit rounding of a value that differs in its last bits
can flip by one). The port's AVI holds its frames exactly; the JAX
package's MJPG of the same frames is held to a PSNR of 25 dB: the frames
render random buffers, pixel noise, on which JPEG loses most (28.2 dB
here).
"""

import json
import os
from os.path import join

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dtu_pipeline import _make_dtu_scene
from tests.test_gen_geo import _lookat_c2w
from tests.test_torch_fields import neus_pair
from tests.test_torch_models import SMALL, jax_params
from vqnerf_release_tpu.data import neus_dataset as j_ds
from vqnerf_release_tpu.data import rays as j_rays
from vqnerf_release_tpu.data import shape_dataset as j_sd
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.pipelines import gen_geo as j_geo
from vqnerf_release_tpu.pipelines import gen_video as j_gv
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.data import neus_dataset as t_ds
from vqnerf_release_torch.data import rays as t_rays
from vqnerf_release_torch.data import shape_dataset as t_sd
from vqnerf_release_torch.interop.jax_params import from_jax
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.pipelines import gen_geo as t_geo
from vqnerf_release_torch.pipelines import gen_video as t_gv


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL, ATOL = 1e-4, 1e-5
NEAR, FAR = 0.5, 3.5
LIGHT_H = 2
KW = dict(batch_size=64, light_h=LIGHT_H, vis_point_batch=16)
H = 12  # trajectory frames
VH = 16  # the stage-2 video frames
MJPG_MIN_PSNR = 25.0


def _files(root):
    return sorted(os.path.relpath(join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def compare_trees(j_root, t_root, rtol=RTOL, atol=ATOL, exact=("embed",)):
    """Every file under both roots: the same names; .npy within rtol/atol
    (exact where the name holds one of ``exact``), PNGs within 1 LSB,
    JSON equal."""
    files = _files(j_root)
    assert _files(t_root) == files
    for f in files:
        jp, tp = join(j_root, f), join(t_root, f)
        if f.endswith(".npy"):
            got, want = np.load(tp), np.load(jp)
            assert got.shape == want.shape and got.dtype == want.dtype, f
            if any(e in f for e in exact):
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                           err_msg=f)
        elif f.endswith(".png"):
            want = cv2.imread(jp, cv2.IMREAD_UNCHANGED).astype(int)
            got = cv2.imread(tp, cv2.IMREAD_UNCHANGED).astype(int)
            assert got.shape == want.shape, f
            assert np.abs(got - want).max() <= 1, f
        else:
            with open(jp) as a, open(tp) as b:
                assert json.load(b) == json.load(a), f
    return files


def _write_nerf_trajectory(root, n=2, cx=None, as_string=False):
    frames = []
    for i in range(n):
        ang = 0.3 + 0.4 * i
        c2w = _lookat_c2w([2.0 * np.sin(ang), 0.3, 2.0 * np.cos(ang)])
        pm = (",".join(str(v) for v in c2w.reshape(-1)) if as_string
              else c2w.tolist())
        frames.append({"transform_matrix": pm})
    cams = {"camera_angle_x": 0.8, "frames": frames}
    if cx is not None:
        cams.update(cx=cx, cy=cx - 1)
    os.makedirs(root, exist_ok=True)
    with open(join(root, "transforms_test.json"), "w") as f:
        json.dump(cams, f)
    return root


def _write_dtu_trajectory(path):
    K = np.eye(4)
    K[:3, :3] = [[14.0, 0, 6.0], [0, 14.0, 6.0], [0, 0, 1.0]]
    poses = []
    for ang in (0.3, 0.7):
        eye = np.array([2.0 * np.sin(ang), 0.4, 2.0 * np.cos(ang)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = (
            right, np.cross(fwd, right), fwd, eye)
        poses.append(c2w.tolist())
    with open(path, "w") as f:
        json.dump({"poses": poses, "intrinsic": K.tolist()}, f)


def test_video_ray_helpers_are_bit_equal_copies():
    rs = np.random.RandomState(0)
    c2w = _lookat_c2w([1.0, 0.5, 2.0])
    for kw in ({}, {"cx": 3.5, "cy": 4.0}):
        for got, want in zip(t_rays.video_nerf_rays(c2w, 9.0, 6, 7, **kw),
                             j_rays.video_nerf_rays(c2w, 9.0, 6, 7, **kw)):
            np.testing.assert_array_equal(got, want)
    intr = np.eye(4)
    intr[:3, :3] = [[9.0, 0.1, 3.0], [0, 8.0, 2.5], [0, 0, 1]]
    intr[:3, :3] += 0.01 * rs.rand(3, 3)
    for got, want in zip(t_rays.video_dtu_rays(c2w, intr, 5, 8),
                         j_rays.video_dtu_rays(c2w, intr, 5, 8)):
        np.testing.assert_array_equal(got, want)


def _same_trajectory(td, jd, idx=1):
    assert (td.n_images, td.H, td.W) == (jd.n_images, jd.H, jd.W)
    assert td.max_radius == jd.max_radius and td.masks is jd.masks is None
    assert td.frame_metadata(idx) == jd.frame_metadata(idx)
    ro, rd = td.gen_rays_at(idx)
    for got, want in zip((ro, rd), jd.gen_rays_at(idx)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(td.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3)),
                         jd.near_far(ro.reshape(-1, 3), rd.reshape(-1, 3))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cx,as_string", [(None, False), (5.0, True)])
def test_trajectory_dataset_matches_jax(tmp_path, cx, as_string):
    root = _write_nerf_trajectory(str(tmp_path), cx=cx, as_string=as_string)
    jd = j_ds.TrajectoryDataset(root, imh=H, imw=H + 2, near=NEAR, far=FAR)
    td = t_ds.TrajectoryDataset(root, imh=H, imw=H + 2, near=NEAR, far=FAR)
    assert td.focal == jd.focal
    _same_trajectory(td, jd)


@pytest.mark.parametrize("where", ["scene", "two_up"])
def test_dtu_trajectory_dataset_matches_jax(tmp_path, where):
    """test.json in the scene, or two directories up (the DTU layout
    <root>/<scan>/<dir>); the train set's resize factor scales the
    intrinsic."""
    scene = str(tmp_path / "dtu" / "scan" / "scene")
    os.makedirs(scene)
    _make_dtu_scene(scene)
    _write_dtu_trajectory(join(scene if where == "scene"
                               else str(tmp_path / "dtu"), "test.json"))
    new_h = 0 if where == "scene" else 8
    jd = j_ds.DtuTrajectoryDataset(
        scene, j_ds.DtuSceneDataset(scene, is_train=True, new_h=new_h))
    td = t_ds.DtuTrajectoryDataset(
        scene, t_ds.DtuSceneDataset(scene, is_train=True, new_h=new_h))
    np.testing.assert_array_equal(td.intrinsic, jd.intrinsic)
    _same_trajectory(td, jd)


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """A NeRF-convention trajectory extracted with lvis and a DTU one
    without, each through both packages from shared NeuS weights."""
    root = tmp_path_factory.mktemp("traj")
    jp, model, jcfg, tcfg = neus_pair()
    out = {}
    scene = _write_nerf_trajectory(str(root / "nerf"))
    mk_j = j_ds.TrajectoryDataset(scene, imh=H, imw=H, near=NEAR, far=FAR)
    mk_t = t_ds.TrajectoryDataset(scene, imh=H, imw=H, near=NEAR, far=FAR)
    dtu = str(root / "dtu")
    os.makedirs(dtu)
    _make_dtu_scene(dtu)
    _write_dtu_trajectory(join(dtu, "test.json"))
    dtu_j = j_ds.DtuTrajectoryDataset(dtu, j_ds.DtuSceneDataset(dtu))
    dtu_t = t_ds.DtuTrajectoryDataset(dtu, t_ds.DtuSceneDataset(dtu))
    for name, jd, td, no_vis, white in (("nerf", mk_j, mk_t, False, True),
                                        ("dtu", dtu_j, dtu_t, True, False)):
        dirs = {}
        for pkg, mod, params, cfg, ds, kw in (
                ("jax", j_geo, jp, jcfg, jd, {}),
                ("torch", t_geo, model, tcfg, td, {"device": "cpu"})):
            vroot = str(root / name / pkg / "video")
            ex = mod.GeoExtractor(params, cfg, ds, vroot,
                                  use_white_bkgd=white, **KW, **kw)
            gv = j_gv if pkg == "jax" else t_gv
            dirs[pkg] = gv.extract_trajectory(ex, ds, vroot, no_vis=no_vis)
        out[name] = (dirs, str(root / name / "jax" / "video"),
                     str(root / name / "torch" / "video"), td)
    return out


@pytest.mark.parametrize("name", ["nerf", "dtu"])
def test_extract_trajectory_matches_jax_file_by_file(extracted, name):
    dirs, j_root, t_root, _ = extracted[name]
    assert [os.path.relpath(d, t_root) for d in dirs["torch"]] == \
        [os.path.relpath(d, j_root) for d in dirs["jax"]] == \
        ["test_000", "test_001"]
    files = compare_trees(j_root, t_root, rtol=1e-4, atol=1e-4)
    want = (t_geo.VIEW_FILES_CG if name == "nerf"
            else t_geo.VIEW_FILES_REAL) + ["metadata.json"]
    assert sorted(f for f in files if f.startswith("test_000")) == \
        sorted(join("test_000", f) for f in want)


def test_extract_trajectory_resumes(extracted, tmp_path):
    dirs, _, t_root, td = extracted["nerf"]
    stamp = {d: os.path.getmtime(join(d, "lvis.npy")) for d in dirs["torch"]}
    ex = t_geo.GeoExtractor(neus_pair()[1], neus_pair()[3], td, t_root,
                            device="cpu", **KW)
    assert t_gv.extract_trajectory(ex, td, t_root) == dirs["torch"]
    for d in dirs["torch"]:
        assert os.path.getmtime(join(d, "lvis.npy")) == stamp[d]


def _same_view(got, want):
    assert (got.id, got.h, got.w) == (want.id, want.h, want.w)
    gb, wb = got.as_batch(), want.as_batch()
    assert sorted(gb) == sorted(wb)
    for k in wb:
        assert gb[k].dtype == wb[k].dtype, k
        np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


@pytest.mark.parametrize("name,interp", [("nerf", 1), ("nerf", 2),
                                         ("dtu", 1)])
def test_video_dataset_matches_jax(extracted, name, interp):
    """Both loaders on the JAX extractor's tree: the frame list, and each
    frame's rays from the video metadata form and its buffers, exactly."""
    _, j_root, _, td = extracted[name]
    kw = dict(data_type=name, imh=H, white_bg=name == "nerf",
              interp=interp, with_ref=True)
    jv, tv = j_sd.VideoDataset(j_root, **kw), t_sd.VideoDataset(j_root, **kw)
    assert tv.files == jv.files and len(tv.files) == 2 // interp
    for f in tv.files:
        _same_view(tv.load_view(f), jv.load_view(f))
    # the rays are the trajectory's own
    view = tv.load_view(tv.files[0])
    ro, rd = td.gen_rays_at(0)
    np.testing.assert_allclose(view.rayo.reshape(H, H, 3), ro, atol=1e-5)
    np.testing.assert_allclose(
        view.rayd.reshape(H, H, 3)
        / np.linalg.norm(view.rayd.reshape(H, H, 3), axis=-1, keepdims=True),
        rd, atol=1e-5)


def _write_video_frames(root, n_lights, n=2):
    """Stage-2 trajectory frames of VH x VH: frame 0 in the video
    metadata form, frame 1 in the train form; a frame with no lvis is
    left out of a nerf dataset."""
    rs = np.random.RandomState(0)
    for i in range(n + 1):
        d = join(root, "test_%03d" % i)
        os.makedirs(d)
        c2w = _lookat_c2w([0.3 * i, 0.2, 3.0])
        meta = ({"focal": 20.0, "cx": None, "cy": None, "imh": VH,
                 "imw": VH, "cam_angle_x": 0.7,
                 "cam_transform_mat": c2w.tolist()} if i == 0 else
                {"imh": VH, "imw": VH, "cam_angle_x": 0.7,
                 "cam_transform_mat": ",".join(
                     str(x) for x in c2w.reshape(-1))})
        with open(join(d, "metadata.json"), "w") as f:
            json.dump(meta, f)
        np.save(join(d, "xyz.npy"), rs.rand(VH, VH, 3).astype(np.float32)
                - 0.5)
        np.save(join(d, "normal.npy"), rs.randn(VH, VH, 3).astype(np.float32))
        alpha = np.full((VH, VH), 255, np.uint8)
        alpha[:3] = 0
        cv2.imwrite(join(d, "alpha.png"), alpha)
        cv2.imwrite(join(d, "rgb.png"),
                    (rs.rand(VH, VH, 3) * 255).astype(np.uint8))
        if i < n:
            np.save(join(d, "lvis.npy"),
                    rs.rand(VH, VH, n_lights).astype(np.float32))
    return root


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """The stage-2 side: frames, both packages' views of them, the models
    as JAX trees and as the port's modules, probes, OLATs and edit
    masks."""
    jcfg, tcfg = j_dc.DecompConfig(**SMALL), t_dc.DecompConfig(**SMALL)
    root = _write_video_frames(str(tmp_path_factory.mktemp("frames")),
                               tcfg.n_lights)
    j_views = [j_sd.VideoDataset(root, imh=VH).load_view(f)
               for f in j_sd.VideoDataset(root, imh=VH).files]
    ds = t_sd.VideoDataset(root, imh=VH)
    t_views = [ds.load_view(f) for f in ds.files]
    assert len(t_views) == 2
    _, vq_np, ref_np = jax_params()
    rs = np.random.RandomState(4)
    masks = []
    for _ in t_views:
        m = np.zeros((VH, VH, 3), np.float32)
        m[4:12, 5:13] = 1.0
        masks.append(m.reshape(-1, 3))
    return dict(
        jcfg=jcfg, tcfg=tcfg, j_views=j_views, t_views=t_views,
        j_vq=jax.tree_util.tree_map(jnp.asarray, vq_np),
        j_ref=jax.tree_util.tree_map(jnp.asarray, ref_np),
        t_vq=from_jax(vq_np, "vq_nfr"), t_ref=from_jax(ref_np, "ref_nfr"),
        probes=(rs.rand(2, tcfg.n_lights, 3) * 2).astype(np.float32),
        olats=(rs.rand(2, tcfg.n_lights, 3) * 3).astype(np.float32),
        masks=masks)


RENDER_CASES = {
    "recon": {},
    "relight": {"opt_scale": [1.1, 0.9, 1.0]},
    "edit": {"edit_material": {"diff": [0.8, 0.1, 0.1],
                               "spec": [-1.0, 0.0, 0.0], "rough": [0.3]}},
    "edit_probe": {"edit_material": {"diff": [-1.0, 0, 0],
                                     "spec": [1.0, 0.77, 0.34],
                                     "rough": [0.2]},
                   "dst_env_name": "studio", "opt_scale": [1.2, 1.0, 0.8]},
    "vq_dcomps": {"n_vq": 3},
    "gen_comps": {"n_vq": 3},
    "gen_comps_all_codes": {},
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_video_matches_jax_file_by_file(video, tmp_path, case):
    mode = case.split("_probe")[0].split("_all")[0]
    v = video
    kw = dict(RENDER_CASES[case], novel_probes=v["probes"],
              probe_names=["city", "studio"], novel_olat=v["olats"],
              olat_names=["olat0", "olat1"], edit_masks=v["masks"])
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_kw = dict(kw, novel_probes=jnp.asarray(kw["novel_probes"]),
                novel_olat=jnp.asarray(kw["novel_olat"]))
    if "opt_scale" in kw:
        j_kw["opt_scale"] = jnp.asarray(kw["opt_scale"], jnp.float32)
    j_dirs = j_gv.render_video(mode, v["jcfg"], v["j_views"], j_out,
                               ref_params=v["j_ref"], vq_params=v["j_vq"],
                               **j_kw)
    t_dirs = t_gv.render_video(mode, v["tcfg"], v["t_views"], t_out,
                               ref_model=v["t_ref"], vq_model=v["t_vq"],
                               device="cpu", **kw)
    assert [os.path.relpath(d, t_out) for d in t_dirs] == \
        [os.path.relpath(d, j_out) for d in j_dirs]
    files = compare_trees(j_out, t_out)
    want = {"recon": "pred_rgb.png", "relight": "pred_rgb_probes_studio.png",
            "edit": "pred_rough.npy", "vq_dcomps": "pred_embed.npy",
            "gen_comps": "embed_map.png"}[mode]
    assert join("batch000000001", want) in files
    if mode in ("vq_dcomps", "gen_comps"):
        emb = np.load(join(t_out, "batch000000000", "pred_embed.npy"))
        assert emb.max() <= kw.get("n_vq", SMALL["num_embed"])
    with pytest.raises(ValueError):
        t_gv.render_video("bogus", v["tcfg"], [], t_out, device="cpu")


def _composited(dirs, alpha_name):
    """The frames compose_video stitches, made with the JAX package's own
    reader: RGB over white through the alpha frame, clipped, truncated."""
    from vqnerf_release_tpu.data import io as j_io
    out = []
    for d in dirs:
        img = j_io.load_img_f32(join(d, "pred_rgb.png"))[..., :3]
        a = j_io.load_img_f32(join(d, alpha_name))
        img = j_io.alpha_blend(img, a[..., 0] if a.ndim == 3 else a,
                               np.ones_like(img))
        out.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.stack(out)


def _decode_with_cv2(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f[..., ::-1].copy())
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return np.stack(frames), fps


def test_compose_video_writes_the_composited_frames(video, tmp_path):
    v = video
    dirs = t_gv.render_video("recon", v["tcfg"], v["t_views"],
                             str(tmp_path / "frames"), ref_model=v["t_ref"],
                             device="cpu")
    want = _composited(dirs, "pred_alpha.png")
    avi = str(tmp_path / "video.avi")
    assert t_gv.compose_video(dirs + [str(tmp_path)], "pred_rgb.png", avi,
                              fps=12, alpha_name="pred_alpha.png") == 2
    got, fps = _decode_with_cv2(avi)
    np.testing.assert_array_equal(got, want)
    assert fps == 12
    # the JAX package's MJPG of the same frames, within a JPEG's loss
    j_avi = str(tmp_path / "jax.avi")
    assert j_gv.compose_video(dirs, "pred_rgb.png", j_avi, fps=12,
                              alpha_name="pred_alpha.png") == 2
    jpeg, _ = _decode_with_cv2(j_avi)
    mse = np.mean((jpeg.astype(float) - want.astype(float)) ** 2)
    assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= MJPG_MIN_PSNR
    with pytest.raises(FileNotFoundError):
        t_gv.compose_video([str(tmp_path)], "pred_rgb.png", avi)


def test_chip_smoke_reads_the_avi_header(tmp_path):
    """chip_smoke.py holds the card's video.avi to its header: frame count,
    size and rate as written; a frame chunk missing is refused."""
    import chip_smoke
    frames = np.random.RandomState(2).randint(0, 256, (3, 10, 7, 3))
    avi = str(tmp_path / "video.avi")
    assert t_io.write_avi(avi, frames.astype(np.uint8), fps=12) == 3
    assert chip_smoke.avi_header(avi) == (3, 7, 10, 12)
    data = open(avi, "rb").read()
    k = data.rindex(b"00db", 0, data.rindex(b"idx1"))
    with open(avi, "wb") as f:
        f.write(data[:k] + b"01db" + data[k + 4:])
    with pytest.raises(AssertionError, match="not 3 frame chunks"):
        chip_smoke.avi_header(avi)
