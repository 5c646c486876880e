"""The port's evaluation (vqnerf_release_torch/eval/, data/io.py::resize and
the metric-eval and cluster-eval subcommands) against the JAX package's
(vqnerf_release_tpu/eval/), which runs here on cv2, scipy, sklearn and
pandas, on the CPU.

Tolerances:
  * resize: cv2.resize(INTER_AREA) within 1e-6 absolute (it is equal);
  * SSIM, MSE, the LPIPS proxy, and LPIPS from float64 weights: 1e-9
    relative (float64 sums in another order). LPIPS from float32 weights:
    1e-6 relative, because the JAX module's scipy FFT transforms a float32
    kernel in single precision (with float64 weights the two agree to
    1e-14);
  * metric_eval: the uint8 images that the scores are taken of are
    compared first. Where the family's height is reached by a downscale
    (cv2's area weights, equal) or no resize they are equal (the sRGB
    curve in float32 through torch and through XLA rounds alike on these
    inputs), and every score is within 1e-9 relative (LPIPS from float32
    weights, 1e-6 as above). Where it is reached by an upscale, the port's
    bilinear weights (data/io.py) lie within a float32 ulp of cv2's
    INTER_LINEAR, which moves a few values across a uint8 step: at most
    UPSCALE_OFF_SHARE of the values differ, each by 1 (308 of 786,432 in
    the worst image here), and the scores are held within 1e-5 relative
    (3e-6 seen);
  * cluster_eval: the contingency matrix, the majority map and the label
    maps equal, the five scores equal to the last bit (the same integer
    counts, the same divisions);
  * mean shift: the same number of centres and equal label maps; centres
    within 1e-9 on float64 features, and within 1e-5 on float32 features
    (sklearn takes the mean of float32 points in float32, summed in its
    KD-tree's order; the port in float64);
  * CSV: byte for byte.
"""

import io
import json
import os
from contextlib import redirect_stdout
from os.path import join

import cv2
import numpy as np
import pytest
import torch
from sklearn.cluster import MeanShift

from vqnerf_release_tpu import cli as j_cli
from vqnerf_release_tpu.eval import cluster_eval as jce
from vqnerf_release_tpu.eval import lpips_net as jl
from vqnerf_release_tpu.eval import meanshift as jms
from vqnerf_release_tpu.eval import metric_eval as jme
from vqnerf_release_tpu.eval import metrics as jm
from vqnerf_release_tpu.eval import vis_csv as jvc
from vqnerf_release_torch import cli as t_cli
from vqnerf_release_torch.data import io as tio
from vqnerf_release_torch.eval import cluster_eval as tce
from vqnerf_release_torch.eval import lpips_net as tl
from vqnerf_release_torch.eval import meanshift as tms
from vqnerf_release_torch.eval import metric_eval as tme
from vqnerf_release_torch.eval import metrics as tm
from vqnerf_release_torch.eval import vis_csv as tvc


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REL = 1e-9
LPIPS_F32_REL = 1e-6
UPSCALE_OFF_SHARE = 1e-3
UPSCALE_REL = 1e-5
WIDTHS = [3, 4, 6, 8, 6, 5]  # AlexNet's 3, 64, 192, 384, 256, 256, cut
KSIZES = [11, 5, 3, 3, 3]


def _close(got, want, rel=REL):
    assert np.isfinite(got) and abs(got - want) <= rel * max(abs(want),
                                                              1e-300), \
        (got, want)


def _weights(path, dtype, seed=0):
    rs = np.random.RandomState(seed)
    w = {}
    for i in range(5):
        w[f"conv{i + 1}/kernel"] = (0.1 * rs.randn(
            KSIZES[i], KSIZES[i], WIDTHS[i], WIDTHS[i + 1])).astype(dtype)
        w[f"conv{i + 1}/bias"] = (0.1 * rs.randn(WIDTHS[i + 1])).astype(
            dtype)
        w[f"lin{i}/kernel"] = rs.rand(1, 1, WIDTHS[i + 1], 1).astype(dtype)
    np.savez(path, **w)
    return str(path)


# ---- resize -----------------------------------------------------------------


@pytest.mark.parametrize("shape,new", [
    ((800, 800, 3), (512, 512)), ((600, 600, 4), (420, 420)),
    ((1200, 1600, 3), (512, 682)), ((800, 800), (512, 512)),
    ((600, 600, 1), (420, 420)), ((512, 512, 3), (420, 420)),
    ((37, 53, 2), (20, 31))])
def test_resize_area_equals_cv2(shape, new):
    img = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    want = cv2.resize(img, new[::-1], interpolation=cv2.INTER_AREA)
    if len(shape) == 3 and shape[2] == 1:
        want = want[..., None]
    got = tio.resize(img, *new)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-6


def test_resize_integer_image_non_integer_factor_raises():
    """A non-integer downscale of an integer image is ported now: cv2's
    area mean in float32, rounded to nearest even, equal to cv2; only
    integer types cv2 does not take raise."""
    img = (np.random.RandomState(8).rand(800, 800, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(
        tio.resize(img, 512, 512),
        cv2.resize(img, (512, 512), interpolation=cv2.INTER_AREA))
    with pytest.raises(NotImplementedError, match="uint8, uint16"):
        tio.resize(np.zeros((800, 800, 3), np.int32), 512, 512)


# ---- metrics ----------------------------------------------------------------


def _image_pairs():
    rs = np.random.RandomState(1)
    a = (rs.rand(48, 60, 3) * 255).astype(np.uint8)
    b = np.clip(a.astype(int) + rs.randint(-30, 30, a.shape), 0,
                255).astype(np.uint8)
    return [(a, b), (a / 255.0, b / 255.0),
            (rs.rand(33, 41).astype(np.float32),
             rs.rand(33, 41).astype(np.float32))]


@pytest.mark.parametrize("pair", range(3))
def test_ssim_mse_proxy_equal_jax(pair):
    a, b = _image_pairs()[pair]
    _close(tm.ssim(a, b, device="cpu"), jm.ssim(a, b))
    _close(tm.mse(a, b), jm.mse(a, b))
    _close(tm._lpips_proxy(a, b, device="cpu"), jm._lpips_proxy(a, b))
    assert tm.psnr(a, b) == jm.psnr(a, b)


def test_lpips_from_weights_equals_jax(tmp_path):
    a, b = _image_pairs()[0]
    w64 = _weights(tmp_path / "w64.npz", np.float64)
    w32 = _weights(tmp_path / "w32.npz", np.float32)
    for im1, im2 in ((a, b), (a / 255.0, b / 255.0),
                     (a / 300.0, b / 255.0)):  # max <= 1.5: no rescale
        _close(tl.lpips_from_weights(im1, im2, w64, device="cpu"),
               jl.lpips_from_weights(im1, im2, w64))
    _close(tl.lpips_from_weights(a, b, w32, device="cpu"),
           jl.lpips_from_weights(a, b, w32), LPIPS_F32_REL)


def test_lpips_switch_and_proxy_warning(tmp_path, monkeypatch):
    a, b = _image_pairs()[0]
    monkeypatch.delenv("VQNERF_LPIPS_WEIGHTS", raising=False)
    monkeypatch.setattr(tm, "_PROXY_WARNED", False)
    assert tm.lpips_impl() == "proxy"
    with pytest.warns(UserWarning, match="proxy"):
        v = tm.lpips(a, b, device="cpu")
    assert v == tm._lpips_proxy(a, b, device="cpu")
    path = _weights(tmp_path / "w.npz", np.float64)
    monkeypatch.setenv("VQNERF_LPIPS_WEIGHTS", path)
    assert tm.lpips_impl() == jm.lpips_impl() == "alexnet"
    assert tm.lpips(a, b, device="cpu") == tl.lpips_from_weights(
        a, b, path, device="cpu")


# ---- metric_eval ------------------------------------------------------------


def _write(path, img):
    tio.write_img(img, path)


def _disc(h, w):
    """An alpha with a soft-edged disc: values across the thresholds."""
    yy, xx = np.mgrid[:h, :w]
    r = np.hypot((yy - h / 2) / h, (xx - w / 2) / w)
    return np.clip((0.42 - r) * 12, 0, 1)


def _write_gt(gt_scene, n_views, h, w, envs, rs):
    for i in range(n_views):
        d = join(gt_scene, "val_%03d" % i)
        alpha = _disc(h, w)
        _write(join(d, "rgba.png"), np.dstack([rs.rand(h, w, 3), alpha]))
        for name in ("albedo", "metal", "rough"):
            _write(join(d, name + ".png"), rs.rand(h, w, 3))
        for env in envs:
            _write(join(d, "rgba_%s.png" % env),
                   np.dstack([rs.rand(h, w, 3), alpha]))


def _write_pred(view_dir, adapter, h, w, rs):
    names = {adapter["rgb"], adapter["albedo"], adapter["albedo_add"],
             adapter["spec"], adapter["spec_mul"], adapter["rough"]}
    names |= set(adapter["kd_scale"])
    for name in names - {None}:
        img = 0.2 + 0.6 * rs.rand(h, w, 3)
        if name.endswith(".jpg"):  # nero's renders are JPEG files
            os.makedirs(view_dir, exist_ok=True)
            cv2.imwrite(join(view_dir, name),
                        (img[..., ::-1] * 255).astype(np.uint8),
                        [cv2.IMWRITE_JPEG_QUALITY, 90])
        else:
            _write(join(view_dir, name), img)
    alpha = adapter["alpha"]
    if alpha.endswith(".npy"):
        np.save(join(view_dir, alpha), np.full((h, w, 1), 2.5, np.float32))
    elif adapter["alpha_invert"]:
        _write(join(view_dir, alpha),
               1.0 - _disc(h, w)[..., None] * np.ones(3))
    elif alpha not in names:
        _write(join(view_dir, alpha), _disc(h, w))


# (model, family, scene, GT size, prediction size, views, envs); the pd
# and relight trees at resolve_scene_dirs' layout
CASES = [
    ("nfr", "nerf", "hotdog_2163", (64, 64), (64, 64), 1, ["city"]),
    ("nv", "mat", "machine1_3072", (600, 600), (600, 600), 1, []),
    ("pil", "mat", "ball_x", (420, 420), (420, 420), 1, []),
    ("ref_nfr", "dtu", "dtu_scan24", (512, 640), (512, 640), 1, []),
    ("nero", "mat", "lego_3072", (420, 420), (420, 420), 1, []),
]


def _write_case(root, model, family, scene, gt_hw, pd_hw, n_views, envs,
                seed):
    rs = np.random.RandomState(seed)
    gt_root, pred_root = join(root, "gt"), join(root, "pred")
    _write_gt(join(gt_root, scene), n_views, *gt_hw, envs, rs)
    os.makedirs(pred_root, exist_ok=True)
    pd_scene, relit = tme.resolve_scene_dirs(pred_root, scene, family,
                                             model)
    if model == "nfr":  # the layout's fixed names, made to exist
        pd_scene = join(pred_root, scene + "_nerfactor", "lr5e-3",
                        "vis_vali", "epoch000000100")
        relit = join(pred_root, scene + "_nerfactor", "lr5e-3", "vis_test",
                     "ckpt-10")
    adapter = tme.MODEL_ADAPTERS[model]
    for i in range(n_views):
        name = {"val": "val_%03d", "numeric": "%d"}.get(
            adapter["view_prefix"], "batch%09d") % i
        _write_pred(join(pd_scene, name), adapter, *pd_hw, rs)
        for env in envs:
            _write(join(relit, name, adapter["relit"].format(env=env)),
                   rs.rand(*pd_hw, 3))
    return gt_root, pred_root


def _capture(module, monkeypatch, into):
    """Record the uint8 image pairs that ``module``'s _score takes."""
    score = module._score

    def spy(metric, key, gt, pd, *rest):
        into.append((key, gt.copy(), pd.copy()))
        return score(metric, key, gt, pd, *rest)

    monkeypatch.setattr(module, "_score", spy)


def _assert_scores_close(got, want, rel=REL, lpips_rel=None):
    assert set(got) == set(want)
    for scene, bufs in want.items():
        if scene.startswith("_"):
            assert got[scene] == bufs
            continue
        assert set(got[scene]) == set(bufs)
        for buf, ms in bufs.items():
            for m, vals in ms.items():
                assert len(got[scene][buf][m]) == len(vals) > 0
                for g, w in zip(got[scene][buf][m], vals):
                    _close(g, w, max(rel, lpips_rel or 0.0)
                           if m == "lpips" else rel)


@pytest.fixture(scope="module")
def metric_cases(tmp_path_factory):
    """Each case's tree and the JAX eval_dataset's scores and images, once
    for the module."""
    root = tmp_path_factory.mktemp("metric_eval")
    out = []
    mp = pytest.MonkeyPatch()
    mp.delenv("VQNERF_LPIPS_WEIGHTS", raising=False)
    for k, (model, family, scene, gt_hw, pd_hw, n, envs) in enumerate(CASES):
        case = join(str(root), "%s_%s" % (model, family))
        gt_root, pred_root = _write_case(case, model, family, scene, gt_hw,
                                         pd_hw, n, envs, k)
        images = []
        _capture(jme, mp, images)
        scores = jme.eval_dataset([scene], family, pred_root, gt_root,
                                  out_json=join(case, "jax.json"),
                                  model_name=model)
        mp.undo()
        mp.delenv("VQNERF_LPIPS_WEIGHTS", raising=False)
        out.append((case, model, family, scene, gt_root, pred_root, scores,
                    images))
    mp.undo()
    return out


@pytest.mark.parametrize("k", range(len(CASES)))
def test_eval_dataset_equals_jax(metric_cases, k, monkeypatch):
    case, model, family, scene, gt_root, pred_root, want, want_images = \
        metric_cases[k]
    upscale = CASES[k][3][0] < tme.FAMILY_FLAGS[family]["new_h"]
    monkeypatch.delenv("VQNERF_LPIPS_WEIGHTS", raising=False)
    images = []
    _capture(tme, monkeypatch, images)
    got = tme.eval_dataset([scene], family, pred_root, gt_root,
                           out_json=join(case, "port.json"),
                           model_name=model, device="cpu")
    assert [k for k, _, _ in images] == [k for k, _, _ in want_images]
    for (key, g_gt, g_pd), (_, w_gt, w_pd) in zip(images, want_images):
        for g, w in ((g_gt, w_gt), (g_pd, w_pd)):
            assert g.dtype == np.uint8 and g.shape == w.shape, key
            off = np.abs(g.astype(int) - w.astype(int))
            if upscale:
                assert off.max() <= 1, key
                assert (off > 0).mean() <= UPSCALE_OFF_SHARE, key
            else:
                assert not off.any(), key
    _assert_scores_close(got, want, UPSCALE_REL if upscale else REL)
    with open(join(case, "port.json")) as f:
        assert json.load(f) == got
    assert got["_lpips_impl"] == "proxy"


def test_eval_scene_scales_and_sizes(metric_cases):
    """The mat case resizes 600 -> 420 (cv2's area weights) and the nerf
    case 64 -> 512 (bilinear); each scored image has the family's height."""
    seen = {m: {img.shape[:2] for _, img, _ in imgs}
            for _, m, _, _, _, _, _, imgs in metric_cases}
    assert seen["nv"] == {(420, 420)} and seen["nfr"] == {(512, 512)}
    case, model, family, scene, gt_root, pred_root, _, _ = metric_cases[1]
    pd_scene, _ = tme.resolve_scene_dirs(pred_root, scene, family, model)
    args = (pd_scene, join(gt_root, scene), scene,
            tme.FAMILY_FLAGS[family], tme.MODEL_ADAPTERS[model])
    np.testing.assert_allclose(tme.compute_scene_scales(*args),
                               jme.compute_scene_scales(*args), rtol=1e-6)


def test_nero_adapter_raises(metric_cases):
    """The nero adapter raised while the port had no JPEG decoder; now its
    .jpg renders (real JPEG files) decode to cv2's pixels and eval_scene
    scores them as the JAX package does."""
    case, model, family, scene, gt_root, pred_root, scores, _ = [
        c for c in metric_cases if c[1] == "nero"][0]
    pd_scene, _ = tme.resolve_scene_dirs(pred_root, scene, family, model)
    jpg = join(pd_scene, "0", "rgb_pr.jpg")
    with open(jpg, "rb") as f:
        assert f.read(3) == b"\xff\xd8\xff"
    np.testing.assert_array_equal(
        tio.read_image(jpg), cv2.imread(jpg, cv2.IMREAD_UNCHANGED)[..., ::-1])
    got = tme.eval_scene(scene, family, pd_scene, join(gt_root, scene),
                         model_name=model, device="cpu")
    want = scores[scene]  # the JAX eval_dataset's, from the fixture
    assert set(got) == set(want) and {"rgb", "kd", "ks", "rough"} == set(got)
    for buf, ms in want.items():
        for m, vals in ms.items():
            for g, w in zip(got[buf][m], vals):
                assert abs(g - w) <= 1e-6 * max(1.0, abs(w)), (buf, m)


def test_resolve_scene_dirs_equals_jax(tmp_path):
    layouts = ["s_ref_nfr/lr5e-4/pd_test/ckpt-3", "s_nfr_unit/lr5e-4/vis_z/a",
               "s_nerfactor/lr5e-3/vis_vali/e1", "s_material-val/7",
               "s/run0/plots/5", "s/test_1234"]
    for rel in layouts:
        os.makedirs(join(str(tmp_path), rel))
    for model in tme.MODEL_ADAPTERS:
        for family in ("nerf", "dtu"):
            assert tme.resolve_scene_dirs(str(tmp_path), "s", family,
                                          model) == \
                jme.resolve_scene_dirs(str(tmp_path), "s", family, model)
    with pytest.raises(NotImplementedError):
        tme.resolve_scene_dirs(str(tmp_path), "s", "nerf", "bogus")


# ---- cluster_eval -----------------------------------------------------------


def _labels(seed, n=4000):
    rs = np.random.RandomState(seed)
    gt = rs.choice([0, 1, 2, 5, 9], n, p=[0.1, 0.4, 0.3, 0.15, 0.05])
    pd = np.where(rs.rand(n) < 0.7, gt * 2 + 1,
                  rs.choice([0, 3, 4, 7, 12, 13], n))
    pd[:3] = 40  # an extra predicted label of a few pixels
    return gt, pd


@pytest.mark.parametrize("seed", range(3))
def test_correspond_and_scores_equal_sklearn(seed):
    from sklearn.metrics import f1_score, precision_score, recall_score
    gt, pd = _labels(seed)
    j_coo, j_map, j_gt, j_pd = jce.correspond(gt, pd)
    t_coo, t_map, t_gt, t_pd = tce.correspond(gt, pd, device="cpu")
    for t, j in ((t_coo, j_coo), (t_map, j_map), (t_gt, j_gt), (t_pd, j_pd)):
        assert np.array_equal(t, j)
    assert tce.purity(t_coo) == jce.purity(j_coo)
    got = tce.label_scores(j_gt, j_pd, device="cpu")
    assert got == {
        "f1-micro": float(f1_score(j_gt, j_pd, average="micro")),
        "f1-macro": float(f1_score(j_gt, j_pd, average="macro")),
        "p-macro": float(precision_score(j_gt, j_pd, average="macro",
                                         zero_division=0)),
        "r-macro": float(recall_score(j_gt, j_pd, average="macro",
                                      zero_division=0))}
    # labels absent from the prediction and extra predicted ones
    gt2 = np.array([0, 0, 1, 2, 2, 3])
    pd2 = np.array([0, 4, 4, 2, 5, 5])
    assert tce.label_scores(gt2, pd2, device="cpu")["p-macro"] == float(
        precision_score(gt2, pd2, average="macro", zero_division=0))
    assert tce.label_scores(gt2, pd2, device="cpu")["f1-macro"] == float(
        f1_score(gt2, pd2, average="macro", zero_division=0))


def _write_cluster_tree(root, scene, n_views, h, w, seed):
    rs = np.random.RandomState(seed)
    for i in range(n_views):
        for sub in (join("labels", scene, "val_%03d" % i),
                    join("pred", scene, "batch%09d" % i)):
            os.makedirs(join(root, sub), exist_ok=True)
        alpha = _disc(h, w)
        _write(join(root, "rgba", scene, "val_%03d" % i, "rgba.png"),
               np.dstack([rs.rand(h, w, 3), alpha]))
        gt = rs.randint(0, 5, (h // 8, w // 8)).repeat(8, 0).repeat(8, 1)
        pd = np.where(rs.rand(h, w) < 0.8, gt + 2, rs.randint(0, 9, (h, w)))
        pal_gt = np.array([[7, 7, 7]] + [list(c) for c in
                                         tce.SEL_COLORS[:6]], np.uint8)
        pal_pd = np.array([[0, 0, 0]] + [list(c) for c in
                                         tce.EMBED_C[:11]], np.uint8)
        tio.write_png(join(root, "labels", scene, "val_%03d" % i,
                           "idx.png"), pal_gt[gt])
        tio.write_png(join(root, "pred", scene, "batch%09d" % i,
                           "embed_map.png"), pal_pd[pd])


def test_eval_scene_segmentation_equals_jax(tmp_path):
    root = str(tmp_path)
    _write_cluster_tree(root, "s", 2, 48, 64, 0)
    args = [join(root, d, "s") for d in ("rgba", "labels", "pred")]
    want = jce.eval_scene_segmentation(*args)
    got = tce.eval_scene_segmentation(*args, device="cpu")
    assert got == want and list(got) == list(want)
    assert 0.3 < got["purity"] < 1.0


# ---- mean shift -------------------------------------------------------------


def _write_materials(root, n_views, h, w, dtype, seed):
    rs = np.random.RandomState(seed)
    centres = rs.rand(5, 7)
    dirs = []
    for i in range(n_views):
        d = join(root, "val_%03d" % i)
        os.makedirs(d)
        lab = rs.randint(0, 5, (h, w))
        f = centres[lab] + 0.03 * rs.randn(h, w, 7)
        f[_disc(h, w) < 0.5] = 0.0  # background
        np.save(join(d, "albedo.npy"), f[..., :3].astype(dtype))
        np.save(join(d, "spec.npy"), f[..., 3:6].astype(dtype))
        np.save(join(d, "rough.npy"), f[..., 6:].astype(dtype))
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-9),
                                        (np.float32, 1e-5)])
def test_meanshift_equals_jax(tmp_path, dtype, atol):
    dirs = _write_materials(str(tmp_path / "mat"), 2, 40, 48, dtype, 0)
    j_out = [str(tmp_path / "j" / os.path.basename(d)) for d in dirs]
    t_out = [str(tmp_path / "t" / os.path.basename(d)) for d in dirs]
    j_n, _ = jms.meanshift_segmentation(dirs, j_out, max_pixels=1500)
    t_n, _ = tms.meanshift_segmentation(dirs, t_out, max_pixels=1500,
                                        device="cpu")
    assert t_n == j_n >= 3
    for j, t in zip(j_out, t_out):
        assert np.array_equal(np.load(join(t, "labels.npy")),
                              np.load(join(j, "labels.npy")))
        assert tio.read_png(join(t, "labels.png")).tobytes() == \
            cv2.imread(join(j, "labels.png"))[..., ::-1].tobytes()
    # the centres of the same subsample, against sklearn's fit
    feats = np.concatenate([np.concatenate(
        [np.load(join(d, n)).reshape(-1, c) for n, c in
         (("albedo.npy", 3), ("spec.npy", 3), ("rough.npy", 1))], -1)
        for d in dirs])
    feats = feats[np.abs(feats).sum(-1) > 0][:1200]
    want = MeanShift(bandwidth=0.2, bin_seeding=True).fit(feats)
    got = tms.mean_shift(feats, 0.2, device="cpu")
    assert got.shape == want.cluster_centers_.shape
    np.testing.assert_allclose(got, want.cluster_centers_, rtol=0, atol=atol)
    labels = tms.nearest_center(torch.as_tensor(feats, dtype=torch.float64),
                                torch.as_tensor(got))
    assert np.array_equal(labels.numpy(), want.predict(feats))


def test_chip_smoke_planted_materials_equal_jax(tmp_path):
    """chip_smoke.py's planted materials, at a small size: the port's
    mean shift finds every planted material, as the JAX one (sklearn)
    does, with the same labels, one to each planted sector."""
    import chip_smoke

    dirs = [str(tmp_path / "mat" / v) for v in ("a", "b")]
    truth = chip_smoke._write_clustered_materials(dirs, 64, 0)
    j_out = [str(tmp_path / "j" / v) for v in ("a", "b")]
    t_out = [str(tmp_path / "t" / v) for v in ("a", "b")]
    j_n, _ = jms.meanshift_segmentation(dirs, j_out, max_pixels=3000)
    t_n, _ = tms.meanshift_segmentation(dirs, t_out, max_pixels=3000,
                                        device="cpu")
    assert t_n == j_n == len(chip_smoke.MS_MATERIALS)
    for j, t, planted in zip(j_out, t_out, truth):
        lab = np.load(join(t, "labels.npy"))
        assert np.array_equal(lab, np.load(join(j, "labels.npy")))
        pairs = np.unique(np.stack([planted.ravel(), lab.ravel()]), axis=1)
        assert len(pairs[0]) == t_n + 1 == len(set(pairs[0])) == \
            len(set(pairs[1]))


def test_chip_smoke_same_csv():
    """The smoke's card-against-CPU CSV check: float cells within 1e-9
    relative, every other cell equal."""
    import chip_smoke

    a = b"scene,rgb_psnr\nlego,30.000000000001\n"
    assert chip_smoke._same_csv(a, a, "t") == (0, 2)
    assert chip_smoke._same_csv(a, b"scene,rgb_psnr\nlego,30.0\n",
                                "t") == (1, 2)
    for other in (b"scene,rgb_psnr\nlego,30.001\n",
                  b"scene,rgb_psnr\nlegO,30.000000000001\n",
                  b"scene,rgb_ssim\nlego,30.000000000001\n",
                  b"scene,rgb_psnr\nlego,\n"):
        with pytest.raises(AssertionError):
            chip_smoke._same_csv(a, other, "t")


def test_bin_seeds_equal_sklearn():
    from sklearn.cluster import get_bin_seeds
    rs = np.random.RandomState(3)
    for x in (rs.rand(500, 3).astype(np.float32), rs.rand(200, 2),
              rs.rand(4, 7)):  # the last: every point its own bin
        want = get_bin_seeds(x, 0.2)
        got = tms.bin_seeds(x, 0.2)
        assert got.dtype == want.dtype
        assert sorted(map(tuple, got)) == sorted(map(tuple, want))


# ---- CSV --------------------------------------------------------------------


def test_csv_writers_equal_pandas(tmp_path):
    metric = {
        "lego_3072": {"rgb": {"psnr": [30.1, 32.25], "ssim": [0.9],
                              "lpips": [0.1, 0.30000000000000004]},
                      "kd": {"psnr": [], "ssim": [], "lpips": []}},
        "a,b": {"rgb": {"psnr": [1e-5], "ssim": [1e16], "lpips": [12.0]},
                "env": {"psnr": [25.123456789012344], "ssim": [0.5],
                        "lpips": [2.0]}},
        "_lpips_impl": "proxy"}
    cluster = {"vq": {"purity": [0.9, 0.8], "f1-micro": [0.7]},
               "meanshift": {"purity": [0.5], "r-macro": [1 / 3]}}
    for name, obj, j_fn, t_fn in (
            ("m", metric, jvc.metric_json_to_csv, tvc.metric_json_to_csv),
            ("c", cluster, jvc.cluster_json_to_csv,
             tvc.cluster_json_to_csv)):
        path = str(tmp_path / (name + ".json"))
        with open(path, "w") as f:
            json.dump(obj, f)
        df = j_fn(path, str(tmp_path / (name + "_j.csv")))
        rows = t_fn(path, str(tmp_path / (name + "_t.csv")))
        with open(str(tmp_path / (name + "_j.csv")), "rb") as f:
            want = f.read()
        with open(str(tmp_path / (name + "_t.csv")), "rb") as f:
            assert f.read() == want
        assert [list(r) for r in rows] == [
            [k for k, v in rec.items() if not (isinstance(v, float)
                                              and np.isnan(v))]
            for rec in df.to_dict("records")]
    tvc.write_rows([], str(tmp_path / "empty.csv"))
    import pandas as pd
    pd.DataFrame([]).to_csv(str(tmp_path / "empty_j.csv"), index=False)
    assert open(str(tmp_path / "empty.csv"), "rb").read() == open(
        str(tmp_path / "empty_j.csv"), "rb").read()


# ---- the subcommands --------------------------------------------------------


def _run(main, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_cli_metric_and_cluster_eval_equal_jax(tmp_path, monkeypatch):
    """metric-eval (ref_nfr, family nerf: 600 -> 512 area, the albedo
    scale, a relight, AlexNet LPIPS of reduced widths) and cluster-eval
    through both CLIs on one tree: the printed lines and the JSONs."""
    root = str(tmp_path)
    gt_root, pred_root = _write_case(root, "ref_nfr", "nerf", "lego_3072",
                                     (600, 600), (600, 600), 1, ["city"],
                                     7)
    monkeypatch.setenv("VQNERF_LPIPS_WEIGHTS",
                       _weights(tmp_path / "w.npz", np.float32))
    args = ["metric-eval", "--family", "nerf", "--scenes", "lego_3072",
            "--pred-root", pred_root, "--gt-root", gt_root, "--out-json"]
    want = _run(j_cli.main, args + [join(root, "j.json")])
    got = _run(t_cli.main, args + [join(root, "t.json"), "--device", "cpu"])
    assert got == want and want[0] == "lpips_impl: alexnet"
    assert [line.split()[1] for line in want[1:]] == ["rgb", "kd", "env"]
    with open(join(root, "j.json")) as f:
        j_scores = json.load(f)
    with open(join(root, "t.json")) as f:
        _assert_scores_close(json.load(f), j_scores,
                             lpips_rel=LPIPS_F32_REL)
    assert len(j_scores["lego_3072"]["env"]["psnr"]) == 1

    _write_cluster_tree(root, "s", 2, 40, 40, 1)
    args = ["cluster-eval", "--scenes", "s", "--rgba-root",
            join(root, "rgba"), "--label-root", join(root, "labels"),
            "--pred-root", join(root, "pred"), "--out-json"]
    want = _run(j_cli.main, args + [join(root, "cj.json")])
    got = _run(t_cli.main, args + [join(root, "ct.json"), "--device", "cpu"])
    assert got == want
    assert open(join(root, "ct.json")).read() == \
        open(join(root, "cj.json")).read()


@pytest.mark.parametrize("sub", ["metric-eval", "cluster-eval"])
def test_cli_eval_device_cuda_without_card_exits(sub, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    argv = {"metric-eval": ["--family", "nerf", "--scenes", "s",
                            "--pred-root", str(tmp_path), "--gt-root",
                            str(tmp_path)],
            "cluster-eval": ["--scenes", "s", "--rgba-root", str(tmp_path),
                             "--label-root", str(tmp_path), "--pred-root",
                             str(tmp_path)]}[sub]
    with pytest.raises(SystemExit, match="torch.cuda.is_available"):
        t_cli.main([sub, *argv, "--out-json", str(tmp_path / "x.json")])
