"""The port's material editing against the JAX package's, on the CPU: the
edit mask loader, ``apply_edit`` in both branches, a round of the edit
server driven by the other package's client, the client's material
database and segment selection, the PNG codec under the web UI's masks,
and the web UI itself.

Inputs are seeded numpy; the parameters are the JAX init functions'
converted by ``from_jax``. Tolerances: rendered arrays in [0, 1] at rtol
1e-4 / atol 1e-5, PNGs within 1 LSB (as tests/test_torch_test_driver.py
holds them); masks, ids, material tables and decoded PNGs exactly.
"""

import base64
import os
import struct
import zlib
from os.path import join

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_edit_web as jax_web_tests
from tests.test_data_layer import _make_synth_scene
from tests.test_torch_models import SMALL, jax_params
from tests.test_torch_video import compare_trees
from vqnerf_release_tpu.data.shape_dataset import ShapeDataset as JShape
from vqnerf_release_tpu.models import decomp_common as j_dc
from vqnerf_release_tpu.pipelines import edit as j_edit
from vqnerf_release_tpu.pipelines import edit_client as j_client
from vqnerf_release_tpu.pipelines import edit_web as j_web
from vqnerf_release_torch import cli as t_cli
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.data.shape_dataset import ShapeDataset as TShape
from vqnerf_release_torch.interop.jax_params import from_jax
from vqnerf_release_torch.models import decomp_common as t_dc
from vqnerf_release_torch.pipelines import edit as t_edit
from vqnerf_release_torch.pipelines import edit_client as t_client
from vqnerf_release_torch.pipelines import edit_web as t_web


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GOLD = t_client.MATERIAL_DB["gold"]
RED = {"diff": [0.8, 0.05, 0.05], "spec": [-1.0, 0, 0], "rough": [0.4]}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """Two 16x16 test views, the models in both forms, two probes and an
    edit mask a view ([H, W, 3] bool, as a client writes it)."""
    root = str(tmp_path_factory.mktemp("scene"))
    data_root, surf_root = _make_synth_scene(root)
    kw = dict(imh=16, mode="test", with_ref=True)
    jcfg, tcfg = j_dc.DecompConfig(**SMALL), t_dc.DecompConfig(**SMALL)
    j_views = [JShape(data_root, surf_root, **kw).load_view(f)
               for f in JShape(data_root, surf_root, **kw).files]
    ds = TShape(data_root, surf_root, **kw)
    t_views = [ds.load_view(f) for f in ds.files]
    _, vq_np, ref_np = jax_params()
    rs = np.random.RandomState(6)
    masks = []
    for i, v in enumerate(t_views):
        m = np.zeros((v.h, v.w, 3), bool)
        m[3 + i:11, 2:9 + i] = True
        masks.append(m)
    return dict(
        jcfg=jcfg, tcfg=tcfg, j_views=j_views, t_views=t_views,
        j_vq=jax.tree_util.tree_map(jnp.asarray, vq_np),
        j_ref=jax.tree_util.tree_map(jnp.asarray, ref_np),
        t_vq=from_jax(vq_np, "vq_nfr"), t_ref=from_jax(ref_np, "ref_nfr"),
        probes=(rs.rand(2, tcfg.n_lights, 3) * 2).astype(np.float32),
        probe_names=["city", "studio"], masks=masks)


@pytest.mark.parametrize("shape", [(16, 16), (16, 16, 3)])
def test_load_edit_mask_matches_jax(tmp_path, shape):
    m = np.random.RandomState(1).rand(*shape) > 0.5
    path = str(tmp_path / "m.npy")
    np.save(path, m if len(shape) == 2 else m.astype(np.float32))
    got = t_edit._load_edit_mask(path, 256)
    np.testing.assert_array_equal(got, j_edit._load_edit_mask(path, 256))
    assert got.shape == (256, 1) and got.dtype == np.float32
    with pytest.raises(ValueError, match="mask pixels"):
        t_edit._load_edit_mask(path, 255)


def _masks(scene):
    """The masks as apply_edit takes them: float32 [N, 1]."""
    return [m.reshape(-1, 3)[:, :1].astype(np.float32)
            for m in scene["masks"]]


@pytest.mark.parametrize("env,material,scale", [
    (None, RED, None), ("original", GOLD, [1.1, 0.9, 1.0]),
    ("studio", GOLD, None), ("city", RED, [0.8, 1.0, 1.2])])
def test_apply_edit_matches_jax_file_by_file(scene, tmp_path, env, material,
                                             scale):
    s = scene
    j_out, t_out = str(tmp_path / "jax"), str(tmp_path / "torch")
    j_edit.apply_edit(
        s["j_ref"], s["j_vq"], s["jcfg"], s["j_views"], material,
        [jnp.asarray(m) for m in _masks(s)], j_out, dst_env_name=env,
        novel_probes=jnp.asarray(s["probes"]), probe_names=s["probe_names"],
        opt_scale=None if scale is None else jnp.asarray(scale, jnp.float32))
    dirs = t_edit.apply_edit(
        s["t_ref"], s["t_vq"], s["tcfg"], s["t_views"], material, _masks(s),
        t_out, dst_env_name=env, novel_probes=s["probes"],
        probe_names=s["probe_names"], opt_scale=scale, device="cpu")
    assert [os.path.basename(d) for d in dirs] == ["batch000000000",
                                                   "batch000000001"]
    files = compare_trees(j_out, t_out)
    assert join("batch000000001", "pred_rough.npy") in files
    assert join("batch000000001", "pred_rgb.png") in files


def test_edit_changes_only_the_masked_rays(scene, tmp_path):
    """Outside the mask the edited render is the unedited one bit for
    bit; inside it (and inside the object) the maps are the material's,
    and a negative first channel keeps a map."""
    s = scene
    material = {"diff": [0.1, 0.6, 0.3], "spec": [-1.0, 0, 0],
                "rough": [0.25]}
    none = [np.zeros_like(m) for m in _masks(s)]
    for env in ("original", "city"):
        outs = {}
        for name, masks in (("plain", none), ("edit", _masks(s))):
            outs[name] = t_edit.apply_edit(
                s["t_ref"], s["t_vq"], s["tcfg"], s["t_views"], material,
                masks, str(tmp_path / env / name), dst_env_name=env,
                novel_probes=s["probes"], probe_names=s["probe_names"],
                device="cpu")
        for i, (plain, edit) in enumerate(zip(outs["plain"], outs["edit"])):
            inside = s["masks"][i][..., 0]
            fg = s["t_views"][i].alpha.reshape(inside.shape) > 0
            for name in ("albedo", "spec", "rough", "basecolor"):
                a = np.load(join(plain, "pred_%s.npy" % name))
                b = np.load(join(edit, "pred_%s.npy" % name))
                np.testing.assert_array_equal(b[~inside], a[~inside])
            np.testing.assert_array_equal(
                np.load(join(edit, "pred_spec.npy")),
                np.load(join(plain, "pred_spec.npy")))
            sel = inside & fg
            assert sel.any()
            np.testing.assert_allclose(
                np.load(join(edit, "pred_albedo.npy"))[sel],
                np.broadcast_to(material["diff"], (sel.sum(), 3)), rtol=1e-6)
            np.testing.assert_allclose(
                np.load(join(edit, "pred_rough.npy"))[sel], 0.25, rtol=1e-6)
            a = cv2.imread(join(plain, "pred_rgb.png"))
            b = cv2.imread(join(edit, "pred_rgb.png"))
            np.testing.assert_array_equal(b[~inside], a[~inside])
            assert (b[sel] != a[sel]).any()


def test_edit_server_round_with_either_client(scene, tmp_path):
    """The JAX client drives the port's server and the port's client the
    JAX server, one round each with poll_interval 0: the status goes
    uploaded -> finished, and both servers write the same files."""
    s = scene
    masks = [m[..., 0] for m in s["masks"]]
    t_root, j_root = str(tmp_path / "t_root"), str(tmp_path / "j_root")
    j_client.submit_edit(t_root, "gold", masks, env="studio")
    t_client.submit_edit(j_root, "gold", masks, env="studio")
    for name in ("dst.json", "illum.json", "batch000000001.npy"):
        a = open(join(t_root, "edited", name), "rb").read()
        assert a == open(join(j_root, "edited", name), "rb").read(), name
    assert open(join(t_root, "status", "status.json"), "rb").read() == \
        open(join(j_root, "status", "status.json"), "rb").read()
    rounds = t_edit.edit_server_loop(
        s["t_ref"], s["t_vq"], s["tcfg"], s["t_views"], t_root,
        novel_probes=s["probes"], probe_names=s["probe_names"],
        poll_interval=0, max_rounds=1, device="cpu")
    assert rounds == 1
    assert t_client.wait_finished(t_root, timeout=5, poll=0) == \
        join(t_root, "pd_edited")
    assert j_client.wait_finished(t_root, timeout=5, poll=0)
    j_edit.edit_server_loop(
        s["j_ref"], s["j_vq"], s["jcfg"], s["j_views"], j_root,
        novel_probes=jnp.asarray(s["probes"]), probe_names=s["probe_names"],
        poll_interval=0, max_rounds=1)
    assert t_edit.read_status(join(j_root, "status", "status.json")) == \
        {"status": "finished"}
    compare_trees(join(j_root, "pd_edited"), join(t_root, "pd_edited"))


def test_read_status_waits_out_a_half_written_file(tmp_path):
    path = tmp_path / "status.json"
    assert t_edit.read_status(str(path)) is None
    path.write_text('{"status": "upl')
    assert t_edit.read_status(str(path)) is None
    with pytest.raises(TimeoutError):
        t_client.wait_finished(str(tmp_path), timeout=0.05, poll=0.01)


def test_material_db_equals_jax():
    assert list(t_client.MATERIAL_DB) == list(j_client.MATERIAL_DB)
    for name, mat in j_client.MATERIAL_DB.items():
        assert t_client.MATERIAL_DB[name] == mat, name
    assert len(t_client.MATERIAL_DB) == 19


@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_auto_select_mask_matches_jax(dilate):
    emb = np.random.RandomState(dilate).randint(0, 4, (13, 17))
    emb[:, 0] = 3  # a segment on the border
    for embed_id in (1, 3):
        got = t_client.auto_select_mask(emb, embed_id, dilate=dilate)
        want = j_client.auto_select_mask(emb, embed_id, dilate=dilate)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(img, kinds):
    """A PNG of ``img`` (uint8 or uint16, [H, W] or [H, W, C], file
    order) whose row y is written with filter kinds[y % len(kinds)]."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    bpp = ch * img.dtype.itemsize
    x = np.frombuffer(img.astype(img.dtype.newbyteorder(">")).tobytes(),
                      np.uint8).reshape(h, w * bpp).astype(np.int32)
    raw = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = kinds[y % len(kinds)]
        pred = [0 * cur, left, up, (left + up) >> 1,
                _paeth(left, up, up_left)][kind]
        raw.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return _png(w, h, 8 * img.dtype.itemsize, ctype, b"".join(raw))


def _png(w, h, depth, ctype, raw):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _cv2_file_order(img):
    """cv2's BGR(A) decode in the file's channel order."""
    if img.ndim == 3:
        return img[..., [2, 1, 0, 3]] if img.shape[2] == 4 else img[..., ::-1]
    return img


@pytest.mark.parametrize("kinds", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                   [4, 4, 3, 1, 3, 0, 2]])
@pytest.mark.parametrize("ch,dtype", [(1, np.uint8), (3, np.uint8),
                                      (4, np.uint8), (4, np.uint16),
                                      (3, np.uint16)])
def test_png_codec_matches_cv2_on_every_filter(kinds, ch, dtype):
    rs = np.random.RandomState(len(kinds) * 10 + ch)
    top = np.iinfo(dtype).max
    img = (rs.rand(9, 11, ch) * top).astype(dtype)
    img[2:5, 3:8] = img[2, 3]  # runs where the filters predict well
    img = img[..., 0] if ch == 1 else img
    data = _filtered_png(img, kinds)
    want = _cv2_file_order(cv2.imdecode(np.frombuffer(data, np.uint8),
                                        cv2.IMREAD_UNCHANGED))
    got = t_io.decode_png(data)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    back = cv2.imdecode(np.frombuffer(t_io.encode_png(img), np.uint8),
                        cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(_cv2_file_order(back), img)


def test_png_codec_gray_alpha_and_bad_input():
    ga = (np.random.RandomState(2).rand(6, 7, 2) * 255).astype(np.uint8)
    data = _filtered_png(ga, [4, 3])
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    got = t_io.decode_png(data)  # cv2's BGRA, the gray replicated, as RGBA
    np.testing.assert_array_equal(got, want[..., [2, 1, 0, 3]])
    np.testing.assert_array_equal(got, ga[..., [0, 0, 0, 1]])
    with pytest.raises(ValueError, match="not a PNG"):
        t_io.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="filter type"):
        t_io.decode_png(_png(2, 1, 8, 0, b"\x07\x00\x00"))
    # a palette PNG (an upload from an image editor) decodes as cv2 does
    plte = struct.pack(">I", 0x1F2E3D)[1:] + b"\xff\x80\x00"
    ihdr = _png(2, 1, 8, 3, b"\x00\x01\x00")
    at = ihdr.index(b"IDAT") - 4
    data = (ihdr[:at] + struct.pack(">I", 6) + b"PLTE" + plte
            + struct.pack(">I", zlib.crc32(b"PLTE" + plte) & 0xFFFFFFFF)
            + ihdr[at:])
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(t_io.decode_png(data), want[..., ::-1])
    np.testing.assert_array_equal(t_io.decode_png(data),
                                  [[[255, 128, 0], [31, 46, 61]]])


def test_png_decode_time_script_runs(monkeypatch, capsys):
    """scripts/torch_png_decode_time.py at a small size: both unfilter
    paths decode the port's PNGs to the same bytes, and each is timed."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_png_decode_time", join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "scripts",
            "torch_png_decode_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr("sys.argv", ["x", "--size", "9", "--reps", "1"])
    mod.main()
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" filter-0")[0] for ln in lines] == \
        ["9x9x1", "9x9x3", "9x9x4"]


@pytest.mark.parametrize("shape", [(8, 10), (1, 1), (31, 17)])
def test_mask_pngs_cross_between_the_packages(shape):
    mask = np.random.RandomState(shape[0]).rand(*shape) > 0.6
    np.testing.assert_array_equal(
        j_web._png_b64_to_mask(t_web._mask_png_b64(mask)), mask)
    np.testing.assert_array_equal(
        t_web._png_b64_to_mask(j_web._mask_png_b64(mask)), mask)
    url = "data:image/png;base64," + j_web._mask_png_b64(mask)
    np.testing.assert_array_equal(t_web._png_b64_to_mask(url), mask)
    rgb = np.zeros(shape + (3,), np.uint8)
    rgb[mask] = (0, 7, 0)
    b64 = base64.b64encode(t_io.encode_png(rgb)).decode()
    np.testing.assert_array_equal(t_web._png_b64_to_mask(b64), mask)
    np.testing.assert_array_equal(j_web._png_b64_to_mask(b64), mask)


def test_edit_page_and_routes_are_jax_ones():
    assert t_web._PAGE == j_web._PAGE
    assert t_web._BATCH_RE.pattern == j_web._BATCH_RE.pattern
    assert t_web._SAFE_IMG.pattern == j_web._SAFE_IMG.pattern


@pytest.mark.parametrize("test", ["test_edit_web_ui_roundtrip",
                                  "test_edit_web_paint_and_custom_brdf"])
def test_web_ui_round_trip_against_the_port(monkeypatch, tmp_path, test):
    """The JAX package's own web UI tests, run against the port's server
    and material database."""
    monkeypatch.setattr(jax_web_tests, "serve_edit_ui", t_web.serve_edit_ui)
    monkeypatch.setattr(jax_web_tests, "MATERIAL_DB", t_client.MATERIAL_DB)
    getattr(jax_web_tests, test)(tmp_path)


def test_cli_edit_ui_dispatches(monkeypatch):
    calls = {}

    def fake_serve(root, views_dir, port=0, envs=(), host=""):
        calls.update(root=root, views_dir=views_dir, port=port,
                     envs=list(envs), host=host)

    monkeypatch.setattr(t_web, "serve_edit_ui", fake_serve)
    t_cli.main(["edit-ui", "--root", "/r", "--views-dir", "/v",
                "--port", "1234", "--envs", "original,court"])
    assert calls == {"root": "/r", "views_dir": "/v", "port": 1234,
                     "envs": ["original", "court"], "host": "127.0.0.1"}
