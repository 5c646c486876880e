"""The port's video-frame helpers against the JAX package's, on the CPU:
``make_frame`` bit for bit (shape and dtype included) on batch dirs of
PNGs written with cv2 from a numpy seed, and ``make_anim``'s flipbook
decoded through PIL as the JAX function's is.
"""

import os

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from vqnerf_release_torch.utils import vis as t_vis
from vqnerf_release_tpu.utils import vis as j_vis


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(rs, *shape):
    return (rs.rand(*shape) * 255).astype(np.uint8)


def _write(d, name, img):
    assert cv2.imwrite(os.path.join(d, name + ".png"), img)


LAYOUT = (("normal", "nn"), ("albedo", "rgb"))


def _case_rgb8(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 12, 12, 3))
    return LAYOUT, _u8(rs, 4, 8, 3), 2


def _case_rgba(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 10, 13, 4))
    return LAYOUT, _u8(rs, 3, 5, 4), 2


def _case_gray(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 11, 9))
    return LAYOUT, _u8(rs, 4, 4, 3), 2


def _case_rgb16(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, (rs.rand(9, 14, 3) * 65535).astype(np.uint16))
    return LAYOUT, _u8(rs, 2, 3, 3), 2


def _case_resize_both_ways(d, rs):
    # row-major: normal (smaller), albedo (larger), rgb (last: the size)
    _write(d, "pred_normal", _u8(rs, 7, 5, 3))
    _write(d, "pred_albedo", _u8(rs, 16, 15, 3))
    _write(d, "pred_rgb", _u8(rs, 12, 11, 3))
    return LAYOUT, _u8(rs, 3, 3, 3), 2


def _case_bare_before_pred(d, rs):
    for name in ("rgb", "pred_rgb", "pred_albedo", "normal"):
        _write(d, name, _u8(rs, 8, 10, 3))
    return LAYOUT, None, 2


def _case_nn_and_missing(d, rs):
    _write(d, "pred_albedo", _u8(rs, 9, 8, 3))
    _write(d, "pred_rgb", _u8(rs, 9, 8, 3))
    return (("nn", "albedo", "missing"), ("rgb", "nn", "gone")), \
        _u8(rs, 2, 2, 3), 2


def _case_light_too_tall(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 8, 12, 3))
    return LAYOUT, _u8(rs, 8, 3, 3), 2


def _case_light_too_wide(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 8, 12, 3))
    return LAYOUT, _u8(rs, 3, 12, 3), 2


def _case_float_light(d, rs):
    for name in ("pred_rgb", "pred_albedo", "pred_normal"):
        _write(d, name, _u8(rs, 12, 12, 3))
    return LAYOUT, rs.rand(5, 6, 3) * 255.99, 2


def _case_rgb_names(d, rs):
    for name in ("pred_rgb_probes_sky", "pred_rgb_olat_0", "pred_albedo",
                 "spec"):
        _write(d, name, _u8(rs, 10, 10, 3))
    return (("rgb_probes_sky", "albedo"), ("spec", "rgb_olat_0")), \
        _u8(rs, 3, 4, 3), 2


def _case_pad0(d, rs):
    layout, light, _ = _case_rgb8(d, rs)
    return layout, light, 0


def _case_pad3(d, rs):
    layout, light, _ = _case_resize_both_ways(d, rs)
    return layout, light, 3


def _case_nothing_found(d, rs):
    _write(d, "pred_other", _u8(rs, 4, 4, 3))
    return (("rgb", "nn"), ("albedo", "normal")), _u8(rs, 2, 2, 3), 2


CASES = {
    "rgb8": _case_rgb8, "rgba": _case_rgba, "gray": _case_gray,
    "rgb16": _case_rgb16, "resize_both_ways": _case_resize_both_ways,
    "bare_before_pred": _case_bare_before_pred,
    "nn_and_missing": _case_nn_and_missing,
    "light_too_tall": _case_light_too_tall,
    "light_too_wide": _case_light_too_wide,
    "float_light": _case_float_light, "rgb_names": _case_rgb_names,
    "pad0": _case_pad0, "pad3": _case_pad3,
    "nothing_found": _case_nothing_found,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_frame_equals_jax_bit_for_bit(case, tmp_path):
    d = str(tmp_path / "batch000000000")
    os.makedirs(d)
    layout, light, pad = CASES[case](d, np.random.RandomState(
        sorted(CASES).index(case)))
    want = j_vis.make_frame(d, layout, rgb_embed_light=light, pad=pad)
    got = t_vis.make_frame(d, layout, rgb_embed_light=light, pad=pad)
    if case == "nothing_found":
        assert want is None and got is None
        return
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_make_frame_raises_on_a_file_that_does_not_decode(tmp_path):
    d = str(tmp_path / "batch000000000")
    os.makedirs(d)
    _write(d, "pred_albedo", _u8(np.random.RandomState(0), 4, 4, 3))
    with open(os.path.join(d, "pred_rgb.png"), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n not a png")
    with pytest.raises(TypeError):
        j_vis.make_frame(d, LAYOUT)
    with pytest.raises(ValueError):
        t_vis.make_frame(d, LAYOUT)


def _decode_all(path):
    """PIL's reading of a flipbook: frames, per-frame durations, loop."""
    im = Image.open(path)
    frames, durations = [], []
    for i in range(getattr(im, "n_frames", 1)):
        im.seek(i)
        frames.append(np.array(im))
        durations.append(im.info.get("duration"))
    return frames, durations, im.info.get("loop"), im.format


def test_make_anim_decodes_as_the_jax_flipbook(tmp_path):
    rs = np.random.RandomState(1)
    a, b = _u8(rs, 6, 7, 3), _u8(rs, 6, 7, 3)
    g1, g2 = _u8(rs, 5, 4), _u8(rs, 5, 4)
    q1, q2 = _u8(rs, 4, 6, 4), _u8(rs, 4, 6, 4)
    cases = [([a, b], 1000), ([a, a], 1000), ([a, a, b, b, a], 40),
             ([g1, g2], 250), ([q1, q2, q1], 1000)]
    for i, (frames, duration) in enumerate(cases):
        jp = j_vis.make_anim(frames, str(tmp_path / "j" / f"{i}.apng"),
                             duration=duration)
        tp = t_vis.make_anim([torch.from_numpy(f) for f in frames],
                             tmp_path / "t" / f"{i}.apng", duration=duration)
        assert tp == str(tmp_path / "t" / f"{i}.apng")
        jf, jd, jl, jfmt = _decode_all(jp)
        tf, td, tl, tfmt = _decode_all(tp)
        assert (len(tf), td, tl, tfmt) == (len(jf), jd, jl, jfmt), i
        for x, y in zip(tf, jf):
            np.testing.assert_array_equal(x, y)
