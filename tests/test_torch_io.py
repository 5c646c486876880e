"""The port's OpenCV-free image IO (vqnerf_release_torch/data/io.py) against
cv2, which this test environment has and the GPU machine does not."""

import cv2
import numpy as np
import pytest

from vqnerf_release_tpu.data import io as j_io
from vqnerf_release_torch.data import io as t_io


def _to_cv(img):
    """RGB(A) -> BGR(A) for cv2."""
    if img.ndim == 3 and img.shape[2] in (3, 4):
        return img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _image(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    top = 255 if dtype == np.uint8 else 65535
    img = rs.randint(0, top + 1, shape).astype(dtype)
    img[: shape[0] // 2] //= 7  # smooth-ish regions: all five PNG filters
    return img


SHAPES = {"gray": (13, 17), "rgb": (12, 9, 3), "rgba": (11, 16, 4)}


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("layout", list(SHAPES))
def test_png_read_write_match_cv2(tmp_path, layout, dtype):
    img = _image(SHAPES[layout], dtype)
    cv_path, port_path = str(tmp_path / "cv.png"), str(tmp_path / "port.png")
    cv2.imwrite(cv_path, _to_cv(img))
    got = t_io.read_png(cv_path)
    assert got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)
    t_io.write_png(port_path, img)
    back = cv2.imread(port_path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(_to_cv(back), img)
    # the JAX package's float loader reads the same floats as the port's
    np.testing.assert_array_equal(t_io.load_img_f32(cv_path),
                                  j_io.load_img_f32(cv_path))


def _filtered_png(path, img):
    """Write img (uint8/uint16 [H, W, C]) as a PNG whose row y uses filter
    type y % 5, so that the reader meets None, Sub, Up, Average and Paeth
    (cv2 writes Sub only)."""
    import struct
    import zlib
    h, w, ch = img.shape
    bpp = ch * img.dtype.itemsize
    rows = np.frombuffer(img.astype(img.dtype.newbyteorder(">")).tobytes(),
                         np.uint8).reshape(h, -1).astype(np.int32)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        kind = y % 5
        if kind == 4:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, up_left))
        else:
            pred = [0 * x, left, up, (left + up) // 2][kind]
        out.append(np.concatenate([[kind], (x - pred) & 255]))
    raw = np.concatenate(out).astype(np.uint8).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8 * img.dtype.itemsize, ctype, 0,
                       0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 2, 4])
def test_png_reader_undoes_every_filter(tmp_path, channels, dtype):
    img = _image((15, 10, channels), dtype, seed=channels)
    path = str(tmp_path / "filtered.png")
    _filtered_png(path, img)
    got = t_io.read_png(path)
    want = img[..., 0] if channels == 1 else img
    np.testing.assert_array_equal(got, want)
    if channels != 2:  # cv2 turns gray+alpha into BGRA
        cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(_to_cv(cv), want)


def test_write_img_matches_jax(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.rand(10, 7, 3) * 1.2 - 0.1
    t_io.write_img(img, str(tmp_path / "port.png"))
    j_io.write_img(img, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(
        cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
        cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED))


@pytest.mark.parametrize("w", [4, 32])  # cv2 writes flat below 8, else RLE
def test_hdr_read_matches_cv2(tmp_path, w):
    rs = np.random.RandomState(2)
    img = (rs.rand(6, w, 3) ** 3 * 50).astype(np.float32)
    img[0, : w // 2] = 0.0
    img[1] = img[1, :1]  # runs of one value
    path = str(tmp_path / "env.hdr")
    cv2.imwrite(path, img[..., ::-1])
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(t_io.read_hdr(path), want)
    np.testing.assert_array_equal(t_io.read_envmap(path),
                                  j_io.read_envmap(path))


def test_hdr_write_reads_back_in_cv2(tmp_path):
    rs = np.random.RandomState(3)
    img = (rs.rand(5, 12, 3) * 4).astype(np.float32)
    path = str(tmp_path / "port.hdr")
    t_io.write_hdr(path, img)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    np.testing.assert_array_equal(back, t_io.read_hdr(path))
    # RGBE keeps 8 mantissa bits of the largest channel
    assert (np.abs(back - img) <= img.max(axis=-1, keepdims=True) / 128).all()


@pytest.mark.parametrize("shape,new_h", [
    ((32, 64, 3), 16), ((32, 64, 3), 8), ((24, 24), 6), ((16, 16, 7), 16)])
def test_resize_matches_cv2_area(shape, new_h):
    rs = np.random.RandomState(4)
    img = rs.rand(*shape).astype(np.float32)
    got = t_io.resize(img, new_h=new_h)
    want = j_io.resize(img, new_h=new_h)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_resize_rejects_other_factors():
    img = np.zeros((30, 60, 3), np.float32)
    with pytest.raises(NotImplementedError):
        t_io.resize(img, new_h=20)  # 1.5x down
    with pytest.raises(NotImplementedError):
        t_io.resize(img, new_h=60)  # up
