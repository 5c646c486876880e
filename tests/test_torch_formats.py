"""The port's file formats against OpenCV and the JAX package, on the CPU:
the PNG decoder (vqnerf_release_torch/data/io.py::decode_png) against
cv2.imdecode(IMREAD_UNCHANGED) on every kind of PNG, the JPEG decoder
(vqnerf_release_torch/data/jpeg.py) against cv2.imread(IMREAD_UNCHANGED),
the signature dispatch of the image readers,
the committed JPEG fixtures, the OpenEXR reader and writer against the JAX
package's, and ``data/io.py::resize`` against cv2.resize under the JAX
package's choice of interpolation.

Tolerances: the PNG and JPEG decodes, EXR arrays and files, and integer resizes
are equal bit for bit. Two cv2 paths run through Intel IPP, which the port
does not copy: a uint16 INTER_LINEAR result is held bit for bit to cv2
with IPP off and within 1 of the default; a float INTER_LINEAR one within
2e-7 of the default (a float32 ulp near 1).
"""

import glob
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch

from vqnerf_release_tpu.data import exr as j_exr
from vqnerf_release_tpu.data import io as j_io
from vqnerf_release_torch.data import exr as t_exr
from vqnerf_release_torch.data import io as t_io
from vqnerf_release_torch.data import jpeg as t_jpeg


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module: the suite's workers share the
    host, and a pool of spinning threads a worker turns these tests'
    small operations into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_jpeg")
SAMPLING = {
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
}


def _image(h, w, c, seed):
    """Smooth waves with noise: long zero runs and large coefficients."""
    rs = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                    for k in range(c)], -1)
    img = np.clip(img + rs.randn(h, w, c) * 30, 0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _encode(img, params):
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _cv2_decode(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img[..., ::-1] if img.ndim == 3 else img


def _assert_decodes_like_cv2(data):
    got = t_jpeg.decode_jpeg(data)
    want = _cv2_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---- PNG --------------------------------------------------------------------
# The files are written here byte by byte (cv2 writes none of these kinds
# on request): every scanline with its own filter, samples packed below 8
# bits, Adam7 passes each filtered on its own.

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_scanlines(samples, depth, rs):
    """samples int [h, w, ch] -> filtered scanlines, a random filter a
    row."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, w * ch)
    if depth == 16:
        rows = np.frombuffer(flat.astype(">u2").tobytes(), np.uint8)
        rows = rows.reshape(h, -1)
    elif depth == 8:
        rows = flat.astype(np.uint8)
    else:
        per = 8 // depth
        flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per)))
        grouped = flat.reshape(h, -1, per)
        rows = sum(grouped[..., i] << (8 - depth * (i + 1))
                   for i in range(per)).astype(np.uint8)
    rows = rows.astype(np.int32)
    bpp = max(1, ch * depth // 8)
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for cur in rows:
        kind = int(rs.randint(5))
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0 * cur, left, prev, (left + prev) >> 1,
                _png_paeth(left, prev, up_left)][kind]
        out.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def _png_file(samples, depth, ctype, interlace=False, plte=None, trns=None,
              seed=0):
    """PNG bytes of samples int [h, w, ch] (palette indices for ctype 3)."""
    rs = np.random.RandomState(seed)
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(
            _png_scanlines(samples[y0::dy, x0::dx], depth, rs)
            for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        raw = _png_scanlines(samples, depth, rs)
    extra = b""
    if plte is not None:
        extra += _png_chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        extra += _png_chunk(b"tRNS", trns)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr) + extra
            + _png_chunk(b"IDAT", zlib.compress(raw, 9))
            + _png_chunk(b"IEND", b""))


def _assert_png_decodes_like_cv2(data):
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:  # cv2's BGR(A) in the file's order
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    got = t_io.decode_png(data)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# (h, w): odd sizes, and sizes where some Adam7 passes are empty
PNG_SIZES = [(9, 13), (1, 1), (2, 3), (5, 1), (17, 8)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", [
    (0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1),
    (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
def test_png_every_kind_equals_cv2(ctype, depth, interlace):
    """Every colour type at every depth, interlaced or not: palettes
    expanded to RGB, gray below 8 bits scaled to 0..255, gray+alpha as
    RGBA with the gray replicated, as cv2 gives it (BGRA)."""
    for k, (h, w) in enumerate(PNG_SIZES):
        rs = np.random.RandomState(100 * ctype + depth + k)
        ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
        samples = rs.randint(0, 1 << depth, (h, w, ch))
        plte = None
        if ctype == 3:
            plte = rs.randint(0, 256, (1 << depth, 3))
        data = _png_file(samples, depth, ctype, interlace, plte, seed=k)
        got = _assert_png_decodes_like_cv2(data)
        if ctype == 4:  # cv2 replicates the gray into BGR
            np.testing.assert_array_equal(got, samples[..., [0, 0, 0, 1]])
        elif ctype == 3:
            np.testing.assert_array_equal(got, plte[samples[..., 0]])
        elif depth < 8:
            np.testing.assert_array_equal(
                got, samples[..., 0] * (255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette_trns_equals_cv2(depth, interlace):
    """A palette with a tRNS table decodes to RGBA: alpha from the table,
    255 past its end; an index past a short palette is black."""
    rs = np.random.RandomState(depth)
    n = 1 << depth
    samples = rs.randint(0, n, (11, 6, 1))
    for n_plte in sorted({n, max(1, n - 3)}):
        plte = rs.randint(0, 256, (n_plte, 3))
        for n_trns in sorted({1, max(1, n_plte // 2), n_plte}):
            trns = rs.randint(0, 256, n_trns).astype(np.uint8).tobytes()
            got = _assert_png_decodes_like_cv2(_png_file(
                samples, depth, 3, interlace, plte, trns))
            assert got.shape == (11, 6, 4)
        # a tRNS longer than the palette is ignored, as libpng ignores it
        got = _assert_png_decodes_like_cv2(_png_file(
            samples, depth, 3, interlace, plte, bytes(n_plte + 1)))
        assert got.shape == (11, 6, 3)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_rgb_trns_key_gives_alpha_like_cv2(depth, interlace):
    """An RGB PNG with a tRNS key decodes to 4 channels: alpha 0 where the
    pixel equals the key, the maximum elsewhere (8-bit keys compared in
    their low byte, as libpng compares them)."""
    rs = np.random.RandomState(depth)
    top = (1 << depth) - 1
    samples = rs.randint(0, 3, (10, 7, 3)) * (top // 2)
    key = samples[3, 4]
    for k in (key, key + (256 if depth == 8 else 0)):
        trns = struct.pack(">HHH", *(int(v) for v in k))
        got = _assert_png_decodes_like_cv2(_png_file(
            samples, depth, 2, interlace, trns=trns))
        alpha = np.where(np.all(samples == key, -1), 0, top)
        np.testing.assert_array_equal(got[..., 3], alpha)
        assert (got[..., 3] == 0).sum() >= 1


@pytest.mark.parametrize("depth", [1, 2, 4, 8, 16])
def test_png_gray_trns_is_ignored_like_cv2(depth):
    rs = np.random.RandomState(depth)
    samples = rs.randint(0, 1 << depth, (7, 9, 1))
    plain = _assert_png_decodes_like_cv2(_png_file(samples, depth, 0))
    trns = struct.pack(">H", int(samples[0, 0, 0]))
    for interlace in (False, True):
        got = _assert_png_decodes_like_cv2(_png_file(
            samples, depth, 0, interlace, trns=trns))
        np.testing.assert_array_equal(got, plain)


def test_png_bilevel_mask_written_by_cv2_reads_like_cv2(tmp_path):
    """A 1-bit mask as ``cv2.imwrite(..., IMWRITE_PNG_BILEVEL)`` writes
    it reads through ``read_image`` as cv2.imread(IMREAD_UNCHANGED)."""
    mask = (np.random.RandomState(0).rand(19, 21) > 0.5).astype(np.uint8)
    path = str(tmp_path / "mask.png")
    cv2.imwrite(path, mask * 255, [cv2.IMWRITE_PNG_BILEVEL, 1])
    with open(path, "rb") as f:
        assert struct.unpack(">B", f.read()[24:25])[0] == 1  # bit depth
    np.testing.assert_array_equal(
        t_io.read_image(path), cv2.imread(path, cv2.IMREAD_UNCHANGED))


def test_png_malformed_files_raise():
    samples = np.zeros((4, 4, 1), int)
    with pytest.raises(ValueError, match="PLTE"):
        t_io.decode_png(_png_file(samples, 8, 3))
    with pytest.raises(NotImplementedError, match="color type 2, bit depth 4"):
        t_io.decode_png(_png_file(samples, 4, 2))
    data = _png_file(samples, 8, 0, interlace=True)
    start = data.index(b"IDAT") + 4
    (n,) = struct.unpack(">I", data[start - 8:start - 4])
    short = zlib.compress(zlib.decompress(data[start:start + n])[:-3])
    with pytest.raises(ValueError):
        t_io.decode_png(data[:start - 8] + _png_chunk(b"IDAT", short)
                        + _png_chunk(b"IEND", b""))


# ---- JPEG -------------------------------------------------------------------

@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_baseline_matrix_equals_cv2(quality, sampling):
    img = _image(64, 64, 3, quality)
    _assert_decodes_like_cv2(_encode(img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_jpeg_progressive_equals_cv2(sampling):
    """jpeg_simple_progression: spectral selection, successive
    approximation with AC refinement scans, EOB runs."""
    img = _image(48, 64, 3, 7)
    _assert_decodes_like_cv2(_encode(img, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]))


@pytest.mark.parametrize("kind", ["gray", "gray_rst", "gray_progressive",
                                  "rst", "optimize", "odd_37x53",
                                  "odd_progressive_rst", "large_256"])
def test_jpeg_kinds_equal_cv2(kind):
    gray, color = _image(40, 56, 1, 1), _image(40, 56, 3, 2)
    q = [cv2.IMWRITE_JPEG_QUALITY, 85]
    data = {
        "gray": lambda: _encode(gray, q),
        "gray_rst": lambda: _encode(
            gray, q + [cv2.IMWRITE_JPEG_RST_INTERVAL, 2]),
        "gray_progressive": lambda: _encode(
            gray, q + [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
        "rst": lambda: _encode(color, q + [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
        "optimize": lambda: _encode(
            color, q + [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
        "odd_37x53": lambda: _encode(_image(37, 53, 3, 3), q),
        "odd_progressive_rst": lambda: _encode(_image(37, 53, 3, 4), q + [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
            cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
        "large_256": lambda: _encode(_image(256, 256, 3, 5), q),
    }[kind]()
    _assert_decodes_like_cv2(data)


def _splice_after_soi(data, segment):
    assert data[:2] == b"\xff\xd8"
    return data[:2] + segment + data[2:]


def _exif_orientation_6():
    """An APP1 Exif segment with one IFD0 entry: Orientation (0x0112) = 6,
    little-endian TIFF."""
    tiff = (b"II*\x00" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHII", 0x0112, 3, 1, 6) + struct.pack("<I", 0))
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


def test_jpeg_exif_orientation_is_ignored_as_cv2_unchanged():
    """cv2 ignores the EXIF orientation under IMREAD_UNCHANGED (and would
    rotate under IMREAD_COLOR): the port does not rotate."""
    img = _image(24, 40, 3, 6)
    data = _splice_after_soi(_encode(img, [cv2.IMWRITE_JPEG_QUALITY, 90]),
                             _exif_orientation_6())
    rotated = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    assert rotated.shape == (40, 24, 3)  # the segment is read by cv2
    got = t_jpeg.decode_jpeg(data)
    assert got.shape == (24, 40, 3)
    _assert_decodes_like_cv2(data)


def _drop_jfif(data):
    assert data[2:4] == b"\xff\xe0"
    n = struct.unpack(">H", data[4:6])[0]
    return data[:2] + data[4 + n:]


def test_jpeg_adobe_transform_flag_equals_cv2():
    """With no JFIF segment, the Adobe APP14 transform flag decides: 0 is
    RGB (no colour conversion), 1 YCbCr."""
    base = _drop_jfif(_encode(_image(32, 32, 3, 8), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        SAMPLING["444"]]))
    for transform in (0, 1):
        body = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform)
        seg = b"\xff\xee" + struct.pack(">H", len(body) + 2) + body
        _assert_decodes_like_cv2(_splice_after_soi(base, seg))
    rgb = t_jpeg.decode_jpeg(_splice_after_soi(base, b"\xff\xee" + struct.pack(
        ">H", 14) + b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)))
    ycc = t_jpeg.decode_jpeg(base)
    assert np.abs(rgb.astype(int) - ycc.astype(int)).max() > 10


def _with_marker(data, old, new):
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


@pytest.mark.parametrize("marker,name", [
    (b"\xff\xc3", "SOF3"), (b"\xff\xc9", "SOF9"), (b"\xff\xca", "SOF10"),
    (b"\xff\xcb", "SOF11"), (b"\xff\xc5", "SOF5")])
def test_jpeg_unsupported_frames_raise_naming_the_marker(marker, name):
    data = _encode(_image(16, 16, 3, 9), [cv2.IMWRITE_JPEG_QUALITY, 90])
    with pytest.raises(NotImplementedError, match=name):
        t_jpeg.decode_jpeg(_with_marker(data, b"\xff\xc0", marker))


def test_jpeg_12_bit_and_cmyk_raise():
    """12-bit samples and a malformed frame raise; a 4-component (CMYK)
    file no longer raises but decodes as cv2 does (3 channels)."""
    data = _encode(_image(16, 16, 3, 10), [cv2.IMWRITE_JPEG_QUALITY, 90])
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(NotImplementedError, match="SOF0 with 12-bit"):
        t_jpeg.decode_jpeg(twelve)
    two = data[:sof + 9] + b"\x02" + data[sof + 10:]
    with pytest.raises(NotImplementedError, match="2 components"):
        t_jpeg.decode_jpeg(two)
    _assert_decodes_like_cv2(_cmyk_jpeg(_image(16, 16, 4, 10), 90, {}, 0))
    with pytest.raises(ValueError, match="not a JPEG"):
        t_jpeg.decode_jpeg(b"\x89PNG\r\n\x1a\n")


def _cmyk_jpeg(img, quality, kwargs, transform):
    """An Adobe CMYK JPEG written by PIL, its APP14 transform flag set to
    ``transform`` (0 CMYK, 2 YCCK, 1 an unknown flag libjpeg reads as YCCK),
    or without the APP14 segment when ``transform`` is None."""
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=quality,
                                      **kwargs)
    data = bytearray(buf.getvalue())
    app14 = data.index(b"\xff\xee")
    assert data[app14 + 4:app14 + 9] == b"Adobe"
    if transform is None:
        n = struct.unpack(">H", data[app14 + 2:app14 + 4])[0]
        return bytes(data[:app14] + data[app14 + 2 + n:])
    data[app14 + 4 + 11] = transform
    return bytes(data)


@pytest.mark.parametrize("transform", [0, 2, 1, None])
@pytest.mark.parametrize("kind", ["444_q90", "420_q50", "progressive_q100",
                                  "odd_37x53_q75"])
def test_jpeg_cmyk_and_ycck_equal_cv2(kind, transform):
    """4-component files as cv2 reads them, bit for bit: CMYK stored as is
    (no APP14, or transform 0), YCCK (transform 2 or another flag) through
    libjpeg's YCC -> RGB, then OpenCV's CMYK -> BGR; 3 channels under
    IMREAD_UNCHANGED and IMREAD_COLOR alike."""
    h, w = (37, 53) if kind.startswith("odd") else (24, 40)
    quality = int(kind.split("_q")[1])
    kwargs = {"444_q90": {"subsampling": 0}, "420_q50": {"subsampling": 2},
              "progressive_q100": {"progressive": True},
              "odd_37x53_q75": {}}[kind]
    data = _cmyk_jpeg(_image(h, w, 4, 31), quality, kwargs, transform)
    _assert_decodes_like_cv2(data)
    color = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(color[..., ::-1], t_jpeg.decode_jpeg(data))


def test_readers_dispatch_on_the_signature_like_cv2(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as cv2 reads them:
    load_img_f32 and read_rgba16 equal the JAX package's."""
    img = _image(20, 28, 3, 11)
    jpg_as_png = str(tmp_path / "frame.png")
    with open(jpg_as_png, "wb") as f:
        f.write(_encode(img, [cv2.IMWRITE_JPEG_QUALITY, 90]))
    png_as_jpg = str(tmp_path / "frame.jpg")
    ok, buf = cv2.imencode(".png", img)
    with open(png_as_jpg, "wb") as f:
        f.write(buf.tobytes())
    for path in (jpg_as_png, png_as_jpg):
        np.testing.assert_array_equal(t_io.load_img_f32(path),
                                      j_io.load_img_f32(path))
        np.testing.assert_array_equal(t_io.read_rgba16(path),
                                      j_io.read_rgba16(path))
    gray = str(tmp_path / "gray.jpg")
    cv2.imwrite(gray, _image(20, 28, 1, 12))
    np.testing.assert_array_equal(t_io.load_img_f32(gray),
                                  j_io.load_img_f32(gray))
    junk = str(tmp_path / "junk.png")
    with open(junk, "wb") as f:
        f.write(b"GIF89a" + bytes(10))
    with pytest.raises(NotImplementedError, match="neither a PNG nor"):
        t_io.load_img_f32(junk)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_gray_alpha_reads_equal_jax(tmp_path, dtype):
    """A gray+alpha PNG (written by the port's encoder) reads as the JAX
    package's cv2 readers read it: [H, W, 4], the gray replicated into
    RGB, at 8 and 16 bits, through read_image, load_img_f32 and
    read_rgba16."""
    top = np.iinfo(dtype).max
    img = (np.random.RandomState(21).rand(9, 14, 2) * top).astype(dtype)
    path = str(tmp_path / "gray_alpha.png")
    t_io.write_png(path, img)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
    got = t_io.read_image(path)
    assert got.dtype == want.dtype and got.shape == (9, 14, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img[..., [0, 0, 0, 1]])
    for fn in ("load_img_f32", "read_rgba16"):
        got, want = getattr(t_io, fn)(path), getattr(j_io, fn)(path)
        assert got.dtype == want.dtype and got.shape == want.shape, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("kind", ["gray", "gray_alpha", "rgba", "rgb16",
                                  "jpeg"])
def test_imread_color_equals_cv2_imread(tmp_path, kind):
    """What cv2.imread(path) (IMREAD_COLOR) gives, in RGB order: gray and
    alpha images to 3 channels, 16 bits shifted down to 8."""
    rs = np.random.RandomState(13)
    path = str(tmp_path / "x.png")
    if kind == "gray":
        t_io.write_png(path, (rs.rand(9, 11) * 255).astype(np.uint8))
    elif kind == "gray_alpha":
        t_io.write_png(path, (rs.rand(9, 11, 2) * 255).astype(np.uint8))
    elif kind == "rgba":
        t_io.write_png(path, (rs.rand(9, 11, 4) * 255).astype(np.uint8))
    elif kind == "rgb16":
        t_io.write_png(path, (rs.rand(9, 11, 3) * 65535).astype(np.uint16))
    else:  # a JPEG named .png, without EXIF: no rotation on either side
        with open(path, "wb") as f:
            f.write(_encode(_image(9, 11, 3, 14),
                            [cv2.IMWRITE_JPEG_QUALITY, 90]))
    want = cv2.imread(path)[..., ::-1]
    got = t_io.imread_color(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_committed_fixtures_are_cv2_decodes():
    """tests/data/torch_jpeg: each .png is cv2.imread of its .jpg, and the
    port's decoder gives the same pixels (the card's check, which has no
    cv2, reads the same files)."""
    jpgs = sorted(glob.glob(os.path.join(FIXTURES, "*.jpg")))
    assert len(jpgs) == 8
    total = 0
    for jpg in jpgs:
        want = t_io.read_png(jpg[:-4] + ".png")
        np.testing.assert_array_equal(
            _cv2_decode(open(jpg, "rb").read()), want, err_msg=jpg)
        np.testing.assert_array_equal(t_io.read_jpeg(jpg), want,
                                      err_msg=jpg)
        total += os.path.getsize(jpg) + os.path.getsize(jpg[:-4] + ".png")
    assert total <= 400 * 1024
    with open(os.path.join(FIXTURES, "progressive_420_q90_512.jpg"),
              "rb") as f:
        assert b"\xff\xc2" in f.read()


# ---- EXR --------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["none", "zips", "zip"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_exr_equals_jax(tmp_path, comp, dtype):
    """The copy writes the JAX module's bytes and reads its files to the
    same arrays."""
    rs = np.random.RandomState(0)
    arr = (rs.rand(21, 13, 3) * 5).astype(np.float32)
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    j_exr.write_exr(jp, arr, compression=comp, dtype=dtype)
    t_exr.write_exr(tp, arr, compression=comp, dtype=dtype)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    np.testing.assert_array_equal(t_exr.read_exr(jp), j_exr.read_exr(jp))


def test_exr_uint_rgba_gray_equal_jax(tmp_path):
    rs = np.random.RandomState(1)
    for name, arr, dtype in (
            ("rgba", rs.rand(7, 5, 4).astype(np.float32), np.float32),
            ("gray", rs.rand(6, 9).astype(np.float32), np.float16),
            ("uint", (rs.rand(4, 6, 3) * 1000).astype(np.uint32),
             np.uint32)):
        p = str(tmp_path / (name + ".exr"))
        j_exr.write_exr(p, arr, compression="zip", dtype=dtype)
        got, want = t_exr.read_exr(p), j_exr.read_exr(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels,new_h", [(3, None), (4, None), (4, 8),
                                            (3, 32)])
def test_read_envmap_exr_equals_jax(tmp_path, channels, new_h):
    """An EXR probe reads as JAX reads it (alpha dropped), resized or
    not."""
    env = (np.random.RandomState(channels).rand(16, 32, channels)
           * 4).astype(np.float32)
    p = str(tmp_path / "probe.exr")
    t_exr.write_exr(p, env, compression="zips", dtype=np.float32)
    got = t_io.read_envmap(p, new_h=new_h)
    want = j_io.read_envmap(p, new_h=new_h)
    assert got.shape == want.shape
    if new_h is None or new_h < 16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * 4)


# ---- resize -----------------------------------------------------------------

def _jax_resize(img, new_h, new_w):
    return j_io.resize(img, new_h=new_h, new_w=new_w)


RESIZE_CASES = [
    # (h, w, new_h, new_w): upscales, non-integer downscales, mixed axes,
    # integer factors, one axis unchanged
    (20, 24, 47, 53), (9, 13, 40, 41), (60, 80, 42, 56), (37, 53, 20, 31),
    (30, 40, 12, 70), (13, 40, 7, 41), (30, 40, 45, 22), (12, 40, 30, 9),
    (64, 64, 32, 32), (48, 36, 16, 12), (64, 48, 16, 12), (30, 40, 30, 25),
    (30, 40, 20, 40), (1, 5, 3, 9),
]


@pytest.mark.parametrize("h,w,new_h,new_w", RESIZE_CASES)
@pytest.mark.parametrize("channels", [0, 1, 3, 4])
def test_resize_uint8_equals_cv2(h, w, new_h, new_w, channels):
    rs = np.random.RandomState(h * w + channels)
    shape = (h, w) if channels == 0 else (h, w, channels)
    img = (rs.rand(*shape) * 255).astype(np.uint8)
    got = t_io.resize(img, new_h, new_w)
    want = _jax_resize(img, new_h, new_w)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,new_h,new_w", RESIZE_CASES)
def test_resize_uint16_equals_cv2(h, w, new_h, new_w):
    """Area paths bit for bit against cv2; the bilinear path bit for bit
    against cv2's own resampler (IPP off) and within 1 of the default,
    which hands uint16 INTER_LINEAR to Intel IPP."""
    img = (np.random.RandomState(h + w).rand(h, w, 3) * 65535).astype(
        np.uint16)
    got = t_io.resize(img, new_h, new_w)
    want = _jax_resize(img, new_h, new_w)
    assert got.dtype == np.uint16 and got.shape == want.shape
    if new_h < h:
        np.testing.assert_array_equal(got, want)
        return
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        own = cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    finally:
        cv2.ipp.setUseIPP(ipp)
    np.testing.assert_array_equal(got, own)


@pytest.mark.parametrize("h,w,new_h,new_w", RESIZE_CASES)
def test_resize_float_equals_cv2(h, w, new_h, new_w):
    """Float images: the area paths bit for bit, the bilinear one within a
    float32 ulp near 1."""
    img = np.random.RandomState(3 * h + w).rand(h, w, 3).astype(np.float32)
    got = t_io.resize(img, new_h, new_w)
    want = _jax_resize(img, new_h, new_w)
    assert got.dtype == np.float32 and got.shape == want.shape
    if new_h < h:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def test_resize_u8_linear_equals_cv2_at_stage1_sizes():
    """The stage-1 loaders' 560 -> 420 and 128 -> 512 resizes of RGBA
    frames, bit for bit (they were within 1 before)."""
    rs = np.random.RandomState(15)
    for h, new_h in ((560, 420), (128, 512)):
        img = (rs.rand(h, h, 4) * 255).astype(np.uint8)
        np.testing.assert_array_equal(
            t_io.resize_u8_linear(img, new_h, new_h),
            cv2.resize(img, (new_h, new_h)))
