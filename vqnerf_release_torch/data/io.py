"""Image and array IO without OpenCV (counterpart of
vqnerf_release_tpu/data/io.py, which reads and writes through cv2).

  * PNG: a decoder and an encoder of bytes in numpy and zlib (and the file
    reader and writer on them). The decoder reads every kind of PNG as
    cv2.imdecode(IMREAD_UNCHANGED) does (``decode_png``): gray, gray+alpha,
    RGB, RGBA and palette at every depth, tRNS, Adam7 interlacing; it
    undoes all five row filters (Average and Paeth rows an anti-diagonal of
    pixels a step). The encoder writes 8- and 16-bit gray, gray+alpha, RGB
    and RGBA, non-interlaced, filter 0 (None).
  * JPEG: ``data/jpeg.py``'s decoder, equal to cv2.imread bit for bit.
    The readers tell PNG from JPEG by the file's signature, as cv2 does,
    not by its extension (``decode_image``); ``imread_color`` is what
    ``cv2.imread(path)`` (IMREAD_COLOR) gives.
  * AVI: a writer and a reader of uncompressed 24-bit frames ('DIB ') in
    a RIFF AVI 1.0 file with its index (what OpenCV writes is MJPG).
  * Radiance .hdr: a reader for flat and run-length-encoded scanlines and
    a flat writer, with OpenCV's RGBE conversion (rgbe.c: value =
    mantissa * 2^(exponent - 136), no half-step offset). OpenEXR envmaps
    through ``data/exr.py``.
  * ``resize``: ``cv2.resize`` under the JAX package's choice of
    interpolation (INTER_AREA where the height shrinks, else
    INTER_LINEAR), every direction and factor, for uint8, uint16 and
    float images. Integer images equal cv2's own resampler bit for bit;
    float images too except the bilinear resampler, within a float32 ulp
    of cv2 (which hands float and uint16 INTER_LINEAR to Intel IPP: a
    uint16 bilinear result may then differ from cv2's by 1).
  * ``read_rgba16`` and ``resize_u8_linear``: the stage-1 loaders' 16-bit
    RGBA read (floor-divided to 8 bits) and their bilinear resize of uint8
    images, in cv2's 11-bit fixed point.
"""

import glob
import json
import math
import os
import struct
import zlib

import numpy as np

from .jpeg import decode_jpeg, is_jpeg, read_jpeg

__all__ = [
    "decode_png", "encode_png", "read_png", "write_png", "write_apng",
    "decode_jpeg", "read_jpeg", "decode_image", "read_image", "imread_color",
    "write_avi", "load_img_f32", "write_img",
    "read_rgba16", "resize_u8_linear", "read_hdr",
    "write_hdr", "read_envmap", "resize", "vis_light", "alpha_blend",
    "read_json", "write_json", "sortglob",
]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # color type -> samples a pixel
_PNG_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def sortglob(directory, pattern="*", ext=None):
    if ext is None:
        return sorted(glob.glob(os.path.join(directory, pattern)))
    if isinstance(ext, str):
        ext = (ext,)
    paths = []
    for e in ext:
        paths += glob.glob(os.path.join(directory, "*." + e))
    return sorted(paths)


# ---------------------------------------------------------------------------
# PNG


def _png_chunks(data):
    pos = len(_PNG_SIG)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_diagonals(cur, kinds, bpp):
    """Undo the filters of every row of ``cur`` (int32 [h, stride]) by
    anti-diagonals.

    A byte depends on the bytes bpp to its left, above and above-left,
    whichever filter its row uses, so every pixel of one anti-diagonal
    y + x = d is decoded in one vectorised step: h + w - 1 steps. The image
    lives in a flat buffer with a zero row and a zero column in front,
    where the pixels of a diagonal lie w apart and their left, upper and
    upper-left neighbours are the same strided slice shifted by 1, w + 1
    and w + 2."""
    h, stride = cur.shape
    w = stride // bpp
    w1 = w + 1
    buf = np.zeros(((h + 1) * w1, bpp), np.int32)
    data = cur.reshape(h * w, bpp)
    step = max(w - 1, 1)  # data's step along a diagonal
    for d in range(h + w - 1):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        m = y1 - y0
        # pixel (y, d - y) sits at (y + 1) * w1 + d - y + 1 in buf
        p0 = y0 * w + w1 + d + 1
        left = buf[p0 - 1:p0 + (m - 1) * w:w]
        up = buf[p0 - w1:p0 - w1 + (m - 1) * w + 1:w]
        up_left = buf[p0 - w1 - 1:p0 - w1 + (m - 1) * w:w]
        q0 = y0 * (w - 1) + d
        x = data[q0:q0 + (m - 1) * step + 1:step]
        kind = kinds[y0:y1, None]
        pred = np.select(
            [kind == 1, kind == 2, kind == 3, kind == 4],
            [left, up, (left + up) >> 1, _paeth(left, up, up_left)], 0)
        buf[p0:p0 + (m - 1) * w + 1:w] = (x + pred) & 255
    return buf.reshape(h + 1, w1, bpp)[1:, 1:].reshape(h, stride)


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters; returns uint8 [h, stride]. An image
    with Average or Paeth rows, whose bytes depend on their left
    neighbours, is decoded by anti-diagonals (``_unfilter_diagonals``);
    one of None, Sub and Up rows only, as every PNG the port writes, a row
    a step, which is far faster (scripts/torch_png_decode_time.py times
    both)."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    kinds = rows[:, 0].astype(np.int32)
    if np.any(kinds > 4):
        raise ValueError(f"bad PNG filter type {kinds.max()}")
    cur = rows[:, 1:].astype(np.int32)
    if np.any(kinds >= 3):
        return _unfilter_diagonals(cur, kinds, bpp).astype(np.uint8)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        row = cur[y]
        if kinds[y] == 1:  # Sub: running sum along each byte lane
            row = np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1)
        elif kinds[y] == 2:  # Up
            row = row + prev
        prev = row & 255
        out[y] = prev
    return out


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # x0, y0, dx, dy a pass
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}


def _png_samples(rows, w, ch, depth):
    """Unfiltered scanlines uint8 [h, stride] -> samples [h, w, ch], uint16
    at depth 16, else uint8 (depths 1, 2 and 4 unpacked, not scaled)."""
    h = rows.shape[0]
    if depth == 16:
        v = rows.reshape(h, w * ch, 2)
        v = (v[..., 0].astype(np.uint16) << 8) | v[..., 1]
    elif depth == 8:
        v = rows
    else:  # several samples a byte, the first in the high bits
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = ((rows[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w * ch]
    return v.reshape(h, w, ch)


def _png_image(raw, w, h, ch, depth, interlace):
    """The zlib-inflated IDAT stream -> samples [h, w, ch]. Each Adam7
    pass is a sub-image of its own width, filtered on its own; a pass with
    no pixel has no scanline."""
    bpp = max(1, ch * depth // 8)  # the filters' byte distance
    if not interlace:
        stride = (w * ch * depth + 7) // 8
        return _png_samples(_unfilter(raw, h, stride, bpp), w, ch, depth)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        n = ph * (stride + 1)
        rows = _unfilter(raw[pos:pos + n], ph, stride, bpp)
        out[y0::dy, x0::dx] = _png_samples(rows, pw, ch, depth)
        pos += n
    return out


def decode_png(data, what="PNG"):
    """PNG bytes -> uint8 or uint16 array, [H, W] for gray, else [H, W, C]
    in RGB(A) order, as ``cv2.imdecode(..., IMREAD_UNCHANGED)`` decodes it
    (with its channels in BGR order): gray+alpha as RGBA with the gray
    replicated; gray at depths 1, 2 and 4 scaled to 0..255; a palette
    expanded to RGB, or to RGBA when a tRNS chunk gives alphas (255 past
    the table's end, black past the palette's); RGB with a tRNS key gets
    alpha 0 where a pixel equals the key and the maximum elsewhere; a tRNS
    on gray is ignored; Adam7-interlaced files give the same array as
    non-interlaced ones. ``what`` names the source in errors."""
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{what}: not a PNG file")
    idat = []
    ihdr = plte = trns = None
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{what}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth not in _PNG_DEPTHS.get(ctype, ()) or interlace > 1:
        raise NotImplementedError(
            f"{what}: PNG color type {ctype}, bit depth {depth}, interlace "
            f"{interlace} is not a kind the PNG format defines")
    if ctype == 3 and plte is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    ch = _PNG_CHANNELS[ctype]
    img = _png_image(zlib.decompress(b"".join(idat)), w, h, ch, depth,
                     interlace)
    top = (1 << depth) - 1
    if ctype == 3:
        n = len(plte) // 3
        table = np.zeros((256, 3), np.uint8)
        table[:n] = plte[:3 * n].reshape(n, 3)
        # libpng ignores an empty tRNS or one longer than the palette
        if trns is not None and 0 < len(trns) <= n:
            alpha = np.full((256, 1), 255, np.uint8)
            alpha[:len(trns), 0] = np.frombuffer(trns, np.uint8)
            table = np.concatenate([table, alpha], axis=1)
        return table[img[..., 0]]
    if ctype == 0:
        img = img[..., 0]
        return img * np.uint8(255 // top) if depth < 8 else img
    if ctype == 4:
        return img[..., [0, 0, 0, 1]]
    if ctype == 2 and trns is not None and len(trns) == 6:
        key = np.array(struct.unpack(">HHH", trns)) & top
        alpha = np.where(np.all(img == key, axis=-1), 0, top)
        img = np.concatenate([img, alpha[..., None].astype(img.dtype)],
                             axis=-1)
    return img


def read_png(path):
    """PNG file -> array, as ``decode_png``."""
    with open(path, "rb") as f:
        return decode_png(f.read(), what=str(path))


def _png_chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_parts(img, what):
    """(IHDR chunk, zlib stream of the filter-0 scanlines, (w, h))."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{what} takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _PNG_COLOR_TYPE:
        raise ValueError(f"{what} takes 1-4 channels, got {ch}")
    depth = 8 * img.dtype.itemsize
    body = img.astype(img.dtype.newbyteorder(">")).tobytes()
    stride = w * ch * img.dtype.itemsize
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _PNG_COLOR_TYPE[ch], 0, 0, 0)
    return (_png_chunk(b"IHDR", ihdr), zlib.compress(raw.tobytes(), 6),
            (w, h))


def encode_png(img):
    """uint8 or uint16 [H, W] or [H, W, C] (C in 1-4, RGB order) -> PNG
    bytes."""
    ihdr, data, _ = _png_parts(img, "encode_png")
    return (_PNG_SIG + ihdr + _png_chunk(b"IDAT", data)
            + _png_chunk(b"IEND", b""))


def write_png(path, img):
    """``encode_png(img)`` written to ``path``."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def write_apng(path, frames, duration_ms=1000):
    """Frames of one shape and dtype -> an animated PNG that loops forever;
    the first frame is also the still image. ``duration_ms`` is one delay
    for every frame or a list of one a frame (whole milliseconds, at most
    65535)."""
    parts = [_png_parts(f, "write_apng") for f in frames]
    ihdr, _, (w, h) = parts[0]
    if any(p[0] != ihdr for p in parts):
        raise ValueError("write_apng: frames differ in shape or dtype")
    if isinstance(duration_ms, (list, tuple)):
        if len(duration_ms) != len(parts):
            raise ValueError("write_apng: one duration a frame")
        delays = list(duration_ms)
    else:
        delays = [duration_ms] * len(parts)
    out = [_PNG_SIG, ihdr,
           _png_chunk(b"acTL", struct.pack(">II", len(parts), 0))]
    seq = 0
    for i, (_, data, _) in enumerate(parts):
        out.append(_png_chunk(b"fcTL", struct.pack(
            ">IIIIIHHBB", seq, w, h, 0, 0, delays[i], 1000, 0, 0)))
        seq += 1
        if i == 0:
            out.append(_png_chunk(b"IDAT", data))
        else:
            out.append(_png_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"".join(out))


def decode_image(data, what="image"):
    """PNG or JPEG bytes -> array (channels in RGB order), told apart by
    the signature as cv2 tells them (89 50 4E 47 is PNG, FF D8 FF is
    JPEG), whatever the file is called."""
    if bytes(data[:8]) == _PNG_SIG:
        return decode_png(data, what=what)
    if is_jpeg(data):
        return decode_jpeg(data, what=what)
    raise NotImplementedError(
        f"{what}: neither a PNG nor a JPEG file (signature "
        f"{bytes(data[:4]).hex()})")


def read_image(path):
    """A PNG or JPEG file -> array, as ``cv2.imread(path,
    IMREAD_UNCHANGED)`` with the channels in RGB(A) order."""
    if not os.path.exists(str(path)):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        return decode_image(f.read(), what=str(path))


def imread_color(path):
    """``cv2.imread(path)`` (IMREAD_COLOR) in RGB order: uint8 [H, W, 3];
    gray is replicated, alpha dropped, 16-bit samples shifted down by 8.
    (cv2 would also apply a JPEG's EXIF orientation here; this does not.)"""
    img = read_image(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def load_img_f32(path):
    """PNG or JPEG -> float32 in [0, 1] (uint8 / 255, uint16 / 65535)."""
    img = read_image(path)
    scale = 255.0 if img.dtype == np.uint8 else 65535.0
    return img.astype(np.float32) / scale


def read_rgba16(path, longint=True):
    """uint16 PNG -> uint8 (floor-divide by 256), as the stage-1 loaders
    do; channels in RGB(A) order, gray+alpha as RGBA. 8-bit PNGs and JPEGs
    pass through."""
    img = read_image(str(path))
    if longint and img.dtype == np.uint16:
        img = (img // 256).astype(np.uint8)
    return np.clip(img, 0, 255)


def write_img(arr, path, clip=True):
    """float [0, 1] (or uint8) -> 8-bit PNG; returns the uint8 array."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        if clip:
            arr = np.clip(arr, 0.0, 1.0)
        arr = (arr * 255.0).round().astype(np.uint8)
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    write_png(path, arr)
    return arr


# ---------------------------------------------------------------------------
# AVI: uncompressed 24-bit DIB frames in a RIFF AVI 1.0 container

_AVIF_HASINDEX = 0x10
_AVIIF_KEYFRAME = 0x10
_AVI_MAX_BYTES = 2**31 - 1  # readers take the RIFF size as signed


def _riff_chunk(fourcc, data):
    pad = b"\0" if len(data) % 2 else b""
    return fourcc + struct.pack("<I", len(data)) + data + pad


def _riff_list(kind, body):
    return _riff_chunk(b"LIST", kind + body)


def write_avi(path, frames, fps=24):
    """uint8 RGB frames [N, H, W, 3] (or a list of [H, W, 3] of one shape)
    -> an AVI of uncompressed BGR frames ('DIB '), with an idx1 index.
    Rows are stored top-down (a negative DIB height): FFmpeg, which
    OpenCV reads AVIs through, mishandles the bottom-up form. Returns the
    number of frames."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("write_avi: no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != (h, w, 3) or f.dtype != np.uint8:
            raise ValueError(f"write_avi takes uint8 [{h}, {w}, 3] frames, "
                             f"got {f.dtype} {f.shape}")
    row = (3 * w + 3) & ~3  # DIB rows are padded to 4 bytes
    size = row * h
    if (size + 24) * len(frames) + 4096 > _AVI_MAX_BYTES:
        raise ValueError(f"write_avi: {len(frames)} frames of {w}x{h} "
                         "exceed the 2 GiB of an AVI 1.0 file")
    n, fps = len(frames), int(fps)
    usec = int(round(1e6 / fps))
    avih = struct.pack("<14I", usec, size * fps, 0, _AVIF_HASINDEX, n, 0, 1,
                       size, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"DIB ", 0, 0, 0, 0,
                       1, fps, 0, n, size, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<IiiHHIIiiII", 40, w, -h, 1, 24, 0, size, 0, 0, 0, 0)
    hdrl = _riff_list(b"hdrl", _riff_chunk(b"avih", avih) + _riff_list(
        b"strl", _riff_chunk(b"strh", strh) + _riff_chunk(b"strf", strf)))
    chunks, index, offset = [], [], 4  # offsets from the 'movi' fourcc
    for f in frames:
        dib = np.zeros((h, row), np.uint8)
        dib[:, :3 * w] = f[:, :, ::-1].reshape(h, 3 * w)
        chunk = _riff_chunk(b"00db", dib.tobytes())
        index.append(struct.pack("<4sIII", b"00db", _AVIIF_KEYFRAME, offset,
                                 size))
        chunks.append(chunk)
        offset += len(chunk)
    movi = _riff_list(b"movi", b"".join(chunks))
    body = b"AVI " + hdrl + movi + _riff_chunk(b"idx1", b"".join(index))
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return n


# ---------------------------------------------------------------------------
# Radiance .hdr


def _rgbe_to_float(rgbe):
    rgbe = rgbe.astype(np.int32)
    scale = np.where(rgbe[..., 3] > 0,
                     np.ldexp(1.0, rgbe[..., 3] - 136), 0.0)
    return (rgbe[..., :3] * scale[..., None]).astype(np.float32)


def _read_rle_scanline(data, pos, w):
    """One new-style RLE scanline (4 channel runs) from data[pos:]."""
    line = np.empty((4, w), np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            count = data[pos]
            pos += 1
            if count > 128:  # a run of one value
                count -= 128
                line[c, x:x + count] = data[pos]
                pos += 1
            else:  # literal bytes
                line[c, x:x + count] = np.frombuffer(
                    data, np.uint8, count, pos)
                pos += count
            x += count
    return line.T, pos


def read_hdr(path):
    """Radiance .hdr -> float32 [H, W, 3] linear RGB."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while True:  # header lines end at an empty line
        end = data.index(b"\n", pos)
        line = data[pos:end].strip()
        pos = end + 1
        if not line:
            break
        if line.startswith(b"FORMAT=") and line != b"FORMAT=32-bit_rle_rgbe":
            raise NotImplementedError(f"{path}: {line.decode()}")
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise NotImplementedError(
            f"{path}: resolution line {data[pos:end]!r}; only -Y H +X W")
    h, w = int(res[1]), int(res[3])
    out = np.empty((h, w, 4), np.uint8)
    for y in range(h):
        rle = (8 <= w < 0x8000 and data[pos] == 2 and data[pos + 1] == 2
               and (data[pos + 2] << 8 | data[pos + 3]) == w)
        if rle:
            out[y], pos = _read_rle_scanline(data, pos + 4, w)
        else:
            out[y] = np.frombuffer(data, np.uint8, 4 * w, pos).reshape(w, 4)
            pos += 4 * w
    return _rgbe_to_float(out)


def write_hdr(path, img):
    """float [H, W, 3] linear RGB -> Radiance .hdr with flat scanlines."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    v = img.max(axis=-1).astype(np.float64)
    mant, exp = np.frexp(v)
    ok = v >= 1e-32
    scale = np.where(ok, mant * 256.0 / np.where(ok, v, 1.0), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = (img * scale[..., None]).astype(np.uint8)
    rgbe[..., 3] = np.where(ok, exp + 128, 0)
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def read_envmap(path, new_h=None):
    """.hdr, .exr or .npy envmap, optionally resized to height new_h; an
    EXR's alpha channel is dropped."""
    ext = os.path.basename(str(path)).split(".")[-1].lower()
    if ext == "exr":
        from .exr import read_exr
        arr = read_exr(path)
        if arr.ndim == 3 and arr.shape[2] == 4:
            arr = arr[..., :3]
    elif ext == "hdr":
        arr = read_hdr(path)
    elif ext == "npy":
        arr = np.load(path).astype(np.float32)
    else:
        raise NotImplementedError(
            f"{path}: envmaps are read from .hdr, .exr or .npy, not .{ext}")
    if new_h is not None and arr.shape[0] != new_h:
        arr = resize(arr, new_h=new_h)
    return arr


# ---------------------------------------------------------------------------


def _bilinear_axis(img, new_n, axis):
    """Linear interpolation of a float image along one axis, pixel centres
    at half integers, the source position in float64 and the border
    replicated: within a float32 ulp of cv2.INTER_LINEAR, which runs float
    images through Intel IPP."""
    n = img.shape[axis]
    src = (np.arange(new_n, dtype=np.float64) + 0.5) * (n / new_n) - 0.5
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    frac[lo < 0] = 0.0
    i0 = np.clip(lo, 0, n - 1)
    i1 = np.clip(lo + 1, 0, n - 1)
    shape = [1] * img.ndim
    shape[axis] = new_n
    frac = frac.reshape(shape)
    return (np.take(img, i0, axis=axis) * (1.0 - frac)
            + np.take(img, i1, axis=axis) * frac)


def _resample_tab(n, new_n, area, edge):
    """The source index and float32 fraction of each destination sample
    along one axis, as cv2's generic resampler (resize.cpp, resize())
    computes them: ``(d + 0.5) * scale - 0.5`` for INTER_LINEAR; for
    INTER_AREA outside its pure-downscale path ``s = floor(d * scale)``
    and ``(d + 1) - (s + 1) / scale`` clamped at 0, minus its floor. On
    the horizontal axis (``edge``) an index outside the image is pulled in
    with fraction 0; on the vertical one only the rows are clipped."""
    inv = new_n / n
    scale = 1.0 / inv
    d = np.arange(new_n, dtype=np.float64)
    if area:
        lo = np.floor(d * scale).astype(np.int64)
        frac = ((d + 1) - (lo + 1) * inv).astype(np.float32)
        frac = np.where(frac <= 0, np.float32(0),
                        frac - np.floor(frac)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        lo = np.floor(f).astype(np.int64)
        frac = (f - lo.astype(np.float32)).astype(np.float32)
    if edge:
        frac[(lo < 0) | (lo >= n - 1)] = 0.0
    return (np.clip(lo, 0, n - 1), np.clip(lo + 1, 0, n - 1),
            np.float32(1) - frac, frac)


def _saturate(out, dtype):
    """Round to nearest even and saturate to an integer dtype
    (cv2's saturate_cast)."""
    info = np.iinfo(dtype)
    return np.clip(np.rint(out), info.min, info.max).astype(dtype)


def _resample(img, new_h, new_w, area=False):
    """cv2's two-tap generic resampler (INTER_LINEAR, and INTER_AREA where
    one axis grows): a horizontal pass, then a vertical one over the rows
    it made. uint8 runs in cv2's 11-bit fixed point, whose vertical pass
    shifts each row's term by 4, weights it, shifts by 16 and rounds the
    sum with + 2 >> 2; other types in float32 (uint16 rounded to nearest
    even and saturated, as saturate_cast does)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _resample_tab(w, new_w, area, True)
    y0, y1, b0, b1 = _resample_tab(h, new_h, area, False)
    tail = (1,) * (img.ndim - 2)
    a0, a1 = a0.reshape((1, -1) + tail), a1.reshape((1, -1) + tail)
    b0, b1 = b0.reshape((-1, 1) + tail), b1.reshape((-1, 1) + tail)
    if img.dtype == np.uint8:
        def fix(c):
            return np.rint(c * np.float32(2048)).astype(np.int64)
        src = img.astype(np.int64)
        rows = src[:, x0] * fix(a0) + src[:, x1] * fix(a1)
        out = (((rows[y0] >> 4) * fix(b0)) >> 16) \
            + (((rows[y1] >> 4) * fix(b1)) >> 16)
        return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    rows = src[:, x0] * a0 + src[:, x1] * a1
    out = rows[y0] * b0 + rows[y1] * b1
    if np.issubdtype(img.dtype, np.integer):
        return _saturate(out, img.dtype)
    return out.astype(img.dtype)


def resize_u8_linear(img, new_h, new_w):
    """Bilinear resize of a uint8 image [H, W] or [H, W, C] as
    ``cv2.resize(img, (new_w, new_h))`` does it, bit for bit: 11-bit
    fixed-point weights per axis, horizontal pass first (``_resample``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_u8_linear takes uint8, got {img.dtype}")
    if (new_h, new_w) == img.shape[:2]:
        return img
    return _resample(img, new_h, new_w)


def _area_terms(n, new_n):
    """cv2.INTER_AREA's table along one axis (resize.cpp
    computeResizeAreaTab): for destination cell d the source span
    [d * s, (d + 1) * s), s = 1 / (new_n / n), a partial weight at either
    end where the fraction exceeds 1e-3, and every weight divided by the
    cell's width. Returns (source index, float32 weight), each [new_n, T],
    the terms of a cell in cv2's order and padded with weight 0."""
    scale = 1.0 / (new_n / n)
    cells = []
    for d in range(new_n):
        fs1 = d * scale
        fs2 = fs1 + scale
        width = min(scale, n - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, n - 1)
        s1 = min(s1, s2)
        terms = []
        if s1 - fs1 > 1e-3:
            terms.append((s1 - 1, (s1 - fs1) / width))
        terms += [(s, 1.0 / width) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            terms.append((s2, min(min(fs2 - s2, 1.0), width) / width))
        cells.append(terms)
    t = max(len(c) for c in cells)
    idx = np.zeros((new_n, t), np.int64)
    wts = np.zeros((new_n, t), np.float32)
    for d, terms in enumerate(cells):
        for j, (s, a) in enumerate(terms):
            idx[d, j], wts[d, j] = s, np.float32(a)
    return idx, wts


def _area_axis(img, new_n, axis):
    """One pass of the area mean along ``axis``: each cell's terms summed
    in cv2's order in float32 or the image's wider float type (first term
    times its weight, then each further term times its weight added)."""
    idx, wts = _area_terms(img.shape[axis], new_n)
    shape = [1] * img.ndim
    shape[axis] = new_n
    out = None
    for j in range(idx.shape[1]):
        term = np.take(img, idx[:, j], axis=axis) * wts[:, j].astype(
            img.dtype).reshape(shape)
        out = term if out is None else out + term
    return out


def _area_fast(img, fy, fx):
    """cv2.INTER_AREA at integer factors (resizeAreaFast_). Integer images:
    each block's integer sum times float32(1 / area), rounded to nearest
    even; at 2x2 (cv2's vector path) the sum + 2 >> 2. Float images: the
    block summed in float32 four terms at a time (((a + b) + c) + d added
    to the running sum), times float32(1 / area); at 2x2 with 1 or 4
    channels cv2's 4-lane vector path sums (row 0 pair) + (row 1 pair)
    and times 0.25, up to the last multiple of 4 of a row's values."""
    h, w = img.shape[:2]
    blocks = img.reshape((h // fy, fy, w // fx, fx) + img.shape[2:])
    if np.issubdtype(img.dtype, np.integer):
        total = blocks.astype(np.int64).sum(axis=(1, 3))
        if (fy, fx) == (2, 2):
            return _saturate((total + 2) >> 2, img.dtype)
        return _saturate(total.astype(np.float32)
                         * np.float32(1.0 / (fy * fx)), img.dtype)
    terms = [blocks[:, sy, :, sx] for sy in range(fy) for sx in range(fx)]
    total = np.zeros_like(terms[0])
    k = 0
    while k + 4 <= len(terms):
        total = total + (((terms[k] + terms[k + 1]) + terms[k + 2])
                         + terms[k + 3])
        k += 4
    for t in terms[k:]:
        total = total + t
    out = total * img.dtype.type(1.0 / (fy * fx))
    cn = 1 if img.ndim == 2 else img.shape[2]
    if (fy, fx) == (2, 2) and cn in (1, 4):
        vec = ((terms[0] + terms[1]) + (terms[2] + terms[3])) \
            * img.dtype.type(0.25)
        flat, vflat = out.reshape(h // 2, -1), vec.reshape(h // 2, -1)
        n = flat.shape[1] // 4 * 4
        flat[:, :n] = vflat[:, :n]
    return out


def resize(img, new_h=None, new_w=None):
    """``cv2.resize`` as the JAX package calls it: INTER_AREA where the
    height shrinks, INTER_LINEAR otherwise (the height alone decides).
    INTER_AREA with neither axis growing is cv2's area mean (a block mean
    at integer factors); with the width growing it is cv2's generic
    resampler with area fractions. Integer images (uint8, uint16) come out
    equal to cv2 bit for bit, float ones too except the bilinear
    resampler, which lies within a float32 ulp of cv2."""
    h, w = img.shape[:2]
    if new_h is not None and new_w is None:
        new_w = int(w / h * new_h)
    elif new_w is not None and new_h is None:
        new_h = int(h / w * new_w)
    if (new_h, new_w) == (h, w):
        return img
    img = np.asarray(img)
    integer = np.issubdtype(img.dtype, np.integer)
    if integer and img.dtype not in (np.uint8, np.uint16):
        raise NotImplementedError(
            f"resize of a {img.dtype} image: uint8, uint16 and float only")
    if new_h >= h and not integer:
        out = _bilinear_axis(img.astype(np.float32), new_w, 1)
        return _bilinear_axis(out, new_h, 0).astype(img.dtype)
    if new_h >= h or new_w > w:
        return _resample(img, new_h, new_w, area=new_h < h)
    if not (h % new_h or w % new_w):
        return _area_fast(img, h // new_h, w // new_w)
    # horizontal, then vertical, as cv2's ResizeArea_Invoker sums
    src = img.astype(np.float32) if integer else img
    out = _area_axis(_area_axis(src, new_w, 1), new_h, 0)
    return _saturate(out, img.dtype) if integer else out


def vis_light(light, outpath=None, h=None):
    """Tonemap an HDR envmap for viewing: clip by the max, gamma 1/2.2, to
    uint8; optionally resized to height h and written to outpath."""
    light = np.asarray(light, np.float32)
    if h is not None and light.shape[0] != h:
        light = resize(light, new_h=h)
    maxv = max(float(light.max()), 1e-8)
    tonemapped = np.power(np.clip(light / maxv, 0, 1), 1.0 / 2.2)
    img = (tonemapped * 255).astype(np.uint8)
    if outpath is not None:
        write_img(img, outpath)
    return img


def alpha_blend(fg, alpha, bg):
    """fg * alpha + bg * (1 - alpha); alpha broadcast to fg's channels."""
    fg = np.asarray(fg, np.float32)
    bg = np.asarray(bg, np.float32)
    alpha = np.asarray(alpha, np.float32)
    if alpha.ndim == fg.ndim - 1:
        alpha = alpha[..., None]
    return fg * alpha + bg * (1.0 - alpha)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(obj, path):
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
