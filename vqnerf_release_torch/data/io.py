"""Image and array IO without OpenCV (counterpart of
vqnerf_release_tpu/data/io.py, which reads and writes through cv2).

  * PNG: a reader and a writer in numpy and zlib, for 8- and 16-bit gray,
    gray+alpha, RGB and RGBA, non-interlaced. The reader undoes all five
    row filters; the writer writes filter 0 (None).
  * Radiance .hdr: a reader for flat and run-length-encoded scanlines and
    a flat writer, with OpenCV's RGBE conversion (rgbe.c: value =
    mantissa * 2^(exponent - 136), no half-step offset).
  * ``resize``: the same size passes through; an integer-factor
    downscale is a block mean, which is what cv2.INTER_AREA gives there.
    Other factors raise NotImplementedError.
"""

import glob
import json
import os
import struct
import zlib

import numpy as np

__all__ = [
    "read_png", "write_png", "load_img_f32", "write_img", "read_hdr",
    "write_hdr", "read_envmap", "resize", "alpha_blend", "read_json",
    "write_json", "sortglob",
]

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel
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


def _unfilter(raw, h, stride, bpp):
    """Undo the per-row PNG filters; returns uint8 [h, stride]."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind = rows[y, 0]
        cur = rows[y, 1:].astype(np.int32)
        if kind == 1:  # Sub: running sum along each byte lane
            cur = np.cumsum(cur.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif kind == 2:  # Up
            cur = (cur + prev) & 255
        elif kind in (3, 4):  # Average, Paeth: depend on the left pixel
            cur = cur.reshape(-1, bpp)
            up = prev.reshape(-1, bpp)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(cur.shape[0]):
                if kind == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up_left)
                left = (cur[x] + pred) & 255
                cur[x] = left
                up_left = up[x]
            cur = cur.reshape(-1)
        elif kind != 0:
            raise ValueError(f"bad PNG filter type {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path):
    """PNG -> uint8 or uint16 array, [H, W] for gray, else [H, W, C] in
    file order (RGB / RGBA / gray+alpha)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    idat = []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ctype not in _PNG_CHANNELS or depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"{path}: PNG color type {ctype}, bit depth {depth}, interlace "
            f"{interlace}; supported are gray/RGB/gray+alpha/RGBA at 8 or "
            "16 bits, non-interlaced")
    ch = _PNG_CHANNELS[ctype]
    bpp = ch * depth // 8
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = img.reshape(h, w * ch, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def write_png(path, img):
    """uint8 or uint16 [H, W] or [H, W, C] (C in 1-4, RGB order) -> PNG."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in _PNG_COLOR_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, got {ch}")
    depth = 8 * img.dtype.itemsize
    body = img.astype(img.dtype.newbyteorder(">")).tobytes()
    stride = w * ch * img.dtype.itemsize
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _PNG_COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def load_img_f32(path):
    """PNG -> float32 in [0, 1] (uint8 / 255, uint16 / 65535)."""
    img = read_png(path)
    scale = 255.0 if img.dtype == np.uint8 else 65535.0
    return img.astype(np.float32) / scale


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
    """.hdr or .npy envmap, optionally resized to height new_h."""
    ext = os.path.basename(str(path)).split(".")[-1].lower()
    if ext == "hdr":
        arr = read_hdr(path)
    elif ext == "npy":
        arr = np.load(path).astype(np.float32)
    else:
        raise NotImplementedError(
            f"{path}: envmaps are read from .hdr or .npy; .{ext} is not "
            "ported yet")
    if new_h is not None and arr.shape[0] != new_h:
        arr = resize(arr, new_h=new_h)
    return arr


# ---------------------------------------------------------------------------


def resize(img, new_h=None, new_w=None):
    """Passthrough at the same size; integer-factor area downscale (block
    mean, as cv2.INTER_AREA). Any other factor raises."""
    h, w = img.shape[:2]
    if new_h is not None and new_w is None:
        new_w = int(w / h * new_h)
    elif new_w is not None and new_h is None:
        new_h = int(h / w * new_w)
    if (new_h, new_w) == (h, w):
        return img
    if new_h > h or new_w > w or h % new_h or w % new_w:
        raise NotImplementedError(
            f"resize {h}x{w} -> {new_h}x{new_w}: only integer-factor "
            "downscales are ported (a cv2-equal general resize is later "
            "work)")
    fy, fx = h // new_h, w // new_w
    img = np.asarray(img)
    blocks = img.reshape((new_h, fy, new_w, fx) + img.shape[2:])
    out = blocks.astype(np.float64).mean(axis=(1, 3))
    if np.issubdtype(img.dtype, np.integer):
        return np.round(out).astype(img.dtype)
    return out.astype(img.dtype)


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
