"""Minimal OpenEXR scanline reader and writer in numpy and zlib (the
port's copy of vqnerf_release_tpu/data/exr.py; tests hold the two bit for
bit).

The subset real light probes use: single-part scanline files, HALF /
FLOAT / UINT channels, NONE / ZIPS / ZIP compression, increasing line
order. Format: the public OpenEXR layout (magic 20000630, version 2; a
null-terminated attribute list; the chunk offset table; per chunk
[y:int32][size:int32][data]; ZIP chunks are zlib streams over
delta-encoded, two-plane-interleaved bytes).
"""

import struct
import zlib

import numpy as np

__all__ = ["read_exr", "write_exr"]

_MAGIC = 20000630
_PIXEL_DTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_CODE = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
               np.dtype(np.float32): 2}
# lines per chunk by compression id
_BLOCK_LINES = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstr(buf, pos):
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _unpredict_deinterleave(data):
    """Inverse of OpenEXR zip pre-pass: undo the byte delta, then merge
    the two half-planes back into interleaved order."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    # sequential recurrence t[i] += t[i-1] - 128  =>  closed form
    # t[i] = sum(d[0..i]) - 128*i  (mod 256)
    d = (np.cumsum(d) - 128 * np.arange(d.size)) % 256
    d = d.astype(np.uint8)
    n = d.size
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


def _interleave_predict(data):
    d = np.frombuffer(data, np.uint8)
    n = d.size
    half = (n + 1) // 2
    planes = np.empty(n, np.uint8)
    planes[:half] = d[0::2]
    planes[half:] = d[1::2]
    p = planes.astype(np.int32)
    delta = np.empty(n, np.int32)
    delta[0] = p[0]
    delta[1:] = p[1:] - p[:-1] + 128
    return (delta % 256).astype(np.uint8).tobytes()


def read_exr(path):
    """-> float32 [H, W] (one channel), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA). Channels are returned in R,G,B(,A) order regardless of the
    file's alphabetical storage order."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR not supported")
    pos = 8

    channels = []  # (name, dtype)
    compression = None
    data_window = None
    while True:
        if buf[pos] == 0:  # end of header
            pos += 1
            break
        name, pos = _read_cstr(buf, pos)
        _atype, pos = _read_cstr(buf, pos)
        size = struct.unpack_from("<i", buf, pos)[0]
        pos += 4
        payload = buf[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                cname, cp = _read_cstr(payload, cp)
                ptype = struct.unpack_from("<i", payload, cp)[0]
                cp += 16  # type + pLinear/reserved + x/ySampling
                channels.append((cname, _PIXEL_DTYPE[ptype]))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)
        elif name == "lineOrder" and payload[0] != 0:
            raise NotImplementedError("non-increasing line order")

    if compression not in _BLOCK_LINES:
        raise NotImplementedError(
            f"EXR compression id {compression} (only NONE/ZIPS/ZIP)")
    xmin, ymin, xmax, ymax = data_window
    w, h = xmax - xmin + 1, ymax - ymin + 1
    block = _BLOCK_LINES[compression]
    n_chunks = (h + block - 1) // block
    pos += 8 * n_chunks  # skip the offset table; chunks follow in order

    chans_sorted = sorted(channels)  # storage order is alphabetical
    line_bytes = {c: w * np.dtype(t).itemsize for c, t in chans_sorted}
    per_line = sum(line_bytes.values())
    planes = {c: np.zeros((h, w), np.float32) for c, _ in chans_sorted}

    for _ in range(n_chunks):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        raw = buf[pos:pos + size]
        pos += size
        y0 = y - ymin
        n_lines = min(block, h - y0)
        if compression in (2, 3):  # ZIPS / ZIP
            if size < n_lines * per_line:  # zlib only when it shrank
                raw = _unpredict_deinterleave(zlib.decompress(raw))
        cp = 0
        for li in range(n_lines):
            for cname, ctype in chans_sorted:
                nb = line_bytes[cname]
                row = np.frombuffer(raw[cp:cp + nb], ctype)
                planes[cname][y0 + li] = row.astype(np.float32)
                cp += nb

    names = [c for c, _ in channels]
    if set("RGB").issubset(names):
        order = ["R", "G", "B"] + (["A"] if "A" in names else [])
        return np.stack([planes[c] for c in order], axis=-1)
    if len(names) == 1:
        return planes[names[0]]
    return np.stack([planes[c] for c, _ in chans_sorted], axis=-1)


def _attr(name, atype, payload):
    return (name.encode() + b"\x00" + atype.encode() + b"\x00"
            + struct.pack("<i", len(payload)) + payload)


def write_exr(path, arr, compression="zip", dtype=np.float16):
    """[H, W], [H, W, 3] or [H, W, 4] float array -> scanline EXR."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    block = _BLOCK_LINES[comp_id]
    dtype = np.dtype(dtype)

    chlist = b""
    for n in sorted(names):
        chlist += (n.encode() + b"\x00"
                   + struct.pack("<i", _PIXEL_CODE[dtype])
                   + struct.pack("<BBBB", 0, 0, 0, 0)
                   + struct.pack("<ii", 1, 1))
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        _attr("channels", "chlist", chlist)
        + _attr("compression", "compression", bytes([comp_id]))
        + _attr("dataWindow", "box2i", box)
        + _attr("displayWindow", "box2i", box)
        + _attr("lineOrder", "lineOrder", b"\x00")
        + _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
        + _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\x00")

    idx = {n: i for i, n in enumerate(names)}
    chunks = []
    for y0 in range(0, h, block):
        n_lines = min(block, h - y0)
        raw = b""
        for li in range(n_lines):
            for n in sorted(names):
                raw += arr[y0 + li, :, idx[n]].astype(dtype).tobytes()
        if comp_id in (2, 3):
            packed = zlib.compress(_interleave_predict(raw))
            if len(packed) >= len(raw):
                packed = raw  # stored uncompressed when zlib grows it
        else:
            packed = raw
        chunks.append(struct.pack("<ii", y0, len(packed)) + packed)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset = 8 + len(header) + 8 * len(chunks)
        for ch in chunks:
            f.write(struct.pack("<Q", offset))
            offset += len(ch)
        for ch in chunks:
            f.write(ch)
