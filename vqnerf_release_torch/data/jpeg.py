"""A baseline and progressive JPEG decoder in numpy, equal bit for bit to
what ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` gives through the
libjpeg-turbo 3.1 that OpenCV bundles.

  * Frames: SOF0 / SOF1 sequential Huffman and SOF2 progressive (spectral
    selection, successive approximation, EOB runs), 8-bit samples, 1, 3
    or 4 components, any sampling factors, DRI / RSTn restart intervals,
    Huffman and quantisation tables redefined between scans.
  * The entropy decode is sequential Python over a de-stuffed bit buffer:
    a 65,536-entry table per Huffman table gives, for the next 16 bits,
    the code's symbol and length and, where code and magnitude bits fit
    in 16, the coefficient too. Everything after it is numpy over all
    blocks at once.
  * The IDCT is libjpeg's ISLOW (jidctint.c: 13-bit constants, two passes,
    PASS1_BITS 2), its output clamped as the SIMD version clamps it.
  * Chroma is upsampled as jdsample.c does with fancy upsampling on:
    triangle filters for 2x1, 2x2 and 1x2 (edges replicated at the
    component's own size), plain replication otherwise and where the
    component is at most 2 samples wide.
  * YCbCr -> RGB by jdcolor.c's 16-bit fixed-point tables; the colour
    space is read as jdapimin.c reads it (JFIF, then the Adobe transform
    flag, then the component ids).
  * 4 components: CMYK (no Adobe segment, or transform 0) as stored, YCCK
    (transform 2, or any other) through jdcolor.c's ycck_cmyk_convert;
    then OpenCV's CMYK -> BGR (``c = k - ((255 - c) k >> 8)`` for each of
    c, m, y), as cv2 gives 3 channels under IMREAD_UNCHANGED and
    IMREAD_COLOR alike.
  * EXIF orientation is ignored, as cv2 does under IMREAD_UNCHANGED.

Arithmetic coding (SOF9-11, SOF13-15), lossless and hierarchical frames
(SOF3, SOF5-7) and 12-bit samples raise NotImplementedError naming the
marker.
"""

import numpy as np

__all__ = ["is_jpeg", "decode_jpeg", "read_jpeg"]

_SOI = b"\xff\xd8\xff"

# zigzag index -> natural (row-major) position in the 8x8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

_UNSUPPORTED_SOF = {
    0xC3: "SOF3 (lossless)",
    0xC5: "SOF5 (differential sequential)",
    0xC6: "SOF6 (differential progressive)",
    0xC7: "SOF7 (differential lossless)",
    0xC9: "SOF9 (arithmetic sequential)",
    0xCA: "SOF10 (arithmetic progressive)",
    0xCB: "SOF11 (arithmetic lossless)",
    0xCD: "SOF13 (differential arithmetic sequential)",
    0xCE: "SOF14 (differential arithmetic progressive)",
    0xCF: "SOF15 (differential arithmetic lossless)",
}

# bias of the coefficient packed into a table entry (|value| < 2048)
_VBIAS = 4096


def is_jpeg(data):
    """True if ``data`` starts with a JPEG signature (FF D8 FF)."""
    return bytes(data[:3]) == _SOI


def _huff_table(counts, symbols):
    """The 16-bit lookahead table of one Huffman table, as a list of ints:
    bits 0-4 the bits consumed, 5-12 the symbol, 13 set where the
    magnitude bits fit into the 16 and the coefficient is packed in bits
    14 and up (plus _VBIAS). A lookahead that starts no code reads as
    symbol 0 over 16 bits, as libjpeg's decoder does after its
    warning."""
    length = np.full(65536, 16, np.int64)
    sym = np.zeros(65536, np.int64)
    code, k = 0, 0
    for n in range(1, 17):
        for _ in range(counts[n - 1]):
            lo, hi = code << (16 - n), (code + 1) << (16 - n)
            length[lo:hi] = n
            sym[lo:hi] = symbols[k]
            k += 1
            code += 1
        code <<= 1
    s = sym & 15
    total = length + s
    fits = total <= 16
    look = np.arange(65536, dtype=np.int64)
    bits = (look >> np.where(fits, 16 - total, 0)) & ((1 << s) - 1)
    value = np.where(bits < (1 << s) >> 1, bits - (1 << s) + 1, bits)
    value = np.where(fits & (s > 0), value, 0)
    entry = (((value + _VBIAS) << 14) | (fits.astype(np.int64) << 13)
             | (sym << 5) | np.where(fits, total, length))
    return entry.tolist()


def _segment_words(seg):
    """De-stuff an entropy-coded segment (FF 00 -> FF) and return it as a
    list of big-endian 32-bit words, one starting at every byte, padded
    with zero bytes (libjpeg feeds zeros past the data)."""
    a = np.frombuffer(seg, np.uint8)
    ff = np.flatnonzero(a[:-1] == 0xFF)
    stuffed = ff[a[ff + 1] == 0] + 1
    if len(stuffed):
        a = np.delete(a, stuffed)
    a = np.concatenate([a, np.zeros(8, np.uint8)]).astype(np.int64)
    return ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
            | a[3:]).tolist()


def _split_scan(data, pos):
    """The entropy-coded data after an SOS header at ``pos``: a list of
    restart intervals (split at RST0-7) and the position of the marker
    that ends the scan."""
    a = np.frombuffer(data, np.uint8)
    ff = pos + np.flatnonzero(a[pos:-1] == 0xFF)
    nxt = a[ff + 1]
    rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    end_at = ff[(nxt != 0) & (nxt != 0xFF) & ~rst]
    end = int(end_at[0]) if len(end_at) else len(data)
    cuts = ff[rst & (ff < end)]
    segs, start = [], pos
    for c in cuts.tolist():
        segs.append(data[start:c])
        start = c + 2
    segs.append(data[start:end])
    return segs, end


def _decode_sequential(words, blocks, comp_of, coef, dc_luts, ac_luts,
                       pred):
    """Sequential Huffman decode of one restart interval: ``blocks`` are
    the offsets of the blocks' first coefficient in ``coef`` (zigzag
    order), ``comp_of`` their component slot in the scan."""
    pos = 0
    for base, c in zip(blocks, comp_of):
        e = dc_luts[c][(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        pos += e & 31
        s = (e >> 5) & 15
        if s:
            if e & 8192:
                v = (e >> 14) - _VBIAS
            else:
                v = (words[pos >> 3] >> (32 - s - (pos & 7))) & ((1 << s) - 1)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
            pred[c] += v
        coef[base] = pred[c]
        lut = ac_luts[c]
        k = 1
        while k < 64:
            e = lut[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += e & 31
            rs = (e >> 5) & 255
            s = rs & 15
            if s:
                k += rs >> 4
                if e & 8192:
                    v = (e >> 14) - _VBIAS
                else:
                    v = (words[pos >> 3] >> (32 - s - (pos & 7))) \
                        & ((1 << s) - 1)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                coef[base + k] = v
                k += 1
            elif rs == 0xF0:
                k += 16
            else:
                break


def _read_bits(words, pos, n):
    return (words[pos >> 3] >> (32 - n - (pos & 7))) & ((1 << n) - 1)


def _decode_dc_first(words, blocks, comp_of, coef, dc_luts, pred, al):
    pos = 0
    for base, c in zip(blocks, comp_of):
        e = dc_luts[c][(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        pos += e & 31
        s = (e >> 5) & 15
        if s:
            if e & 8192:
                v = (e >> 14) - _VBIAS
            else:
                v = _read_bits(words, pos, s)
                pos += s
                if v < (1 << (s - 1)):
                    v -= (1 << s) - 1
            pred[c] += v
        coef[base] = pred[c] << al


def _decode_dc_refine(words, blocks, coef, al):
    pos = 0
    bit = 1 << al
    for base in blocks:
        if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
            coef[base] |= bit
        pos += 1


def _decode_ac_first(words, blocks, coef, lut, ss, se, al):
    pos = 0
    eobrun = 0
    for base in blocks:
        if eobrun:
            eobrun -= 1
            continue
        k = ss
        while k <= se:
            e = lut[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            pos += e & 31
            rs = (e >> 5) & 255
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                if e & 8192:
                    v = (e >> 14) - _VBIAS
                else:
                    v = _read_bits(words, pos, s)
                    pos += s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                coef[base + k] = v * (1 << al)
            elif r == 15:
                k += 15
            else:
                eobrun = 1 << r
                if r:
                    eobrun += _read_bits(words, pos, r)
                    pos += r
                eobrun -= 1
                break
            k += 1


def _decode_ac_refine(words, blocks, coef, lut, ss, se, al):
    """Successive-approximation refinement of AC coefficients
    (jdphuff.c decode_mcu_AC_refine): new coefficients of magnitude
    1 << al, and a correction bit for every coefficient already nonzero
    that the run passes over."""
    pos = 0
    eobrun = 0
    p1, m1 = 1 << al, -1 << al
    for base in blocks:
        k = ss
        if not eobrun:
            while k <= se:
                e = lut[(words[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                pos += e & 31
                rs = (e >> 5) & 255
                r, s = rs >> 4, rs & 15
                if s:
                    if e & 8192:
                        s = p1 if (e >> 14) > _VBIAS else m1
                    else:
                        s = p1 if _read_bits(words, pos, 1) else m1
                        pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _read_bits(words, pos, r)
                        pos += r
                    break
                while k <= se:
                    cur = coef[base + k]
                    if cur:
                        if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                            if not cur & p1:
                                coef[base + k] = cur + (p1 if cur >= 0
                                                        else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    coef[base + k] = s
                k += 1
        if eobrun:
            while k <= se:
                cur = coef[base + k]
                if cur:
                    if (words[pos >> 3] >> (31 - (pos & 7))) & 1:
                        if not cur & p1:
                            coef[base + k] = cur + (p1 if cur >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1


# jidctint.c constants (CONST_BITS 13)
_F = dict(c0_298=2446, c0_390=3196, c0_541=4433, c0_765=6270, c0_899=7373,
          c1_175=9633, c1_501=12299, c1_847=15137, c1_961=16069,
          c2_053=16819, c2_562=20995, c3_072=25172)


def _idct_1d(x, axis):
    """The 8-point ISLOW butterfly along ``axis`` of int64 ``x``; returns
    the eight outputs before their descale (scaled by 2^13)."""
    def at(i):
        return np.take(x, i, axis=axis)
    f = _F
    z2, z3 = at(2), at(6)
    z1 = (z2 + z3) * f["c0_541"]
    tmp2 = z1 - z3 * f["c1_847"]
    tmp3 = z1 + z2 * f["c0_765"]
    z2, z3 = at(0), at(4)
    tmp0 = (z2 + z3) << 13
    tmp1 = (z2 - z3) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = at(7), at(5), at(3), at(1)
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["c1_175"]
    t0 = t0 * f["c0_298"]
    t1 = t1 * f["c2_053"]
    t2 = t2 * f["c3_072"]
    t3 = t3 * f["c1_501"]
    z1 = z1 * -f["c0_899"]
    z2 = z2 * -f["c2_562"]
    z3 = z3 * -f["c1_961"] + z5
    z4 = z4 * -f["c0_390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return np.stack([tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                     tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3],
                    axis=axis)


def _idct_islow(blocks):
    """Dequantised coefficients int64 [..., 8, 8] (row = vertical
    frequency) -> samples uint8 [..., 8, 8]."""
    ws = _idct_1d(blocks, -2)
    ws = (ws + (1 << 10)) >> 11  # DESCALE(CONST_BITS - PASS1_BITS)
    out = _idct_1d(ws, -1)
    out = (out + (1 << 17)) >> 18  # DESCALE(CONST_BITS + PASS1_BITS + 3)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _fancy_h2(x, axis):
    """jdsample.c h2v1_fancy_upsample along ``axis``: 3/4 nearer + 1/4
    further sample, +1 for the left output and +2 for the right."""
    n = x.shape[axis]
    idx = np.arange(n)
    left = np.take(x, np.maximum(idx - 1, 0), axis=axis)
    right = np.take(x, np.minimum(idx + 1, n - 1), axis=axis)
    a = (3 * x + left + 1) >> 2
    b = (3 * x + right + 2) >> 2
    return np.stack([a, b], axis=axis + 1).reshape(
        x.shape[:axis] + (2 * n,) + x.shape[axis + 1:])


def _fancy_h2v2(x):
    """jdsample.c h2v2_fancy_upsample: column sums 3 * nearer row +
    further row, then 3 * nearer sum + further sum, +8 for the left
    output and +7 for the right, >> 4."""
    h, w = x.shape
    r = np.arange(h)
    above = x[np.maximum(r - 1, 0)]
    below = x[np.minimum(r + 1, h - 1)]
    sums = np.stack([3 * x + above, 3 * x + below], axis=1).reshape(2 * h, w)
    c = np.arange(w)
    left = sums[:, np.maximum(c - 1, 0)]
    right = sums[:, np.minimum(c + 1, w - 1)]
    a = (3 * sums + left + 8) >> 4
    b = (3 * sums + right + 7) >> 4
    return np.stack([a, b], axis=2).reshape(2 * h, 2 * w)


def _upsample(plane, hx, vx):
    """A component plane at its own size -> hx, vx times that size."""
    w = plane.shape[1]
    if (hx, vx) == (1, 1):
        return plane
    if (hx, vx) == (2, 1) and w > 2:
        return _fancy_h2(plane, 1)
    if (hx, vx) == (1, 2):
        return _fancy_h2(plane, 0)
    if (hx, vx) == (2, 2) and w > 2:
        return _fancy_h2v2(plane)
    return np.repeat(np.repeat(plane, vx, axis=0), hx, axis=1)


def _ycc_to_rgb(y, cb, cr):
    """jdcolor.c ycc_rgb_convert with its fixed-point tables (uint8
    [..., 3])."""
    return np.clip(_ycc_to_rgb_int(y, cb, cr), 0, 255).astype(np.uint8)


def _ycc_to_rgb_int(y, cb, cr):
    """ycc_rgb_convert before its range limit: int [..., 3]."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.stack([r, g, b], axis=-1)


def _cmyk_to_rgb(c, m, y, k):
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, channels in RGB order."""
    return np.stack([k - (((255 - v) * k) >> 8) for v in (c, m, y)],
                    axis=-1).astype(np.uint8)


class _Frame:
    def __init__(self, marker, data, what):
        if marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(
                f"{what}: {_UNSUPPORTED_SOF[marker]} frames are not "
                "supported (baseline, extended and progressive Huffman "
                "only)")
        self.progressive = marker == 0xC2
        precision = data[0]
        self.h = (data[1] << 8) | data[2]
        self.w = (data[3] << 8) | data[4]
        n = data[5]
        name = "SOF%d" % (marker - 0xC0)
        if precision != 8:
            raise NotImplementedError(
                f"{what}: {name} with {precision}-bit samples is not "
                "supported (8-bit only)")
        if n not in (1, 3, 4):
            raise NotImplementedError(
                f"{what}: {name} with {n} components is not supported "
                "(1 = gray, 3 = YCbCr / RGB, 4 = CMYK / YCCK)")
        if self.h == 0:
            raise NotImplementedError(f"{what}: {name} with height 0 (DNL)")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(n):
            cid, hv, tq = data[6 + 3 * i], data[7 + 3 * i], data[8 + 3 * i]
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # per component: size at its own sampling, blocks, offset in coef
        self.dw = [-(-self.w * h // self.hmax) for h in self.hs]
        self.dh = [-(-self.h * v // self.vmax) for v in self.vs]
        self.bw = [self.mcux * h for h in self.hs]
        self.bh = [self.mcuy * v for v in self.vs]
        self.offset, total = [], 0
        for ci in range(n):
            self.offset.append(total)
            total += self.bw[ci] * self.bh[ci] * 64
        self.coef = [0] * total
        self.quant = [None] * n

    def scan_blocks(self, comps):
        """The blocks of a scan over component indices ``comps``, in
        decode order: (base offsets, component slot of each, blocks a
        MCU)."""
        if len(comps) == 1:
            ci = comps[0]
            nbx, nby = -(-self.dw[ci] // 8), -(-self.dh[ci] // 8)
            by, bx = np.meshgrid(np.arange(nby), np.arange(nbx),
                                 indexing="ij")
            base = self.offset[ci] + (by * self.bw[ci] + bx) * 64
            return base.reshape(-1).tolist(), [0] * base.size, 1
        bases, slots = [], []
        for slot, ci in enumerate(comps):
            my, mx, v, h = np.meshgrid(
                np.arange(self.mcuy), np.arange(self.mcux),
                np.arange(self.vs[ci]), np.arange(self.hs[ci]),
                indexing="ij")
            blk = ((my * self.vs[ci] + v) * self.bw[ci]
                   + mx * self.hs[ci] + h)
            bases.append(self.offset[ci] + 64 * blk.reshape(
                self.mcuy * self.mcux, -1))
            slots.append(np.full(bases[-1].shape, slot))
        base = np.concatenate(bases, axis=1)
        slot = np.concatenate(slots, axis=1)
        return base.reshape(-1).tolist(), slot.reshape(-1).tolist(), \
            base.shape[1]

    def planes(self):
        """Each component dequantised, inverse-transformed and cropped to
        its own size: uint8 [dh, dw]."""
        out = []
        for ci in range(len(self.ids)):
            n = self.bw[ci] * self.bh[ci]
            o = self.offset[ci]
            zz = np.array(self.coef[o:o + 64 * n], np.int64).reshape(n, 64)
            nat = np.empty_like(zz)
            nat[:, _NATURAL] = zz
            nat *= self.quant[ci]
            blocks = _idct_islow(nat.reshape(n, 8, 8))
            plane = blocks.reshape(self.bh[ci], self.bw[ci], 8, 8)
            plane = plane.transpose(0, 2, 1, 3).reshape(
                self.bh[ci] * 8, self.bw[ci] * 8)
            out.append(plane[:self.dh[ci], :self.dw[ci]])
        return out


def decode_jpeg(data, what="JPEG"):
    """JPEG bytes -> uint8 [H, W] (gray) or [H, W, 3] (RGB; also for a
    CMYK / YCCK file), the pixels of ``cv2.imread(..., IMREAD_UNCHANGED)``
    with the channels in RGB order. ``what`` names the source in errors."""
    data = bytes(data)
    if not is_jpeg(data):
        raise ValueError(f"{what}: not a JPEG file")
    qt, dc_tabs, ac_tabs = {}, {}, {}
    luts = {}
    frame = None
    restart = 0
    jfif = adobe = False
    transform = None
    pos = 2
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{what}: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker == 0xD9:  # EOI
            break
        if marker in (0x01,) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        seglen = (data[pos + 2] << 8) | data[pos + 3]
        body = data[pos + 4:pos + 2 + seglen]
        pos += 2 + seglen
        if marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body, ">u2" if pq else np.uint8, 64,
                                     i + 1).astype(np.int64)
                tab = np.empty(64, np.int64)
                tab[_NATURAL] = vals
                qt[tq] = tab
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                nsym = sum(counts)
                syms = list(body[i + 17:i + 17 + nsym])
                (ac_tabs if tc else dc_tabs)[th] = (counts, syms)
                luts.pop((tc, th), None)
                i += 17 + nsym
        elif marker == 0xCC:
            raise NotImplementedError(
                f"{what}: DAC (arithmetic conditioning) is not supported")
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            frame = _Frame(marker, body, what)
        elif marker == 0xDD:  # DRI
            restart = (body[0] << 8) | body[1]
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, transform = True, body[11]
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError(f"{what}: SOS before SOF")
            pos = _scan(frame, body, data, pos, qt, dc_tabs, ac_tabs, luts,
                        restart, what)
    if frame is None:
        raise ValueError(f"{what}: no frame")
    planes = frame.planes()
    h, w = frame.h, frame.w
    full = []
    for ci, plane in enumerate(planes):
        hx = frame.hmax // frame.hs[ci]
        vx = frame.vmax // frame.vs[ci]
        if frame.hmax % frame.hs[ci] or frame.vmax % frame.vs[ci]:
            raise NotImplementedError(
                f"{what}: sampling factors {frame.hs}x{frame.vs} are not "
                "integral ratios")
        up = _upsample(plane.astype(np.int64), hx, vx)
        full.append(up[:h, :w])
    if len(full) == 1:
        return full[0].astype(np.uint8)
    if len(full) == 4:  # jdapimin.c: CMYK unless the Adobe flag says else
        if adobe and transform != 0:
            rgb = np.clip(_ycc_to_rgb_int(*full[:3]), 0, 255)
            full = [255 - rgb[..., 0], 255 - rgb[..., 1], 255 - rgb[..., 2],
                    full[3]]
        return _cmyk_to_rgb(*full)
    if jfif:
        rgb_space = False
    elif adobe:
        rgb_space = transform == 0
    else:
        rgb_space = frame.ids == [82, 71, 66]
    if rgb_space:
        return np.stack(full, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*full)


def _scan(frame, body, data, pos, qt, dc_tabs, ac_tabs, luts, restart,
          what):
    """Decode one scan into ``frame.coef``; returns the position of the
    marker after its entropy-coded data."""
    ns = body[0]
    comps, tds, tas = [], [], []
    for i in range(ns):
        cid, t = body[1 + 2 * i], body[2 + 2 * i]
        comps.append(frame.ids.index(cid))
        tds.append(t >> 4)
        tas.append(t & 15)
    ss, se, ahl = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
    ah, al = ahl >> 4, ahl & 15
    for ci in comps:  # latch the quantisation table at the first scan
        if frame.quant[ci] is None:
            if frame.tq[ci] not in qt:
                raise ValueError(f"{what}: missing quantisation table")
            frame.quant[ci] = qt[frame.tq[ci]]

    def lut(tc, th):
        key = (tc, th)
        if key not in luts:
            tabs = ac_tabs if tc else dc_tabs
            if th not in tabs:
                raise ValueError(f"{what}: missing Huffman table {key}")
            luts[key] = _huff_table(*tabs[th])
        return luts[key]

    segs, end = _split_scan(data, pos)
    bases, slots, per_mcu = frame.scan_blocks(comps)
    step = restart * per_mcu if restart else len(bases)
    coef = frame.coef
    progressive = frame.progressive
    for i, seg in enumerate(segs):
        lo = i * step
        if lo >= len(bases):
            break
        blk = bases[lo:lo + step]
        slot = slots[lo:lo + step]
        words = _segment_words(seg)
        pred = [0] * ns
        if not progressive:
            _decode_sequential(words, blk, slot, coef,
                               [lut(0, t) for t in tds],
                               [lut(1, t) for t in tas], pred)
        elif ss == 0 and ah == 0:
            _decode_dc_first(words, blk, slot, coef,
                             [lut(0, t) for t in tds], pred, al)
        elif ss == 0:
            _decode_dc_refine(words, blk, coef, al)
        elif ah == 0:
            _decode_ac_first(words, blk, coef, lut(1, tas[0]), ss, se, al)
        else:
            _decode_ac_refine(words, blk, coef, lut(1, tas[0]), ss, se, al)
    return end


def read_jpeg(path):
    """A JPEG file -> array, as ``decode_jpeg``."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), what=str(path))
