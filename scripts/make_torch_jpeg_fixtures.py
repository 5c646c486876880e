#!/usr/bin/env python3
"""Write the JPEG fixtures that the port's decoder is held to where OpenCV
is absent (the GPU machine): tests/data/torch_jpeg/<name>.jpg, made with
cv2.imencode (the 4-component ones with PIL, which writes Adobe CMYK; the
YCCK one is that file with its Adobe transform flag set to 2), and beside
each <name>.png, cv2.imread(<name>.jpg, IMREAD_UNCHANGED) written
losslessly (channels in RGB order).

    python scripts/make_torch_jpeg_fixtures.py [--out DIR]

Needs cv2 and PIL (run it where OpenCV is installed). The images are drawn
from a fixed seed, so a rerun with the same OpenCV writes the same bytes;
tests/test_torch_formats.py re-decodes the committed JPEGs with cv2 and
checks the committed PNGs.
"""

import argparse
import os

import io

import cv2
import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                   "tests", "data", "torch_jpeg")

# name -> (height, width, channels, cv2.imencode parameters)
FIXTURES = {
    "baseline_420_q90_512": (512, 512, 3, [
        cv2.IMWRITE_JPEG_QUALITY, 90,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]),
    "progressive_420_q90_512": (512, 512, 3, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]),
    "baseline_444_q95": (96, 128, 3, [
        cv2.IMWRITE_JPEG_QUALITY, 95,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]),
    "baseline_422_q75": (96, 128, 3, [
        cv2.IMWRITE_JPEG_QUALITY, 75,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422]),
    "gray_rst_q90": (80, 112, 1, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
    "odd_37x53_420_q50": (37, 53, 3, [cv2.IMWRITE_JPEG_QUALITY, 50]),
}
# 4 components, written by PIL: name -> (height, width, 4, Adobe transform
# flag); drawn from the seeds after FIXTURES', which keep theirs
CMYK_FIXTURES = {
    "cmyk_q90": (48, 64, 4, 0),
    "ycck_q90": (48, 64, 4, 2),
}


def encode_cmyk(img, transform):
    """An Adobe CMYK JPEG of img [H, W, 4] at quality 90 (PIL), its Adobe
    APP14 transform flag set to ``transform`` (0 CMYK, 2 YCCK)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90)
    data = bytearray(buf.getvalue())
    body = data.index(b"\xff\xee") + 4  # APP14: "Adobe", version, flags
    assert data[body:body + 5] == b"Adobe"
    data[body + 11] = transform
    return bytes(data)


def fixture_image(h, w, c, seed):
    """Flat colour shapes, hard edges between them and one smooth ramp: the
    Huffman tables see long runs and large coefficients both, and the
    decodes stay small as PNGs."""
    rs = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.empty((h, w, c))
    img[:] = rs.uniform(0.2, 0.8, c)
    for _ in range(6):
        cx, cy, r = rs.uniform(0.1, 0.9), rs.uniform(0.1, 0.9), \
            rs.uniform(0.05, 0.2)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rs.uniform(0, 1, c)
    ramp = (y > 0.75) & (x < 0.5)
    img[ramp] = (0.2 + 0.6 * np.stack([x, y, x * y, 1 - x][:c], -1))[ramp]
    return np.clip(img * 255 + 0.5, 0, 255).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    todo = sorted(FIXTURES.items()) + sorted(CMYK_FIXTURES.items())
    for i, (name, (h, w, c, params)) in enumerate(todo):
        img = fixture_image(h, w, c, seed=i)
        if c == 4:
            data = encode_cmyk(img, params)
        else:
            ok, buf = cv2.imencode(".jpg", img[..., 0] if c == 1 else img,
                                   params)
            if not ok:
                raise SystemExit(f"cv2 could not encode {name}")
            data = buf.tobytes()
        jpg = os.path.join(args.out, name + ".jpg")
        with open(jpg, "wb") as f:
            f.write(data)
        dec = cv2.imread(jpg, cv2.IMREAD_UNCHANGED)
        if dec.ndim == 3:
            dec = dec[..., ::-1]  # stored RGB, as the port decodes
        # cv2.imwrite takes BGR: hand it the channels back in that order
        cv2.imwrite(os.path.join(args.out, name + ".png"),
                    dec[..., ::-1] if dec.ndim == 3 else dec,
                    [cv2.IMWRITE_PNG_COMPRESSION, 9])
        print(name, dec.shape, len(data), "bytes")


if __name__ == "__main__":
    main()
