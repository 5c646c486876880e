"""Host time of the two unfilter paths of vqnerf_release_torch/data/io.py.

A PNG that the port writes (``encode_png``: every row filter 0) is decoded
a row a step, the path of images with None, Sub and Up rows only; the same
rows through ``_unfilter_diagonals``, the anti-diagonal path that images
with Average or Paeth rows (a browser canvas's PNG) take. Prints the median
milliseconds of each, for gray, RGB and RGBA images of --size x --size.

    python scripts/torch_png_decode_time.py [--size 512] [--reps 5]
"""

import argparse
import os
import sys
import time
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from vqnerf_release_torch.data import io as vio  # noqa: E402


def _median_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    rng = np.random.RandomState(0)
    for ch in (1, 3, 4):
        shape = (args.size, args.size) + ((ch,) if ch > 1 else ())
        img = rng.randint(0, 256, shape).astype(np.uint8)
        png = vio.encode_png(img)
        raw = zlib.decompress(b"".join(
            body for kind, body in vio._png_chunks(png) if kind == b"IDAT"))
        h, stride = args.size, args.size * ch
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
        kinds, cur = rows[:, 0].astype(np.int32), rows[:, 1:].astype(np.int32)
        out = vio._unfilter_diagonals(cur, kinds, ch).astype(np.uint8)
        if not np.array_equal(out.reshape(shape), img) or not np.array_equal(
                vio.decode_png(png), img):
            raise AssertionError("a path decoded other bytes")
        row_ms = _median_ms(lambda: vio._unfilter(raw, h, stride, ch),
                            args.reps)
        diag_ms = _median_ms(
            lambda: vio._unfilter_diagonals(cur, kinds, ch), args.reps)
        print("%dx%dx%d filter-0 PNG: a row a step %.3f ms, by "
              "anti-diagonals %.3f ms (%.0fx)"
              % (args.size, args.size, ch, row_ms, diag_ms, diag_ms / row_ms))


if __name__ == "__main__":
    main()
