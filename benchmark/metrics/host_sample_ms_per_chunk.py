"""host_sample_ms_per_chunk.<cell>: the host's milliseconds a chunk in the
program's span ``loop.sample`` (``train/loop.py::_epoch_scan_xs``: the ray
pairs of a chunk's steps drawn by the host sampler, timed inside the
program), the mean over the traced slice's chunks."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("loop.sample")
