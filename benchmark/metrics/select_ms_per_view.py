"""select_ms_per_view.<cell>: the milliseconds of one view's pair selection,
the program's span ``sampler.select``
(``train/loop.py::sample_view_pix_many``: the native call on its pool
thread, or the numpy call in the loop), the mean over the traced slice's
calls."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("sampler.select")
