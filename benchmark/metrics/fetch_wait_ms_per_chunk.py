"""fetch_wait_ms_per_chunk.<cell>: the host's milliseconds a chunk in the copy
of its losses to the host (the program's span ``loop.fetch`` in
``train/loop.py::_rows_to_dicts``, which waits for the chunk's end), the
mean over the traced slice's chunks."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("loop.fetch")
