"""batch_copy_ms_per_step.<cell>: the host's milliseconds a step in the copies
of the host batch to the card (the program's span ``neus.h2d``, inside
``NeuSRunner._host_batch``; pageable copies that wait for the device), over
the traced slice's steps."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("neus.h2d", per="neus.host_batch")
