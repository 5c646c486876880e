"""host_batch_ms_per_step.<cell>: the host's milliseconds a step in
``NeuSRunner._host_batch`` (the program's span ``neus.host_batch``: the
random rays of a view drawn on the host and copied to the card), the mean
over the traced slice's steps."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("neus.host_batch")
