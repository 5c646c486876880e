"""replay_issue_ms_per_chunk.<cell>: the host's milliseconds a chunk inside the
replay loop of ``train/graphed.py::StepGraph.run`` (the program's span
``graph.replay``: issuing a chunk's graph launches, and whatever of the
device's work they wait for), the mean over the traced slice's chunks."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("graph.replay")
