"""step_issue_ms_per_step.<cell>: the host's milliseconds from entry to return
of the step function of ``train/neus_trainer.py::make_neus_train_step`` (the
program's span ``neus.step``: issuing a step's launches, with no
synchronise), the mean over the traced slice's steps."""

from benchmark.spans import mean_ms

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    return mean_ms("neus.step")
