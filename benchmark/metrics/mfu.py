"""mfu.<cell>: the operations the configuration's own forward and backward
need (counted once from the shapes, ``counts/``) over the time the traced
run's window spent outside the profiler, against the H100's dense TF32
peak, in percent: the ceiling of any route that keeps the stated float32
precision. The profiler's own cost stays out of it."""

from benchmark.counts.peaks import TF32_FLOPS_PER_S

UNIT = "%"
SOURCE = "host_clock"


def read(ctx):
    rate = ctx["spans"].get("flops_per_s")
    if not rate:
        return None
    return 100.0 * rate / TF32_FLOPS_PER_S
