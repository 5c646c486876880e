"""device_idle.<cell>: the share of the traced slice's wall time in which
no operation ran on the device (the union of the CUDA events' intervals
against the slice's host-clock length)."""

UNIT = "fraction"
SOURCE = "device_trace"


def read(ctx):
    s = ctx["summary"]
    if s is None or s["busy_s"] <= 0:
        return None
    return 1.0 - s["busy_s"] / s["window_s"]
