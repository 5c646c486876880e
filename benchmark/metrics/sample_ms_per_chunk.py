"""sample_ms_per_chunk.<cell>: the host's milliseconds a chunk in the
benchmark's span around the program loop's call that samples a chunk
(``train/loop.py::_epoch_scan_xs``: the ray pairs of every step drawn by the
host sampler), the mean over the chunks that the window ran."""

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    sample = ctx["spans"].get("sample_s")
    if not sample:
        return None
    return 1e3 * sum(sample) / len(sample)
