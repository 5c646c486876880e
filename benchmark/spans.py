"""The program's own spans (``vqnerf_release_torch/utils/profiling.py``),
for the per-layer readers of host time inside the program.

The program records a span only while a ``torch.profiler`` profile records
in its process. In a run of the benchmark that is the traced slice alone:
the tracer's warm-up profile before the window holds no program call, and
the readers run after the slice has closed. A span is stamped on the host's
clock inside the program. A program without the recorder, or a slice
without the named span, gives None.
"""


def durations_ms(name):
    """The milliseconds of every recorded span called ``name``."""
    try:
        from vqnerf_release_torch.utils.profiling import spans
    except ImportError:
        return []
    return [(s.end_ns - s.start_ns) / 1e6 for s in spans() if s.name == name]


def mean_ms(name, per=None):
    """The spans ``name``'s mean milliseconds, or with ``per`` their sum
    over the number of ``per`` spans; None where there is none."""
    ms = durations_ms(name)
    n = len(durations_ms(per)) if per else len(ms)
    if not ms or not n:
        return None
    return sum(ms) / n
