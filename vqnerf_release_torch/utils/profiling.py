"""Performance tracing of the port (counterpart of
vqnerf_release_tpu/utils/profiling.py):

  * ``span(name, ...)`` and ``count(name, n)``: spans and counters inside
    the program, kept in memory (``spans()``, ``counters()``, ``reset()``);
  * ``trace(logdir)``: a context manager around ``torch.profiler`` that
    records the host's operators and, on a CUDA device, the kernels, and
    writes into ``logdir`` a Chrome trace (``trace.json``, viewable in
    Perfetto or chrome://tracing), the operator table by device time
    (``key_averages.txt``), the program's spans and counters
    (``spans.json``) and the device's longest idle gaps, each labelled
    with the program span and the runtime call open at its middle
    (``idle_gaps.json``).

The CLI's ``--profile-dir`` of ``geo-train`` and ``decomp-train`` wraps the
training in ``trace``.

**The switch is torch's own.** A span or a count records only while a
``torch.profiler`` profile records in the process: torch's flag
``torch.autograd.profiler._is_profiler_enabled``, which every profile sets
on start, whatever its activities, and which every thread reads (torch's
thread-local check, ``torch._C._autograd._profiler_enabled()``, is false on
the threads of a pool). With no profile a span site costs that one read
and a branch: it reads no clock, takes no lock and enters no
``record_function``. Spans and counts may come from any thread.

**One clock with the profiler.** A span is stamped with ``clock_ns()``,
the Unix time in ns: the clock torch stamps the profiler's events with
(its approximate clock is converted to Unix time, and an event's
``start_ns()`` less the result's ``trace_start_ns()`` gives the event
times of ``prof.events()``, in us). So a span and the device's events
compare directly: ``start_ns - trace_start_ns`` is the span's start on the
trace's time line.

While ``trace`` records, a span also enters
``torch.profiler.record_function(name)``, so that ``trace.json`` shows it
beside the operators and kernels. Under a profile of the device's activity
alone (the benchmark's) it does not: torch records no host annotation
there, and an entered ``record_function`` costs about 10 us for nothing.

A span records its name, start and end, its own id, the id of the span
that caused it (by default the innermost span open on its thread; across a
thread pool the caller passes it), the chunk or step it belongs to (given,
or its parent's) and the thread it ran on.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch

__all__ = ["span", "count", "current", "spans", "counters", "reset",
           "clock_ns", "label_idle_gaps", "trace", "Span"]

# the module whose flag torch sets while a profile records
_profiler = torch.autograd.profiler

Span = collections.namedtuple(
    "Span", "id parent name start_ns end_ns step thread")

clock_ns = time.time_ns  # the profiler's event clock, see the docstring

_SPANS = []  # list.append is atomic: spans end on every thread
_COUNTERS = {}
_COUNTERS_LOCK = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_annotate = False  # set while ``trace`` records the host's operators
_OFF = contextlib.nullcontext()  # what a span site gets with no profile


class _Open:
    __slots__ = ("name", "parent", "step", "id", "start", "rf")

    def __init__(self, name, parent, step):
        self.name, self.parent, self.step = name, parent, step
        self.rf = None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        if stack and self.parent is None:
            top = stack[-1]
            self.parent = top.id
            if self.step is None:
                self.step = top.step
        self.id = next(_ids)
        stack.append(self)
        if _annotate:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = clock_ns()
        return self

    def __exit__(self, *exc):
        end = clock_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        _SPANS.append(Span(self.id, self.parent, self.name, self.start, end,
                           self.step, threading.get_ident()))
        return False


def span(name, parent=None, step=None):
    """A context manager that records one span while a profile records;
    ``parent``: the causing span's id where it is not the innermost span
    open on this thread (work handed to a pool); ``step``: the chunk's
    first step or the step the work belongs to (default: the parent's)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(name, parent, step)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profile records."""
    if not _profiler._is_profiler_enabled:
        return
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def current():
    """The innermost span open on this thread (its ``id`` and ``step``),
    or None; for handing a parent to work on another thread."""
    if not _profiler._is_profiler_enabled:
        return None
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def spans():
    """The recorded spans, in the order they ended."""
    return list(_SPANS)


def counters():
    return dict(_COUNTERS)


def reset():
    """Forget every recorded span and counter."""
    _SPANS.clear()
    _COUNTERS.clear()


def _union(pairs):
    out = []
    for a, b in sorted(pairs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(named, t):
    """The name of the interval of ``named`` (name, start, end) open at
    ``t`` that started last, or None."""
    open_at = [(a, name) for name, a, b in named if a <= t <= b]
    return max(open_at)[1] if open_at else None


def label_idle_gaps(busy, program, calls, top=20):
    """The ``top`` longest gaps between the device's busy intervals
    ``busy`` [(start, end)], longest first, each labelled at its middle
    with the innermost program span of ``program`` [(name, start, end)] and
    the innermost runtime call of ``calls`` [(name, start, end)] open
    there ("host" where none is, as the benchmark's trace labels it); all
    times in one unit."""
    merged = _union(busy)
    gaps = sorted(((b, a) for (_, b), (a, _) in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        out.append({"start": a, "end": b, "length": b - a,
                    "span": _innermost(program, mid),
                    "call": _innermost(calls, mid) or "host"})
    return out


def _write_exports(prof, logdir):
    """``spans.json`` and ``idle_gaps.json`` of a finished profile."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    recorded = spans()
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump({"clock": "unix ns, the profiler's event clock",
                   "trace_start_ns": t0,
                   "spans": [s._asdict() for s in recorded],
                   "counters": counters()}, f)
    busy, calls = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end)  # us from t0
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy.append(r)
        elif e.name.startswith("cuda"):
            calls.append((e.name,) + r)
    named = [(s.name, (s.start_ns - t0) / 1e3, (s.end_ns - t0) / 1e3)
             for s in recorded]
    gaps = [{"start_us": g["start"], "ms": g["length"] / 1e3,
             "span": g["span"], "call": g["call"]}
            for g in label_idle_gaps(busy, named, calls)]
    with open(os.path.join(logdir, "idle_gaps.json"), "w") as f:
        json.dump({"unit": "us from the trace's start", "gaps": gaps}, f,
                  indent=1)


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block into ``logdir`` (no-op if None); the
    recorder is emptied first, so that ``spans.json`` holds the block's."""
    global _annotate
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        _annotate = True
        try:
            yield
        finally:
            _annotate = False
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort_by = ("self_cuda_time_total" if torch.cuda.is_available()
               else "self_cpu_time_total")
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=50))
    _write_exports(prof, logdir)
