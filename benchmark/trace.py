"""The traced slice of a run: ``torch.profiler`` over a steady part of the
window, reduced to what the per-layer readers read.

On the card the profiler records the device's activity alone (kernels,
copies, and the runtime's calls): recording every host-side operation too
cost an eager NeuS step half its time again, and doubled the idle share
that the trace reads. The profiler is started once before the window, so
that its own start-up stays out of the slice.

The device's busy time is the union of the device events' intervals (the
arithmetic of the repository's smoke script, ``_busy_us``): kernels on
concurrent streams overlap, and a sum of their times would count the
overlap twice. Kernels replayed from a CUDA graph are seen as any other.
"""

import time

import torch

# the runtime's calls that start device work: a kernel or a whole graph
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def merged_intervals(pairs):
    """The union of [start, end) intervals, as sorted disjoint pairs."""
    out = []
    for a, b in sorted(pairs):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _activities(device):
    from torch.profiler import ProfilerActivity
    if torch.device(device).type == "cuda":
        return [ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


class Tracer:
    """Profiles one slice (``start`` ... ``stop``) and keeps its summary:
    ``busy_s``, ``window_s``, device time and calls by kernel name, the
    runtime's launch calls by name, and the breakdown of device operations
    and of idle gaps by the runtime call the host was in."""

    def __init__(self, device):
        from torch.profiler import profile
        self.device = torch.device(device)
        self.summary = None
        self._prof = None
        self._t0 = None
        with profile(activities=_activities(self.device)):
            self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import profile
        self._sync()
        self._prof = profile(activities=_activities(self.device))
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, work):
        """End the slice once the device has finished it; ``work`` is what
        it did, as the driver counts it (steps, requests, operations)."""
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.summary = summarize(self._prof.events(), window_s)
        self.summary["work"] = dict(work)
        self._prof = None


def summarize(events, window_s):
    dev, calls, launches = [], [], {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append(e)
        elif e.name.startswith("cuda"):
            calls.append(e)
            if e.name in LAUNCH_CALLS:
                launches[e.name] = launches.get(e.name, 0) + 1
    kernels = {}
    for e in dev:
        k = kernels.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += (e.time_range.end - e.time_range.start) / 1e6
    busy = merged_intervals((e.time_range.start, e.time_range.end)
                            for e in dev)
    gaps = [[a, b] for (_, a), (b, _) in zip(busy, busy[1:])]
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [c.name for c in calls
                 if c.time_range.start <= mid <= c.time_range.end]
        labelled.append([inner[-1] if inner else "host", (b - a) / 1e6])
    ops = sorted(([n, t] for n, (_, t) in kernels.items()),
                 key=lambda o: -o[1])
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": window_s, "kernels": kernels,
            "launch_calls": launches,
            "breakdown": {"device_ops": ops[:10], "idle_gaps": labelled}}


def kernel_time(summary, pattern):
    """(calls, seconds) of the kernels whose name holds ``pattern``."""
    calls, secs = 0, 0.0
    for name, (n, t) in summary["kernels"].items():
        if pattern in name:
            calls += n
            secs += t
    return calls, secs
