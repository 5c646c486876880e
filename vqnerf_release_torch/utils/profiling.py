"""Lightweight performance tracing (counterpart of
vqnerf_release_tpu/utils/profiling.py):

  * ``trace(logdir)``: a context manager around ``torch.profiler`` that
    records the host's operators and, on a CUDA device, the kernels, and
    writes a Chrome trace (``trace.json``, viewable in Perfetto or
    chrome://tracing) and the operator table by device time
    (``key_averages.txt``) into ``logdir``;
  * ``StepTimer``: host-side step timing that waits for the step's result
    before it stops the clock, since a CUDA launch returns before the work
    ends.

The CLI's ``--profile-dir`` of ``geo-train`` and ``decomp-train`` wraps the
training in ``trace``.
"""

import contextlib
import json
import os
import time

import torch

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block into ``logdir`` (no-op if None)."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort_by = ("self_cuda_time_total" if torch.cuda.is_available()
               else "self_cpu_time_total")
    with open(os.path.join(logdir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort_by, row_limit=50))


class StepTimer:
    """Aggregates step wall times; ``sync`` must be a tensor whose value
    depends on the step's full computation."""

    def __init__(self, path=None):
        self.path = path
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        if sync is not None:
            float(sync)  # a copy to the host waits for the device
        self.times.append(time.perf_counter() - self._t0)

    def summary(self):
        if not self.times:
            return {}
        ts = sorted(self.times)
        n = len(ts)
        out = {
            "steps": n,
            "mean_ms": 1e3 * sum(ts) / n,
            "p50_ms": 1e3 * ts[n // 2],
            "p90_ms": 1e3 * ts[min(n - 1, (9 * n) // 10)],
            "best_ms": 1e3 * ts[0],
        }
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "w") as f:
                json.dump(out, f)
        return out
