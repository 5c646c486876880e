"""A training step replayed as a CUDA graph: the port's counterpart of the
JAX package's ``lax.scan`` over one jitted step (the scanned epoch of
``train/decomp_trainer.py`` and ``make_neus_multi_step`` of
``train/neus_trainer.py``).

``StepGraph(body, device, rows)`` runs ``body(i)`` once a step. ``i`` is a
0-dim int64 device tensor, the step's index within the dispatch: the body
reads its inputs (view index, ray indices, learning rate, dropout draws,
...) from entry ``i`` of tensors staged for the whole dispatch, updates the
model, optimizer and EMA state IN PLACE, and returns a dict of 0-dim loss
tensors, which land in row ``i`` of ``out`` [rows, n_terms]. ``i`` advances
on the device, inside the step.

On a CUDA device the first step of the first dispatch runs eagerly on a side
stream (it is a real step: it warms autograd, cuBLAS, the kernels' libraries
and their scratch), then ONE step is captured as a ``torch.cuda.CUDAGraph``
and every later step of every dispatch is a replay of it: the same kernels
on the same buffers, so the replayed steps give what the eager steps give.
The graph keeps a private memory pool of the step's temporaries (as large
as the step's peak) until ``close()``.
The graph holds the addresses of everything it touches, so the staged
tensors, the state and the VQ kernel's scratch (``kernels/vq.py``) are never
reallocated while it lives. A capture that fails raises; nothing falls back
to the eager path. On the CPU (the caller asked for it) the same body runs
eagerly, step by step.

Over a mesh (``mesh``, the devices the step's work runs on, the first
being ``device``) the body forks a stream for every mesh entry from the
capturing stream and joins it back (``parallel.MeshStreams``), so that the
graph holds every entry's work and every copy between devices. The
allocations that the capture makes on a further card go to the graph's
pool as those on ``device`` do; a mesh whose entries share one card (the
only kind this was run on) has none.

Nothing random may be drawn inside the body: the callers draw from their
generators before a dispatch, in the order the per-step path draws, and
stage the draws.

The kernels count their launches in Python, so a capture counts the kernels
it records but launches none; ``StepGraph`` takes the capture's counts back
and adds them once per replay instead.
"""

import torch

from ..kernels import render as krender
from ..kernels import sdf as ksdf
from ..kernels import vq as kvq
from ..utils import profiling

__all__ = ["StepGraph", "launch_counts", "REPLAYS"]

REPLAYS = 0  # graph replays of every StepGraph, for the smoke's report


def launch_counts():
    """Every kernel's launch counter, as a flat dict."""
    counts = {"vq_fused_train": kvq.LAUNCHES,
              "fused_brdf_render": krender.LAUNCHES}
    counts.update({"sdf:" + k: v for k, v in ksdf.LAUNCHES.items()})
    counts.update({"render:" + k: v
                   for k, v in krender.LAUNCHES_BY_INSTANCE.items()})
    return counts


def _add_counts(delta, times):
    if not times:
        return
    kvq.LAUNCHES += delta.get("vq_fused_train", 0) * times
    krender.LAUNCHES += delta.get("fused_brdf_render", 0) * times
    for k in ksdf.LAUNCHES:
        ksdf.LAUNCHES[k] += delta.get("sdf:" + k, 0) * times
    for k in krender.LAUNCHES_BY_INSTANCE:
        krender.LAUNCHES_BY_INSTANCE[k] += delta.get("render:" + k, 0) * times


class StepGraph:
    """One step, captured once and replayed on CUDA, eager on the CPU; see
    the module docstring. ``run(n)`` takes n steps and returns ``out[:n]``
    on the device (not synchronised)."""

    def __init__(self, body, device, rows, mesh=None):
        self.body = body
        self.device = torch.device(device)
        self.rows = rows
        # further cards the step allocates on (their index)
        self._others = sorted({d.index for d in map(torch.device, mesh or ())
                               if d.type == "cuda" and d != self.device})
        self._pool = None
        self.counter = torch.zeros((), dtype=torch.int64, device=self.device)
        self.keys = None
        self.out = None
        self.graph = None
        self.replays = 0  # over the graph's life
        self.launches_per_replay = {}
        self._pinned = ()

    def _step(self):
        ld = self.body(self.counter)
        if self.keys is None:
            self.keys = sorted(ld)
            self.out = torch.zeros((self.rows, len(self.keys)),
                                   dtype=torch.float32, device=self.device)
        row = torch.stack([ld[k].detach().to(torch.float32).reshape(())
                           for k in self.keys])
        self.out.index_copy_(0, self.counter.reshape(1), row[None])
        self.counter.add_(1)

    def _capture(self):
        """The first step eagerly on a side stream, then the capture."""
        profiling.count("graph.captures")
        with profiling.span("graph.capture"):
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self._step()
            current.wait_stream(side)
            before = launch_counts()
            graph = torch.cuda.CUDAGraph()
            if self._others:  # one pool id for the graph on every card
                self._pool = torch.cuda.graph_pool_handle()
            try:
                with torch.cuda.device(self.device), torch.cuda.graph(
                        graph, pool=self._pool):
                    for i in self._others:
                        torch._C._cuda_beginAllocateToPool(i, self._pool)
                    try:
                        self._step()
                    finally:
                        for i in self._others:
                            torch._C._cuda_endAllocateToPool(i, self._pool)
            except Exception as e:
                raise RuntimeError(
                    "capturing the training step as a CUDA graph failed; the "
                    "step must not synchronise with the host, allocate "
                    "outside the graph's pool or draw random numbers (%s)"
                    % e) from e
            after = launch_counts()
            self.launches_per_replay = {k: after[k] - before[k]
                                        for k in after}
            # the capture launched none
            _add_counts(self.launches_per_replay, -1)
            # the VQ kernel's scratch as the graph recorded it: a later eager
            # call that grows the scratch must not free these buffers
            self._pinned = kvq.scratch_buffers()
            self.graph = graph

    def close(self):
        """Free the graph and its private memory pool (a later ``run``
        captures again)."""
        if self.graph is not None:
            self.graph.reset()
            for i in self._others:
                torch._C._cuda_releasePool(i, self._pool)
        self.graph = None
        self._pinned = ()

    def run(self, n):
        if not 0 < n <= self.rows:
            raise ValueError(f"a dispatch of {n} steps; this graph stages "
                             f"1 to {self.rows}")
        self.counter.zero_()
        if self.device.type != "cuda":
            with profiling.span("graph.replay"):
                for _ in range(n):
                    self._step()
            return self.out[:n]
        first = 0
        if self.graph is None:
            self._capture()
            first = 1
        global REPLAYS
        with profiling.span("graph.replay"):
            for _ in range(n - first):
                self.graph.replay()
        self.replays += n - first
        REPLAYS += n - first
        _add_counts(self.launches_per_replay, n - first)
        return self.out[:n]
