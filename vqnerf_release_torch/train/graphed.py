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

``CallGraphs`` replays a call rather than a step: ``fn(staged)``, a function
of a dict of CUDA tensors that returns a dict of new tensors of one dtype,
none of them a view of its inputs. It keeps one captured graph per call
signature (the caller's key, the device, its current stream, inference mode
or not, each input's dtype and shape or None, and the address, dtype and
shape of each tensor the call reads in place), the least recently used first
out past ``SIZE``, each private pool freed with its graph. A call copies its
inputs into the graph's own buffers and replays; the tensors it reads in
place (model parameters, constants) are read where they lie, and the graph
keeps them alive, so an address in a signature names them alone while the
graph lives. Its outputs land in one block that every call copies once: the
returned dict is made of views into that copy, which no later replay
overwrites. A signature's first call stages its inputs, runs ``fn`` eagerly
on a side stream (its result is the call's, and it warms cuBLAS and the
kernels) and then captures, as ``StepGraph._capture`` does; a capture that
fails raises. The counters ``<name>.captures`` and ``<name>.replays``
(``utils/profiling.py``) say how often each happens.
"""

import collections
import threading

import torch

from ..kernels import render as krender
from ..kernels import sdf as ksdf
from ..kernels import vq as kvq
from ..utils import profiling

__all__ = ["StepGraph", "CallGraphs", "launch_counts", "REPLAYS"]

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


class _Call:
    """One captured call: its input buffers, graph and output block, and
    the kernel launches a replay makes."""

    def __init__(self, inputs, reads, device):
        self.reads = reads  # their storage, alive while the graph lives
        self.static = {k: None if t is None else
                       torch.empty(t.shape, dtype=t.dtype, device=device)
                       for k, t in inputs.items()}
        self.graph = self.block = None
        self.layout, self.launches = [], {}

    def _stage(self, inputs):
        for k, t in self.static.items():
            if t is not None:
                t.copy_(inputs[k])

    def capture(self, fn, inputs):
        """``fn`` eagerly on a side stream, then the capture; returns the
        eager result."""
        self._stage(inputs)
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = fn(self.static)
        current.wait_stream(side)
        for t in first.values():
            t.record_stream(current)
        if len({t.dtype for t in first.values()}) != 1:
            raise ValueError("a graphed call returns tensors of one dtype")
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                out = fn(self.static)
                self.block = torch.cat([t.reshape(-1) for t in out.values()])
        except Exception as e:
            raise RuntimeError(
                "capturing the call as a CUDA graph failed; it must not "
                "synchronise with the host or draw random numbers (%s)"
                % e) from e
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        _add_counts(self.launches, -1)  # the capture launched none
        at = 0
        for k, t in out.items():
            self.layout.append((k, at, at + t.numel(), t.shape))
            at += t.numel()
        self.graph = graph
        return first

    def replay(self, inputs):
        self._stage(inputs)
        self.graph.replay()
        _add_counts(self.launches, 1)
        block = self.block.clone()
        return {k: block[a:b].view(shape) for k, a, b, shape in self.layout}

    def close(self):
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.static = self.block = self.reads = None


class CallGraphs:
    """Calls replayed as one CUDA graph per signature, at most ``SIZE``;
    see the module docstring. ``name`` prefixes the counters."""

    SIZE = 4

    def __init__(self, name):
        self.name = name
        self._calls = collections.OrderedDict()
        # a call stages, replays and copies out under it: a graph's buffers
        # serve one call at a time
        self._lock = threading.Lock()

    def __call__(self, fn, inputs, key, reads):
        """``fn(staged)`` for ``inputs`` {name: CUDA tensor or None}, all on
        one device; ``key``: what else decides ``fn``'s program (hashable);
        ``reads``: the tensors ``fn`` reads in place."""
        device = next(t.device for t in inputs.values() if t is not None)
        sig = (key, device, torch.cuda.current_stream(device).cuda_stream,
               torch.is_inference_mode_enabled(),
               tuple((k,) if t is None else (k, t.dtype, t.shape)
                     for k, t in inputs.items()),
               tuple((t.data_ptr(), t.dtype, t.shape) for t in reads))
        with self._lock, torch.cuda.device(device):
            call = self._calls.get(sig)
            if call is not None:
                self._calls.move_to_end(sig)
                profiling.count(self.name + ".replays")
                return call.replay(inputs)
            while len(self._calls) >= self.SIZE:
                self._calls.popitem(last=False)[1].close()
            profiling.count(self.name + ".captures")
            call = _Call(inputs, tuple(t.detach() for t in reads), device)
            first = call.capture(fn, inputs)
            self._calls[sig] = call
            return first
