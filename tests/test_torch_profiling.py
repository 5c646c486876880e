"""The port's spans and counters (``vqnerf_release_torch/utils/profiling.py``)
on the CPU:
  * off outside a profile: a span site records nothing;
  * under ``torch.profiler`` a span records its name, start, end, id,
    parent and step, on a pool's thread too, with the parent handed over,
    and 16 threads at once lose no span and no count;
  * its clock is the profiler's: an operator run inside a span starts and
    ends inside it by the profile's absolute times;
  * the idle-gap labelling on synthetic intervals, and ``trace``'s two
    files;
  * the sites: a tiny ``_scan_epoch_loop`` of 3 chunks (numpy and native
    host sampler) and a tiny ``NeuSRunner.train`` of 4 steps.
"""

import json
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vqnerf_release_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tiny runs are thousands of small
    operations, which a pool of spinning threads only slows."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_outside_a_profile_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("a", step=1) as sp:
        assert sp is None
        profiling.count("n", 3)
        assert profiling.current() is None
    assert profiling.spans() == [] and profiling.counters() == {}


def test_records_name_times_ids_parent_and_step():
    with _cpu_profile():
        with profiling.span("outer", step=7) as outer:
            assert profiling.current() is outer
            with profiling.span("inner"):
                profiling.count("n", 2)
            profiling.count("n")
        with profiling.span("alone"):
            pass
    got = {s.name: s for s in profiling.spans()}
    assert list(got) == ["inner", "outer", "alone"]  # the order they ended
    o, i, a = got["outer"], got["inner"], got["alone"]
    assert o.start_ns <= i.start_ns <= i.end_ns <= o.end_ns <= a.start_ns
    assert len({o.id, i.id, a.id}) == 3
    assert (o.parent, i.parent, a.parent) == (None, o.id, None)
    assert (o.step, i.step, a.step) == (7, 7, None)
    assert o.thread == threading.get_ident()
    assert profiling.counters() == {"n": 3}


def test_records_on_a_pool_thread_with_the_parent_handed_over():
    pool = ThreadPoolExecutor(2)
    pool.submit(lambda: None).result()  # the thread exists before

    def work(parent, step):
        with profiling.span("pooled", parent=parent, step=step):
            return threading.get_ident()

    with _cpu_profile():
        with profiling.span("caller", step=5):
            cause = profiling.current()
            tid = pool.submit(work, cause.id, cause.step).result()
    pool.shutdown()
    pooled, = _by_name(profiling.spans(), "pooled")
    caller, = _by_name(profiling.spans(), "caller")
    assert tid != threading.get_ident() and pooled.thread == tid
    assert (pooled.parent, pooled.step) == (caller.id, 5)


def test_threads_lose_no_span_and_no_count():
    n_threads, per = 16, 200  # more threads than the host's cores
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work(i):
                for _ in range(per):
                    with profiling.span("t", step=i):
                        profiling.count("n")
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.spans()
    assert len(spans) == n_threads * per
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.parent is None for s in spans)
    assert profiling.counters() == {"n": n_threads * per}


def test_span_clock_is_the_profilers_event_clock():
    a = torch.randn(384, 384)
    with _cpu_profile() as prof:
        for _ in range(3):
            with profiling.span("mm"):
                a @ a
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [e for e in prof.events() if e.name == "aten::mm"]
    spans = _by_name(profiling.spans(), "mm")
    assert len(ops) == len(spans) == 3
    for e, s in zip(sorted(ops, key=lambda e: e.time_range.start), spans):
        start = t0 + e.time_range.start * 1e3
        end = t0 + e.time_range.end * 1e3
        assert s.start_ns <= start <= end <= s.end_ns


def test_idle_gaps_are_labelled_with_the_innermost_open_span():
    busy = [(0, 10), (5, 12), (20, 30), (31, 40), (60, 61)]
    program = [("outer", 0, 100), ("inner", 14, 18), ("late", 41, 70)]
    calls = [("cudaLaunchKernel", 15, 17)]
    gaps = profiling.label_idle_gaps(busy, program, calls, top=3)
    assert [(g["start"], g["end"]) for g in gaps] == [(40, 60), (12, 20),
                                                       (30, 31)]
    assert [g["span"] for g in gaps] == ["late", "inner", "outer"]
    assert [g["call"] for g in gaps] == ["host", "cudaLaunchKernel", "host"]
    assert profiling.label_idle_gaps(busy, [], [])[0]["span"] is None


def test_trace_writes_the_spans_and_the_idle_gaps(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("work", step=2):
            profiling.count("h2d_bytes", 64)
            torch.ones(32, 32) @ torch.ones(32, 32)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert [(s["name"], s["step"]) for s in spans["spans"]] == [("work", 2)]
    assert spans["counters"] == {"h2d_bytes": 64}
    gaps = json.loads((tmp_path / "idle_gaps.json").read_text())
    assert gaps["gaps"] == []  # no device here
    assert not profiling._annotate


def _tiny_views(tmp_path):
    from tests.test_data_layer import _make_synth_scene
    from vqnerf_release_torch.data.shape_dataset import ShapeDataset
    data_root, surf_root = _make_synth_scene(str(tmp_path), n_train=2,
                                             n_val=0)
    ds = ShapeDataset(data_root, surf_root, imh=16, mode="train")
    return [ds.load_view(f) for f in ds.files]


@pytest.mark.parametrize("native", ["0", "1"], ids=["numpy", "native"])
def test_scan_loop_spans_a_chunk(tmp_path, monkeypatch, native):
    from vqnerf_release_torch.data.device_store import DeviceViewStore
    from vqnerf_release_torch.models import decomp_common as dc
    from vqnerf_release_torch.train import decomp_trainer as dt
    from vqnerf_release_torch.train import loop

    monkeypatch.setenv("VQNERF_NATIVE_SAMPLER", native)
    views = _tiny_views(tmp_path)
    k = len(views)
    cfg = dc.DecompConfig(n_rays_per_step=8)

    def step_fn(batch, step, lr=None):
        return {"loss": batch["rgb"].mean() * lr}
    step_fn.mesh = None
    steps = loop._Steps(step_fn)
    scan = dt.make_plain_epoch_scan(step_fn, DeviceViewStore(views, "cpu"),
                                    k, cfg.n_rays_per_step)
    rng = np.random.RandomState(0)
    at = [0]

    def sample_xs(n_ep):
        return loop._epoch_scan_xs(views, cfg, rng, "random", at[0], n_ep), 0

    def dispatch(xs):
        n, rows = steps.dispatch(scan, xs)
        at[0] += n
        return rows

    def fetch(rows, n_ep):
        return loop._split_epochs(loop._rows_to_dicts(rows, scan.keys), n_ep,
                                  k)

    with _cpu_profile():
        loop._scan_epoch_loop(0, 3, 100, 1, sample_xs, dispatch, fetch,
                              lambda *a: None)
    spans = profiling.spans()
    samples = _by_name(spans, "loop.sample")
    assert len(samples) == len(_by_name(spans, "graph.replay")) == 3
    assert len(_by_name(spans, "loop.fetch")) == 3
    assert len(_by_name(spans, "scan.stage")) == 3
    selects = _by_name(spans, "sampler.select")
    assert len(selects) == 3 * k
    assert [s.step for s in samples] == [0, k, 2 * k]
    for s in samples:
        mine = [x for x in selects if x.parent == s.id]
        assert len(mine) == k and {x.step for x in mine} == {s.step}
        assert all(s.start_ns <= x.start_ns <= x.end_ns <= s.end_ns
                   for x in mine)
    assert profiling.counters()["h2d_bytes"] == 3 * k * (
        8 + 4 + 8 * 2 * cfg.n_rays_per_step)


def test_neus_runner_spans_a_step(tmp_path):
    import chip_smoke
    from vqnerf_release_torch.data.neus_dataset import NerfSceneDataset
    from vqnerf_release_torch.models.fields import ColorConfig, SDFConfig
    from vqnerf_release_torch.models.neus import NeuSConfig
    from vqnerf_release_torch.train.neus_loop import NeuSRunner
    from vqnerf_release_torch.train.neus_trainer import NeuSTrainConfig

    root = str(tmp_path / "scene")
    chip_smoke.write_stage1_scene(root, 12, 1, 1, 0)
    runner = NeuSRunner(
        NeuSConfig(sdf=SDFConfig(d_hidden=16, n_layers=2, skip_in=(),
                                 multires=2, d_out=17),
                   color=ColorConfig(d_feature=16, d_hidden=16, n_layers=2),
                   n_samples=8, n_importance=8, up_sample_steps=2),
        NeuSTrainConfig(batch_size=32, end_iter=4, warm_up_end=1,
                        save_freq=100, val_freq=100, mesh_freq=100,
                        occ_res=8, occ_update_freq=2),
        NerfSceneDataset(root, near=0.5, far=3.5), str(tmp_path / "exp"),
        device="cpu")
    with _cpu_profile():
        runner.train()
    spans = profiling.spans()
    batches = _by_name(spans, "neus.host_batch")
    copies = _by_name(spans, "neus.h2d")
    assert [b.step for b in batches] == [0, 1, 2, 3]
    assert [c.parent for c in copies] == [b.id for b in batches]
    assert [s.step for s in _by_name(spans, "neus.step")] == [0, 1, 2, 3]
    assert [s.step for s in _by_name(spans, "neus.occ_rebuild")] == [0, 2]
    assert runner.occ_builds == [0, 2]
    assert profiling.counters()["h2d_bytes"] == 4 * 4 * 32 * (
        3 + 3 + 3 + 1 + 1 + 1 + 1)
