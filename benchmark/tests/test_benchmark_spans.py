"""The per-layer metrics read from the program's own spans: a tiny cell run
with ``--trace 1`` reports every one of its span metrics as a number; with
``--trace 0`` it reports none and the program records no span."""

import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import run_cell
from vqnerf_release_torch.utils import profiling

SPAN_METRICS = {
    "decomp.vq_train": ["host_sample_ms_per_chunk.vq_train",
                        "select_ms_per_view.vq_train",
                        "replay_issue_ms_per_chunk.vq_train",
                        "fetch_wait_ms_per_chunk.vq_train"],
    "geo.train": ["host_batch_ms_per_step.geo_train",
                  "batch_copy_ms_per_step.geo_train",
                  "step_issue_ms_per_step.geo_train"]}


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
@pytest.mark.parametrize("trace", [0, 1])
def test_span_metrics_come_from_the_traced_slice(tiny_root, capsys, workload,
                                                 trace, monkeypatch):
    # a stand-in 'jax' that an earlier test of this process left in
    # sys.modules would end the run without a result; this test is not
    # about that check
    for name in harness.forbidden_modules():
        monkeypatch.delitem(sys.modules, name)
    profiling.reset()
    code, res = run_cell(tiny_root, workload, trace=trace, capsys=capsys)
    assert code == 0
    assert res["correct"], res["checks"]
    names = SPAN_METRICS[workload]
    if trace:
        for name in names:
            value = res["metrics"][name]["value"]
            assert isinstance(value, float) and value > 0, name
        assert res["metrics"][names[0]]["unit"] == "ms"
    else:
        assert not set(names) & set(res["metrics"])
        assert profiling.spans() == [] and profiling.counters() == {}
    profiling.reset()


def test_no_span_no_metric():
    from benchmark.spans import mean_ms
    profiling.reset()
    assert mean_ms("loop.sample") is None
    assert mean_ms("neus.h2d", per="neus.host_batch") is None
