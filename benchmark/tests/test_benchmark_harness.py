"""The harness: cells, mixes and metrics found from files alone; a run
without a card; tiny runs of the benchmark's cells on the CPU, sound and
with the timed path broken underneath."""

import json

import pytest
import torch

from benchmark import harness, run

from .conftest import run_cell

FIXTURE_DRIVER = '''
class Driver:
    def __init__(self, config, mix, seed, device):
        self.rate = mix["rate"] * config["model"]["scale"]
    def setup(self):
        pass
    def window(self, seconds, tracer=None):
        if tracer is not None:
            tracer.start()
            tracer.stop({"steps": 4})
        return {"attempted": 4, "failed": 0,
                "metrics": {"fixture_rate": self.rate}}
    def release(self):
        pass
    def check(self, side=None):
        return [{"name": "gap", "value": 0.0, "limit": 0.0}]
'''

FIXTURE_READER = '''
UNIT = "steps"
SOURCE = "program_counter"
def read(ctx):
    return float(ctx["summary"]["work"]["steps"]) + ctx["mix"]["rate"]
'''


def _add_fixture_cell(root):
    """A configuration, a mix, a driver and a metric, each a new file, and
    their entries in BENCHMARK.json: nothing of the harness is edited."""
    b = root / "benchmark"
    (b / "configs" / "fixture.json").write_text(json.dumps(
        {"model": {"scale": 2.0}}))
    (b / "traffic" / "fixture_mix.json").write_text(json.dumps(
        {"driver": "fixture_driver", "rate": 3.0}))
    (b / "drivers" / "fixture_driver.py").write_text(FIXTURE_DRIVER)
    (b / "metrics" / "fixture_count.py").write_text(FIXTURE_READER)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "fixture", "source": "-",
                             "file": "benchmark/configs/fixture.json",
                             "reduced": [], "why": "a fixture"})
    bench["workloads"].append({"name": "fixture.cell", "config": "fixture",
                               "traffic": "fixture_mix", "chips": 1,
                               "why": "a fixture"})
    bench["end_to_end"].append({"name": "fixture_rate", "unit": "1/s",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["fixture.cell"]})
    bench["per_layer"].append({"name": "fixture_count.cell", "unit": "steps",
                               "better": "higher", "source":
                               "program_counter", "layer": "fixture",
                               "moves": "fixture_rate",
                               "workloads": ["fixture.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_cell_is_found_from_files_alone(tiny_root, capsys):
    _add_fixture_cell(tiny_root)
    code, res = run_cell(tiny_root, "fixture.cell", capsys=capsys)
    assert code == 0 and res["correct"]
    assert set(res["metrics"]) == {"fixture_rate", "setup_s"}
    assert res["metrics"]["fixture_rate"]["value"] == 6.0
    assert list(res)[-1] == "checks"
    code, res = run_cell(tiny_root, "fixture.cell", trace=1, capsys=capsys)
    assert code == 0
    # found as the family reader fixture_count.py of fixture_count.cell
    assert res["metrics"] == {"fixture_count.cell": {"value": 7.0,
                                                     "unit": "steps"}}


def test_cells_only_get_their_metrics(tiny_root):
    cell = harness.Cell(tiny_root, "decomp.relight")
    names = {m["name"] for m in cell.metrics("end_to_end")}
    assert names == {"relight_views_per_s", "relight_p95_ms", "setup_s"}


def test_readers_declare_what_benchmark_json_says():
    cell = harness.Cell(harness.BENCH_DIR.parent, "decomp.vq_train")
    for m in cell.bench["per_layer"]:
        reader = cell.reader(m["name"])
        assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"])


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    code = run.main(["--workload", "decomp.vq_train", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert code != 0
    assert captured.out.strip() == ""
    assert "CUDA" in captured.err


@pytest.mark.parametrize("workload", ["decomp.vq_train", "geo.train",
                                      "decomp.relight"])
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_is_correct(tiny_root, capsys, workload, trace):
    code, res = run_cell(tiny_root, workload, trace=trace, capsys=capsys)
    assert code == 0
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"


def _unchanged_state(monkeypatch):
    from vqnerf_release_torch.train import decomp_trainer as dt

    def step(self, grads, lr, loss=None):
        return torch.ones((), dtype=torch.bool)
    monkeypatch.setattr(dt.KerasAmsgrad, "step", step)


def _half_batch(monkeypatch):
    from vqnerf_release_torch.data import device_store
    gather_at = device_store.DeviceViewStore.gather_at

    def half(self, vi, pix, keys=None):
        return gather_at(self, vi, pix[: pix.shape[0] // 2], keys)
    monkeypatch.setattr(device_store.DeviceViewStore, "gather_at", half)


def _neus_unchanged_state(monkeypatch):
    from vqnerf_release_torch.train import neus_trainer

    def step(self, grads, lr, loss=None):
        return torch.ones((), dtype=torch.bool)
    monkeypatch.setattr(neus_trainer.NeuSAdam, "step", step)


def _neus_half_batch(monkeypatch):
    from vqnerf_release_torch.train import neus_loop, neus_trainer
    make = neus_trainer.make_neus_train_step

    def halved(*a, **k):
        opt, step_fn = make(*a, **k)

        def half(batch, step, occ_grid=None, rand=None, **kw):
            n = batch["rays_o"].shape[0] // 2
            if rand is not None:
                rand = {key: v[:n] for key, v in rand.items()}
            return step_fn({key: v[:n] for key, v in batch.items()}, step,
                           occ_grid=occ_grid, rand=rand, **kw)
        return opt, half
    monkeypatch.setattr(neus_trainer, "make_neus_train_step", halved)
    monkeypatch.setattr(neus_loop, "make_neus_train_step", halved)


def _altered_answer(monkeypatch):
    from vqnerf_release_torch.models import vq_nfr
    render = vq_nfr.vq_fast_render

    def altered(*a, **k):
        out = render(*a, **k)
        out["rgb_probes"] = out["rgb_probes"].contiguous().clone()
        out["rgb_probes"].view(-1)[3] += 0.5
        return out
    monkeypatch.setattr(vq_nfr, "vq_fast_render", altered)


@pytest.mark.parametrize("workload, fault", [
    ("decomp.vq_train", _unchanged_state),
    ("decomp.vq_train", _half_batch),
    ("geo.train", _neus_unchanged_state),
    ("geo.train", _neus_half_batch),
    ("decomp.relight", _altered_answer)],
    ids=["vq_train-unchanged_state", "vq_train-half_batch",
         "geo_train-unchanged_state", "geo_train-half_batch",
         "relight-altered_answer"])
def test_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                          workload, fault):
    fault(monkeypatch)
    code, res = run_cell(tiny_root, workload, capsys=capsys)
    assert code == 0
    assert res["correct"] is False


LOADING_READER = '''
import sys
import types
UNIT = "steps"
SOURCE = "program_counter"
def read(ctx):
    sys.modules["jax"] = types.ModuleType("jax")
    return 1.0
'''


def test_a_jax_module_loaded_after_the_window_gives_no_result(
        tiny_root, capsys, monkeypatch):
    """What the check and the readers load counts too: a reader that loads
    a module named jax leaves the run without a result."""
    import sys
    _add_fixture_cell(tiny_root)
    (tiny_root / "benchmark" / "metrics" / "fixture_count.py").write_text(
        LOADING_READER)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    code, res = run_cell(tiny_root, "fixture.cell", trace=1, capsys=capsys)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert code != 0 and res is None


def test_compare_reads_the_worst_or_the_median_leaf():
    """One leaf that moves differently sets the worst leaf's change gap and
    leaves the median leaf's; a state left unchanged reads 1 on both."""
    from benchmark.compare import compare
    w0 = {k: torch.zeros(4) for k in "abcde"}
    exact = {"loss": [2.0], "grad1": {k: torch.ones(4) for k in w0},
             "params": {k: torch.ones(4) for k in w0}}
    prog = {"loss": [2.0], "grad1": exact["grad1"],
            "params": dict(exact["params"], e=torch.full((4,), 1.5))}
    detail = {}
    worst = compare(prog, exact, w0, detail=detail)["change_gap"]
    median = compare(prog, exact, w0, change_by="median")["change_gap"]
    assert worst == pytest.approx(0.5) and median == 0.0
    assert detail["change_worst"] == worst and detail["change_median"] == 0
    assert detail["worst_leaves"][0][0] == "e"
    still = dict(prog, params=w0)
    for by in ("worst", "median"):
        assert compare(still, exact, w0, change_by=by)["change_gap"] == 1.0
