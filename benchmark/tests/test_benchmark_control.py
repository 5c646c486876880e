"""The control and the planted faults, put in the program's place at a
tiny size on the CPU, come out not correct against the cells' limits (on
the card, ``calibrate.py`` reads them at the cells' sizes)."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

from .conftest import ROOT


@pytest.mark.parametrize("workload, side", [
    ("decomp.vq_train", "lowp"), ("decomp.vq_train", "half_batch"),
    ("geo.train", "lowp"), ("geo.train", "half_batch"),
    ("decomp.relight", "lowp"), ("decomp.relight", "altered")])
def test_control_and_faults_fail_a_limit(tiny_root, workload, side):
    cell = harness.Cell(tiny_root, workload)
    run = cell.driver.Driver(cell.config, cell.mix, 2_200_000_021, "cpu")
    run.setup()
    run.window(0.2)
    run.release()
    assert harness.checks_ok(run.check())
    assert not harness.checks_ok(run.check(side))


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["decomp.vq_train", "geo.train",
                                      "decomp.relight"])
def test_cell_on_the_card(workload):
    """A short run of the cell on the card, as the benchmark's command runs
    it: correct, and the device named."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "2200000031", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
