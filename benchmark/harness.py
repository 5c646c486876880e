"""The harness: finds a cell's configuration, traffic mix, driver and metric
readers by the names ``BENCHMARK.json`` gives, runs the cell once and builds
the result line. It holds no list of cells, mixes or metrics: each is a file
of its own, found by name.

  * ``BENCHMARK.json`` at the root: the cells, the metrics and their bounds.
  * ``benchmark/configs/<config>.json``: a configuration (the cell's config
    entry names the file); its ``model`` keys are what the program runs.
  * ``benchmark/traffic/<traffic>.json``: a traffic mix, data only; its
    ``driver`` names the generator that runs it,
    ``benchmark/drivers/<driver>.py``, and its ``limits`` are the limits of
    the numbers that decide ``correct``.
  * ``benchmark/metrics/<metric>.py``, else ``benchmark/metrics/<family>.py``
    where the family is the metric's name before its first dot: the reader
    of a per-layer metric, ``read(ctx)`` -> a number, or None when the run
    holds nothing to read.
"""

import importlib.util
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vqnerf_release_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json`` with everything it names, read from
    the tree at ``root`` (the checkout)."""

    def __init__(self, root, name):
        root = Path(root)
        self.root = root
        self.bench = load_json(root / "BENCHMARK.json")
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        cfg = [c for c in self.bench["configs"]
               if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / cfg["file"])
        self.mix = load_json(root / "benchmark" / "traffic"
                             / f"{self.workload['traffic']}.json")
        self.driver = load_module(
            root / "benchmark" / "drivers" / f"{self.mix['driver']}.py",
            f"bench_driver_{self.mix['driver']}")

    def metrics(self, kind):
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"):
        those listing it under ``workloads``, or listing no cells."""
        name = self.workload["name"]
        return [m for m in self.bench[kind]
                if name in m.get("workloads", [name])]

    def reader(self, metric):
        """The reader module of a per-layer metric."""
        base = self.root / "benchmark" / "metrics"
        for stem in (metric, metric.split(".")[0]):
            path = base / f"{stem}.py"
            if path.exists():
                return load_module(path, "bench_metric_" + stem.replace(
                    ".", "_").replace("-", "_"))
        raise FileNotFoundError(f"no reader for the metric {metric!r} "
                                f"under {base}")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def checks_ok(checks):
    """True when every compared number lies within its limit."""
    return all(c["value"] <= c["limit"] for c in checks)
