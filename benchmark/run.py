"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs and weights from the seed, the program's build, warm-up of
every shape the cell uses), then the measured window of ``--seconds``, then
the check of what the window produced against the plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics, read over a traced slice of the window), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit. The same numbers end standard error.

It exits with another code than 0, and prints no result, without a CUDA
device (or with fewer than the cell asks for), and when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.time()
_ROOT = Path(__file__).resolve().parent.parent
# every cache the program or a library might fill stays inside the checkout,
# at a fixed path, so that only a cell's first run there builds
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(_var, str(_ROOT / ".bench_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402


def process_start():
    """The wall time at which this process started (Linux: from its start
    tick; elsewhere the time this module was first read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def _power_limit():
    """The card's name and power limit as nvidia-smi reports them, or
    None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root=None, device=None):
    """Run the cell; returns the exit code. ``root`` (the checkout) and
    ``device`` are for the benchmark's own tests, which run a tiny cell on
    the CPU: without ``device`` the run takes the CUDA card or fails."""
    t_start = process_start()
    args = parse(argv)
    import torch
    from benchmark import harness
    from benchmark.trace import Tracer

    cell = harness.Cell(root or _ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: the cell needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count() "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    power = _power_limit() if cuda else None

    run = cell.driver.Driver(cell.config, cell.mix, args.seed, device)
    run.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    tracer = Tracer(device) if args.trace else None
    out = run.window(args.seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.release()
    checks = run.check()

    if args.trace:
        ctx = {"summary": tracer.summary, "spans": out.get("spans", {}),
               "config": cell.config["model"], "mix": cell.mix,
               "cell": cell.workload["name"], "device": device}
        metrics = {}
        for m in cell.metrics("per_layer"):
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.metrics("end_to_end")}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    if power:
        dev["power_limit"] = power
    if args.trace and tracer.summary is not None:
        dev["busy_s"] = tracer.summary["busy_s"]
        dev["window_s"] = tracer.summary["window_s"]
    result = {"correct": bool(out["attempted"] > 0
                              and harness.checks_ok(checks)),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if args.trace and tracer.summary is not None:
        result["breakdown"] = tracer.summary["breakdown"]
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        print(f"check {c['name']} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    # last, so that whatever the check and the readers loaded counts too
    loaded = harness.forbidden_modules()
    if loaded:
        print("no result: modules of JAX or of the JAX package are loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
