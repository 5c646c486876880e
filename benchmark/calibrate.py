"""The readings that a cell's limits are set from, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--sides program,lowp,half_batch] [--window 0]

For every seed: the cell's set-up (which takes the program's checked steps
or, with ``--window``, also a window of that many seconds), then each side's
numbers against the plain reference, printed as one JSON line a side and
seed. ``program`` is the program's own run (the lower readings); every other
side puts a variant of the reference in the program's place (the driver's
``SIDES``): the control in the precision below the configuration's, and the
planted faults (the upper readings). The benchmark's runs never call this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def main(argv=None, root=None, device=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default=None)
    p.add_argument("--window", type=float, default=0.0)
    args = p.parse_args(argv)
    import torch
    from benchmark import harness

    cell = harness.Cell(root or _ROOT, args.workload)
    if device is None:
        if not torch.cuda.is_available():
            print("calibrate: no CUDA device", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    driver = cell.driver
    sides = (args.sides.split(",") if args.sides
             else ["program", *driver.SIDES])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = driver.Driver(cell.config, cell.mix, seed, device)
        run.setup()
        if args.window > 0:
            run.window(args.window)
        run.release()
        for side in sides:
            checks = run.check(None if side == "program" else side)
            print(json.dumps({"seed": seed, "side": side,
                              "seconds": round(time.time() - t0, 3),
                              "numbers": {c["name"]: c["value"]
                                          for c in checks},
                              "detail": getattr(run, "detail", None)}),
                  flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
