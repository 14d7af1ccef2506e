#!/usr/bin/env python3
"""The correctness control of a cell, on the card, at the cell's own size:

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 20

For each seed, in one process, runs the cell as perfbench/run.py does
(a short window at the cell's load) and then, beside the comparison of
the program with the float32 reference, the same comparison of the
reference computed in the precision below the configuration's (the LLM's
weights in int8, the float32 graph modules in TF32) and, for a training
cell, of the reference with half of every batch left out. Prints one JSON
line a seed: the program's readings (the lower ones of the limits) and
the control's and faults' (the upper ones). The benchmark's own runs do
not run this.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import core  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    core.prepare_env()
    cell = core.Cell(args.workload)
    core.check_device(cell.entry["chips"])
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    import torch
    for seed in (int(s) for s in args.seeds.split(",")):
        run = driver.run(cell, seed, args.seconds, False, time.monotonic(),
                         control=True)
        print(json.dumps({"seed": seed, "correct": run.correct,
                          "program": {n: v for n, v, _ in run.checks},
                          "limits": {n: lim for n, _, lim in run.checks},
                          "control": run.notes.get("control"),
                          "e2e": run.e2e}), flush=True)
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
