#!/usr/bin/env python3
"""The benchmark of llamole_tpu_torch (the PyTorch + CUDA port).

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on the cards of this machine: its
configuration (perfbench/configs/), its traffic (perfbench/workloads/)
and its limits (perfbench/limits/) are found by the names in
BENCHMARK.json, and the traffic file names the driver
(perfbench/drivers/). Prints, as the last line of standard output, one
JSON object: correct, attempted, failed, the cell's end-to-end metrics
(--trace 0) or per-layer metrics (--trace 1, read by
perfbench/metrics/<name>.py), the device, and each compared number
beside its limit; the same numbers end standard error. Exits non-zero
without a result when the cards are missing or JAX was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    core.prepare_env()
    cell = core.Cell(args.workload)
    core.check_device(cell.entry["chips"])
    print(f"perfbench: {cell.name} seed {args.seed} on "
          f"{core.card_tag()}", file=sys.stderr, flush=True)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell.traffic['driver']}")
    run = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                     T_START)
    found = core.forbidden_loaded()
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return 3
    line = core.result_line(run, cell, bool(args.trace))
    print(json.dumps({"counters": run.counters, "notes": run.notes},
                     default=str), file=sys.stderr)
    core.print_checks(run)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
