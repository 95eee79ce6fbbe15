#!/usr/bin/env python3
"""Read the numbers that decide a cell's `correct` over many seeds in
one process: the program as its configuration states it, and the
control, the program with its own TF32 path switched on, which the
limits must fail. Each run is a short window at the cell's own size.

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--fault NAME --fault-seeds 7 8 9] \
        [--seconds 2]

`--fault` plants one of `portbench.faults` in the program for the
`--fault-seeds` runs. Prints one JSON line a run: the seed, the variant
(sound, control or the fault) and each number with its limit. The
benchmark's own runs never run the control or a fault; the limits in
the traffic files were set from these readings (PERF.md).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import importlib

    import torch

    from portbench import faults
    from portbench.common import Context, block_forbidden
    from portbench.run import resolve
    block_forbidden()
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    found = resolve(ROOT, args.workload)
    driver = importlib.import_module(
        f"portbench.drivers.{found['traffic']['driver']}")
    kind = found["traffic"]["driver"]
    runs = [(s, "sound") for s in args.seeds] + \
        [(s, "control") for s in args.control_seeds] + \
        [(s, args.fault) for s in args.fault_seeds]
    for seed, variant in runs:
        ctx = Context(cell=args.workload, config=found["config"],
                      traffic=found["traffic"], seed=seed,
                      seconds=args.seconds, trace=False,
                      control=variant == "control")
        mend = (faults.plant(kind, variant)
                if variant not in ("sound", "control") else (lambda: None))
        try:
            run = driver.run(ctx)
        finally:
            mend()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"seed": seed, "variant": variant,
                          "correct": run.correct, **{
                              c.name: [c.value, c.limit, c.note]
                              for c in run.checks}}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
