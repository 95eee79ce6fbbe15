#!/usr/bin/env python3
"""`readings.py` for the MD cells of the EAM family, whose driver
(`drivers/md_eam.py`) runs the program's `VelocityVerlet` as `md.py`
does: a fault is planted by `portbench.faults` under the kind "md".

    python3 portbench/readings_md_eam.py --workload md_adp_mo432k \
        --seeds 1 2 3 [--control-seeds 4 5 6] \
        [--fault NAME --fault-seeds 7 8 9] [--seconds 2]
    python3 portbench/readings_md_eam.py --workload md_adp_mo432k \
        --lowered bfloat16 --lowered-seeds 1 2 3 [--seconds 2]

`--lowered DTYPE` (bfloat16 or float16) reads the lower side of the
limits for a configuration in float32 whose TF32 control changes no bit:
the program runs as configured, and `drivers/md_eam.py`'s `_compare`
holds it to the reference computed in DTYPE in place of float32 (the
neighbour list from the positions in float32, the model, its forces and
the BAOAB chunk in DTYPE). A reference that cannot finish in DTYPE is
printed with its error in place of the numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import faults  # noqa: E402
from portbench import readings  # noqa: E402

_plant = faults.plant


def plant(kind: str, name: str):
    return _plant("md" if kind == "md_eam" else kind, name)


def lower_reference(dtype):
    """Run `reference/md.baoab_chunk` in `dtype` (a torch dtype) for the
    life of the process; -> a function that takes the patch out."""
    from portbench.reference import md as ref_md
    chunk = ref_md.baoab_chunk

    def lowered(potential, pos, vel, masses, *args):
        build = potential._list

        def listed(p):
            build(p.float())
            potential.shift = potential.shift.to(dtype)
        potential._list = listed
        potential.cell = potential.cell.to(dtype)
        p, v, energy = chunk(potential, pos.to(dtype), vel.to(dtype),
                             masses.to(dtype), *args)
        return p.float(), v.float(), energy

    ref_md.baoab_chunk = lowered

    def mend():
        ref_md.baoab_chunk = chunk
    return mend


def lowered_readings(argv) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--lowered", required=True,
                        choices=("bfloat16", "float16"))
    parser.add_argument("--lowered-seeds", type=int, nargs="+",
                        required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    import importlib

    import torch

    from portbench.common import Context, block_forbidden
    from portbench.run import resolve
    block_forbidden()
    if not torch.cuda.is_available():
        print("portbench: readings need a CUDA device", file=sys.stderr)
        return 2
    found = resolve(readings.ROOT, args.workload)
    driver = importlib.import_module(
        f"portbench.drivers.{found['traffic']['driver']}")
    variant = f"reference_{args.lowered}"
    for seed in args.lowered_seeds:
        ctx = Context(cell=args.workload, config=found["config"],
                      traffic=found["traffic"], seed=seed,
                      seconds=args.seconds, trace=False)
        mend = lower_reference(getattr(torch, args.lowered))
        try:
            run = driver.run(ctx)
            line = {"seed": seed, "variant": variant,
                    "correct": run.correct,
                    **{c.name: [c.value, c.limit, c.note]
                       for c in run.checks}}
            del run
        except (ValueError, RuntimeError) as err:
            line = {"seed": seed, "variant": variant,
                    "error": f"{type(err).__name__}: {err}"[:300]}
        finally:
            mend()
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if "--lowered" in sys.argv:
        sys.exit(lowered_readings(sys.argv[1:]))
    faults.plant = plant
    sys.exit(readings.main())
