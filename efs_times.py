#!/usr/bin/env python3
"""Time the device E/F/S of the served SF and GRAP requests of one checkout
of the PyTorch port on one NVIDIA GPU, to compare two checkouts.

    python3 efs_times.py [--root DIR]

`--root` is the root of the checkout whose `tensoralloy_tpu_torch` is
timed (default: this script's own). The requests are `chip_smoke.py`'s:
snap_ni_sfa (G2, G4) and snap_ni_v5_readapt (GRAP) on jittered fcc Ni of
4000 and 32000 atoms on the host lists, and the GRAP 32000-atom request
on the device lists (where "auto" sends it), float32, backend "pallas".
Device E/F/S is the median host-clock time of the calculator's E/F/S
function on features made once, each call waited for (40 calls at 4000
atoms, 15 at 32000, after a warm-up request: a 4000-atom request's host
clock varies by a millisecond or more from call to call). Prints one
JSON line per request with the launches of one request by kernel. Run
two checkouts in turns (A, B, B, A) in one call to compare them on one
card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402

# (label, path, fcc repeats, calculator options)
REQUESTS = (
    ("sf 4000", "sf", 10, {"device_nl": False}),
    ("sf 32000", "sf", 20, {"device_nl": False}),
    ("grap 4000", "grap", 10, {"device_nl": False}),
    ("grap 32000", "grap", 20, {"device_nl": False}),
    ("grap 32000 device lists", "grap", 20, {}),
)


def device_efs(calc, structure, reps: int) -> tuple:
    """-> (median device E/F/S ms, on device lists, launches of one
    request by kernel)."""
    from tensoralloy_tpu_torch.ops import fused
    vap = calc._get_vap(structure)
    device = calc._use_device_nl(structure)
    fused.reset_launch_counts()
    calc.calculate(structure)
    launches = dict(fused.launch_counts)
    feats = (calc.featurize_device(structure, vap) if device
             else calc.featurize(structure, vap))
    efs = calc._get_variant(structure, device)[1]
    return chip_smoke._median_host_ms(lambda: efs(feats), reps), device, \
        launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    root = Path(parser.parse_args().root).resolve()
    card = chip_smoke.check_card()
    sys.path.insert(0, str(root))
    import tensoralloy_tpu_torch
    if Path(tensoralloy_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {tensoralloy_tpu_torch.__file__}, "
                         f"not the package under {root}")
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    for label, path, reps, options in REQUESTS:
        calc = TensorAlloyCalculator(str(chip_smoke.PATHS[path][0]),
                                     device="cuda", dtype="medium",
                                     backend="pallas", **options)
        structure = chip_smoke._structure(reps)
        ms, device, launches = device_efs(calc, structure,
                                          40 if reps < 20 else 15)
        print(json.dumps({"root": str(root), "card": card,
                          "request": label, "atoms": len(structure),
                          "device_lists": device, "device_efs_ms": ms,
                          "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
