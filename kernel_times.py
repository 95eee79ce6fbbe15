#!/usr/bin/env python3
"""Time the descriptor kernels of one checkout of the PyTorch port on one
NVIDIA GPU, at the main path's largest shapes, to compare two checkouts.

    python3 kernel_times.py [--root DIR]

`--root` is the root of the checkout whose `tensoralloy_tpu_torch` is
timed (default: this script's own). The inputs, the timing and the work
counts are `chip_smoke.py`'s (`kernel_cases`, `time_kernels`): the
32000-atom jittered fcc Ni request of the SF model (G2, G4) and of the
GRAP model, float32. Run two checkouts in turns (A, B, B, A) in one call
to compare them on one card. Prints one JSON line per kernel.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402


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
    structure = chip_smoke._structure(chip_smoke.REQUEST_REPS[-1])
    sf, grap = (TensorAlloyCalculator(str(chip_smoke.PATHS[name][0]),
                                      device="cuda", dtype="medium",
                                      backend="pallas")
                for name in ("sf", "grap"))
    cases = chip_smoke.kernel_cases(sf, structure, grap, structure)
    for row in chip_smoke.time_kernels(cases, card):
        print(json.dumps({"root": str(root), "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
