#!/usr/bin/env python3
"""Device times of two design choices of the on-device neighbor list, on
one NVIDIA GPU:

    python3 device_nl_times.py

1. Compaction of the candidate columns to the neighbor width: the prefix
   sum of `transform/device_nl._compact` against a stable row sort of the
   column keys (the reference's order, by another route). Both must give
   the same features; each build is timed (median of single builds
   between CUDA events).
2. The padding slots' gather indices on a route that differentiates the
   positions (`ops/dense.spread_padding`, the GRAP request): spread over
   the rows, as the port runs, against all on row 0, as built. The E/F/S
   of both must agree to 1e-4; each is timed the same way.

Cells: the 32000-atom jittered fcc Ni request of `chip_smoke.py` through
the GRAP model (snap_ni_v5_readapt) and the EAM model (mleam_ni, flat
layout), float32, builders from the density census as the calculator's
"auto" makes them. Prints the card's name and power limit, then one JSON
line per measurement. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch


def sort_compact(valid: torch.Tensor, width: int):
    """The compaction by a stable sort of the keys (column if valid, C
    otherwise): the same contract as `device_nl._compact`."""
    n, c = valid.shape
    key = torch.where(valid, torch.arange(c, device=valid.device), c)
    return (torch.sort(key, dim=1, stable=True).values[:, :width],
            valid.sum(dim=1))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import dense
    from tensoralloy_tpu_torch.transform import device_nl
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card)
    cs.build()
    s = cs._structure(cs.TIMED_REPS)
    cases = {"grap": (cs.PATHS["grap"][0], dict(backend="pallas")),
             "eam_flat": (cs.EAM_PATHS["mleam_ni"][0],
                          dict(fast_efs=False))}
    prefix = device_nl._compact
    for name, (path, opts) in cases.items():
        calc = TensorAlloyCalculator(str(path), dtype="medium", **opts)
        vap = calc._get_vap(s)
        b = calc.device_builder(s, vap)
        pos = torch.as_tensor(vap.map_positions(s.positions),
                              dtype=calc.dtype, device=calc.device)
        cell = torch.as_tensor(s.cell, dtype=calc.dtype, device=calc.device)
        feats, diag = b.build(pos, cell)
        b.check(diag)
        times = {}
        for label, fn in (("prefix_sum", prefix), ("sort", sort_compact),
                          ("prefix_sum_again", prefix)):
            device_nl._compact = fn
            other, _ = b.build(pos, cell)
            for k in feats:
                if not torch.equal(other[k], feats[k]):
                    raise AssertionError(f"{name} {label}: {k} differs")
            times[label] = cs._median_ms(lambda: b.build(pos, cell), 20)
        device_nl._compact = prefix
        print(json.dumps({"case": name, "measure": "build_ms",
                          "atoms": len(s), "nnl_cap": b.nnl_cap,
                          "cell_cap": b.cell_cap,
                          "candidates": b.n_stencil * b.cell_cap,
                          **times, "card": card}))
        if name != "grap":
            continue        # the flat layout spreads its own padding
        efs = calc._get_variant(s, True)[1]
        spread = dense.spread_padding
        out, ms = {}, {}
        for label in ("spread", "row0", "spread_again"):
            dense.spread_padding = (spread if label != "row0"
                                    else lambda jd, mask, n_rows: jd)
            out[label] = efs(feats)
            ms[label] = cs._median_ms(lambda: efs(feats), 10)
        dense.spread_padding = spread
        err = max(cs.rel_err(out["row0"][k].cpu().numpy(),
                             out["spread"][k].cpu().numpy())
                  for k in ("energy", "forces", "stress_voigt"))
        padding = int((feats["pair_mask_d"] <= 0).sum().item())
        print(json.dumps({"case": name, "measure": "efs_ms",
                          "padding_slots": padding, **ms,
                          "rel_err": err, "card": card}))
        if not err <= cs.F32_REL or not np.isfinite(err):
            raise AssertionError(f"{name}: the two gathers disagree: {err}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
