#!/usr/bin/env python3
"""Time the descriptor kernels of one checkout of the PyTorch port on one
NVIDIA GPU, at the main path's largest shapes, to compare two checkouts.

    python3 kernel_times.py [--root DIR] [--kernels NAME ...]

`--root` is the root of the checkout whose `tensoralloy_tpu_torch` is
timed (default: this script's own); `--kernels` times only the named
kernels (`chip_smoke.SOURCES`' names, and `adp` for the fused ADP
pass of `chip_smoke.time_adp_pass` at the md_adp_mo432k cell's shape;
all by default). Where this run
builds the checkout's library, it first prints ptxas' registers and
spills of each compiled kernel (`chip_smoke.kernel_registers`). The
inputs, the timing and the work counts are `chip_smoke.py`'s
(`kernel_cases`, `time_kernels`): the 32000-atom jittered fcc Ni
request of the SF model (G2, G4) and of the GRAP model, each kernel
with its VJP kernel and, where the checkout has it, its second-order
kernel, float32. Run two checkouts in turns (A, B, B, A) in one call to
compare them on one card. Prints one JSON line per kernel, then one
per kernel with the host's share of a wrapper call (`host_us`: the
median host-clock time of one call that does not wait for the device)
and its pieces, each timed alone in a loop: the input checks, the host
tables built afresh, the kept tables and bound C function looked up
(where the checkout keeps them), the output's allocation, the stream
with and without entering the device and as a bare handle, and the
pointers boxed for ctypes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke  # noqa: E402


def _loop_us(fn, reps: int = 2000) -> float:
    """Host-clock time of one `fn()` in microseconds, over a loop."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def _call_us(fn, reps: int = 2000, drain: int = 100) -> float:
    """Median host-clock time of one `fn()` that queues device work and
    does not wait for it; the queue is drained every `drain` calls."""
    times = []
    for i in range(reps):
        if i % drain == 0:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def host_pieces(cases):
    """-> per kernel, the host time of a wrapper call and of its pieces
    (microseconds), for the package `chip_smoke.kernel_cases` imported."""
    from tensoralloy_tpu_torch.ops import fused
    rows = []
    for name, (args, kernel, _) in cases.items():
        if name.endswith(("_vjp", "_vjp_bwd")):   # the forward's pieces
            rows.append({"name": name,
                         "host_us": _call_us(lambda: kernel(*args))})
            continue
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        spec = args[len(tensors):]
        out = kernel(*args)
        device = tensors[0].device
        pieces = {"check_inputs": _loop_us(
            lambda: fused._check_cuda_inputs(name, *tensors))}
        if name == "grap":
            desc, rcut, n_slots = spec
            pieces["tables_built"] = _loop_us(
                lambda: fused.grap_tables(desc), 200)
            if hasattr(fused, "_bound_grap"):
                pieces["tables_kept"] = _loop_us(lambda: fused._bound_grap(
                    desc, rcut, n_slots, out.dtype, device))
        else:
            grid, rc, cutoff, n_slots = spec
            pieces["tables_built"] = _loop_us(
                lambda: fused._grid_columns(np.asarray(grid)))
            if hasattr(fused, "_bound_sf"):
                pieces["tables_kept"] = _loop_us(lambda: fused._bound_sf(
                    name, grid, rc, cutoff, n_slots, out.dtype))
        pieces["empty_output"] = _loop_us(lambda: torch.empty(
            out.shape, dtype=out.dtype, device=device))

        def stream_entering():
            with torch.cuda.device(device):
                return torch.cuda.current_stream().cuda_stream

        def stream_current():
            if device.index == torch.cuda.current_device():
                return torch.cuda.current_stream().cuda_stream

        pieces["stream_entering_device"] = _loop_us(stream_entering)
        pieces["stream_of_current_device"] = _loop_us(stream_current)
        pieces["stream_handle_only"] = _loop_us(
            lambda: (device.index == torch.cuda.current_device()
                     and torch._C._cuda_getCurrentRawStream(device.index)))
        pieces["pointers_boxed"] = _loop_us(
            lambda: [ctypes.c_void_p(t.data_ptr()) for t in tensors + [out]])
        pieces["pointers_plain"] = _loop_us(
            lambda: [t.data_ptr() for t in tensors + [out]])
        rows.append({"name": name, "host_us": _call_us(lambda: kernel(*args)),
                     "pieces_us": pieces})
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--kernels", nargs="+", default=None,
                        choices=list(chip_smoke.SOURCES) + ["adp"])
    args = parser.parse_args()
    root = Path(args.root).resolve()
    card = chip_smoke.check_card()
    sys.path.insert(0, str(root))
    import tensoralloy_tpu_torch
    if Path(tensoralloy_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {tensoralloy_tpu_torch.__file__}, "
                         f"not the package under {root}")
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    fused.build_kernels()
    for row in chip_smoke.kernel_registers(fused.build_log):
        print(json.dumps({"root": str(root), "card": card, "build": row}),
              flush=True)
    descriptors = [k for k in (args.kernels or chip_smoke.SOURCES)
                   if k != "adp"]
    rows = []
    if descriptors:
        structure = chip_smoke._structure(chip_smoke.TIMED_REPS)
        sf, grap = (TensorAlloyCalculator(str(chip_smoke.PATHS[name][0]),
                                          device="cuda", dtype="medium",
                                          backend="pallas")
                    for name in ("sf", "grap"))
        cases = chip_smoke.kernel_cases(sf, structure, grap, structure)
        cases = {k: v for k, v in cases.items() if k in descriptors}
        rows = chip_smoke.time_kernels(cases, card) + host_pieces(cases)
        del sf, grap, cases
    if args.kernels is None or "adp" in args.kernels:
        torch.cuda.empty_cache()
        rows.append(chip_smoke.time_adp_pass(card))
    for row in rows:
        print(json.dumps({"root": str(root), "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
