#!/usr/bin/env python3
"""Time the train steps of the SF and GRAP training configurations and an
SF Hessian of one checkout of the PyTorch port on one NVIDIA GPU, to
compare two checkouts.

    python3 train_times.py [--root DIR] [--profile] [--parts ...]

`--root` is the root of the checkout whose `tensoralloy_tpu_torch` is
timed (default: this script's own). The trainers are `chip_smoke.py`'s
(`TrainingManager` on the runs' input.toml at full width, backend
'pallas', float32, on artifacts/snap_ni/snap-Ni.db): train_sf
(snap_ni_sfa, G2 + G4, batch 25) and train_grap (snap_ni_v5_readapt,
batch 50). For each: 20 steps from `init_params`, structures/s (each
step waited for, the median after 3), the launches a step by kernel,
and the step split from CUDA events (`chip_smoke._step_split`, medians
of 6 steps after 2). Then the float64 Hessian of snap_ni_sfa on the
27-atom supercell (3x3x3 primitive fcc Ni cells, a = 3.52 A, as the
analysis phase's phonons), the median of 3 after one, with its launches,
and the same of snap_ni_v5_readapt (GRAP). `--profile` adds one
`torch.profiler` pass of a step of each configuration: the device time
of the step's kernels, of those launched inside the first backward
(forces) and, of both, what the descriptors' plain twins ran
(`fused._twin_vjp` and, in the loss backward, the backward of the nodes
it made), and the largest ops. The part `kernels` times each
configuration's descriptor kernels, their VJP and second-order kernels
at a batch's shapes (`chip_smoke.time_kernels`): G2 and G4 with
train_sf, GRAP with train_grap. `--parts` picks among
train_sf, train_grap, hessian and kernels (all by default). Prints one
JSON line per measurement. Run two checkouts in
turns (A, B, B, A) in one call to compare them on one card.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402

STEPS = 20
WARM = 3
PARTS = ("train_sf", "train_grap", "hessian", "kernels")


def _trainer_and_data(name, work):
    """-> (float32 trainer, its dataset's (train features, train labels))
    for the configuration `name`, the dataset built as the train phase
    builds it."""
    cfg = chip_smoke.TRAIN_CONFIGS[name]
    m64 = chip_smoke._manager(cfg, work, "high", "pallas", 1)
    arrays = m64.dataset.split(*m64.dataset.build())
    trainer = chip_smoke._manager(cfg, work, "medium", "pallas",
                                  STEPS).trainer
    return trainer, arrays


def train_times(name, workdir, card, profile, kernels):
    from tensoralloy_tpu_torch.ops import fused
    from tensoralloy_tpu_torch.train.dataset import batch_index_stream
    work = Path(workdir) / name
    work.mkdir()
    trainer, arrays = _trainer_and_data(name, work)
    params = trainer.init_params(arrays[0], verbose=False)
    fused.reset_launch_counts()
    out, _, seconds = chip_smoke._fit_losses(trainer, arrays, params,
                                             timed=True)
    launches = {k: v / STEPS for k, v in fused.launch_counts.items()}
    tp = trainer.train_parameters
    rates = tp.batch_size / np.asarray(seconds[WARM:])
    dev_f, dev_l = trainer._to_device(arrays[0]), trainer._to_device(
        arrays[1])
    idx = batch_index_stream(len(arrays[1]["energy"]), tp.batch_size,
                             seed=tp.seed, repeat=True)
    split = chip_smoke._step_split(trainer, out["state"], dev_f, dev_l,
                                   [next(idx) for _ in range(8)], card)
    row = {"measure": f"train_{name}", "structures_per_s":
           float(np.median(rates)), "rates_min_max": [float(rates.min()),
                                                      float(rates.max())],
           "launches_per_step": launches, "split_ms": split}
    sel = torch.as_tensor(next(idx), device=trainer.device)
    feats = {k: v[sel] for k, v in dev_f.items()}
    if profile:
        row["profile"] = profile_step(trainer, out["state"], feats,
                                      {k: v[sel] for k, v in dev_l.items()})
    rows = [row]
    if kernels:
        # the descriptor kernels at this batch's shapes
        fz, model = trainer.model.featurizer, trainer.model
        gen = torch.Generator(device=trainer.device).manual_seed(
            chip_smoke.SEED + 4)
        if name == "sf":
            cases = chip_smoke.sf_kernel_cases(
                feats, model.descriptor, fz.rcut, fz.acut,
                fz.n_radial_slots, fz.n_angular_slots, gen)
        else:
            cases = chip_smoke.grap_kernel_cases(
                feats, model.descriptor, fz.rcut, fz.n_radial_slots, gen)
        rows += [{"measure": f"kernel at the train_{name} batch shape",
                  **r} for r in chip_smoke.time_kernels(cases, card)]
    return rows


def _device_us(event) -> float:
    """Device time of the kernels `event` (a host-side op) launched
    itself, microseconds."""
    for key in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, key):
            return float(getattr(event, key))
    return 0.0


def _ancestor(event, accept):
    parent = event.cpu_parent
    while parent is not None and not accept(parent):
        parent = parent.cpu_parent
    return parent


def profile_step(trainer, state, feats, labels) -> dict:
    """One profiled train step (after one unprofiled): device ms of all
    its kernels, of those launched inside the forward + first backward,
    and of the twins' part of each (the ops that `fused._twin_vjp`
    runs; the loss backward's nodes that it made, found by their
    sequence numbers); the largest ops by device time with the autograd
    node that ran each. Each kernel counts once, under the host op that
    launched it; the profiled step's own wall time is not a step's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from tensoralloy_tpu_torch.ops import fused
    ranges = ("forward+first backward", "twin_vjp")
    twin_vjp = getattr(fused, "_twin_vjp", None)

    def traced_twin(*args, **kwargs):
        with record_function(ranges[1]):
            return twin_vjp(*args, **kwargs)

    predictions = trainer.batched_predictions

    def traced_predictions(*args, **kwargs):
        with record_function(ranges[0]):
            return predictions(*args, **kwargs)

    trainer.train_step(state, feats, labels)
    torch.cuda.synchronize()
    trainer.batched_predictions = traced_predictions
    if twin_vjp is not None:
        fused._twin_vjp = traced_twin
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(state, feats, labels)
            torch.cuda.synchronize()
    finally:
        del trainer.batched_predictions
        if twin_vjp is not None:
            fused._twin_vjp = twin_vjp
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CPU and e.name not in ranges]
    first = lambda e: e.name == ranges[0]  # noqa: E731
    twin = lambda e: e.name == ranges[1]  # noqa: E731
    node = lambda e: e.name.startswith("autograd::engine::evaluate")  # noqa
    twin_seq = {e.sequence_nr for e in events
                if _ancestor(e, twin) is not None
                and getattr(e, "sequence_nr", -1) >= 0}
    parts = {"step": 0.0, "forward + first backward": 0.0,
             "twin in the first backward": 0.0,
             "twin's nodes in the loss backward": 0.0}
    by_op = {}
    for e in events:
        us = _device_us(e)
        if us <= 0:
            continue
        parts["step"] += us
        runner = _ancestor(e, node)
        key = e.name + (f" <- {runner.name[31:]}" if runner else "")
        by_op[key] = by_op.get(key, 0.0) + us
        if _ancestor(e, first) is not None:
            parts["forward + first backward"] += us
            if _ancestor(e, twin) is not None:
                parts["twin in the first backward"] += us
        elif _ancestor(e, lambda p: node(p) and p.sequence_nr
                       in twin_seq) is not None:
            parts["twin's nodes in the loss backward"] += us
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:20]
    return {"device_ms": {k: v / 1e3 for k, v in parts.items()},
            "top_ops_ms": {k: v / 1e3 for k, v in top},
            "twin_sequence_numbers": len(twin_seq)}


def hessian_times(card, name) -> dict:
    """The float64 Hessian of the main path's model `name` (sf:
    snap_ni_sfa, grap: snap_ni_v5_readapt) on the 27-atom supercell."""
    from tensoralloy_tpu_torch.analysis.phonon import \
        supercell_force_constants
    from tensoralloy_tpu_torch.atoms import Structure
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    from tensoralloy_tpu_torch.ops import fused
    path = chip_smoke.PATHS[name][0]
    calc = TensorAlloyCalculator(str(path),
                                 dtype="high", backend="pallas")
    prim = chip_smoke.fcc_primitive(Structure, chip_smoke.PHONON_A)
    times, launches = [], None
    for i in range(4):
        fused.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        supercell_force_constants(calc, prim, chip_smoke.PHONON_SUPERCELL)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
        launches = dict(fused.launch_counts)
    return {"measure": f"hessian {path.parts[-3]} 27 atoms float64",
            "ms": float(np.median(times)), "ms_all": times,
            "launches": launches}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(HERE))
    parser.add_argument("--profile", action="store_true")
    parser.add_argument("--parts", nargs="+", default=PARTS, choices=PARTS)
    args = parser.parse_args()
    root = Path(args.root).resolve()
    card = chip_smoke.check_card()
    sys.path.insert(0, str(root))
    import tensoralloy_tpu_torch
    if Path(tensoralloy_tpu_torch.__file__).resolve().parents[1] != root:
        raise SystemExit(f"imported {tensoralloy_tpu_torch.__file__}, "
                         f"not the package under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as workdir:
        rows = [r for name in chip_smoke.TRAIN_CONFIGS
                if f"train_{name}" in args.parts
                for r in train_times(name, workdir, card,
                                     args.profile,
                                     "kernels" in args.parts)]
    if "hessian" in args.parts:
        rows += [hessian_times(card, name) for name in ("sf", "grap")]
    for row in rows:
        print(json.dumps({"root": str(root), "card": card, **row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
