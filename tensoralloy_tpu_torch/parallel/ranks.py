"""The work each rank does under `parallel.mesh.launch`: the sharded
routes driven end to end from plain arguments, for the tests, the dry
run and `chip_smoke.py`.

Each function takes one picklable `spec` dict (models by file path,
structures, numpy arrays), runs in a rank of the current group or in a
process alone (a mesh of one rank: the unsharded reference), and returns
numbers, numpy arrays and the descriptor kernels' launch counts of its
own process. Times are host-clock milliseconds of work ended by a
device synchronize.
"""
from __future__ import annotations

import contextlib
import io
import os
import time
from typing import Dict

import numpy as np
import torch

from ..ops import fused


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timed(fn, device, reps: int):
    """(the last result of `fn()`, the milliseconds of each call)."""
    out, ms = None, []
    for _ in range(max(int(reps), 1)):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def _load(spec):
    from ..io.model import load_model
    return load_model(spec["model"], device=spec["device"],
                      dtype=spec.get("dtype", "high"),
                      backend=spec.get("backend"))[0]


def train_steps(spec) -> Dict:
    """Data-parallel train steps: a `Trainer(n_devices)` over the model
    file `spec["model"]` from `spec["params"]` (its saved weights where
    None), one step on each (features, labels) of `spec["batches"]` (the
    global batches, numpy). Keys: loss_parameters, opt_parameters,
    train_parameters, minimize_properties, n_devices (None: the group),
    device, dtype, backend. -> losses, the last step's metrics, the
    parameters and EMA after the last step, step_ms, allreduce_ms (in a
    group: the median all-reduce of one parameter set, what a step's
    gradient sum moves), launches, ranks."""
    from ..train.trainer import Trainer
    from ..utils import tree_flatten
    from .collectives import all_reduce_many
    model = _load(spec)
    trainer = Trainer(model, spec["loss_parameters"],
                      spec["opt_parameters"], spec["train_parameters"],
                      minimize_properties=spec["minimize_properties"],
                      n_devices=spec.get("n_devices"),
                      device=spec["device"], dtype=spec.get("dtype", "high"))
    params = spec.get("params")
    state = trainer.init_state(model.param_tree() if params is None
                               else params)
    batches = [(trainer._to_device(f), trainer._to_device(lab))
               for f, lab in spec["batches"]]
    fused.reset_launch_counts()
    losses, ms, metrics = [], [], {}
    for bf, bl in batches:
        _sync(spec["device"])
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, bf, bl)
        _sync(spec["device"])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss/total"]))
    launches = dict(fused.launch_counts)
    allreduce_ms = None
    if trainer.mesh.group is not None:
        # what a step's gradient all-reduce moves: one parameter set
        leaves = list(tree_flatten(state["params"]).values())
        allreduce_ms = float(np.median(_timed(
            lambda: all_reduce_many(leaves, trainer.mesh),
            spec["device"], 5)[1]))
    return {"losses": losses,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": state["params"], "ema": state["ema_params"],
            "step_ms": ms, "allreduce_ms": allreduce_ms,
            "launches": launches, "ranks": trainer.mesh.size}


def _spatial_inputs(spec, model):
    """(model, features as tensors) of `spec`: its numpy "features", or
    its "structure" featurized as the calculator routes it (the device
    builder from 8192 atoms)."""
    from ..calculator import TensorAlloyCalculator
    from ..train.dataset import to_tensors
    if "features" in spec:
        return model, to_tensors(spec["features"], spec["device"],
                                 spec.get("dtype", "high"))
    s = spec["structure"]
    calc = TensorAlloyCalculator(model, device=spec["device"],
                                 dtype=spec.get("dtype", "high"),
                                 fast_efs=spec["route"] == "fast")
    vap = calc._get_vap(s)
    use_device = calc._use_device_nl(s)
    model = calc._get_variant(s, use_device)[0]
    feats = (calc.featurize_device(s, vap) if use_device
             else calc.featurize(s, vap))
    return model, feats


def spatial_efs(spec) -> Dict:
    """E/F/S of one structure with its pairs ("segment": the flat pair
    and triple arrays, autograd) or its dense neighbor columns ("fast":
    the EAM family's analytic EFS) split over `spec["n_shards"]` ranks
    (None: the group). Keys: model, route, features or structure, reps,
    device, dtype, backend. -> energy, forces (VAP rows), virial,
    stress_voigt, ms of each repeat, launches, ranks."""
    from .mesh import make_mesh
    from .spatial import (make_spatial_efs_fn, make_spatial_fast_efs_fn,
                          shard_features_spatial,
                          shard_features_spatial_dense)
    model, feats = _spatial_inputs(spec, _load(spec))
    mesh = make_mesh(spec.get("n_shards"), axis_name="pairs")
    if spec["route"] == "fast":
        local = shard_features_spatial_dense(feats, mesh)
        fn = make_spatial_fast_efs_fn(model, mesh)
    else:
        local = shard_features_spatial(feats, mesh)
        fn = make_spatial_efs_fn(model.energy, mesh)
    fused.reset_launch_counts()
    out, ms = _timed(lambda: fn(None, local), spec["device"],
                     spec.get("reps", 1))
    return {"energy": float(out["energy"]), "forces": out["forces"],
            "virial": out["virial"], "stress_voigt": out["stress_voigt"],
            "ms": ms, "launches": dict(fused.launch_counts),
            "ranks": mesh.size}


def neb_band(spec) -> Dict:
    """An NEB band with its replicas split over `spec["n_shards"]` ranks
    (1: the unsharded band). Keys: model, initial, final, n_images,
    n_shards, steps (FIRE steps, in chunks of chunk_size), k, climb,
    fmax, device, dtype, backend. -> the run's result, the band's
    positions, seconds, band evaluations, launches."""
    from ..neb import NEB
    neb = NEB(_load(spec), spec["initial"], spec["final"],
              n_images=spec["n_images"], k=spec.get("k", 5.0),
              climb=spec.get("climb", True),
              chunk_size=spec.get("chunk_size", 25),
              n_shards=spec.get("n_shards", 1))
    fused.reset_launch_counts()
    res, ms = _timed(lambda: neb.run(fmax=spec.get("fmax", 1e-9),
                                     max_steps=spec["steps"]),
                     spec["device"], 1)
    return {"result": res, "positions": neb.positions, "ms": ms[0],
            "evaluations": neb.n_evaluations,
            "launches": dict(fused.launch_counts)}


def committee(spec) -> Dict:
    """One request of a committee of the model files `spec["members"]`
    split over `spec["n_shards"]` ranks (1: unsharded). Keys: members,
    structure, n_shards, reps, chunked, chunk_size, device, dtype,
    backend. -> the calculator's results (mean and spread), ms of each
    repeat, launches."""
    from ..ensemble import EnsembleCalculator
    calc = EnsembleCalculator(
        [str(p) for p in spec["members"]], n_shards=spec.get("n_shards", 1),
        device=spec["device"], dtype=spec.get("dtype", "high"),
        backend=spec.get("backend"), chunked=spec.get("chunked", "auto"),
        chunk_size=spec.get("chunk_size", 0))
    fused.reset_launch_counts()
    res, ms = _timed(lambda: calc.calculate(spec["structure"]),
                     spec["device"], spec.get("reps", 1))
    return {"results": res, "ms": ms, "launches": dict(fused.launch_counts)}


def manager_run(spec) -> Dict:
    """`TrainingManager(spec["config"])` (an input file or its dict) on
    `spec["device"]`: train_and_evaluate, then export. -> the loss of
    every step, the final parameters and EMA, the exported path, the
    history and the mesh's size."""
    from ..train.manager import TrainingManager
    manager = TrainingManager(spec["config"], device=spec["device"])
    losses = []
    fit = manager.trainer.fit

    def recorded(*args, callback=None, **kwargs):
        def record(step, state, metrics):
            losses.append(float(metrics["loss/total"]))
            if callback is not None:
                callback(step, state, metrics)
        return fit(*args, callback=record, **kwargs)

    manager.trainer.fit = recorded
    result = manager.train_and_evaluate(verbose=False)
    return {"losses": losses, "params": result["state"]["params"],
            "ema": result["state"]["ema_params"], "path": manager.export(),
            "history": result["history"], "ranks": manager.mesh.size}


def cli(spec) -> Dict:
    """`python -m tensoralloy_tpu_torch.cli` in this rank: `main(
    spec["argv"], device=..., dtype=...)` run in `spec["cwd"]`. -> the
    exit code and what it printed on stdout."""
    from ..cli.entry import main
    out = io.StringIO()
    here = os.getcwd()
    os.chdir(spec["cwd"])
    try:
        with contextlib.redirect_stdout(out):
            rc = main(spec["argv"], device=spec["device"],
                      dtype=spec.get("dtype"))
    finally:
        os.chdir(here)
    return {"rc": rc, "stdout": out.getvalue()}


def run_all(calls):
    """[(rank function of this module, spec)] -> their results in order:
    several cases in one launch."""
    return [fn(spec) for fn, spec in calls]


def all_equal(results, keys) -> bool:
    """Whether every rank returned the same `keys` (bit for bit)."""
    first = results[0]
    return all(np.array_equal(np.asarray(r[k]), np.asarray(first[k]))
               for r in results[1:] for k in keys)
