"""The multi-rank dry run (port of `__graft_entry__.dryrun_multichip`).

`dryrun_multichip(n)` launches n ranks and runs the four parallel modes
of the JAX dry run on its structures, in float64: (1) a data-parallel
train step of an angular SF AtomicNN, (2) its energy with the pair axis
split (spatial EFS, flat layout) and the fast dense EAM EFS with the
neighbor columns split, (3) an NEB band step with the replicas split,
(4) a committee request with the members split.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict

import numpy as np
import torch


def make_model_and_features(n_atoms: int = 32, angular: bool = True,
                            seed: int = 0, dtype=torch.float64):
    """The JAX dry run's model and structure: an angular SF AtomicNN
    (hidden [64, 32], no min/max scaling) on a rattled fcc Ni box, with
    its features in both layouts (numpy)."""
    from ..atoms import Structure
    from ..nn.atomic import AtomicNN
    from ..nn.sf import SymmetryFunction
    from ..transform.featurizer import Featurizer

    rng = np.random.RandomState(seed)
    n_cell = max(2, int(round(n_atoms ** (1 / 3) / 4 ** (1 / 3))))
    a0 = 3.52
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                     [0, 0.5, 0.5]])
    frac = np.concatenate([base + np.array([i, j, k])
                           for i in range(n_cell)
                           for j in range(n_cell)
                           for k in range(n_cell)])
    cell = np.eye(3) * a0 * n_cell
    pos = frac * a0 + rng.normal(scale=0.05, size=(len(frac), 3))
    s = Structure.from_symbols(["Ni"] * len(frac), pos, cell,
                               pbc=[True] * 3)
    fz = Featurizer(["Ni"], rcut=4.5, angular=angular)
    model = AtomicNN(fz, Counter({"Ni": len(s)}), SymmetryFunction(["Ni"]),
                     hidden_sizes=[64, 32], minmax_scale=False, dtype=dtype)
    feats = fz.featurize(s, fz.make_vap(s, model.max_occurs), layout="both")
    return model, feats


def eam_cell():
    """The JAX dry run's fast-EFS cell: 8 Ni atoms in a 7.04 x 3.52 x
    3.52 box."""
    from ..atoms import Structure
    frac = np.concatenate([np.array([[0, 0, 0], [.5, .5, 0],
                                     [.5, 0, .5], [0, .5, .5]]) + o
                           for o in ([0, 0, 0], [1, 0, 0])]) \
        * np.array([0.5, 1.0, 1.0])
    cell = np.diag([7.04, 3.52, 3.52])
    return Structure.from_symbols(["Ni"] * 8, frac @ cell, cell,
                                  pbc=[True] * 3)


def vacancy_hop(a0: float = 3.52, reps: int = 2):
    """The JAX dry run's NEB endpoints: fcc Ni with site 0 empty, and
    its nearest neighbor moved into it."""
    from ..atoms import Structure
    base = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0],
                     [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    frac = np.concatenate([base + np.array([i, j, k])
                           for i in range(reps) for j in range(reps)
                           for k in range(reps)]) / reps
    cell = np.eye(3) * a0 * reps
    pos = (frac @ cell)[1:]
    d = pos.copy()
    f2 = d @ np.linalg.inv(cell)
    d = (f2 - np.round(f2)) @ cell
    hop = int(np.argmin(np.linalg.norm(d, axis=1)))
    pos_f = pos.copy()
    pos_f[hop] = pos[hop] - d[hop]
    syms = ["Ni"] * len(pos)
    return (Structure.from_symbols(syms, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(syms, pos_f, cell, pbc=[True] * 3))


def dryrun_rank(n: int, device="cuda", shards: int = None,
                params: Dict = None) -> Dict:
    """The four modes at the dry run's sizes for `n` ranks (a batch of
    2n, 2n NEB images, max(n, 2) committee members), split over
    `shards` ranks (default n; 1: in this process alone, the unsharded
    reference). `params` are the AtomicNN's (a tree; default drawn from
    `torch.Generator().manual_seed(0)`). -> the summary's numbers and
    the launch counts."""
    from ..ensemble import EnsembleCalculator
    from ..neb import NEB
    from ..nn import losses as L
    from ..nn.eam.models import EamAlloyNN
    from ..ops import fused
    from ..train.dataset import to_tensors
    from ..train.trainer import OptParameters, TrainParameters, Trainer
    from ..transform.featurizer import Featurizer
    from .mesh import make_mesh
    from .spatial import (make_spatial_efs_fn, make_spatial_fast_efs_fn,
                          shard_features_spatial,
                          shard_features_spatial_dense)

    shards = n if shards is None else shards
    fused.reset_launch_counts()
    model, feats = make_model_and_features(n_atoms=8, angular=True)
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    trainer = Trainer(model, L.LossParameters(),
                      OptParameters(learning_rate=1e-3),
                      TrainParameters(batch_size=2 * n, train_steps=1),
                      minimize_properties=("energy", "forces", "stress"),
                      n_devices=shards, device=device, dtype="high")
    b = 2 * n
    n_vap = model.n_atoms_vap
    batch_feats = {k: np.stack([v] * b) for k, v in feats.items()}
    labels = {"energy": np.zeros(b), "n_atoms": np.full(b, n_vap - 1.0),
              "forces": np.zeros((b, n_vap, 3)), "stress": np.zeros((b, 6)),
              "has_stress": np.ones(b), "weights": np.ones((b, 3))}
    state = trainer.init_state(params)
    new_state, metrics = trainer.train_step(
        state, trainer._to_device(batch_feats), trainer._to_device(labels))

    # spatial: the same energy with this structure's pairs split
    sp_mesh = make_mesh(shards, axis_name="pairs")
    sp_feats = to_tensors(shard_features_spatial(feats, sp_mesh), device,
                          "high")
    sp_out = make_spatial_efs_fn(model.energy, sp_mesh)(
        new_state["params"], sp_feats)

    # the fast dense EAM EFS with the neighbor columns split
    s = eam_cell()
    fz = Featurizer(["Ni"], rcut=6.0)
    eam = EamAlloyNN(fz, Counter({"Ni": 8}), custom_potentials="zjw04",
                     device=device, dtype=torch.float64)
    dense = fz.featurize(s, fz.make_vap(s, eam.max_occurs), layout="dense")
    fast_out = make_spatial_fast_efs_fn(eam, sp_mesh)(None, to_tensors(
        shard_features_spatial_dense(dense, sp_mesh), device, "high"))

    # NEB with the replicas split
    s_i, s_f = vacancy_hop()
    neb_model = EamAlloyNN(Featurizer(["Ni"], rcut=6.0),
                           Counter(s_i.symbols), custom_potentials="zjw04",
                           device=device, dtype=torch.float64)
    neb = NEB(neb_model, s_i, s_f, n_images=2 * n, k=5.0,
              chunk_size=2 * n, n_shards=shards)
    neb_res = neb.run(fmax=1e-9, max_steps=2)

    # a committee with the members split
    members = [EamAlloyNN(Featurizer(["Ni"], rcut=6.0),
                          Counter(s_i.symbols), custom_potentials="zjw04",
                          device=device, dtype=torch.float64)
               for _ in range(max(n, 2))]
    ens = EnsembleCalculator(members, n_shards=shards, device=device,
                             dtype="high")
    return {"loss": float(metrics["loss/total"]),
            "spatial_E": float(sp_out["energy"]),
            "spatial_forces": sp_out["forces"],
            "fast_spatial_E": float(fast_out["energy"]),
            "fast_forces": fast_out["forces"],
            "neb_fmax": float(neb_res["fmax"]),
            "neb_energies": neb_res["energies"],
            "ensemble_E": float(ens.get_potential_energy(s_i)),
            "ensemble_std": float(ens.get_energy_std(s_i)),
            "params": new_state["params"],
            "launches": dict(fused.launch_counts)}


def summary(n: int, out: Dict) -> str:
    """The JAX dry run's summary line."""
    return (f"dryrun_multichip({n}): loss={out['loss']:.6f} "
            f"spatial_E={out['spatial_E']:.6f} "
            f"fast_spatial_E={out['fast_spatial_E']:.4f} "
            f"neb_fmax={out['neb_fmax']:.4f} "
            f"ensemble_E={out['ensemble_E']:.4f}+-{out['ensemble_std']:.4f} "
            f"[dp+spatial(seg+fast_dense)+neb_replica+ensemble_member] ok")


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 900.0) -> Dict:
    """Launch `n_devices` ranks (`parallel.mesh.launch`: gloo on the CPU,
    NCCL with a card per rank, gloo where ranks share a card), run the
    four modes, check that every rank agrees, print the JAX dry run's
    summary line and return rank 0's numbers."""
    from .mesh import launch
    results = launch(dryrun_rank, n_devices, n_devices, str(device),
                     device=device, timeout=timeout)
    keys = ("loss", "spatial_E", "spatial_forces", "fast_spatial_E",
            "neb_energies", "ensemble_E", "ensemble_std")
    for r in results[1:]:
        for k in keys:
            if not np.array_equal(np.asarray(r[k]),
                                  np.asarray(results[0][k])):
                raise AssertionError(f"dryrun_multichip: ranks disagree "
                                     f"on {k}")
    print(summary(n_devices, results[0]), flush=True)
    return results[0]
