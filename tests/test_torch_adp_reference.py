"""The port's ML-ADP Mo against the benchmark's plain reference
(`portbench/reference/adp.py`), which reads nothing of the port.

At float64 on small jittered bcc Mo cells (3^3 and 4^3 conventional
cells, one 3^3 cell strained), under the trained parameters and two
seeded sets with every parameter scaled by (1 + 0.05 N(0, 1)): the
analytic fast EFS and the flat autograd route give the reference's
energy, forces and virial, and a 5-step BAOAB chunk of
`VelocityVerlet(device_nl=True)` gives its positions and velocities
from the same state and noise generator. The reference's functions are
the model's own setfl table (`snap_Mo_mladp_gw.adp`, written when the
model was trained) to the table's float32 rounding, evidence apart from
the port that the reference follows the forms. `fast_efs.pass_counts`
counts one a pass, by the model's tag, and nothing on the autograd
route.
"""
from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lattice import jittered_bcc
from portbench.reference import adp as ref_adp
from portbench.reference import md as ref_md
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.dynamics import VelocityVerlet
from tensoralloy_tpu_torch.io.lammps import read_adp_setfl
from tensoralloy_tpu_torch.io.model import load_model
from tensoralloy_tpu_torch.nn.eam import fast_efs, models
from tensoralloy_tpu_torch.transform.featurizer import Featurizer

ROOT = Path(__file__).resolve().parent.parent
NPZ = ROOT / "artifacts" / "mladp_mo_v5" / "model" / "snap_Mo_mladp_gw.npz"
A = 3.1467
RCUT = 6.5
REL = 1e-10
# a strain of the 3^3 cell: stretched, sheared and shrunk
STRAIN = np.array([[1.02, 0.01, 0.0], [0.0, 0.99, 0.015], [0.0, 0.0, 1.01]])
CELLS = {"bcc3": (3, None), "bcc4": (4, None), "bcc3_strained": (3, STRAIN)}
PARAMS = ("trained", "scaled7", "scaled8")
EPS32 = float(np.finfo(np.float32).eps)
# the table's gap, in float32 epsilons of the function's largest size
# on the grid: 7.0 at most (phi) under the trained parameters; one
# parameter changed by 1e-5 of itself reads 23 or more
TABLE_EPS = 12.0
# the table is compared from here up: no Mo pair comes this close, and
# below it phi grows to 466 eV at r = 0
TABLE_R_MIN = 1.5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """{name: the path of a saved model}: the trained file and two copies
    with every parameter scaled by (1 + 0.05 N(0, 1)) from a seed."""
    out = {"trained": str(NPZ)}
    with np.load(NPZ) as z:
        flat = {k: z[k] for k in z.files}
    root = tmp_path_factory.mktemp("adp_weights")
    for name in PARAMS[1:]:
        rng = np.random.RandomState(int(name[len("scaled"):]))
        scaled = {k: (v if k == "__config__" else
                      (v * (1.0 + 0.05 * rng.normal(size=v.shape))
                       ).astype(v.dtype))
                  for k, v in sorted(flat.items())}
        path = root / f"{name}.npz"
        np.savez(path, **scaled)
        out[name] = str(path)
    return out


def _structure(cell_name: str, seed: int = 17):
    reps, strain = CELLS[cell_name]
    pos, cell = jittered_bcc(reps, A, 0.05, seed)
    if strain is not None:
        pos, cell = pos @ strain, cell @ strain
    return Structure.from_symbols(["Mo"] * len(pos), pos, cell,
                                  pbc=[True] * 3)


def _reference(path: str, cell) -> ref_adp.Cell:
    return ref_adp.Cell(ref_adp.params_from_npz(path, "Mo"), RCUT,
                        torch.as_tensor(cell, dtype=torch.float64))


def _voigt(w: np.ndarray) -> np.ndarray:
    return np.array([w[0, 0], w[1, 1], w[2, 2], w[1, 2], w[0, 2], w[0, 1]])


@pytest.mark.parametrize("route", ("fast", "flat"))
@pytest.mark.parametrize("cell_name", sorted(CELLS))
@pytest.mark.parametrize("params", PARAMS)
def test_energy_forces_virial_agree_with_the_reference(weights, params,
                                                       cell_name, route):
    s = _structure(cell_name)
    energy, forces, virial = _reference(weights[params], s.cell).evaluate(
        torch.as_tensor(s.positions, dtype=torch.float64))
    model, _ = load_model(weights[params], device="cpu", dtype="high")
    calc = TensorAlloyCalculator(model, device="cpu", dtype="high",
                                 fast_efs=route == "fast")
    out = calc.calculate(s)
    volume = abs(np.linalg.det(s.cell))
    assert _rel(out["energy"], float(energy)) <= REL
    assert _rel(out["forces"], forces.numpy()) <= REL
    assert _rel(out["stress"] * volume, _voigt(virial.numpy())) <= REL


@pytest.mark.parametrize("params", PARAMS)
def test_a_baoab_chunk_agrees_with_the_reference(weights, params):
    """5 BAOAB steps at 300 K of the strained 3^3 cell on the device list
    and the fast route, and the reference's, from the same positions,
    velocities and generator state."""
    s = _structure("bcc3_strained", seed=23)
    model, _ = load_model(weights[params], device="cpu", dtype="high")
    md = VelocityVerlet(model, s, timestep=1.0, skin=1.0, chunk_size=5,
                        temperature=300.0, seed=9, target_temperature=300.0,
                        friction=0.01, device_nl=True)
    assert md._fast_fn is not None
    rows = torch.as_tensor(md.vap.local_to_vap.astype(np.int64))
    pos0 = md._tensor(md.vap.map_positions(s.positions))[rows]
    vel0 = md._tensor(md.velocities_vap)[rows]
    gen = torch.Generator()
    gen.set_state(md._gen.get_state())
    md.run(5)
    masses = torch.as_tensor(s.masses, dtype=torch.float64)
    pos, vel, _ = ref_md.baoab_chunk(
        _reference(weights[params], s.cell), pos0, vel0, masses, 5, 1.0,
        300.0, 0.01, gen, int(md.model.n_atoms_vap), rows)
    assert _rel(md.structure.positions, pos.numpy()) <= REL
    assert _rel(md.velocities_vap[md.vap.local_to_vap], vel.numpy()) <= REL


@pytest.fixture(scope="module")
def table():
    return read_adp_setfl(str(NPZ.with_suffix(".adp")))


def _table_gap(table, name: str, params: dict) -> float:
    """The reference's largest gap from the table's column `name`, in
    float32 epsilons of the function's largest size there."""
    zjw, mishin = params[ref_adp.ZJW], params[ref_adp.MISHIN]
    near = table.r_grid >= TABLE_R_MIN
    fn, x, want, sel = {
        "F": (ref_adp.embedding, table.rho_grid, table.frho["Mo"],
              np.ones(table.nrho, bool)),
        "rho": (ref_adp.density, table.r_grid, table.rho["Mo"], near),
        "phi": (ref_adp.pair, table.r_grid, table.phi["MoMo"], near),
        "u": (ref_adp.dipole, table.r_grid, table.dipole["MoMo"], near),
        "w": (ref_adp.quadrupole, table.r_grid, table.quadrupole["MoMo"],
              near)}[name]
    got = fn(torch.as_tensor(x), mishin if name in ("u", "w") else zjw)
    got, want = got.numpy()[sel], want[sel]
    return float(np.max(np.abs(got - want)) / np.max(np.abs(got)) / EPS32)


@pytest.mark.parametrize("name", ("F", "rho", "phi", "u", "w"))
def test_the_reference_gives_the_models_setfl_table(table, name):
    """rho, phi, u and w on the table's r grid from 1.5 A up, F on its
    rho grid; the reader gives phi from the table's r phi."""
    params = ref_adp.params_from_npz(str(NPZ), "Mo")
    assert table.cutoff == RCUT
    assert _table_gap(table, name, params) <= TABLE_EPS


@pytest.mark.parametrize("name, group, key", (
    ("rho", ref_adp.ZJW, "beta"), ("phi", ref_adp.ZJW, "alpha"),
    ("w", ref_adp.MISHIN, "q2")))
def test_the_table_comparison_sees_a_parameter_changed(table, name, group,
                                                        key):
    """The same comparison with one parameter 1e-5 of itself away fails:
    the tolerance is the table's rounding, not the forms' slack."""
    params = ref_adp.params_from_npz(str(NPZ), "Mo")
    params[group] = dict(params[group], **{key: params[group][key]
                                           * (1.0 + 1e-5)})
    assert _table_gap(table, name, params) > TABLE_EPS


def _model(tag: str):
    """A one-element EAM model of the tag with analytic functions."""
    if tag == "adp":
        return load_model(str(NPZ), device="cpu", dtype="high")[0]
    custom = {"alloy": {"Mo": {"rho": "zjw04xc", "embed": "zjw04xc"},
                        "MoMo": {"phi": "zjw04xc"}},
              "fs": {"Mo": {"embed": "zjw04xc"},
                     "MoMo": {"rho": "zjw04xc", "phi": "zjw04xc"}}}[tag]
    cls = {"alloy": models.EamAlloyNN, "fs": models.EamFsNN}[tag]
    return cls(Featurizer(["Mo"], RCUT), Counter(Mo=64),
               custom_potentials=custom, dtype=torch.float64)


@pytest.mark.parametrize("tag, route, want", (
    ("adp", "fast", 2), ("alloy", "fast", 2), ("fs", "fast", 2),
    ("adp", "flat", 0), ("adp", "md", 3 * (4 + 2))))
def test_pass_counts(tag, route, want):
    """Two calculator requests on the fast route count two passes of the
    model's tag and none of another; the autograd route counts none; MD
    runs a chunk's start, its steps and its end (3 chunks of 4 steps)."""
    s = _structure("bcc3")
    model = _model(tag)
    fast_efs.reset_pass_counts()
    if route == "md":
        VelocityVerlet(model, s, chunk_size=4, temperature=300.0,
                       device_nl=True).run(12)
    else:
        calc = TensorAlloyCalculator(model, device="cpu", dtype="high",
                                     fast_efs=route == "fast")
        calc.calculate(s)
        moved = s.copy()
        moved.positions = s.positions + 0.01
        calc.calculate(moved)
    assert fast_efs.pass_counts == {k: want if k == tag else 0
                                    for k in ("alloy", "fs", "adp")}
