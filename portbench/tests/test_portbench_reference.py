"""The plain reference held to the program at small sizes on the CPU, in
float64: the blocked neighbour search against a loop over images, GRAP
and symmetry-function energies and forces (descriptors, heads and
autograd) against the port's calculator, and the reference's
Maxwell-Boltzmann draw against the port's. The loss, Adam and the EMA,
and BAOAB, are held to the port by the sound runs of
test_portbench_faults.py."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import asedb, grap, md, mlp, neighbors, sf
from portbench.tests.conftest import CONFIGS, ROOT
from portbench.common import load_json

GRAP_NPZ = ROOT / "artifacts" / "snap_ni_v5_readapt" / "model" / "snap_Ni.npz"
SF_NPZ = ROOT / "artifacts" / "snap_ni_sfa" / "model" / "snap_Ni_sfa.npz"
DB = ROOT / "artifacts" / "snap_ni" / "snap-Ni.db"


def _loop_pairs(pos, cell, cutoff):
    """Every (i, j, image) within the cutoff, by a loop over images."""
    out = set()
    reach = [int(np.ceil(cutoff / h))
             for h in neighbors.heights(torch.as_tensor(cell)).tolist()]
    for n in itertools.product(*[range(-m, m + 1) for m in reach]):
        shift = np.asarray(n, float) @ cell
        d = pos[None, :, :] + shift - pos[:, None, :]
        r = np.linalg.norm(d, axis=-1)
        for i, j in zip(*np.nonzero(r < cutoff)):
            if i != j or any(n):
                out.add((int(i), int(j)) + tuple(int(x) for x in n))
    return out


@pytest.mark.parametrize("reps", [2, 4])
def test_neighbour_search(reps):
    """Images within reach at 2^3 cells (7.04 A), the minimum image at
    4^3 (14.08 A)."""
    pos, cell = generate.jittered_fcc(reps, 3.52, 0.05, 7)
    i, j, s = neighbors.pairs(torch.as_tensor(pos), torch.as_tensor(cell),
                              6.0)
    got = {(a, b) + tuple(int(x) for x in n)
           for a, b, n in zip(i.tolist(), j.tolist(), s.tolist())}
    assert len(got) == len(i)
    assert got == _loop_pairs(pos, cell, 6.0)
    assert torch.all(i[1:] >= i[:-1])


def _calculator(path):
    from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
    return TensorAlloyCalculator(str(path), device="cpu", dtype="high",
                                 backend="dense", device_nl=False)


def _structure(pos, cell):
    from tensoralloy_tpu_torch.atoms import Structure
    return Structure.from_symbols(["Ni"] * len(pos), pos, cell,
                                  pbc=[True] * 3)


def test_grap_energy_and_forces():
    config = load_json(CONFIGS / "grap_ni_pexp16_m5.json")
    pos, cell = generate.jittered_fcc(3, 3.52, 0.1, 3)
    want = _calculator(GRAP_NPZ).calculate(_structure(pos, cell))
    layers, xlo, xhi = md.heads_from_npz(str(GRAP_NPZ), "Ni", torch.float64,
                                         "cpu")
    potential = md.Cell(config, layers, xlo, xhi, torch.as_tensor(cell),
                            margin=0.5, block=50)
    energy, forces = potential.energy_forces(torch.as_tensor(pos))
    assert float(energy) == pytest.approx(float(want["energy"]), rel=1e-12)
    np.testing.assert_allclose(forces.numpy(), want["forces"], rtol=0,
                               atol=1e-12)


def test_sf_energy_and_forces():
    """The trained snap_Ni_sfa model on three database rows (6 to 108
    atoms)."""
    config = load_json(CONFIGS / "sf_ni_g2g4_acut4.json")
    calc = _calculator(SF_NPZ)
    layers, xlo, xhi = md.heads_from_npz(str(SF_NPZ), "Ni", torch.float64,
                                         "cpu")
    rows = asedb.read(str(DB))
    picks = sorted(range(len(rows)), key=lambda k: len(rows[k]["numbers"]))
    for k in (picks[0], picks[len(picks) // 2], picks[-1]):
        row = rows[k]
        want = calc.calculate(_structure(row["positions"], row["cell"]))
        pos = torch.tensor(row["positions"], requires_grad=True)
        cell = torch.tensor(row["cell"])
        i, j, s = neighbors.pairs(pos, cell, config["rcut"])
        vec, mask = neighbors.rows(neighbors.vectors(pos, cell, i, j, s), i,
                                   len(pos))
        g = sf.descriptors(vec, mask, config)
        energy = mlp.energies(mlp.scale(g, xlo, xhi), layers).sum()
        (grad,) = torch.autograd.grad(energy, pos)
        assert float(energy.detach()) == pytest.approx(
            float(want["energy"]), rel=1e-12)
        # float64 rounding of sums of terms of about 1 eV/A
        np.testing.assert_allclose(-grad.numpy(), want["forces"], rtol=0,
                                   atol=1e-12)


def test_grap_invariants_at_a_known_point():
    """One neighbour along x at r = 2: P is H_k(2) on the monomials that
    are powers of x and 0 on the others, so Q_m = H_k(2)^2 and
    G_0 = sqrt(H_k(2)^2 + 1e-16)."""
    config = load_json(CONFIGS / "grap_ni_pexp16_m5.json")
    vec = torch.tensor([[[2.0, 0.0, 0.0]]], dtype=torch.float64)
    g = grap.descriptors(vec, torch.ones((1, 1), dtype=torch.bool), config)
    rl, pl = np.asarray(config["rl"]), np.asarray(config["pl"])
    h = np.exp(-(2.0 / rl) ** pl) * 0.5 * (np.cos(np.pi * 2.0 / 6.0) + 1.0)
    want = np.stack([np.sqrt(h * h + 1e-16)] + [h * h] * 5,
                    axis=1).reshape(-1)
    np.testing.assert_allclose(g.numpy()[0], want, rtol=1e-12, atol=1e-300)


def test_maxwell_boltzmann_is_the_ports():
    from tensoralloy_tpu_torch.dynamics import maxwell_boltzmann_velocities
    masses = np.full(40, 58.693)
    seed = generate.legacy_seed(2 ** 31 + 99)
    np.testing.assert_array_equal(
        md.maxwell_boltzmann(masses, 300.0, seed),
        maxwell_boltzmann_velocities(masses, 300.0, seed))


def test_sf_cell_energy_and_forces():
    """The MD reference's cell on a symmetry-function model: the trained
    snap_Ni_sfa model on a jittered 3^3 fcc cell, its list skinned."""
    config = load_json(CONFIGS / "sf_ni_g2g4_acut4.json")
    pos, cell = generate.jittered_fcc(3, 3.52, 0.1, 5)
    want = _calculator(SF_NPZ).calculate(_structure(pos, cell))
    layers, xlo, xhi = md.heads_from_npz(str(SF_NPZ), "Ni", torch.float64,
                                         "cpu")
    potential = md.Cell(config, layers, xlo, xhi, torch.as_tensor(cell),
                        margin=1.0, block=40)
    energy, forces = potential.energy_forces(torch.as_tensor(pos))
    assert float(energy) == pytest.approx(float(want["energy"]), rel=1e-12)
    np.testing.assert_allclose(forces.numpy(), want["forces"], rtol=0,
                               atol=1e-12)
