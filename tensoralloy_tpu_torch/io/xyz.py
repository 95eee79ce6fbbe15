"""STEPMAX-format XYZ files (reference `tensoralloy/io/xyz.py`):
comment line = "<energy/Hartree> a b c alpha beta gamma Cartesian"."""
from __future__ import annotations

import numpy as np

from ..atoms import Structure
from ..elements import atomic_numbers
from .cif import cellpar_to_cell
from .units import get_conversion_factor

HARTREE = get_conversion_factor("Hartree")


def read_stepmax_xyz(path: str) -> Structure:
    with open(path) as fh:
        natoms = int(fh.readline())
        tokens = fh.readline().split()
        assert tokens[-1].lower() == "cartesian"
        energy = float(tokens[0]) * HARTREE
        cellpars = [float(x) for x in tokens[1:7]]
        # reference stores the transpose of the cellpar matrix
        cell = cellpar_to_cell(*cellpars).T
        symbols, positions = [], []
        for _ in range(natoms):
            row = fh.readline().split()
            symbols.append(row[0])
            positions.append([float(x) for x in row[1:4]])
    numbers = np.array([atomic_numbers[s] for s in symbols], np.int32)
    return Structure(numbers, np.asarray(positions), cell,
                     np.array([True] * 3), info={"energy": energy})


def _cell_to_cellpar(cell: np.ndarray) -> np.ndarray:
    lengths = np.linalg.norm(cell, axis=1)
    angles = []
    for i, (j, k) in enumerate([(1, 2), (0, 2), (0, 1)]):
        cosv = np.dot(cell[j], cell[k]) / (lengths[j] * lengths[k])
        angles.append(np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0))))
    return np.concatenate([lengths, angles])


def write_stepmax_xyz(path: str, structure: Structure,
                      energy: float = None):
    e = energy if energy is not None else (structure.energy or 0.0)
    cellpars = _cell_to_cellpar(structure.cell.T)
    with open(path, "w") as fh:
        fh.write(f"{len(structure)}\n")
        fh.write(f"{e / HARTREE} " +
                 " ".join(f"{v: 10.6f}" for v in cellpars) +
                 "  Cartesian\n")
        for sym, pos in zip(structure.symbols, structure.positions):
            fh.write(f"{sym:2s} {pos[0]: 10.6f} {pos[1]: 10.6f} "
                     f"{pos[2]: 10.6f}\n")
