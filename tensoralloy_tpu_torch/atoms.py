"""Minimal atomic-structure container (the ASE `Atoms` role in the reference).

The reference framework (Bismarrck/tensoralloy) leans on `ase.Atoms` for
structure bookkeeping (`tensoralloy/atoms_utils.py`). ASE is not a
dependency here; `Structure` is a small immutable-ish container carrying
exactly what the MLIP pipeline needs: species, positions, cell, pbc and
per-structure properties (energy, forces, stress, electron temperature /
entropy, sample weights).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from .elements import atomic_numbers, atomic_masses, chemical_symbols


@dataclasses.dataclass
class Structure:
    """An atomic structure with optional reference labels.

    Attributes
    ----------
    numbers : [N] int array of atomic numbers.
    positions : [N, 3] float64 Cartesian coordinates (Angstrom).
    cell : [3, 3] float64 lattice vectors as rows (Angstrom). May be zero
        for isolated molecules (use `ensure_cell` to add vacuum).
    pbc : [3] bool periodic flags.
    info : free-form per-structure scalars/labels:
        energy (eV), free_energy (eV), forces [N,3] (eV/A),
        stress [6] Voigt (eV/A^3), eentropy (eV/K ... stored as eV),
        etemperature (eV, i.e. kT), weight, source.
    """

    numbers: np.ndarray
    positions: np.ndarray
    cell: np.ndarray
    pbc: np.ndarray
    info: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.numbers = np.ascontiguousarray(self.numbers, dtype=np.int32)
        self.positions = np.ascontiguousarray(self.positions, dtype=np.float64)
        self.positions = self.positions.reshape(len(self.numbers), 3)
        if self.cell is None:
            self.cell = np.zeros((3, 3))
        self.cell = np.ascontiguousarray(self.cell, dtype=np.float64)
        self.cell = self.cell.reshape(3, 3)
        if self.pbc is None:
            self.pbc = np.zeros(3, dtype=bool)
        self.pbc = np.ascontiguousarray(self.pbc, dtype=bool).reshape(3)

    # ------------------------------------------------------------------
    @classmethod
    def from_symbols(cls, symbols: List[str], positions, cell=None, pbc=None,
                     **info) -> "Structure":
        numbers = np.array([atomic_numbers[s] for s in symbols], np.int32)
        if pbc is None:
            pbc = np.array([cell is not None] * 3)
        return cls(numbers, np.asarray(positions), cell, np.asarray(pbc),
                   info=dict(info))

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.numbers)

    @property
    def symbols(self) -> List[str]:
        return [chemical_symbols[z] for z in self.numbers]

    @property
    def masses(self) -> np.ndarray:
        return atomic_masses[self.numbers]

    @property
    def formula(self) -> str:
        """Hill-ish reduced formula, elements sorted alphabetically."""
        c = Counter(self.symbols)
        return "".join(f"{e}{c[e]}" for e in sorted(c))

    def count(self) -> Counter:
        return Counter(self.symbols)

    @property
    def volume(self) -> float:
        return float(abs(np.linalg.det(self.cell)))

    def copy(self) -> "Structure":
        return Structure(self.numbers.copy(), self.positions.copy(),
                         self.cell.copy(), self.pbc.copy(),
                         info={k: (v.copy() if isinstance(v, np.ndarray) else v)
                               for k, v in self.info.items()})

    # ------------------------------------------------------------------
    def ensure_cell(self, vacuum: float = 20.0) -> "Structure":
        """Give cell-less molecules a padded orthorhombic box (the reference
        defaults molecules to a >=20 A vacuum cell, `io/read.py:43-187`).

        Partially periodic structures (slabs/wires: some pbc True with a
        degenerate lattice vector on a NON-periodic axis) keep their real
        in-plane lattice vectors and periodicity — only the degenerate
        non-periodic axes get vacuum padding. A degenerate PERIODIC axis
        is an input error."""
        if self.volume > 1e-8:
            return self
        if self.pbc.any():
            out = self.copy()
            span = (self.positions.max(axis=0) -
                    self.positions.min(axis=0)) if len(self) else \
                np.zeros(3)
            for ax in range(3):
                if np.linalg.norm(out.cell[ax]) < 1e-8:
                    if self.pbc[ax]:
                        raise ValueError(
                            f"cell vector {ax} is degenerate but "
                            f"pbc[{ax}] is True")
                    normal = np.cross(out.cell[(ax + 1) % 3],
                                      out.cell[(ax + 2) % 3])
                    if np.linalg.norm(normal) > 1e-8:
                        unit = normal / np.linalg.norm(normal)
                    else:
                        unit = np.zeros(3)
                        unit[ax] = 1.0
                    out.cell[ax] = unit * (span[ax] + 2.0 * vacuum)
            if abs(np.linalg.det(out.cell)) < 1e-8:
                raise ValueError("cell is degenerate beyond padded "
                                 "non-periodic axes")
            return out
        lo = self.positions.min(axis=0)
        hi = self.positions.max(axis=0)
        span = hi - lo + 2.0 * vacuum
        out = self.copy()
        out.cell = np.diag(np.maximum(span, 2.0 * vacuum))
        out.positions = self.positions - lo + vacuum
        out.pbc = np.zeros(3, dtype=bool)
        return out

    def scaled_positions(self) -> np.ndarray:
        return np.linalg.solve(self.cell.T, self.positions.T).T

    def wrap(self) -> "Structure":
        """Wrap atoms into the cell along periodic directions."""
        out = self.copy()
        frac = out.scaled_positions()
        frac[:, self.pbc] %= 1.0
        out.positions = frac @ out.cell
        return out

    def repeat(self, reps) -> "Structure":
        """Build a supercell; `reps` is an int or a length-3 sequence."""
        if np.isscalar(reps):
            reps = (int(reps),) * 3
        n1, n2, n3 = (int(r) for r in reps)
        shifts = np.array([(i, j, k)
                           for i in range(n1)
                           for j in range(n2)
                           for k in range(n3)], dtype=np.float64)
        disp = shifts @ self.cell
        pos = (self.positions[None, :, :] + disp[:, None, :]).reshape(-1, 3)
        numbers = np.tile(self.numbers, len(shifts))
        cell = self.cell * np.array([n1, n2, n3], dtype=np.float64)[:, None]
        return Structure(numbers, pos, cell, self.pbc.copy())

    # -------------------------- label accessors ------------------------
    @property
    def energy(self) -> Optional[float]:
        return self.info.get("energy")

    @property
    def forces(self) -> Optional[np.ndarray]:
        f = self.info.get("forces")
        return None if f is None else np.asarray(f, dtype=np.float64)

    @property
    def stress(self) -> Optional[np.ndarray]:
        """Voigt [xx, yy, zz, yz, xz, xy] stress in eV/A^3."""
        s = self.info.get("stress")
        if s is None:
            return None
        s = np.asarray(s, dtype=np.float64)
        if s.shape == (3, 3):
            s = full_3x3_to_voigt(s)
        return s


def full_3x3_to_voigt(s: np.ndarray) -> np.ndarray:
    """[3,3] symmetric tensor -> Voigt [xx, yy, zz, yz, xz, xy]."""
    s = np.asarray(s)
    return np.array([s[0, 0], s[1, 1], s[2, 2],
                     0.5 * (s[1, 2] + s[2, 1]),
                     0.5 * (s[0, 2] + s[2, 0]),
                     0.5 * (s[0, 1] + s[1, 0])])


def voigt_to_full_3x3(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v)
    return np.array([[v[0], v[5], v[4]],
                     [v[5], v[1], v[3]],
                     [v[4], v[3], v[2]]])


def minimum_image(d: np.ndarray, cell: np.ndarray,
                  pbc=None) -> np.ndarray:
    """Minimum-image displacement vector(s) `d` under `cell`.

    `pbc` (default: fully periodic) masks the wrap per axis; a
    singular/zero cell returns `d` unchanged. Fractional rounding
    alone is NOT minimal for skewed (hexagonal/triclinic) cells, so
    the rounded image is refined over its 26 neighboring lattice
    offsets. Shared by NEB band tangents, tensordb cluster geometry
    and fingerprint motifs."""
    d = np.asarray(d, dtype=float)
    if cell is None or abs(np.linalg.det(cell)) < 1e-12:
        return d
    mask = np.ones(3) if pbc is None else np.asarray(pbc, dtype=float)
    if not mask.any():
        return d
    frac = d @ np.linalg.inv(cell)
    base = (frac - np.round(frac * mask)) @ cell
    # refine: for skewed cells the rounded image can be off by one
    # lattice offset along each periodic axis
    steps = [(-1.0, 0.0, 1.0) if mask[ax] else (0.0,)
             for ax in range(3)]
    offsets = np.array([(i, j, k) for i in steps[0] for j in steps[1]
                        for k in steps[2]])
    if len(offsets) == 1:
        return base
    cands = base[..., None, :] + (offsets @ cell)      # [..., no, 3]
    norms = np.sum(np.square(cands), axis=-1)
    best = np.argmin(norms, axis=-1)
    return np.take_along_axis(
        cands, best[..., None, None], axis=-2)[..., 0, :]
