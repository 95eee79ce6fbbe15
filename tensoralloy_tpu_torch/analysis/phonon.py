"""Phonon analysis from the autodiff Hessian (reference
`tensoralloy/analysis/phonon.py`, which forks Phonopy and computes
force sets from the in-graph Hessian).

No phonopy dependency: force constants come directly from the model's
exact Hessian of a supercell; the dynamical matrix is folded per
q-point and diagonalized. Provides band structures along q-paths
(standard fcc/bcc paths built in) and a gamma-point frequency check.

Units: Hessian in eV/A^2, masses in amu -> frequencies in THz via
sqrt(eV/(A^2 amu)) = 98.22695 rad/ps => nu = 15.633302 sqrt(.) THz.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..atoms import Structure

# sqrt(eV / (amu A^2)) -> THz (ordinary frequency)
VASP_TO_THZ = 15.633302


def supercell_force_constants(calc, primitive: Structure,
                              supercell: Tuple[int, int, int]
                              ) -> Tuple[np.ndarray, Structure,
                                         np.ndarray, np.ndarray]:
    """Hessian of the supercell + bookkeeping for folding.

    Returns (fc [Ns, Ns, 3, 3], supercell structure,
    cell_index [Ns] -> lattice-vector id, atom_index [Ns] -> primitive
    atom id, lattice_vectors [ncells, 3]).
    """
    n1, n2, n3 = supercell
    sc = primitive.repeat((n1, n2, n3))
    n_prim = len(primitive)
    ncells = n1 * n2 * n3
    # repeat() orders atoms cell-major: for each (i,j,k), all prim atoms
    lattice_vectors = np.array(
        [(i, j, k) for i in range(n1) for j in range(n2)
         for k in range(n3)], dtype=np.float64) @ primitive.cell
    cell_index = np.repeat(np.arange(ncells), n_prim)
    atom_index = np.tile(np.arange(n_prim), ncells)
    fc = calc.get_hessian(sc, phonopy_format=True)   # [Ns, Ns, 3, 3]
    return fc, sc, cell_index, atom_index, lattice_vectors


class PhononCalculator:
    """Phonon frequencies/band structure for a primitive structure."""

    def __init__(self, calc, primitive: Structure,
                 supercell: Tuple[int, int, int] = (2, 2, 2)):
        self.calc = calc
        self.primitive = primitive
        self.supercell = supercell
        (self.fc, self.sc, self.cell_index, self.atom_index,
         self.lattice_vectors) = supercell_force_constants(
            calc, primitive, supercell)
        self.masses = primitive.masses

    def dynamical_matrix(self, q_frac: np.ndarray) -> np.ndarray:
        """D(q) [3n, 3n] for q in fractional reciprocal coordinates of
        the *primitive* cell."""
        n = len(self.primitive)
        recip = 2.0 * np.pi * np.linalg.inv(self.primitive.cell).T
        q_cart = np.asarray(q_frac) @ recip
        d = np.zeros((n, n, 3, 3), dtype=np.complex128)
        # reference atom for each primitive index: the copy in cell 0
        ref_rows = [np.where((self.cell_index == 0) &
                             (self.atom_index == k))[0][0]
                    for k in range(n)]
        # minimum-image supercell translations: a raw [0, N) cell
        # vector biases phases at non-commensurate q (e^{iq.A} vs the
        # equivalent image e^{iq.(A-L)}); ties at exactly half a
        # supercell are averaged over the degenerate images, which is
        # what makes the interpolation exact at commensurate q and
        # smooth in between
        sc_cell = np.asarray(self.sc.cell)
        offsets = np.array([[i, j, k] for i in (-1, 0, 1)
                            for j in (-1, 0, 1) for k in (-1, 0, 1)],
                           dtype=np.float64)
        images = {}
        for ci in np.unique(self.cell_index):
            lvec = self.lattice_vectors[ci]
            cands = lvec + offsets @ sc_cell
            # restrict to true lattice translations near the minimum
            norms = np.linalg.norm(cands, axis=1)
            keep = cands[norms < norms.min() + 1e-8]
            images[int(ci)] = keep
        for col in range(self.fc.shape[1]):
            kp = self.atom_index[col]
            imgs = images[int(self.cell_index[col])]
            phase = np.mean(np.exp(1j * imgs @ q_cart))
            for k in range(n):
                d[k, kp] += self.fc[ref_rows[k], col] * phase
        # mass weighting
        for k in range(n):
            for kp in range(n):
                d[k, kp] /= np.sqrt(self.masses[k] * self.masses[kp])
        return d.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n)

    def frequencies(self, q_frac: np.ndarray) -> np.ndarray:
        """Phonon frequencies (THz) at one q-point; imaginary modes
        are returned negative."""
        dmat = self.dynamical_matrix(q_frac)
        dmat = 0.5 * (dmat + dmat.conj().T)
        w2 = np.linalg.eigvalsh(dmat)
        return np.sign(w2) * np.sqrt(np.abs(w2)) * VASP_TO_THZ

    def band_structure(self, qpoints: Sequence[Tuple[str, np.ndarray]],
                       npoints: int = 30) -> Dict:
        """Frequencies along straight segments between labelled
        q-points. Returns {'labels', 'distances', 'frequencies'}."""
        recip = 2.0 * np.pi * np.linalg.inv(self.primitive.cell).T
        dists: List[float] = []
        freqs: List[np.ndarray] = []
        ticks = [(0.0, qpoints[0][0])]
        total = 0.0
        for (la, qa), (lb, qb) in zip(qpoints[:-1], qpoints[1:]):
            qa = np.asarray(qa, dtype=np.float64)
            qb = np.asarray(qb, dtype=np.float64)
            seg = np.linalg.norm((qb - qa) @ recip)
            for t in np.linspace(0.0, 1.0, npoints, endpoint=False):
                q = qa + (qb - qa) * t
                dists.append(total + seg * t)
                freqs.append(self.frequencies(q))
            total += seg
            ticks.append((total, lb))
        dists.append(total)
        freqs.append(self.frequencies(np.asarray(qpoints[-1][1])))
        return {"labels": ticks, "distances": np.asarray(dists),
                "frequencies": np.asarray(freqs)}

    def gamma_frequencies(self) -> np.ndarray:
        return self.frequencies(np.zeros(3))

    def dos(self, qmesh: Tuple[int, int, int] = (8, 8, 8),
            sigma: float = 0.2, num_bins: int = 201
            ) -> Tuple[np.ndarray, np.ndarray]:
        """Gaussian-smeared phonon DOS over a Monkhorst-Pack mesh."""
        freqs = []
        for i in range(qmesh[0]):
            for j in range(qmesh[1]):
                for k in range(qmesh[2]):
                    q = np.array([i / qmesh[0], j / qmesh[1],
                                  k / qmesh[2]])
                    freqs.append(self.frequencies(q))
        freqs = np.concatenate(freqs)
        lo, hi = freqs.min() - 1.0, freqs.max() + 1.0
        grid = np.linspace(lo, hi, num_bins)
        dos = np.zeros_like(grid)
        for f in freqs:
            dos += np.exp(-0.5 * ((grid - f) / sigma) ** 2)
        dos /= (len(freqs) * sigma * np.sqrt(2 * np.pi))
        return grid, dos

    def thermal_properties(self, temperatures,
                           qmesh: Tuple[int, int, int] = (8, 8, 8)
                           ) -> Dict[str, np.ndarray]:
        """Quantum-harmonic thermodynamics PER PRIMITIVE CELL from
        exact mode sums over a Monkhorst-Pack mesh (no smearing):
        zero-point energy, vibrational free energy F_vib(T), entropy
        S_vib(T) (eV/K), internal energy U_vib(T), heat capacity
        C_v(T) (eV/K). Divide by `len(primitive)` for per-atom values;
        C_v -> 3 kB per atom in the classical limit."""
        freqs = []
        for i in range(qmesh[0]):
            for j in range(qmesh[1]):
                for k in range(qmesh[2]):
                    q = np.array([i / qmesh[0], j / qmesh[1],
                                  k / qmesh[2]])
                    freqs.append(self.frequencies(q))
        n_q = qmesh[0] * qmesh[1] * qmesh[2]
        out = harmonic_thermo(np.concatenate(freqs), temperatures)
        for key in ("zpe", "free_energy", "entropy",
                    "internal_energy", "heat_capacity"):
            out[key] = out[key] / n_q
        return out


THZ_TO_EV = 4.135667696e-3     # h * 1 THz in eV
KB_EV = 8.617333262e-5         # Boltzmann constant, eV/K


def harmonic_thermo(freqs_thz: np.ndarray,
                    temperatures: np.ndarray,
                    imaginary_tol: float = 0.05) -> Dict[str, np.ndarray]:
    """Quantum-harmonic mode sums (the phonopy `thermal_properties`
    analog, computed from this module's exact autodiff force
    constants).

    `freqs_thz`: mode frequencies (e.g. all modes over a q-mesh —
    results are divided by nothing here, so normalize outside).
    Modes with nu < `imaginary_tol` THz (imaginary or acoustic-gamma)
    are excluded and counted in "n_skipped".

    -> {"T", "zpe" (scalar, eV), "free_energy", "entropy",
        "internal_energy", "heat_capacity", "n_skipped"}:
    F = sum hv/2 + kT ln(1 - e^-x), S = sum k [x n_B - ln(1-e^-x)],
    U = sum hv (1/2 + n_B), C_v = sum k x^2 e^x / (e^x - 1)^2 with
    x = hv/kT, n_B = 1/(e^x - 1). Entropy in eV/K; T = 0 rows give
    (F=ZPE, S=0, U=ZPE, C_v=0) exactly.
    """
    freqs = np.asarray(freqs_thz, float).reshape(-1)
    skipped = int((freqs < imaginary_tol).sum())
    hv = freqs[freqs >= imaginary_tol] * THZ_TO_EV      # [M] eV
    temps = np.atleast_1d(np.asarray(temperatures, float))
    zpe = 0.5 * hv.sum()
    f_out = np.empty(len(temps))
    s_out = np.empty(len(temps))
    u_out = np.empty(len(temps))
    c_out = np.empty(len(temps))
    for i, t in enumerate(temps):
        if t <= 0.0:
            f_out[i], s_out[i], u_out[i], c_out[i] = zpe, 0.0, zpe, 0.0
            continue
        x = hv / (KB_EV * t)
        # exp overflow guard: for x > 50 every occupation term is
        # below 2e-22 — the T=0 limit
        x = np.minimum(x, 50.0)
        expm = np.expm1(x)
        n_b = 1.0 / expm
        ln1me = np.log(-np.expm1(-x))
        f_out[i] = zpe + KB_EV * t * ln1me.sum()
        s_out[i] = KB_EV * np.sum(x * n_b - ln1me)
        u_out[i] = zpe + np.sum(hv * n_b)
        c_out[i] = KB_EV * np.sum(
            x * x * np.exp(x) * n_b * n_b)
    return {"T": temps, "zpe": zpe, "free_energy": f_out,
            "entropy": s_out, "internal_energy": u_out,
            "heat_capacity": c_out, "n_skipped": skipped}


def quasi_harmonic(calc, primitive: Structure, temperatures,
                   scales=None, supercell: Tuple[int, int, int] = (2, 2, 2),
                   qmesh: Tuple[int, int, int] = (4, 4, 4),
                   eos: str = "birchmurnaghan") -> Dict[str, np.ndarray]:
    """Quasi-harmonic approximation: minimize F(V, T) = E(V) +
    F_vib(V, T) over isotropically scaled cells to get the thermal
    expansion (the reference has no QHA — phonopy-based workflows do
    this externally).

    `scales`: linear scale factors for the primitive cell (default
    0.985..1.04, 7 points around equilibrium — widen for high T).
    One exact Hessian per volume; everything else is mode algebra.

    -> {"T" [K], "volume" [A^3 per primitive cell], "a_scale"
    (V(T)/V(T[0]))^(1/3), "alpha" linear expansion coefficient [1/K]
    (central differences), "bulk_modulus" [GPa] (isothermal, from the
    F(V) curvature at the minimum), "free_energy" [eV per primitive
    cell at the minimum]}.
    """
    from .eos import EquationOfState
    from ..nn.fields import EV_ANGSTROM3_TO_GPA
    if scales is None:
        scales = np.linspace(0.985, 1.04, 7)
    temps = np.atleast_1d(np.asarray(temperatures, float))
    volumes, e0, f_vib = [], [], []
    for sc in scales:
        s = primitive.copy()
        s.cell = s.cell * sc
        s.positions = s.positions * sc
        volumes.append(s.volume)
        e0.append(calc.get_potential_energy(s))
        ph = PhononCalculator(calc, s, supercell=supercell)
        th = ph.thermal_properties(temps, qmesh=qmesh)
        f_vib.append(th["free_energy"])
    volumes = np.asarray(volumes)
    e0 = np.asarray(e0)
    f_vib = np.asarray(f_vib)                      # [n_scales, n_T]
    v0 = np.empty(len(temps))
    b0 = np.empty(len(temps))
    f0 = np.empty(len(temps))
    for i in range(len(temps)):
        fit = EquationOfState(volumes, e0 + f_vib[:, i], eos=eos)
        v, f, b = fit.fit()
        v0[i], f0[i], b0[i] = v, f, b * EV_ANGSTROM3_TO_GPA
    a_scale = (v0 / v0[0]) ** (1.0 / 3.0)
    alpha = np.gradient(a_scale, temps) / a_scale
    return {"T": temps, "volume": v0, "a_scale": a_scale,
            "alpha": alpha, "bulk_modulus": b0, "free_energy": f0}


FCC_PATH = [("G", [0.0, 0.0, 0.0]), ("X", [0.5, 0.0, 0.5]),
            ("W", [0.5, 0.25, 0.75]), ("K", [0.375, 0.375, 0.75]),
            ("G", [0.0, 0.0, 0.0]), ("L", [0.5, 0.5, 0.5])]

BCC_PATH = [("G", [0.0, 0.0, 0.0]), ("H", [0.5, -0.5, 0.5]),
            ("N", [0.0, 0.0, 0.5]), ("G", [0.0, 0.0, 0.0]),
            ("P", [0.25, 0.25, 0.25])]
