"""Valle-Oganov structure fingerprints and the similarity kernel
(reference `tensoralloy/analysis/fingerprints.py:18-534`; Oganov &
Valle, doi:10.1063/1.3079326, doi:10.1016/j.cpc.2010.06.007).

The per-pair-type fingerprint is a smeared, surface-area-normalized
radial distribution:

    F_AB(b) = V / (N_A N_B) * sum_{i in A, j in B}
              w_m(d_ij, b) / (area(d_ij) * binwidth)  - 1

with the erf-box smearing of the reference (each pair deposits exact
Gaussian bin integrals over the 2m+1 bins around its own bin, summing
to one), and dimensionality-aware `area` (4 pi r^2 for 3D/0D crystals,
slab / wire corrections for 2D / 1D when `maxdims` is given). The
similarity between two structures is the composition-weighted cosine
distance, w_AB = N_A N_B / sum(N N).

Implementation is vectorized over pairs (the reference loops python
over cells x atoms x bins); only the 2m+1 smearing offsets and the
element-pair channels loop in python.
"""
from __future__ import annotations

from itertools import combinations_with_replacement
from math import erf, sqrt
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..atoms import Structure
from ..neighbor import neighbor_list

PairKey = Tuple[str, str]


class StructureFingerprint:
    """Fingerprints of one structure, keyed by sorted element pair."""

    def __init__(self, structure: Structure, rmax: float = 6.0,
                 delta: float = 0.05, sigma: float = 0.02,
                 nsigma: int = 4, maxdims=(0.0, 0.0, 0.0)):
        self.structure = structure
        self.rmax = float(rmax)
        self.delta = float(delta)        # binwidth
        self.sigma = float(sigma)
        self.nsigma = int(nsigma)
        self.maxdims = maxdims
        self.nbins = int(np.ceil(self.rmax / self.delta))
        self.grid = (np.arange(self.nbins) + 0.5) * self.delta
        self.pbc = np.asarray(structure.pbc, dtype=bool)
        if abs(np.linalg.det(structure.cell)) < 1e-12:
            self.pbc = np.zeros(3, dtype=bool)
        self.dimensions = int(self.pbc.sum())
        if self.dimensions in (1, 2):
            for axis in range(3):
                if not self.pbc[axis] and not maxdims[axis] > 0:
                    raise ValueError(
                        "a positive thickness must be given in maxdims "
                        "for every non-periodic direction of a 1D/2D "
                        f"system (axis {axis})")
        syms = np.asarray(structure.symbols)
        self.elements = sorted(set(structure.symbols))
        self.counts = {e: int(np.sum(syms == e)) for e in self.elements}
        per_atom = self._compute_per_atom()
        self.per_atom = per_atom                       # [N] list of dict
        self.fingerprints = self._sum_types(per_atom)  # pair -> [nbins]

    # ------------------------------------------------------------------
    def _areas(self, d: np.ndarray, center: np.ndarray) -> np.ndarray:
        """Spherical-shell surface area at each pair distance, corrected
        for missing solid angle in slab (2D) / wire (1D) geometries
        (reference `fingerprints.py:320-355`)."""
        if self.dimensions in (3, 0):
            return 4.0 * np.pi * d ** 2
        cell = self.structure.cell
        non_pbc = [i for i in range(3) if not self.pbc[i]]
        # extent of the bounded directions: atoms' span plus margin to
        # the declared physical thickness
        spos = self.structure.positions @ np.linalg.inv(cell)
        axis = non_pbc[0]
        nrm = np.linalg.norm(cell[axis])
        b = self.maxdims[axis] / nrm
        lo, hi = spos[:, axis].min(), spos[:, axis].max()
        margin = 0.5 * (b - (hi - lo))
        pmin, pmax = (lo - margin) * nrm, (hi + margin) * nrm
        p0 = np.atleast_2d(center) @ np.linalg.inv(cell)[:, axis] * nrm
        area = 2.0 * np.pi * d * (np.minimum(pmax - p0, d) +
                                  np.minimum(p0 - pmin, d))
        if self.dimensions == 1:
            axis2 = non_pbc[1]
            nrm2 = np.linalg.norm(cell[axis2])
            b2 = self.maxdims[axis2] / nrm2
            lo2, hi2 = spos[:, axis2].min(), spos[:, axis2].max()
            margin2 = 0.5 * (b2 - (hi2 - lo2))
            qmin, qmax = (lo2 - margin2) * nrm2, (hi2 + margin2) * nrm2
            q0 = np.atleast_2d(center) @ np.linalg.inv(cell)[:, axis2] \
                * nrm2
            with np.errstate(invalid="ignore"):
                phi1 = np.real(np.arccos(
                    np.clip((qmax - q0) / d, -1.0, 1.0) + 0j))
                phi2 = np.pi - np.real(np.arccos(
                    np.clip((qmin - q0) / d, -1.0, 1.0) + 0j))
            area = area * (1.0 - (phi1 + phi2) / np.pi)
        return np.maximum(area, 1e-12)

    def _compute_per_atom(self) -> List[Dict[str, np.ndarray]]:
        s = self.structure
        n = len(s)
        syms = np.asarray(s.symbols)
        # include the smearing tail beyond rmax
        reach = self.rmax + self.nsigma * self.sigma
        struct = s if self.dimensions else s.ensure_cell(
            vacuum=reach + 1.0)
        ii, jj, _, d, _ = neighbor_list(struct, reach)
        # erf-box smearing: offsets deposit exact Gaussian bin
        # integrals (constant per offset), normalized to sum to one
        m = int(np.ceil(self.nsigma * self.sigma / self.delta))
        c = 0.25 * sqrt(2.0) * self.delta / self.sigma
        smearing_norm = erf(c * (2 * m + 1))
        offsets = np.arange(-m, m + 1)
        values = np.array([0.5 * (erf(c * (2 * i + 1)) -
                                  erf(c * (2 * i - 1)))
                           for i in offsets]) / smearing_norm
        rbin = np.floor(d / self.delta).astype(np.int64)
        if self.dimensions in (1, 2):
            area = self._areas(d, s.positions[ii])  # center-dependent
        else:
            area = self._areas(d, None)
        dep = 1.0 / (area * self.delta)
        # one scatter-add per element over ALL (pair, smearing-offset)
        # contributions at once — no per-atom / per-offset Python loops
        volume = struct.volume if self.dimensions else 1.0
        acc = {}
        for e in self.elements:
            sel_e = syms[jj] == e
            flat = np.zeros(n * self.nbins)
            if sel_e.any():
                nb = rbin[sel_e][None, :] + offsets[:, None]
                ok = (nb >= 0) & (nb < self.nbins)
                contrib = np.broadcast_to(
                    values[:, None] * dep[sel_e][None, :], nb.shape)[ok]
                centers = np.broadcast_to(ii[sel_e], nb.shape)[ok]
                np.add.at(flat, centers * self.nbins + nb[ok], contrib)
            # normalize each center's rdf by N_e / V
            acc[e] = flat.reshape(n, self.nbins) * \
                (volume / self.counts[e])
        return [{e: acc[e][idx] for e in self.elements}
                for idx in range(n)]

    def _sum_types(self, per_atom) -> Dict[PairKey, np.ndarray]:
        syms = np.asarray(self.structure.symbols)
        out = {}
        for a, b in combinations_with_replacement(self.elements, 2):
            f = np.zeros(self.nbins)
            for idx in np.flatnonzero(syms == a):
                f += per_atom[idx][b]
            f /= max(self.counts[a], 1)
            if self.dimensions > 0:
                f -= 1.0
            out[(a, b)] = f
        return out

    def individual(self, index: int) -> Dict[PairKey, np.ndarray]:
        """Per-atom fingerprint of atom `index` (reference
        `get_features(individual=True)`)."""
        a = self.structure.symbols[index]
        out = {}
        for b in self.elements:
            f = self.per_atom[index][b].copy()
            if self.dimensions > 0:
                f -= 1.0
            out[tuple(sorted((a, b)))] = f
        for t1, t2 in combinations_with_replacement(self.elements, 2):
            out.setdefault((t1, t2), np.zeros(self.nbins) - 1.0)
        return out

    def flat(self) -> np.ndarray:
        keys = sorted(self.fingerprints)
        return np.concatenate([self.fingerprints[k] for k in keys])


def cosine_distance(fp1: StructureFingerprint,
                    fp2: StructureFingerprint) -> float:
    """Composition-weighted cosine distance (reference
    `get_similarity`, `fingerprints.py:452-485`):
    w_AB = N_A N_B / sum; 0 = identical, 1 = anti-aligned."""
    keys = sorted(set(fp1.fingerprints) | set(fp2.fingerprints))
    nbins = fp1.nbins

    def get(fp, key):
        return fp.fingerprints.get(key, np.zeros(nbins) - 1.0)

    w = {}
    for key in keys:
        w[key] = (fp1.counts.get(key[0], 0) * fp1.counts.get(key[1], 0)
                  or fp2.counts.get(key[0], 0) *
                  fp2.counts.get(key[1], 0))
    wtot = sum(w.values()) or 1
    w = {k: v / wtot for k, v in w.items()}
    norm1 = sqrt(sum(np.linalg.norm(get(fp1, k)) ** 2 * w[k]
                     for k in keys))
    norm2 = sqrt(sum(np.linalg.norm(get(fp2, k)) ** 2 * w[k]
                     for k in keys))
    if norm1 * norm2 < 1e-300:
        return 1.0
    dot = sum(np.sum(get(fp1, k) * get(fp2, k)) * w[k] for k in keys)
    return float(0.5 * (1.0 - dot / (norm1 * norm2)))


class FingerprintsComparator:
    """Pairwise similarity over many structures (dataset dedup, GA
    niching). `looks_like` applies the reference's two-stage gate:
    energy difference then cosine distance."""

    def __init__(self, structures: List[Structure], rmax: float = 6.0,
                 delta: float = 0.05, sigma: float = 0.02,
                 nsigma: int = 4, dE: float = 1.0,
                 cos_dist_max: float = 5e-3,
                 maxdims=(0.0, 0.0, 0.0)):
        self.dE = float(dE)
        self.cos_dist_max = float(cos_dist_max)
        self.structures = list(structures)
        self.fps = [StructureFingerprint(s, rmax, delta, sigma,
                                         nsigma=nsigma, maxdims=maxdims)
                    for s in structures]

    def looks_like(self, i: int, j: int,
                   e1: Optional[float] = None,
                   e2: Optional[float] = None) -> bool:
        """True if structures i and j are duplicates: |dE| below the
        gate (when energies are known) AND cosine distance below
        cos_dist_max."""
        if e1 is None:
            e1 = self.structures[i].energy
        if e2 is None:
            e2 = self.structures[j].energy
        if e1 is not None and e2 is not None:
            if abs(float(e1) - float(e2)) >= self.dE:
                return False
        return cosine_distance(self.fps[i], self.fps[j]) \
            < self.cos_dist_max

    def distance_matrix(self) -> np.ndarray:
        n = len(self.fps)
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                out[i, j] = out[j, i] = cosine_distance(
                    self.fps[i], self.fps[j])
        return out

    def find_duplicates(self, threshold: Optional[float] = None
                        ) -> List[Tuple[int, int]]:
        thr = self.cos_dist_max if threshold is None else threshold
        d = self.distance_matrix()
        n = len(self.fps)
        return [(i, j) for i in range(n) for j in range(i + 1, n)
                if d[i, j] < thr]


def get_motifs(structure: Structure, rcut: float = 20.0
               ) -> List[Structure]:
    """Per-atom motifs: for each atom, the sub-structure of atoms
    within `rcut` of it (reference `get_motifs`,
    `fingerprints.py:487-506`, which uses raw Cartesian distances;
    here distances are minimum-image for periodic cells)."""
    from ..atoms import minimum_image
    pos = structure.positions
    cell = structure.cell
    d = minimum_image(pos[None, :, :] - pos[:, None, :],
                      cell, structure.pbc)
    dist = np.linalg.norm(d, axis=-1)
    out = []
    for i in range(len(structure)):
        keep = np.flatnonzero(dist[i] <= rcut)
        out.append(Structure(
            numbers=structure.numbers[keep].copy(),
            positions=pos[keep].copy(),
            cell=cell.copy(), pbc=structure.pbc.copy(),
            info=dict(structure.info)))
    return out
