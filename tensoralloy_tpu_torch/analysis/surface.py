"""Miller-index slabs and surface energies.

The reference computes surface properties by exporting the potential
to LAMMPS; here the slab builder + the native calculator close the
loop in-process: `make_slab` cuts an (hkl) slab out of any bulk cell
by integer lattice algebra (no ASE), `surface_energy` relaxes it and
returns gamma = (E_slab - N e_bulk) / (2 A).

Conventions: Miller indices are w.r.t. the GIVEN cell (use the
conventional cubic cell for textbook fcc/bcc indices). The slab's
third cell vector carries the vacuum; the first two are the shortest
in-plane lattice vectors.
"""
from __future__ import annotations

from itertools import product
from math import gcd
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..atoms import Structure

__all__ = ["make_slab", "surface_energy", "stacking_fault_energy",
           "gamma_line", "gamma_surface", "make_tilt_bicrystal",
           "grain_boundary_energy", "make_twist_bicrystal",
           "twist_boundary_energy"]


def _in_plane_basis(cell: np.ndarray, hkl: Tuple[int, int, int],
                    search: int = 3) -> Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]:
    """Integer basis (u, v, w) of the bulk lattice with u, v in the
    (hkl) plane (u.hkl = v.hkl = 0), w advancing one plane stack
    (w.hkl = gcd(hkl)), all chosen shortest in Cartesian length and
    right-handed."""
    h = np.asarray(hkl, int)
    if not h.any():
        raise ValueError("Miller indices must not all be zero")
    g = gcd(gcd(abs(int(h[0])), abs(int(h[1]))), abs(int(h[2])))
    h = h // g
    cands = []
    for t in product(range(-search, search + 1), repeat=3):
        t = np.array(t, int)
        if not t.any():
            continue
        if int(t @ h) == 0:
            cands.append(t)
    cands.sort(key=lambda t: float(np.linalg.norm(t @ cell)))
    u = cands[0]
    v = None
    for t in cands[1:]:
        if np.linalg.norm(np.cross(u, t)) > 1e-9:
            v = t
            break
    if v is None:
        raise ValueError(f"no in-plane basis found for {tuple(hkl)}")
    # stacking vector: t.h == 1 (after gcd reduction one always exists
    # within the search range for small indices)
    best_w, best_len = None, np.inf
    for t in product(range(-search, search + 1), repeat=3):
        t = np.array(t, int)
        if int(t @ h) != 1:
            continue
        ln = float(np.linalg.norm(t @ cell))
        if ln < best_len:
            best_w, best_len = t, ln
    if best_w is None:
        raise ValueError(f"no stacking vector found for {tuple(hkl)}")
    m = np.stack([u, v, best_w])
    if np.linalg.det(m) < 0:
        m[1] = -m[1]
    return m[0], m[1], m[2]


def _fill_supercell(bulk: Structure, m: np.ndarray
                    ) -> Tuple[list, np.ndarray, np.ndarray]:
    """Populate the integer supercell `m` (rows: lattice combinations)
    of `bulk` -> (symbols, fractional positions in the NEW cell, new
    cell). Exact-count checked."""
    cell = np.asarray(bulk.cell, float)
    new_cell = m @ cell
    ncells = int(round(abs(np.linalg.det(m))))
    corners = np.array(list(product([0, 1], repeat=3))) @ m
    lo = corners.min(axis=0) - 1
    hi = corners.max(axis=0) + 1
    inv_new = np.linalg.inv(new_cell)
    frac_bulk = bulk.positions @ np.linalg.inv(cell)
    sym, pos = [], []
    for t in product(*(range(int(l), int(h) + 1)
                       for l, h in zip(lo, hi))):
        shift = np.asarray(t, float)
        for s_i, f in zip(bulk.symbols, frac_bulk):
            fn = (f + shift) @ cell @ inv_new
            fn_mod = fn - np.floor(fn + 1e-9)
            if np.all(fn_mod < 1.0 - 1e-9):
                # dedup exact-boundary images
                if any(np.allclose(fn_mod, q, atol=1e-6)
                       for q, s_q in zip(pos, sym) if s_q == s_i):
                    continue
                sym.append(s_i)
                pos.append(fn_mod)
    expected = ncells * len(bulk)
    if len(sym) != expected:
        raise RuntimeError(
            f"supercell filling found {len(sym)} atoms, "
            f"expected {expected}")
    return sym, np.asarray(pos), new_cell


def make_slab(bulk: Structure, miller: Tuple[int, int, int],
              layers: int = 6, vacuum: float = 12.0,
              search: int = 3) -> Structure:
    """Cut an (hkl) slab with `layers` repetitions of the minimal
    stacking period along the plane normal and `vacuum` A of empty
    space separating periodic replicas.

    The returned structure keeps pbc = (T, T, T); the vacuum gap makes
    the third direction non-interacting for any cutoff < vacuum.
    """
    cell = np.asarray(bulk.cell, float)
    u, v, w = _in_plane_basis(cell, miller, search=search)
    m = np.stack([u, v, w * layers])        # integer supercell matrix
    sym, frac, new_cell = _fill_supercell(bulk, m)
    pos = frac @ new_cell
    # vacuum: extend the third vector along the plane normal so the
    # PERPENDICULAR replica gap equals `vacuum`
    normal = np.cross(new_cell[0], new_cell[1])
    normal = normal / np.linalg.norm(normal)
    if normal @ new_cell[2] < 0:
        normal = -normal
    slab_cell = new_cell.copy()
    slab_cell[2] = new_cell[2] + vacuum * normal
    s = Structure.from_symbols(sym, pos, slab_cell, pbc=[True] * 3)
    s.info["miller"] = tuple(int(x) for x in miller)
    return s


def surface_energy(calc, bulk: Structure,
                   miller: Tuple[int, int, int], layers: int = 8,
                   vacuum: float = 12.0, relax: bool = True,
                   fmax: float = 0.02, steps: int = 300
                   ) -> Dict[str, float]:
    """gamma(hkl) = (E_slab - N e_bulk) / (2 A) with e_bulk from the
    SAME calculator on the given bulk cell (consistent reference), the
    slab optionally ion-relaxed. Returns eV/A^2 and J/m^2
    (1 eV/A^2 = 16.0218 J/m^2).
    """
    from .elastic import relax_positions
    e_bulk = calc.get_potential_energy(bulk) / len(bulk)
    slab = make_slab(bulk, miller, layers=layers, vacuum=vacuum)
    e_unrelaxed = calc.get_potential_energy(slab)
    if relax:
        slab = relax_positions(calc, slab, fmax=fmax, steps=steps)
        e_slab = calc.get_potential_energy(slab)
    else:
        e_slab = e_unrelaxed
    area = float(np.linalg.norm(np.cross(slab.cell[0], slab.cell[1])))
    gamma = (e_slab - len(slab) * e_bulk) / (2.0 * area)
    return {"gamma_ev_a2": float(gamma),
            "gamma_j_m2": float(gamma) * 16.02176634,
            "n_atoms": len(slab), "area_a2": area,
            "e_slab": float(e_slab),
            "e_unrelaxed": float(e_unrelaxed),
            "relaxation_ev": float(e_unrelaxed - e_slab)}


def _relax_normal(calc, s: Structure, normal: np.ndarray,
                  fmax: float = 0.02, steps: int = 200,
                  dt: float = 0.08) -> Structure:
    """FIRE-lite with forces PROJECTED on the plane normal — the
    standard constrained relaxation for gamma-surface points (in-plane
    motion would slide the fault away)."""
    s = s.copy()
    n = normal / np.linalg.norm(normal)
    v = np.zeros(len(s))
    a_scale = 0.1
    for _ in range(steps):
        f = np.asarray(calc.get_forces(s)) @ n
        if np.abs(f).max() < fmax:
            break
        power = float(f @ v)
        if power > 0:
            fn = np.linalg.norm(f) or 1.0
            v = (1 - a_scale) * v + a_scale * np.linalg.norm(v) * f / fn
        else:
            v[:] = 0.0
        v = v + dt * f
        s.positions = s.positions + dt * v[:, None] * n[None, :]
    return s


def _is_crystal_translation(frac, sym, t_frac, tol=1e-5) -> bool:
    """Does translating every atom by `t_frac` (fractional, PBC) map
    the structure onto itself species-for-species?"""
    frac = np.asarray(frac)
    d = frac[:, None, :] + np.asarray(t_frac)[None, None, :] \
        - frac[None, :, :]
    d -= np.round(d)
    close = np.max(np.abs(d), axis=-1) < tol
    sym = np.asarray(sym)
    same = sym[:, None] == sym[None, :]
    return bool(np.all(np.any(close & same, axis=1)))


def _lattice_basis_2d(vecs):
    """Basis of the integer span of 2D integer vectors (Euclid on the
    first coordinate, then gcd of the residual second column)."""
    rows = [[int(v[0]), int(v[1])] for v in vecs if any(v)]
    while True:
        nz = sorted((r for r in rows if r[0] != 0),
                    key=lambda r: abs(r[0]))
        if len(nz) <= 1:
            break
        r0 = nz[0]
        for r in nz[1:]:
            q = r[0] // r0[0]
            r[0] -= q * r0[0]
            r[1] -= q * r0[1]
        rows = [r for r in rows if r != [0, 0]]
    a = next(r for r in rows if r[0] != 0)
    gy = 0
    for r in rows:
        if r[0] == 0:
            gy = gcd(gy, abs(r[1]))
    b = [0, gy]
    a[1] -= (a[1] // gy) * gy
    return np.array(a, np.int64), np.array(b, np.int64)


def _lagrange_reduce(a: np.ndarray, b: np.ndarray):
    """Two shortest lattice vectors (2D Gauss-Lagrange reduction)."""
    a, b = a.astype(float), b.astype(float)
    if a @ a > b @ b:
        a, b = b, a
    while True:
        mu = round(float(a @ b) / float(a @ a))
        b = b - mu * a
        if b @ b >= a @ a:
            break
        a, b = b, a
    return a, b


class _GsfCell:
    """Shared tilted-cell setup for gamma-surface scans: the perfect
    (hkl)-oriented supercell, its PRIMITIVE acute in-plane basis, and
    the fault normal/area — built once, evaluated at many shifts.

    The integer lattice algebra of `_in_plane_basis` works on the
    CONVENTIONAL cell, so for centered lattices (fcc/bcc) its in-plane
    vectors can be multiples of the true plane-lattice basis (fcc(111):
    exactly 2x, making a naive gamma-surface 4-fold redundant and
    mislabeling the partials). The constructor therefore reduces
    (b1, b2) to the primitive plane lattice — candidate sub-vectors
    (i b1 + j b2)/6 are verified as crystal translations against the
    atom set itself — and orients the acute basis so that
    (b1 + b2)/3 is the +stacking-offset direction, which makes
    `frac_shift=(1/3, 1/3)` the INTRINSIC (Shockley) fault for
    close-packed planes by construction rather than by coincidence."""

    def __init__(self, calc, bulk: Structure,
                 miller: Tuple[int, int, int], layers: int,
                 search: int = 3):
        cell = np.asarray(bulk.cell, float)
        u, v, w = _in_plane_basis(cell, miller, search=search)
        m = np.stack([u, v, w * layers])
        self.sym, self.frac, self.perfect_cell = _fill_supercell(bulk, m)
        self.positions = self.frac @ self.perfect_cell
        perfect = Structure.from_symbols(self.sym, self.positions,
                                         self.perfect_cell,
                                         pbc=[True] * 3)
        self.n_atoms = len(perfect)
        self.e_perfect = float(calc.get_potential_energy(perfect))
        self.normal = np.cross(self.perfect_cell[0],
                               self.perfect_cell[1])
        self.area = float(np.linalg.norm(self.normal))
        self.b1, self.b2 = self._reduced_basis(layers)

    def _reduced_basis(self, layers: int):
        c1, c2 = self.perfect_cell[0], self.perfect_cell[1]
        inv = np.linalg.inv(self.perfect_cell)
        denom = 6              # covers sublattice indices 2, 3, 4, 6
        found = [(denom, 0), (0, denom)]
        for i in range(denom):
            for j in range(denom):
                if i == 0 and j == 0:
                    continue
                t = (i * c1 + j * c2) / denom
                if _is_crystal_translation(self.frac, self.sym,
                                           t @ inv):
                    found.append((i, j))
        ia, ib = _lattice_basis_2d(found)
        b1 = (ia[0] * c1 + ia[1] * c2) / denom
        b2 = (ib[0] * c1 + ib[1] * c2) / denom
        b1, b2 = _lagrange_reduce(b1, b2)
        if b1 @ b2 < -1e-9:                      # canonical ACUTE
            b2 = -b2
        # Shockley orientation: if the plane's stacking offset (the
        # in-plane projection of the unit-advance vector) is the
        # NEGATIVE diagonal third, flip the basis so that
        # (1/3, 1/3) always means the intrinsic fault
        n_hat = self.normal / np.linalg.norm(self.normal)
        w_vec = self.perfect_cell[2] / layers
        w_par = w_vec - (w_vec @ n_hat) * n_hat
        basis = np.stack([b1, b2]).T             # [3, 2]

        def equiv(vec):
            coords, *_ = np.linalg.lstsq(basis, vec, rcond=None)
            return np.all(np.abs(coords - np.round(coords)) < 1e-6)

        diag = (b1 + b2) / 3.0
        if not equiv(diag - w_par) and equiv(-diag - w_par):
            b1, b2 = -b1, -b2
        return b1, b2

    def evaluate(self, calc, frac_shift, relax: bool = True,
                 fmax: float = 0.02, steps: int = 200
                 ) -> Dict[str, float]:
        """gamma at one in-plane shift (units of the acute basis)."""
        shift = frac_shift[0] * self.b1 + frac_shift[1] * self.b2
        faulted_cell = self.perfect_cell.copy()
        faulted_cell[2] = self.perfect_cell[2] + shift
        # atoms stay at their PERFECT Cartesian positions: only the
        # periodic boundary is sheared, so the slip discontinuity (the
        # fault) is localized at the cell boundary instead of being
        # smeared into a uniform shear strain
        faulted = Structure.from_symbols(self.sym, self.positions,
                                         faulted_cell, pbc=[True] * 3)
        e_unrelaxed = float(calc.get_potential_energy(faulted))
        if relax:
            faulted = _relax_normal(calc, faulted, self.normal,
                                    fmax=fmax, steps=steps)
            e_fault = float(calc.get_potential_energy(faulted))
        else:
            e_fault = e_unrelaxed
        gamma = (e_fault - self.e_perfect) / self.area
        return {"gamma_ev_a2": gamma,
                "gamma_j_m2": gamma * 16.02176634,
                "gamma_mj_m2": gamma * 16021.76634,
                "n_atoms": self.n_atoms, "area_a2": self.area,
                "e_perfect": self.e_perfect,
                "e_unrelaxed": e_unrelaxed,
                "e_fault": e_fault}


def stacking_fault_energy(calc, bulk: Structure,
                          miller: Tuple[int, int, int] = (1, 1, 1),
                          frac_shift: Tuple[float, float] = (1/3, 1/3),
                          layers: int = 8, relax: bool = True,
                          fmax: float = 0.02, steps: int = 200,
                          search: int = 3) -> Dict[str, float]:
    """Generalized stacking-fault energy by the tilted-cell method:
    the (hkl)-oriented supercell's third vector is sheared by
    `frac_shift` of the two in-plane lattice vectors, inserting exactly
    ONE fault per periodic image (no vacuum, no free surfaces). Atoms
    relax along the plane normal only (`relax=True`), the constrained
    mode a gamma-surface scan requires.

    For fcc (111) with the default shortest in-plane basis,
    `frac_shift=(1/3, 1/3)` is the intrinsic stacking fault
    (the Shockley-partial displacement). Returns gamma in eV/A^2,
    J/m^2 and mJ/m^2.
    """
    gsf = _GsfCell(calc, bulk, miller, layers, search=search)
    return gsf.evaluate(calc, frac_shift, relax=relax, fmax=fmax,
                        steps=steps)


def gamma_line(calc, bulk: Structure,
               miller: Tuple[int, int, int] = (1, 1, 1),
               direction: Tuple[float, float] = (1.0, 1.0),
               n_points: int = 13, layers: int = 8,
               relax: bool = True, fmax: float = 0.02,
               steps: int = 200, search: int = 3) -> Dict[str, object]:
    """gamma(t * direction) for t in [0, 1] — the slip-path profile.

    For fcc (111) the default `direction=(1, 1)` of the acute basis is
    the <112> path: gamma rises to the UNSTABLE stacking-fault energy
    gamma_us, dips to the intrinsic gamma_isf at t = 1/3 (the Shockley
    partial), and returns to zero at t = 1 (b1 + b2 is a full lattice
    translation). Returns the curve plus gamma_us (path maximum) and
    gamma at the t = 1/3 grid point if sampled.

    The perfect supercell, its energy, and the compiled evaluator are
    shared across all points (every faulted cell has the same shapes).
    """
    gsf = _GsfCell(calc, bulk, miller, layers, search=search)
    ts = np.linspace(0.0, 1.0, n_points)
    gammas = np.zeros(n_points)
    for i, t in enumerate(ts):
        if i == 0:
            continue            # zero shift: exactly the perfect cell
        r = gsf.evaluate(calc, (t * direction[0], t * direction[1]),
                         relax=relax, fmax=fmax, steps=steps)
        gammas[i] = r["gamma_mj_m2"]
    # gamma_us = the FIRST barrier along the path (the unstable SFE
    # between perfect crystal and the first metastable fault), not the
    # global maximum — on the fcc <112> line the run-on (AA-stacking)
    # peak beyond the intrinsic fault is much higher.  The CUMULATIVE
    # drop below the running maximum must exceed a tolerance (a
    # fraction of that maximum, floored at a few mJ/m^2): finite-fmax
    # relaxations leave mJ/m^2-scale noise that would otherwise mark a
    # spurious early bump as the peak, while an adjacent-sample test
    # would miss a genuine peak followed by a GRADUAL decline (finely
    # sampled lines drop by less than the tolerance per step).
    first_peak = len(gammas) - 1
    run_max, run_arg = gammas[1], 1
    for i in range(2, len(gammas)):
        if gammas[i] > run_max:
            run_max, run_arg = gammas[i], i
            continue
        tol = max(5.0, 0.02 * float(run_max))
        if gammas[i] < run_max - tol:
            first_peak = run_arg
            break
    out = {"t": ts, "gamma_mj_m2": gammas,
           "gamma_us_mj_m2": float(gammas[first_peak]),
           "gamma_max_mj_m2": float(gammas.max()),
           "area_a2": gsf.area, "n_atoms": gsf.n_atoms}
    third = np.isclose(ts, 1.0 / 3.0, atol=1e-9)
    if third.any():
        out["gamma_isf_mj_m2"] = float(gammas[third][0])
    return out


def gamma_surface(calc, bulk: Structure,
                  miller: Tuple[int, int, int] = (1, 1, 1),
                  n_grid: Tuple[int, int] = (8, 8), layers: int = 8,
                  relax: bool = True, fmax: float = 0.02,
                  steps: int = 200, search: int = 3
                  ) -> Dict[str, object]:
    """Full generalized-stacking-fault surface gamma(u, v) on an
    n1 x n2 grid over the in-plane unit cell (acute basis; periodic —
    u, v run over [0, 1) without the duplicate edge).

    Returns {"u", "v", "gamma_mj_m2" [n1, n2], ...}; grid point (0, 0)
    is exactly zero by construction (zero shift IS the perfect cell,
    pinned by `test_surface.py`).
    """
    gsf = _GsfCell(calc, bulk, miller, layers, search=search)
    n1, n2 = n_grid
    us = np.arange(n1) / n1
    vs = np.arange(n2) / n2
    grid = np.zeros((n1, n2))
    for i, uu in enumerate(us):
        for j, vv in enumerate(vs):
            if i == 0 and j == 0:
                continue
            r = gsf.evaluate(calc, (uu, vv), relax=relax, fmax=fmax,
                             steps=steps)
            grid[i, j] = r["gamma_mj_m2"]
    return {"u": us, "v": vs, "gamma_mj_m2": grid,
            "gamma_max_mj_m2": float(grid.max()),
            "area_a2": gsf.area, "n_atoms": gsf.n_atoms}


def _prune_close_pairs(pos: np.ndarray, sym: list,
                       cell: np.ndarray, min_dist: float):
    """Delete one atom of every periodic pair closer than `min_dist`
    (fused cross-boundary sites of unlucky microscopic translations)."""
    inv = np.linalg.inv(cell)
    alive = np.ones(len(pos), bool)
    for i in range(len(pos)):
        if not alive[i]:
            continue
        df = (pos[i + 1:] - pos[i]) @ inv
        df -= np.round(df)
        r = np.linalg.norm(df @ cell, axis=1)
        for j_rel in np.nonzero(r < min_dist)[0]:
            alive[i + 1 + j_rel] = False
    return pos[alive], [s for s, a in zip(sym, alive) if a]


def make_tilt_bicrystal(bulk: Structure, miller: Tuple[int, int, int],
                        layers: int = 8,
                        translation: Tuple[float, float] = (0.0, 0.0),
                        plane_centered: bool = True, search: int = 3,
                        min_dist: Optional[float] = None) -> Structure:
    """Symmetric (mirror) tilt bicrystal with TWO equivalent grain
    boundaries per periodic cell.

    Grain A is the (hkl)-oriented supercell (`layers` planes); grain B
    is its mirror image across the boundary plane, optionally shifted
    in-plane by `translation` (units of the two in-plane cell vectors
    — the microscopic GB translation). `plane_centered=True` puts the
    mirror ON the top atomic plane (shared plane de-duplicated; the
    fcc (111) case IS the coherent twin), else midway between planes.
    Because grain B's stacking tilt is the exact opposite of grain A's,
    the combined stack closes periodically under a PURE-normal third
    cell vector. The structure is returned rotated so the boundary
    normal is Cartesian z (so `relax_cell(strain_mask=diag(0,0,1))`
    relaxes the GB excess volume). `min_dist` optionally deletes one
    atom of any cross-boundary pair closer than it (fused sites of
    unlucky translations).
    """
    cell = np.asarray(bulk.cell, float)
    u, v, w = _in_plane_basis(cell, miller, search=search)
    m = np.stack([u, v, w * layers])
    sym, frac, pc = _fill_supercell(bulk, m)
    pos = frac @ pc
    n_hat = np.cross(pc[0], pc[1])
    n_hat /= np.linalg.norm(n_hat)
    if pc[2] @ n_hat < 0:
        n_hat = -n_hat
    d = float(pc[2] @ n_hat) / layers          # interplanar advance
    z = pos @ n_hat
    z_m = ((layers - 1) * d if plane_centered
           else (layers - 0.5) * d)
    shift = translation[0] * pc[0] + translation[1] * pc[1]
    # grain B excludes the source planes whose mirror images land ON
    # the shared mirror plane (plane-centered) or wrap onto grain A's
    # bottom plane: relying on exact-duplicate removal instead is
    # correct ONLY at zero translation — with a microscopic shift the
    # copies are displaced, not identical, and the bicrystal gains a
    # spurious doubled plane of fused atoms
    tol = 1e-6 * d
    keep_b = z > tol                            # drop z = 0 sources
    if plane_centered:
        keep_b &= z < z_m - tol                 # drop the shared plane
    mirrored = (pos[keep_b]
                + 2.0 * (z_m - z[keep_b])[:, None] * n_hat[None]
                + shift)
    height = 2.0 * z_m
    cell_gb = np.stack([pc[0], pc[1], height * n_hat])

    all_pos = np.concatenate([pos, mirrored])
    all_sym = list(sym) + [s for s, k in zip(sym, keep_b) if k]
    inv = np.linalg.inv(cell_gb)
    fr = all_pos @ inv
    fr -= np.floor(fr + 1e-9)
    # drop exact duplicates (shared mirror plane, wrapped bottom plane)
    keep, kept_fr, kept_sym = [], [], []
    for i, (f, s_i) in enumerate(zip(fr, all_sym)):
        dup = False
        for q, s_q in zip(kept_fr, kept_sym):
            if s_q != s_i:
                continue
            df = f - q
            df -= np.round(df)
            if np.max(np.abs(df @ cell_gb)) < 1e-6:
                dup = True
                break
        if not dup:
            keep.append(i)
            kept_fr.append(f)
            kept_sym.append(s_i)
    fr = np.asarray(kept_fr)
    pos_gb = fr @ cell_gb
    sym_gb = kept_sym
    if min_dist is not None:
        pos_gb, sym_gb = _prune_close_pairs(pos_gb, sym_gb, cell_gb,
                                            min_dist)
    # rotate boundary normal -> z
    e3 = n_hat
    e1 = pc[0] / np.linalg.norm(pc[0])
    e2 = np.cross(e3, e1)
    rot = np.stack([e1, e2, e3])
    return Structure.from_symbols(sym_gb, pos_gb @ rot.T,
                                  cell_gb @ rot.T, pbc=[True] * 3)


def _boundary_energy(calc, bulk: Structure, builder,
                     translations: Optional[Sequence],
                     relax: bool, fmax: float, steps: int
                     ) -> Dict[str, object]:
    """Shared scan: gamma = (E - N e_bulk) / (2 A) minimized over the
    microscopic in-plane translations, with positions AND the normal
    (zz) cell expansion relaxed."""
    from .elastic import relax_cell
    e_bulk = calc.get_potential_energy(bulk) / len(bulk)
    if translations is None:
        translations = [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5),
                        (0.5, 0.5)]
    mask = np.zeros((3, 3))
    mask[2, 2] = 1.0
    best = None
    for tau in translations:
        gb = builder(tau)
        if relax:
            gb = relax_cell(calc, gb, fmax=fmax, smax=0.15,
                            steps=steps, strain_mask=mask)
        e = float(calc.get_potential_energy(gb))
        area = float(np.linalg.norm(np.cross(gb.cell[0], gb.cell[1])))
        gamma = (e - len(gb) * e_bulk) / (2.0 * area)
        entry = {"translation": tuple(tau),
                 "gamma_j_m2": gamma * 16.02176634,
                 "gamma_mj_m2": gamma * 16021.76634,
                 "n_atoms": len(gb), "area_a2": area,
                 "structure": gb}
        if best is None or entry["gamma_j_m2"] < best["gamma_j_m2"]:
            best = entry
    best["e_bulk_per_atom"] = e_bulk
    return best


def grain_boundary_energy(calc, bulk: Structure,
                          miller: Tuple[int, int, int],
                          layers: int = 8,
                          translations: Optional[Sequence] = None,
                          plane_centered: bool = True,
                          relax: bool = True, fmax: float = 0.03,
                          steps: int = 300,
                          min_dist: Optional[float] = None
                          ) -> Dict[str, object]:
    """Symmetric-tilt (mirror) GB energy. Ref: no analog (every
    deformed-cell physics in the reference shells out to LAMMPS)."""
    return _boundary_energy(
        calc, bulk,
        lambda tau: make_tilt_bicrystal(
            bulk, miller, layers=layers, translation=tau,
            plane_centered=plane_centered, min_dist=min_dist),
        translations, relax, fmax, steps)


def _rotation_about(axis: np.ndarray, angle_rad: float) -> np.ndarray:
    n = axis / np.linalg.norm(axis)
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    k = np.array([[0, -n[2], n[1]], [n[2], 0, -n[0]],
                  [-n[1], n[0], 0]])
    return np.eye(3) * c + s * k + (1 - c) * np.outer(n, n)


def make_twist_bicrystal(bulk: Structure,
                         miller: Tuple[int, int, int],
                         angle_deg: float, layers: int = 6,
                         translation: Tuple[float, float] = (0.0, 0.0),
                         search: int = 3, csl_search: int = 6,
                         csl_tol: float = 1e-5,
                         min_dist: Optional[float] = None) -> Structure:
    """Twist bicrystal: grain B is grain A rotated by `angle_deg`
    about the (hkl) plane normal, stacked along it (two equivalent
    twist boundaries per periodic cell).

    Requirements checked explicitly: (a) a PURELY NORMAL stacking
    vector must exist (it does for cubic (001)/(111): [001] advances
    2 planes, [111] advances 3 — axes without one cannot close a
    twist cell periodically); (b) the rotation must map the in-plane
    lattice onto itself over some coincidence-site (CSL) supercell,
    found by testing rotated integer in-plane vectors as crystal
    translations of the BULK (handles centering exactly). Raises if
    no CSL cell exists within `csl_search`.
    """
    cell = np.asarray(bulk.cell, float)
    u, v, _ = _in_plane_basis(cell, miller, search=search)
    n_vec = np.cross(u @ cell, v @ cell)
    n_hat = n_vec / np.linalg.norm(n_vec)
    # (a) shortest integer lattice vector PARALLEL to the normal
    w_n, w_len = None, np.inf
    for t in product(range(-search, search + 1), repeat=3):
        t = np.array(t, int)
        if not t.any():
            continue
        vec = t @ cell
        if np.linalg.norm(vec - (vec @ n_hat) * n_hat) < 1e-9 \
                and vec @ n_hat > 0 and np.linalg.norm(vec) < w_len:
            w_n, w_len = t, float(np.linalg.norm(vec))
    if w_n is None:
        raise ValueError(
            f"no purely-normal stacking vector for {tuple(miller)}: "
            "this axis cannot close a periodic twist cell")
    theta = np.deg2rad(angle_deg)
    rot = _rotation_about(n_hat, theta)
    # (b) in-plane CSL vectors: the bicrystal cell vector c must be a
    # period of BOTH grains — c is in grain A's lattice by integer
    # construction, and in grain B's lattice (= R L) iff R^-1 c is a
    # crystal translation of the bulk
    frac_bulk = bulk.positions @ np.linalg.inv(cell)
    inv_cell = np.linalg.inv(cell)
    matches = []
    for i in range(-csl_search, csl_search + 1):
        for j in range(-csl_search, csl_search + 1):
            if i == 0 and j == 0:
                continue
            vec = (i * u + j * v) @ cell
            rv = rot.T @ vec
            if _is_crystal_translation(frac_bulk, bulk.symbols,
                                       rv @ inv_cell, tol=csl_tol):
                matches.append(((i, j), float(np.linalg.norm(vec))))
    matches.sort(key=lambda x: x[1])
    c1 = c2 = None
    for (i, j), _ln in matches:
        cand = np.array(i, int), np.array(j, int)
        if c1 is None:
            c1 = (i, j)
            continue
        v1 = (c1[0] * u + c1[1] * v) @ cell
        v2 = (i * u + j * v) @ cell
        if np.linalg.norm(np.cross(v1, v2)) > 1e-6:
            c2 = (i, j)
            break
    if c1 is None or c2 is None:
        raise ValueError(
            f"no in-plane CSL cell for {tuple(miller)} twist "
            f"{angle_deg} deg within csl_search={csl_search}")
    m1 = c1[0] * u + c1[1] * v
    m2 = c2[0] * u + c2[1] * v
    m = np.stack([m1, m2, w_n * layers])
    if np.linalg.det(m @ cell) < 0:
        m[1] = -m[1]
        c2 = (-c2[0], -c2[1])
        m2 = -m2
    sym, frac, pc = _fill_supercell(bulk, m)
    pos = frac @ pc
    t_stack = float(pc[2] @ n_hat)             # pure normal by (a)
    shift = translation[0] * pc[0] + translation[1] * pc[1]
    # grain B must be the ROTATED CRYSTAL filled into the SAME cell:
    # rotating the grain-A supercell would double-cover sites (R maps
    # A-lattice vectors outside the cell span onto cell vectors). The
    # pre-images R^T c1/c2 are integer lattice vectors by the CSL
    # test; fill that supercell and rotate it.
    q1 = np.round((rot.T @ (m1 @ cell)) @ inv_cell).astype(int)
    q2 = np.round((rot.T @ (m2 @ cell)) @ inv_cell).astype(int)
    m_b = np.stack([q1, q2, w_n * layers])
    sym_b, frac_b, pc_b = _fill_supercell(bulk, m_b)
    pos_b = ((frac_b @ pc_b) @ rot.T
             + t_stack * n_hat[None] + shift[None])
    sym = list(sym) + list(sym_b)
    cell_gb = np.stack([pc[0], pc[1], 2.0 * t_stack * n_hat])
    all_pos = np.concatenate([pos, pos_b])
    all_sym = sym
    inv_gb = np.linalg.inv(cell_gb)
    fr = all_pos @ inv_gb
    fr -= np.floor(fr + 1e-9)
    pos_gb = fr @ cell_gb
    if min_dist is not None:
        pos_gb, all_sym = _prune_close_pairs(pos_gb, all_sym, cell_gb,
                                             min_dist)
    e3 = n_hat
    e1 = pc[0] / np.linalg.norm(pc[0])
    e2 = np.cross(e3, e1)
    rmat = np.stack([e1, e2, e3])
    return Structure.from_symbols(all_sym, pos_gb @ rmat.T,
                                  cell_gb @ rmat.T, pbc=[True] * 3)


def twist_boundary_energy(calc, bulk: Structure,
                          miller: Tuple[int, int, int],
                          angle_deg: float, layers: int = 6,
                          translations: Optional[Sequence] = None,
                          relax: bool = True, fmax: float = 0.03,
                          steps: int = 300,
                          min_dist: Optional[float] = None
                          ) -> Dict[str, object]:
    """gamma of a twist boundary, minimized over microscopic in-plane
    translations, positions + GB excess volume relaxed."""
    return _boundary_energy(
        calc, bulk,
        lambda tau: make_twist_bicrystal(
            bulk, miller, angle_deg, layers=layers, translation=tau,
            min_dist=min_dist),
        translations, relax, fmax, steps)
