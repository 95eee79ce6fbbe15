"""Elastic-constant computation by finite homogeneous deformations
(reference `tensoralloy/analysis/elastic.py:33-684`).

Two methods:

* `compute_elastic_tensor` — clamped-ion 6x6 from central differences
  of the analytic (autodiff) stress, one strain component at a time.
* `fit_elastic_tensor` — the reference's symmetry-aware protocol:
  detect the lattice family, deform only the non-equivalent axes,
  least-squares fit the family's independent constants through its
  stress-strain equation matrix, optionally relaxing internal
  coordinates under each strain (relaxed-ion constants).

Lattice detection is metric-based (cell lengths/angles) since spglib is
not available in this environment; pass ``lattice=`` to override (e.g.
for primitive cells expressed in non-conventional settings).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..atoms import Structure
from ..nn.fields import EV_ANGSTROM3_TO_GPA

_VOIGT_PAIRS = [(0, 0), (1, 1), (2, 2), (1, 2), (0, 2), (0, 1)]


def strain_matrix(voigt_index: int, magnitude: float) -> np.ndarray:
    """Symmetric strain tensor for one Voigt component."""
    eps = np.zeros((3, 3))
    a, b = _VOIGT_PAIRS[voigt_index]
    if a == b:
        eps[a, a] = magnitude
    else:
        eps[a, b] = eps[b, a] = magnitude / 2.0
    return eps


def apply_strain(structure: Structure, eps: np.ndarray) -> Structure:
    out = structure.copy()
    m = np.eye(3) + eps
    out.cell = structure.cell @ m.T
    out.positions = structure.positions @ m.T
    return out


def compute_elastic_tensor(calc, structure: Structure,
                           delta: float = 1e-3,
                           in_gpa: bool = True) -> np.ndarray:
    """Clamped-ion C_ij (Voigt 6x6) = d sigma_i / d eps_j."""
    c = np.zeros((6, 6))
    for j in range(6):
        sp = calc.get_stress(apply_strain(structure,
                                          strain_matrix(j, +delta)))
        sm = calc.get_stress(apply_strain(structure,
                                          strain_matrix(j, -delta)))
        c[:, j] = (np.asarray(sp) - np.asarray(sm)) / (2.0 * delta)
    c = 0.5 * (c + c.T)
    if in_gpa:
        c = c * EV_ANGSTROM3_TO_GPA
    return c



# ----------------------------------------------------------------------
# Symmetry-aware least-squares protocol (reference `elastic.py:33-684`)
# ----------------------------------------------------------------------

LATTICE_NUMBERS = {"triclinic": 1, "monoclinic": 2, "orthorhombic": 3,
                   "tetragonal": 4, "trigonal": 5, "hexagonal": 6,
                   "cubic": 7}


def detect_lattice(structure: Structure, tol: float = 1e-3) -> str:
    """Lattice family from the cell metric (conventional settings).

    spglib is unavailable here, so this inspects lengths/angles only; a
    crystal in a non-conventional cell (e.g. fcc primitive rhombohedron)
    should pass its family explicitly.
    """
    cell = structure.cell
    a, b, c = np.linalg.norm(cell, axis=1)
    def angle(u, v):
        cosv = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
        return np.degrees(np.arccos(np.clip(cosv, -1, 1)))
    al = angle(cell[1], cell[2])
    be = angle(cell[0], cell[2])
    ga = angle(cell[0], cell[1])
    eq = lambda x, y: abs(x - y) < tol * max(abs(x), abs(y), 1.0)
    right = [eq(x, 90.0) for x in (al, be, ga)]
    if all(right):
        if eq(a, b) and eq(b, c):
            return "cubic"
        if eq(a, b):
            return "tetragonal"   # unique axis z, the orientation the
            # tetragonal-I equation matrix assumes
        # a==c or b==c: tetragonal with unique axis x/y — the
        # orthorhombic pattern (same zero couplings, independent
        # C11/C22/C33) is valid in ANY axis orientation, so fit that
        return "orthorhombic"
    if eq(a, b) and right[0] and right[1] and eq(ga, 120.0):
        return "hexagonal"
    if eq(a, b) and eq(b, c) and eq(al, be) and eq(be, ga):
        # rhombohedral-metric cell: the 3-fold axis lies along [111],
        # NOT along z as the trigonal (3bar-m, hexagonal-setting)
        # equation matrix assumes — and fcc/bcc primitive cells land
        # here too. The orientation-independent triclinic fit is the
        # only correct choice; pass lattice='trigonal' explicitly for
        # a hexagonal-setting trigonal crystal.
        return "triclinic"
    if right[0] and right[1] and not right[2]:
        # unique axis c (gamma oblique) — matches the monoclinic
        # C16/C26/C36/C45 coupling pattern of _eq_matrix
        return "monoclinic"
    # monoclinic in the common unique-axis-b (beta oblique) or
    # unique-axis-a setting couples C15/C25/C35/C46 instead; the full
    # triclinic fit is the orientation-independent correct choice
    return "triclinic"


def _eq_matrix(lattice: str, u: np.ndarray) -> np.ndarray:
    """Stress-strain equation matrix M so that  sigma = M @ Cij for the
    family's independent constants (Landau-Lifshitz relations; same
    contract as reference `elastic.py:89-307`)."""
    xx, yy, zz, yz, xz, xy = u
    if lattice == "cubic":
        # C11, C12, C44
        return np.array([[xx, yy + zz, 0],
                         [yy, xx + zz, 0],
                         [zz, xx + yy, 0],
                         [0, 0, 2 * yz],
                         [0, 0, 2 * xz],
                         [0, 0, 2 * xy]])
    if lattice == "tetragonal":
        # C11, C33, C12, C13, C44, C66
        return np.array([[xx, 0, yy, zz, 0, 0],
                         [yy, 0, xx, zz, 0, 0],
                         [0, zz, 0, xx + yy, 0, 0],
                         [0, 0, 0, 0, 2 * yz, 0],
                         [0, 0, 0, 0, 2 * xz, 0],
                         [0, 0, 0, 0, 0, 2 * xy]])
    if lattice == "orthorhombic":
        # C11, C22, C33, C12, C13, C23, C44, C55, C66
        return np.array(
            [[xx, 0, 0, yy, zz, 0, 0, 0, 0],
             [0, yy, 0, xx, 0, zz, 0, 0, 0],
             [0, 0, zz, 0, xx, yy, 0, 0, 0],
             [0, 0, 0, 0, 0, 0, 2 * yz, 0, 0],
             [0, 0, 0, 0, 0, 0, 0, 2 * xz, 0],
             [0, 0, 0, 0, 0, 0, 0, 0, 2 * xy]])
    if lattice == "hexagonal":
        # C11, C33, C12, C13, C44; C66 = (C11 - C12)/2 so
        # sigma_xy = 2 C66 u_xy = (C11 - C12) u_xy
        return np.array([[xx, 0, yy, zz, 0],
                         [yy, 0, xx, zz, 0],
                         [0, zz, 0, xx + yy, 0],
                         [0, 0, 0, 0, 2 * yz],
                         [0, 0, 0, 0, 2 * xz],
                         [xy, 0, -xy, 0, 0]])
    if lattice == "trigonal":
        # C11, C33, C12, C13, C44, C14 for class 3barm:
        #   [C11 C12 C13  C14  0    0  ]
        #   [C12 C11 C13 -C14  0    0  ]
        #   [C13 C13 C33   0   0    0  ]
        #   [C14 -C14  0  C44  0    0  ]
        #   [ 0    0   0   0  C44  C14 ]
        #   [ 0    0   0   0  C14 (C11-C12)/2]
        return np.array(
            [[xx, 0, yy, zz, 0, 2 * yz],
             [yy, 0, xx, zz, 0, -2 * yz],
             [0, zz, 0, xx + yy, 0, 0],
             [0, 0, 0, 0, 2 * yz, xx - yy],
             [0, 0, 0, 0, 2 * xz, 2 * xy],
             [xy, 0, -xy, 0, 0, 2 * xz]])
    if lattice == "monoclinic":
        # C11 C22 C33 C12 C13 C23 C44 C55 C66 C16 C26 C36 C45
        return np.array(
            [[xx, 0, 0, yy, zz, 0, 0, 0, 0, 2 * xy, 0, 0, 0],
             [0, yy, 0, xx, 0, zz, 0, 0, 0, 0, 2 * xy, 0, 0],
             [0, 0, zz, 0, xx, yy, 0, 0, 0, 0, 0, 2 * xy, 0],
             [0, 0, 0, 0, 0, 0, 2 * yz, 0, 0, 0, 0, 0, 2 * xz],
             [0, 0, 0, 0, 0, 0, 0, 2 * xz, 0, 0, 0, 0, 2 * yz],
             [0, 0, 0, 0, 0, 0, 0, 0, 2 * xy, xx, yy, zz, 0]])
    # triclinic: all 21 constants, sigma_i = sum_j C_ij u_j (2x shears)
    w = np.array([xx, yy, zz, 2 * yz, 2 * xz, 2 * xy])
    m = np.zeros((6, 21))
    idx = 0
    pairs = [(i, j) for i in range(6) for j in range(i, 6)]
    for (i, j) in pairs:
        m[i, idx] += w[j]
        if i != j:
            m[j, idx] += w[i]
        idx += 1
    return m


_CIJ_SLOTS = {
    # family -> [(name, [(i, j), ...] Voigt slots it fills)]
    "cubic": [("C11", [(0, 0), (1, 1), (2, 2)]),
              ("C12", [(0, 1), (0, 2), (1, 2)]),
              ("C44", [(3, 3), (4, 4), (5, 5)])],
    "tetragonal": [("C11", [(0, 0), (1, 1)]), ("C33", [(2, 2)]),
                   ("C12", [(0, 1)]), ("C13", [(0, 2), (1, 2)]),
                   ("C44", [(3, 3), (4, 4)]), ("C66", [(5, 5)])],
    "orthorhombic": [("C11", [(0, 0)]), ("C22", [(1, 1)]),
                     ("C33", [(2, 2)]), ("C12", [(0, 1)]),
                     ("C13", [(0, 2)]), ("C23", [(1, 2)]),
                     ("C44", [(3, 3)]), ("C55", [(4, 4)]),
                     ("C66", [(5, 5)])],
    "hexagonal": [("C11", [(0, 0), (1, 1)]), ("C33", [(2, 2)]),
                  ("C12", [(0, 1)]), ("C13", [(0, 2), (1, 2)]),
                  ("C44", [(3, 3), (4, 4)])],
    "trigonal": [("C11", [(0, 0), (1, 1)]), ("C33", [(2, 2)]),
                 ("C12", [(0, 1)]), ("C13", [(0, 2), (1, 2)]),
                 ("C44", [(3, 3), (4, 4)]),
                 # C24 = -C14, C56 = +C14 (sign handled at fill time)
                 ("C14", [(0, 3), (1, 3), (4, 5)])],
    "monoclinic": [("C11", [(0, 0)]), ("C22", [(1, 1)]),
                   ("C33", [(2, 2)]), ("C12", [(0, 1)]),
                   ("C13", [(0, 2)]), ("C23", [(1, 2)]),
                   ("C44", [(3, 3)]), ("C55", [(4, 4)]),
                   ("C66", [(5, 5)]), ("C16", [(0, 5)]),
                   ("C26", [(1, 5)]), ("C36", [(2, 5)]),
                   ("C45", [(3, 4)])],
}

_DEFORM_AXES = {
    "cubic": [0, 3],
    "hexagonal": [0, 2, 3, 5],
    "trigonal": [0, 1, 2, 3, 4, 5],
    "tetragonal": [0, 2, 3, 5],
    "orthorhombic": [0, 1, 2, 3, 4, 5],
    "monoclinic": [0, 1, 2, 3, 4, 5],
    "triclinic": [0, 1, 2, 3, 4, 5],
}


def deformed_cell(structure: Structure, axis: int,
                  size_percent: float) -> Structure:
    """One Cartesian deformation: axes 0-2 stretch x/y/z, 3-5 shear
    yz/xz/xy by `size_percent` / 100."""
    s = size_percent / 100.0
    m = np.eye(3)
    if axis < 3:
        m[axis, axis] += s
    else:
        a, b = [(1, 2), (0, 2), (0, 1)][axis - 3]
        m[a, b] += s
    out = structure.copy()
    out.cell = structure.cell @ m
    out.positions = structure.positions @ m
    return out


def elementary_deformations(structure: Structure, n: int = 5,
                            d: float = 2.0,
                            lattice: Optional[str] = None):
    """Symmetry-reduced deformation set (reference
    `elastic.py:407-456`)."""
    lattice = lattice or detect_lattice(structure)
    systems = []
    for axis in _DEFORM_AXES[lattice]:
        if axis < 3:
            sizes = np.linspace(-d, d, n)
        else:
            sizes = np.linspace(d / 10.0, d, n)
        for dx in sizes:
            systems.append(deformed_cell(structure, axis, dx))
    return systems, lattice


def voigt_strain(deformed: Structure, reference: Structure) -> np.ndarray:
    """Symmetrized strain in Voigt order [xx, yy, zz, yz, xz, xy]."""
    du = deformed.cell - reference.cell
    u = np.linalg.inv(reference.cell) @ du
    u = 0.5 * (u + u.T)
    return np.array([u[0, 0], u[1, 1], u[2, 2],
                     u[2, 1], u[2, 0], u[1, 0]])


def relax_positions(calc, structure: Structure, fmax: float = 0.02,
                    steps: int = 200, dt: float = 0.08) -> Structure:
    """Fixed-cell internal relaxation (damped dynamics / FIRE-lite)."""
    s = structure.copy()
    v = np.zeros_like(s.positions)
    a_scale = 0.1
    for _ in range(steps):
        f = np.asarray(calc.get_forces(s))
        if np.abs(f).max() < fmax:
            break
        power = float(np.vdot(f, v))
        if power > 0:
            fn = np.linalg.norm(f) or 1.0
            vn = np.linalg.norm(v)
            v = (1 - a_scale) * v + a_scale * vn * f / fn
        else:
            v[:] = 0.0
        v = v + dt * f
        s.positions = s.positions + dt * v
    return s


def relax_cell(calc, structure: Structure, fmax: float = 0.02,
               smax: float = 0.05, steps: int = 500, dt: float = 0.08,
               pressure: float = 0.0,
               hydrostatic: bool = False,
               strain_mask: Optional[np.ndarray] = None) -> Structure:
    """Combined position + cell relaxation (UnitCellFilter-style
    damped dynamics; ref analog: `analysis/lammps` LatticeConstant,
    which shells out to LAMMPS `fix box/relax`).

    The degrees of freedom are the Cartesian positions plus a
    symmetric strain `eps` of the ORIGINAL cell, h = h0 (1 + eps);
    the generalized gradient on the strain block is V (sigma + P 1)
    — energy (enthalpy at `pressure` GPa) decreases along the negative
    stress, so cell and ions relax together in one FIRE-lite loop.
    Both come from the SAME device call (`calc.calculate` yields
    forces and stress from one backward pass).

    Converged when max|F| < `fmax` (eV/A) AND every deviatoric +
    pressure-shifted stress component is under `smax` (GPa).
    `hydrostatic=True` restricts the cell motion to isotropic scaling
    (shape-preserving, volume-only). `strain_mask` ([3, 3] of {0, 1},
    symmetric) frees only the selected strain components — e.g.
    `diag(1, 1, 0)` relaxes the transverse response under a FIXED
    axial stretch (the constrained mode an ideal-strength scan needs);
    masked components also drop out of the stress convergence test.
    """
    from ..nn.fields import EV_ANGSTROM3_TO_GPA
    s = structure.copy()
    if not np.asarray(s.pbc).all():
        raise ValueError("relax_cell needs a fully periodic cell")
    h0 = s.cell.copy()
    eps = np.zeros((3, 3))
    p_ev = pressure / EV_ANGSTROM3_TO_GPA
    cell_factor = float(max(len(s), 1))
    v_pos = np.zeros_like(s.positions)
    v_eps = np.zeros((3, 3))
    a_scale = 0.1
    for _ in range(steps):
        res = calc.calculate(s)
        f = np.asarray(res["forces"])[:len(s)]
        sv = np.asarray(res["stress"])          # Voigt [6], eV/A^3
        sigma = np.array([[sv[0], sv[5], sv[4]],
                          [sv[5], sv[1], sv[3]],
                          [sv[4], sv[3], sv[2]]])
        vol = abs(np.linalg.det(s.cell))
        g_eps = -vol * (sigma + p_ev * np.eye(3)) / cell_factor
        g_eps = 0.5 * (g_eps + g_eps.T)
        if hydrostatic:
            g_eps = np.eye(3) * np.trace(g_eps) / 3.0
        if strain_mask is not None:
            g_eps = g_eps * strain_mask
        s_gpa = (sigma + p_ev * np.eye(3)) * EV_ANGSTROM3_TO_GPA
        s_conv = (s_gpa if strain_mask is None
                  else s_gpa * strain_mask)
        if np.abs(f).max() < fmax and np.abs(s_conv).max() < smax:
            break
        # FIRE-lite mixing over the CONCATENATED dof vector
        power = float(np.vdot(f, v_pos)) + float(np.vdot(g_eps, v_eps))
        if power > 0:
            gn = np.sqrt(np.linalg.norm(f) ** 2 +
                         np.linalg.norm(g_eps) ** 2) or 1.0
            vn = np.sqrt(np.linalg.norm(v_pos) ** 2 +
                         np.linalg.norm(v_eps) ** 2)
            v_pos = (1 - a_scale) * v_pos + a_scale * vn * f / gn
            v_eps = (1 - a_scale) * v_eps + a_scale * vn * g_eps / gn
        else:
            v_pos[:] = 0.0
            v_eps[:] = 0.0
        v_pos = v_pos + dt * f
        v_eps = v_eps + dt * g_eps
        eps = eps + dt * v_eps / cell_factor
        new_cell = h0 @ (np.eye(3) + eps)
        # affine cell update on the fractional coords, then the ionic
        # FIRE step in Cartesian
        frac = s.positions @ np.linalg.inv(s.cell)
        s.cell = new_cell
        s.positions = frac @ new_cell + dt * v_pos
    return s


def fit_elastic_tensor(calc, structure: Structure, n: int = 5,
                       d: float = 2.0, lattice: Optional[str] = None,
                       relax_ions: bool = False, in_gpa: bool = True,
                       stress_fn: Optional[Callable] = None):
    """Symmetry-reduced least-squares elastic tensor.

    -> (C 6x6, {"lattice", "cij", "residual"}). `stress_fn` overrides
    `calc.get_stress` (Voigt eV/A^3).
    """
    get_stress = stress_fn or (lambda s: np.asarray(calc.get_stress(s)))
    systems, lattice = elementary_deformations(structure, n=n, d=d,
                                               lattice=lattice)
    p = -np.mean(get_stress(structure)[:3])
    rows, rhs = [], []
    for g in systems:
        if relax_ions:
            g = relax_positions(calc, g)
        u = voigt_strain(g, structure)
        sigma = get_stress(g) - np.array([-p, -p, -p, 0, 0, 0])
        rows.append(_eq_matrix(lattice, u))
        rhs.append(sigma)
    m = np.concatenate(rows, axis=0)
    y = np.concatenate(rhs)
    cij, res, _, _ = np.linalg.lstsq(m, y, rcond=None)
    # Birch-coefficient -> elastic-constant correction at finite ambient
    # pressure (reference `elastic.py:566-588`); zero at equilibrium
    birch = {
        "cubic": [-1, 1, -1],
        "tetragonal": [-1, -1, 1, 1, -1, -1],
        "orthorhombic": [-1, -1, -1, 1, 1, 1, -1, -1, -1],
        "trigonal": [-1, -1, 1, 1, -1, 1],
        "hexagonal": [-1, -1, 1, 1, -1],
        "monoclinic": [-1, -1, -1, 1, 1, 1, -1, -1, -1, 1, 1, 1, 1],
    }
    if lattice in birch:
        cij = cij - p * np.asarray(birch[lattice], dtype=float)

    c = np.zeros((6, 6))
    if lattice == "triclinic":
        idx = 0
        for i in range(6):
            for j in range(i, 6):
                c[i, j] = cij[idx]
                idx += 1
    else:
        names = _CIJ_SLOTS[lattice]
        for (name, slots), value in zip(names, cij):
            for (i, j) in slots:
                sign = -1.0 if (lattice == "trigonal" and name == "C14"
                                and (i, j) == (1, 3)) else 1.0
                c[i, j] = sign * value
        if lattice in ("hexagonal", "trigonal"):
            c[5, 5] = 0.5 * (c[0, 0] - c[0, 1])
    # all slots fill the upper triangle; mirror it
    c = np.triu(c) + np.triu(c, 1).T
    info = {"lattice": lattice,
            "cij": {name: float(v) * (EV_ANGSTROM3_TO_GPA if in_gpa
                                      else 1.0)
                    for (name, _), v in zip(
                        _CIJ_SLOTS.get(lattice, []), cij)}
            if lattice != "triclinic" else {},
            "residual": float(res[0]) if len(np.atleast_1d(res)) else 0.0}
    if in_gpa:
        c = c * EV_ANGSTROM3_TO_GPA
    return c, info


def cubic_constants(c: np.ndarray) -> dict:
    """{c11, c12, c44} averages for cubic symmetry."""
    return {"c11": float(np.mean([c[0, 0], c[1, 1], c[2, 2]])),
            "c12": float(np.mean([c[0, 1], c[0, 2], c[1, 2]])),
            "c44": float(np.mean([c[3, 3], c[4, 4], c[5, 5]]))}


def bulk_modulus_voigt(c: np.ndarray) -> float:
    return float((c[0, 0] + c[1, 1] + c[2, 2] +
                  2.0 * (c[0, 1] + c[0, 2] + c[1, 2])) / 9.0)


def shear_modulus_voigt(c: np.ndarray) -> float:
    return float(((c[0, 0] + c[1, 1] + c[2, 2]) -
                  (c[0, 1] + c[0, 2] + c[1, 2]) +
                  3.0 * (c[3, 3] + c[4, 4] + c[5, 5])) / 15.0)


def ideal_strength(calc, structure: Structure, axis: int = 2,
                   max_strain: float = 0.30, n_points: int = 16,
                   fmax: float = 0.02, smax: float = 0.1,
                   steps: int = 300) -> dict:
    """Ideal (theoretical) tensile strength along a cell axis.

    The cell is stretched by a FIXED axial strain along `axis` while
    the positions and every OTHER strain component relax
    (`relax_cell(strain_mask=...)` with the axial row/column frozen —
    the standard uniaxial-stress protocol). The axial true stress
    sigma(eps) rises to the ideal strength and falls past the
    instability; the scan stops once the peak is clearly passed.

    Returns {"strain", "stress_gpa" (axial), "energy_per_atom",
    "sigma_max_gpa", "eps_at_max", "youngs_modulus_gpa" (small-strain
    secant)}. Ref: no analog (the reference delegates every deformed-
    cell calculation to exported LAMMPS potentials).
    """
    mask = np.ones((3, 3))
    mask[axis, :] = 0.0
    mask[:, axis] = 0.0
    base = structure.copy()
    strains = np.linspace(0.0, max_strain, n_points)
    stresses, energies = [], []
    s_prev = base
    for eps in strains:
        # warm-start from the previous relaxed state, but pin the
        # axial vector to the PRISTINE one stretched by the total
        # strain (so eps is exact, not accumulated)
        stretched = s_prev.copy()
        frac = s_prev.positions @ np.linalg.inv(s_prev.cell)
        stretched.cell = s_prev.cell.copy()
        stretched.cell[axis] = base.cell[axis] * (1.0 + eps)
        stretched.positions = frac @ stretched.cell
        relaxed = relax_cell(calc, stretched, fmax=fmax, smax=smax,
                             steps=steps, strain_mask=mask)
        sv = np.asarray(calc.get_stress(relaxed))
        sigma_ax = float(sv[axis]) * EV_ANGSTROM3_TO_GPA
        stresses.append(sigma_ax)
        energies.append(float(calc.get_potential_energy(relaxed))
                        / len(relaxed))
        s_prev = relaxed
        if (len(stresses) > 3 and sigma_ax < 0.5 * max(stresses)
                and max(stresses) > 0):
            strains = strains[:len(stresses)]
            break
    stresses = np.asarray(stresses)
    energies = np.asarray(energies)
    i_max = int(np.argmax(stresses))
    young = (stresses[1] / strains[1] if len(stresses) > 1
             and strains[1] > 0 else float("nan"))
    return {"strain": strains[:len(stresses)],
            "stress_gpa": stresses,
            "energy_per_atom": energies,
            "sigma_max_gpa": float(stresses[i_max]),
            "eps_at_max": float(strains[i_max]),
            "youngs_modulus_gpa": float(young)}


def ideal_shear_strength(calc, structure: Structure,
                         plane_axis: int = 2, shear_dir: int = 0,
                         max_strain: float = 0.4, n_points: int = 17,
                         fmax: float = 0.02, smax: float = 0.1,
                         steps: int = 300) -> dict:
    """Ideal (affine) shear strength: simple shear of the `plane_axis`
    cell vector along `shear_dir` (engineering gamma), with positions
    and every OTHER strain component relaxed — the relaxed ideal-shear
    protocol. For an fcc conventional cell sheared on (001) along
    [100] there are no internal modes, so the small-strain slope is
    exactly C44.

    Returns {"strain" (gamma), "stress_gpa" (the sheared component),
    "energy_per_atom", "tau_max_gpa", "gamma_at_max",
    "shear_modulus_gpa" (small-strain secant)}.
    """
    if plane_axis == shear_dir:
        raise ValueError("plane_axis and shear_dir must differ")
    # Voigt index of the sheared component
    pair = tuple(sorted((plane_axis, shear_dir)))
    voigt_idx = {(1, 2): 3, (0, 2): 4, (0, 1): 5}[pair]
    mask = np.ones((3, 3))
    mask[plane_axis, shear_dir] = 0.0
    mask[shear_dir, plane_axis] = 0.0
    base = structure.copy()
    e_s = base.cell[shear_dir] / np.linalg.norm(base.cell[shear_dir])
    other = [i for i in range(3) if i != plane_axis]
    n_hat = np.cross(base.cell[other[0]], base.cell[other[1]])
    n_hat /= np.linalg.norm(n_hat)
    height = float(base.cell[plane_axis] @ n_hat)
    strains = np.linspace(0.0, max_strain, n_points)
    stresses, energies = [], []
    s_prev = base
    for gam in strains:
        stretched = s_prev.copy()
        frac = s_prev.positions @ np.linalg.inv(s_prev.cell)
        row = s_prev.cell[plane_axis].copy()
        # replace the shear-direction component with the exact total
        # applied shear (everything else carries over from relaxation)
        row = row - (row @ e_s) * e_s \
            + (float(base.cell[plane_axis] @ e_s)
               + gam * abs(height)) * e_s
        stretched.cell = s_prev.cell.copy()
        stretched.cell[plane_axis] = row
        stretched.positions = frac @ stretched.cell
        relaxed = relax_cell(calc, stretched, fmax=fmax, smax=smax,
                             steps=steps, strain_mask=mask)
        sv = np.asarray(calc.get_stress(relaxed))
        tau = float(sv[voigt_idx]) * EV_ANGSTROM3_TO_GPA
        stresses.append(tau)
        energies.append(float(calc.get_potential_energy(relaxed))
                        / len(relaxed))
        s_prev = relaxed
        if (len(stresses) > 3
                and abs(tau) < 0.5 * max(np.abs(stresses))
                and max(np.abs(stresses)) > 0):
            strains = strains[:len(stresses)]
            break
    stresses = np.asarray(stresses)
    i_max = int(np.argmax(np.abs(stresses)))
    mu = (stresses[1] / strains[1] if len(stresses) > 1
          and strains[1] > 0 else float("nan"))
    return {"strain": strains[:len(stresses)],
            "stress_gpa": stresses,
            "energy_per_atom": np.asarray(energies),
            "tau_max_gpa": float(abs(stresses[i_max])),
            "gamma_at_max": float(strains[i_max]),
            "shear_modulus_gpa": float(mu)}
