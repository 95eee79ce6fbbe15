"""LAMMPS potential files (port of `tensoralloy_tpu/io/lammps.py`): setfl
(eam/alloy, eam/fs) and ADP read and written, Tersoff read and written,
MEAM/spline and single-element funcfl read.

setfl layout (eam/alloy):
  3 comment lines
  "N el1 el2 ..."
  "nrho drho nr dr cutoff"
  per element: header (Z, mass, lattice, structure), F(rho) [nrho],
               rho(r) [nr]
  per pair (i, j<=i): r*phi(r) [nr]
ADP (.adp) appends u(r) then w(r) tables for every pair (same order).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class SetflData:
    elements: List[str]
    nrho: int
    drho: float
    nr: int
    dr: float
    cutoff: float
    mass: Dict[str, float]
    lattice: Dict[str, float]
    structure: Dict[str, str]
    frho: Dict[str, np.ndarray]          # per element, [nrho]
    rho: Dict[str, np.ndarray]           # per element (alloy), [nr]
    phi: Dict[str, np.ndarray]           # per unordered pair 'AB', phi (eV)
    dipole: Optional[Dict[str, np.ndarray]] = None
    quadrupole: Optional[Dict[str, np.ndarray]] = None

    @property
    def r_grid(self) -> np.ndarray:
        return np.arange(self.nr) * self.dr

    @property
    def rho_grid(self) -> np.ndarray:
        return np.arange(self.nrho) * self.drho


def _pair_key(a: str, b: str) -> str:
    return "".join(sorted([a, b]))


def _find_element_line(lines: List[str]) -> int:
    """Locate the "N el1 el2 ..." line (LAMMPS says 3 comment lines, but
    published files ship with 0 to 5)."""
    for idx, line in enumerate(lines[:10]):
        toks = line.split()
        if len(toks) >= 2 and toks[0].isdigit() and \
                all(t[:1].isalpha() for t in toks[1:]) and \
                int(toks[0]) == len(toks) - 1:
            return idx
    return 3


def read_eam_alloy_setfl(path: str, is_adp: bool = False,
                         style: str = "alloy") -> SetflData:
    """Read setfl tables; `style` 'alloy' (one rho per element) or
    'fs' (per element, N rho columns rho_{i<-j})."""
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    el_line = _find_element_line(lines)
    elements = lines[el_line].split()[1:]
    n_el = len(elements)
    header = lines[el_line + 1].split()
    nrho, drho = int(header[0]), float(header[1])
    nr, dr = int(header[2]), float(header[3])
    cutoff = float(header[4])
    tokens: List[str] = []
    for line in lines[el_line + 2:]:
        tokens.extend(line.split())
    pos = 0

    def take(n):
        nonlocal pos
        out = tokens[pos:pos + n]
        if len(out) < n:
            raise ValueError(
                f"truncated setfl file: expected {n} more values at "
                f"token {pos}, found {len(out)} (file ends early)")
        pos += n
        return out

    mass, lattice, structure = {}, {}, {}
    frho, rho = {}, {}
    for el in elements:
        hdr = take(4)
        mass[el] = float(hdr[1])
        lattice[el] = float(hdr[2])
        structure[el] = hdr[3]
        frho[el] = np.asarray(take(nrho), dtype=np.float64)
        if style == "fs":
            # eam/fs: for element i, N tables rho_ij(r), the density of
            # a neighbor of type j as seen by type i, keyed "ij"
            for other in elements:
                rho[el + other] = np.asarray(take(nr), dtype=np.float64)
        else:
            rho[el] = np.asarray(take(nr), dtype=np.float64)
    phi = {}
    r = np.arange(nr) * dr
    for i in range(n_el):
        for j in range(i + 1):
            key = _pair_key(elements[i], elements[j])
            rphi = np.asarray(take(nr), dtype=np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                vals = np.where(r > 0, rphi / np.where(r > 0, r, 1.0), 0.0)
            vals[0] = vals[1] if nr > 1 else 0.0
            phi[key] = vals
    dipole = quadrupole = None
    if is_adp:
        dipole, quadrupole = {}, {}
        for i in range(n_el):
            for j in range(i + 1):
                dipole[_pair_key(elements[i], elements[j])] = \
                    np.asarray(take(nr), dtype=np.float64)
        for i in range(n_el):
            for j in range(i + 1):
                quadrupole[_pair_key(elements[i], elements[j])] = \
                    np.asarray(take(nr), dtype=np.float64)
    return SetflData(elements=elements, nrho=nrho, drho=drho, nr=nr, dr=dr,
                     cutoff=cutoff, mass=mass, lattice=lattice,
                     structure=structure, frho=frho, rho=rho, phi=phi,
                     dipole=dipole, quadrupole=quadrupole)


def read_adp_setfl(path: str) -> SetflData:
    return read_eam_alloy_setfl(path, is_adp=True)


def read_eam_fs_setfl(path: str) -> SetflData:
    return read_eam_alloy_setfl(path, style="fs")


def _write_block(fh, values: np.ndarray, per_line: int = 5):
    for lo in range(0, len(values), per_line):
        fh.write(" ".join(f"{v: .16e}" for v in values[lo:lo + per_line]))
        fh.write("\n")


def write_eam_alloy_setfl(path: str, data: SetflData,
                          comments: Optional[List[str]] = None,
                          style: str = "alloy"):
    """Write setfl tables; `style` 'alloy' (one rho column per element)
    or 'fs' (LAMMPS eam/fs: per element i, N columns rho_{i<-j} keyed
    'ij' in data.rho). ADP tables are appended when `data` has them."""
    from ..elements import atomic_numbers
    comments = (comments or ["", "", ""]) + ["", "", ""]
    r = data.r_grid
    with open(path, "w") as fh:
        for c in comments[:3]:
            fh.write(c + "\n")
        fh.write(f"{len(data.elements)} " + " ".join(data.elements) + "\n")
        fh.write(f"{data.nrho} {data.drho:.16e} {data.nr} {data.dr:.16e} "
                 f"{data.cutoff:.16e}\n")
        for el in data.elements:
            fh.write(f"{atomic_numbers[el]} {data.mass[el]:.6f} "
                     f"{data.lattice.get(el, 0.0):.6f} "
                     f"{data.structure.get(el, 'fcc')}\n")
            _write_block(fh, data.frho[el])
            if style == "fs":
                for other in data.elements:
                    _write_block(fh, data.rho[el + other])
            else:
                _write_block(fh, data.rho[el])
        pairs = [_pair_key(data.elements[i], data.elements[j])
                 for i in range(len(data.elements)) for j in range(i + 1)]
        for key in pairs:
            _write_block(fh, data.phi[key] * r)
        if data.dipole is not None:
            for key in pairs:
                _write_block(fh, data.dipole[key])
            for key in pairs:
                _write_block(fh, data.quadrupole[key])


def write_adp_setfl(path: str, data: SetflData,
                    comments: Optional[List[str]] = None):
    if data.dipole is None or data.quadrupole is None:
        raise ValueError("an ADP file needs the dipole and quadrupole "
                         "tables")
    write_eam_alloy_setfl(path, data, comments)


def write_eam_fs_setfl(path: str, data: SetflData,
                       comments: Optional[List[str]] = None):
    """LAMMPS eam/fs layout: data.rho must hold every ordered pair 'AB'
    (density a neighbor of type B contributes at a center A)."""
    missing = [a + b for a in data.elements for b in data.elements
               if a + b not in data.rho]
    if missing:
        raise ValueError(f"fs rho missing pairs {missing}")
    write_eam_alloy_setfl(path, data, comments, style="fs")


TERSOFF_KEYS = ["m", "gamma", "lambda3", "c", "d", "costheta0", "n",
                "beta", "lambda2", "B", "R", "D", "lambda1", "A"]


@dataclasses.dataclass
class TersoffPotential:
    elements: List[str]
    params: Dict[str, Dict[str, float]]


def read_tersoff_file(filename: str) -> TersoffPotential:
    """Parse a LAMMPS Tersoff file: per (el1, el2, el3) entry, 14
    parameters possibly wrapped over two lines."""
    params: Dict[str, Dict[str, float]] = {}
    elements: List[str] = []
    stack: List[str] = []
    kbody_term = None
    with open(filename) as fp:
        for line in fp:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            if not _is_number(tokens[0]):
                kbody_term = "".join(tokens[:3])
                elements.extend(tokens[:3])
                stack = list(tokens[3:])
            else:
                stack.extend(tokens)
            if kbody_term and len(stack) == len(TERSOFF_KEYS):
                params[kbody_term] = {
                    key: float(stack[i])
                    for i, key in enumerate(TERSOFF_KEYS)}
                stack = []
    return TersoffPotential(sorted(set(elements)), params)


def write_tersoff_file(filename: str, potential: TersoffPotential):
    import re
    with open(filename, "w") as fp:
        fp.write("# Tersoff parameters (tensoralloy_tpu)\n")
        fp.write("# el1 el2 el3 " + " ".join(TERSOFF_KEYS) + "\n")
        for kbody_term, params in potential.params.items():
            els = re.findall(r"[A-Z][a-z]*", kbody_term)
            row1 = " ".join(str(params[k]) for k in TERSOFF_KEYS[:7])
            row2 = " ".join(str(params[k]) for k in TERSOFF_KEYS[7:])
            fp.write(f"{els[0]:2s} {els[1]:2s} {els[2]:2s} {row1}\n")
            fp.write(f"          {row2}\n")


def _is_number(token: str) -> bool:
    try:
        float(token)
        return True
    except ValueError:
        return False


# ----------------------------------------------------------------------
# MEAM/spline potential files (reference `io/lammps.py:379-492`)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Spline:
    """Cubic-spline table: knots + clamped first-derivative BCs."""
    x: np.ndarray
    y: np.ndarray
    bc_start: float
    bc_end: float

    def __call__(self, r):
        cs = self.__dict__.get("_cs")
        if cs is None:
            # build the tridiagonal factorization ONCE, not per call
            from scipy.interpolate import CubicSpline
            cs = CubicSpline(
                self.x, self.y,
                bc_type=((1, self.bc_start), (1, self.bc_end)))
            self.__dict__["_cs"] = cs
        return cs(r)


@dataclasses.dataclass
class MeamSpline:
    elements: List[str]
    rho: Dict[str, Spline]
    phi: Dict[str, Spline]
    embed: Dict[str, Spline]
    fs: Dict[str, Spline]
    gs: Dict[str, Spline]


def read_meam_spline_file(filename: str,
                          element: Optional[str] = None) -> MeamSpline:
    """Read new-format (header `meam/spline N el...`) or old-format
    (single element, pass `element`) meam/spline files.

    Spline ordering: phi (N(N+1)/2 pair splines), rho (N), U/embed (N),
    f (N), g (N(N+1)/2)."""
    with open(filename) as fp:
        lines = [ln.strip() for ln in fp
                 if ln.strip() and not ln.strip().startswith("#")]
    i = 0
    if lines[0].startswith("meam/spline"):
        tokens = lines[0].split()
        nel = int(tokens[1])
        elements = tokens[2:2 + nel]
        new_format = True
        i = 1
    else:
        if element is None:
            raise ValueError("old meam/spline format requires `element`")
        elements = [element]
        nel = 1
        new_format = False
    kbody_terms = ["".join([elements[a], elements[b]])
                   for a in range(nel) for b in range(a, nel)]
    npairs = len(kbody_terms)

    splines: List[Spline] = []
    total = npairs * 2 + nel * 3
    while len(splines) < total and i < len(lines):
        if new_format and lines[i] == "spline3eq":
            i += 1
        nknots = int(lines[i]); i += 1
        bc = lines[i].split(); i += 1
        bc_start, bc_end = float(bc[0]), float(bc[1])
        if not new_format:
            i += 1   # old format has an extra (ignored) line
        xs = np.zeros(nknots)
        ys = np.zeros(nknots)
        for k in range(nknots):
            vals = lines[i].split(); i += 1
            xs[k], ys[k] = float(vals[0]), float(vals[1])
        splines.append(Spline(xs, ys, bc_start, bc_end))

    phi = {kbody_terms[k]: splines[k] for k in range(npairs)}
    rho = {elements[k]: splines[npairs + k] for k in range(nel)}
    embed = {elements[k]: splines[npairs + nel + k] for k in range(nel)}
    fs = {elements[k]: splines[npairs + 2 * nel + k] for k in range(nel)}
    gs = {kbody_terms[k]: splines[npairs + 3 * nel + k]
          for k in range(npairs)}
    return MeamSpline(elements, rho, phi, embed, fs, gs)


# ----------------------------------------------------------------------
# funcfl (single-element DYNAMO) format
# ----------------------------------------------------------------------

@dataclasses.dataclass
class FuncflData:
    element: str
    nrho: int
    drho: float
    nr: int
    dr: float
    cutoff: float
    mass: float
    frho: np.ndarray      # [nrho]
    zr: np.ndarray        # [nr] effective charge Z(r)
    rho: np.ndarray       # [nr]

    @property
    def r_grid(self) -> np.ndarray:
        return np.arange(self.nr) * self.dr

    @property
    def rho_grid(self) -> np.ndarray:
        return np.arange(self.nrho) * self.drho

    def phi(self) -> np.ndarray:
        """Pair potential (eV): phi(r) = 27.2 * 0.529 * Z(r)^2 / r."""
        r = self.r_grid
        with np.errstate(divide="ignore", invalid="ignore"):
            v = 27.2 * 0.529 * self.zr ** 2 / np.where(r > 0, r, 1.0)
        v[0] = v[1] if self.nr > 1 else 0.0
        return v


def read_funcfl(path: str) -> FuncflData:
    """Read a single-element DYNAMO funcfl file."""
    from ..elements import chemical_symbols
    with open(path) as fh:
        lines = [ln for ln in fh.read().splitlines() if ln.strip()]
    hdr = lines[1].split()
    z, mass = int(hdr[0]), float(hdr[1])
    grid = lines[2].split()
    nrho, drho = int(grid[0]), float(grid[1])
    nr, dr = int(grid[2]), float(grid[3])
    cutoff = float(grid[4])
    tokens: List[str] = []
    for line in lines[3:]:
        tokens.extend(line.split())
    need = nrho + 2 * nr
    if len(tokens) < need:
        raise ValueError(
            f"truncated funcfl file {path!r}: expected {need} table "
            f"values, found {len(tokens)}")
    frho = np.asarray(tokens[:nrho], dtype=np.float64)
    zr = np.asarray(tokens[nrho:nrho + nr], dtype=np.float64)
    rho = np.asarray(tokens[nrho + nr:nrho + 2 * nr], dtype=np.float64)
    return FuncflData(element=chemical_symbols[z], nrho=nrho, drho=drho,
                      nr=nr, dr=dr, cutoff=cutoff, mass=mass,
                      frho=frho, zr=zr, rho=rho)
