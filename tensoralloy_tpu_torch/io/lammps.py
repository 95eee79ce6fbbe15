"""LAMMPS potential files: setfl (eam/alloy, eam/fs) and ADP, read and
written (port of the setfl half of `tensoralloy_tpu/io/lammps.py`; the
Tersoff, MEAM/spline and funcfl readers are not ported yet).

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


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to tensoralloy_tpu_torch yet; it comes with "
        "the analysis slice (ROADMAP queue 1, item 9)")


def read_tersoff_file(*args, **kwargs):
    _not_ported("read_tersoff_file (Tersoff potential files)")


def write_tersoff_file(*args, **kwargs):
    _not_ported("write_tersoff_file (Tersoff potential files)")


def read_meam_spline_file(*args, **kwargs):
    _not_ported("read_meam_spline_file (MEAM/spline potential files)")


def read_funcfl(*args, **kwargs):
    _not_ported("read_funcfl (single-element funcfl files)")
