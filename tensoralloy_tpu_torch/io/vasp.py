"""vasprun.xml reader with finite-temperature quantities.

Unlike the stock ASE reader, this extracts (reference
`tensoralloy/io/vasp.py:56+`):
  * E(sigma->0) for zero-temperature datasets (with the VASP
    e_0_energy bug workaround: correction from the last SC step),
  * internal energy U = e_wo_entrp and free energy F = e_fr_energy,
  * electron entropy S = |-(F - U)/sigma| and the smearing width
    sigma as the electron temperature (eV),
for finite-temperature datasets.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Union

import numpy as np

from ..atoms import Structure, full_3x3_to_voigt
from ..elements import atomic_numbers

# VASP stress is in kBar; eV/A^3 = kBar / 1602.1766208
_KBAR_TO_EVA3 = 1.0 / 1602.1766208


def read_vasp_xml(filename: str = "vasprun.xml",
                  index: Union[int, slice] = -1,
                  finite_temperature: bool = False
                  ) -> Union[Structure, List[Structure]]:
    tree = ET.parse(filename)
    root = tree.getroot()

    # species
    species: List[str] = []
    atominfo = root.find("atominfo")
    for rc_el in atominfo.findall("array[@name='atoms']/set/rc"):
        species.append(rc_el.find("c").text.strip())
    numbers = np.array([atomic_numbers[s] for s in species], np.int32)

    # smearing width (electron temperature, eV)
    sigma = None
    for i_el in root.iter("i"):
        if i_el.attrib.get("name") == "SIGMA":
            try:
                sigma = float(i_el.text)
            except (TypeError, ValueError):
                pass
            break

    structures = []
    for calc in root.findall("calculation"):
        struct_el = calc.find("structure")
        basis = np.array(
            [[float(x) for x in v.text.split()]
             for v in struct_el.findall(
                 "crystal/varray[@name='basis']/v")])
        frac = np.array(
            [[float(x) for x in v.text.split()]
             for v in struct_el.findall("varray[@name='positions']/v")])
        positions = frac @ basis

        forces = None
        fvar = calc.find("varray[@name='forces']")
        if fvar is not None:
            forces = np.array([[float(x) for x in v.text.split()]
                               for v in fvar.findall("v")])
        stress = None
        svar = calc.find("varray[@name='stress']")
        if svar is not None:
            s_kbar = np.array([[float(x) for x in v.text.split()]
                               for v in svar.findall("v")])
            # VASP reports the negative of the Cauchy stress in kBar
            stress = full_3x3_to_voigt(-s_kbar * _KBAR_TO_EVA3)

        free_energy = float(calc.find(
            "energy/i[@name='e_fr_energy']").text)
        scsteps = calc.findall("scstep")
        last = scsteps[-1].find("energy")
        e0_last = float(last.find("i[@name='e_0_energy']").text)
        efr_last = float(last.find("i[@name='e_fr_energy']").text)
        ewo_last = float(last.find("i[@name='e_wo_entrp']").text)
        delta = e0_last - efr_last          # e_0 bug workaround
        eentropy_term = efr_last - ewo_last  # F - U = -T S

        if sigma is None or abs(sigma) < 1e-6:
            eentropy = 0.0
        else:
            eentropy = abs(-eentropy_term / sigma)

        info = {"free_energy": free_energy}
        if finite_temperature and sigma is not None:
            # U = F + T S
            info["energy"] = free_energy + eentropy * sigma
            info["etemperature"] = sigma
            info["eentropy"] = eentropy
        else:
            info["energy"] = free_energy + delta   # E(sigma -> 0)
            if sigma is not None:
                info["etemperature"] = sigma
                info["eentropy"] = eentropy
        if forces is not None:
            info["forces"] = forces
        if stress is not None:
            info["stress"] = stress
        structures.append(Structure(numbers, positions, basis,
                                    np.array([True] * 3), info=info))

    if isinstance(index, int):
        return structures[index]
    return structures[index]


def read_poscar(path: str):
    """Read a VASP POSCAR/CONTCAR (vasp5 format with a symbol line;
    Direct or Cartesian coordinates, optional selective dynamics)."""
    from ..atoms import Structure
    with open(path) as fh:
        lines = [ln.rstrip() for ln in fh]
    scale = float(lines[1].split()[0])
    cell = np.array([[float(x) for x in lines[2 + i].split()[:3]]
                     for i in range(3)])
    if scale < 0:  # negative scale = target cell volume
        vol = abs(np.linalg.det(cell))
        scale = (-scale / vol) ** (1.0 / 3.0)
    cell = cell * scale
    symbols_line = lines[5].split()
    if symbols_line and symbols_line[0].isdigit():
        raise ValueError(f"{path}: vasp4 POSCAR without a symbol line "
                         "is not supported — add the element row")
    counts = [int(x) for x in lines[6].split()]
    symbols = []
    for sym, cnt in zip(symbols_line, counts):
        symbols.extend([sym] * cnt)
    idx = 7
    if lines[idx].strip().lower().startswith("s"):  # selective dynamics
        idx += 1
    cartesian = lines[idx].strip().lower().startswith(("c", "k"))
    idx += 1
    n = sum(counts)
    coords = np.array([[float(x) for x in lines[idx + i].split()[:3]]
                       for i in range(n)])
    positions = coords * scale if cartesian else coords @ cell
    return Structure.from_symbols(symbols, positions, cell,
                                  pbc=[True, True, True])
