"""LAMMPS driver calculators (reference `analysis/lammps/calcs.py`,
vendored from mlearn): EnergyForceStress, LatticeConstant,
ElasticConstant, NudgedElasticBand, DefectFormation.

Each driver writes a complete LAMMPS input deck (data file + script,
templates inlined below) into a scratch directory; `run()` executes the
binary named by $LAMMPS_COMMAND (skipped/raises when absent) and parses
the log. Exported setfl/ADP tables from the EAM models plug directly
into these drivers for independent cross-validation.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..atoms import Structure


def get_lammps_command() -> Optional[str]:
    cmd = os.environ.get("LAMMPS_COMMAND")
    if cmd and shutil.which(cmd.split()[0]):
        return cmd
    return None


def lower_triangular_cell(cell: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate the cell to the LAMMPS lower-triangular convention.
    Returns (new_cell, rotation) with new_cell = cell @ rotation."""
    a, b, c = cell
    ax = np.linalg.norm(a)
    ahat = a / ax
    bx = b @ ahat
    by = np.linalg.norm(b - bx * ahat)
    cx = c @ ahat
    nhat = np.cross(ahat, (b - bx * ahat) / by)
    cy = c @ np.cross(nhat, ahat)
    cz = abs(c @ nhat)
    new_cell = np.array([[ax, 0, 0], [bx, by, 0], [cx, cy, cz]])
    rotation = np.linalg.solve(cell, new_cell)
    return new_cell, rotation


def write_lammps_data(path: str, structure: Structure,
                      elements: Optional[List[str]] = None):
    """Write an atomic-style LAMMPS data file (reference
    `io/lammps.py:495+`)."""
    s = structure.ensure_cell()
    if elements is None:
        elements = sorted(set(s.symbols))
    cell, rot = lower_triangular_cell(s.cell)
    pos = s.positions @ rot
    types = [elements.index(sym) + 1 for sym in s.symbols]
    xy, xz, yz = cell[1, 0], cell[2, 0], cell[2, 1]
    tilted = max(abs(xy), abs(xz), abs(yz)) > 1e-10
    with open(path, "w") as fh:
        fh.write("# generated by tensoralloy_tpu\n\n")
        fh.write(f"{len(s)} atoms\n{len(elements)} atom types\n\n")
        fh.write(f"0.0 {cell[0, 0]:.12f} xlo xhi\n")
        fh.write(f"0.0 {cell[1, 1]:.12f} ylo yhi\n")
        fh.write(f"0.0 {cell[2, 2]:.12f} zlo zhi\n")
        if tilted:
            fh.write(f"{xy:.12f} {xz:.12f} {yz:.12f} xy xz yz\n")
        fh.write("\nMasses\n\n")
        from ..elements import atomic_masses, atomic_numbers
        for i, e in enumerate(elements):
            fh.write(f"{i + 1} {atomic_masses[atomic_numbers[e]]:.6f}\n")
        fh.write("\nAtoms\n\n")
        for i, (t, p) in enumerate(zip(types, pos)):
            fh.write(f"{i + 1} {t} {p[0]:.12f} {p[1]:.12f} "
                     f"{p[2]:.12f}\n")
    return elements


class LammpsDriver:
    """Base: deck assembly + execution + log parsing."""

    def __init__(self, pair_style: str, pair_coeff: str,
                 workdir: Optional[str] = None):
        self.pair_style = pair_style
        self.pair_coeff = pair_coeff
        self.workdir = workdir or tempfile.mkdtemp(prefix="talmp_")
        os.makedirs(self.workdir, exist_ok=True)

    def script(self, structure: Structure) -> str:
        raise NotImplementedError

    def write_deck(self, structure: Structure) -> str:
        elements = write_lammps_data(
            os.path.join(self.workdir, "data.lammps"), structure)
        self._elements = elements
        script = self.script(structure)
        path = os.path.join(self.workdir, "in.lammps")
        with open(path, "w") as fh:
            fh.write(script)
        return path

    def _header(self) -> str:
        return ("units metal\natom_style atomic\nboundary p p p\n"
                "read_data data.lammps\n"
                f"pair_style {self.pair_style}\n"
                f"pair_coeff {self.pair_coeff}\n")

    def run(self, structure: Structure) -> str:
        cmd = get_lammps_command()
        if cmd is None:
            raise RuntimeError(
                "LAMMPS_COMMAND is not set or the binary is missing")
        self.write_deck(structure)
        out = subprocess.run(
            cmd.split() + ["-in", "in.lammps", "-log", "log.lammps"],
            cwd=self.workdir, capture_output=True, text=True,
            timeout=600)
        if out.returncode != 0:
            raise RuntimeError(f"LAMMPS failed: {out.stderr[-2000:]}")
        return open(os.path.join(self.workdir, "log.lammps")).read()

    @staticmethod
    def parse_thermo(log: str, keys: List[str]) -> Dict[str, float]:
        """Last thermo row keyed by the printed custom names."""
        lines = log.splitlines()
        values = {}
        for i, line in enumerate(lines):
            toks = line.split()
            if toks and all(k in toks for k in keys):
                for row in lines[i + 1:]:
                    rt = row.split()
                    if len(rt) != len(toks):
                        break
                    try:
                        vals = [float(x) for x in rt]
                    except ValueError:
                        break
                    values = dict(zip(toks, vals))
        return values


class EnergyForceStress(LammpsDriver):
    """Single-point energy / forces / stress."""

    def script(self, structure: Structure) -> str:
        return (self._header() +
                "compute s all pressure NULL virial\n"
                "thermo_style custom pe c_s[1] c_s[2] c_s[3] "
                "c_s[4] c_s[5] c_s[6]\n"
                "dump d all custom 1 forces.dump id fx fy fz\n"
                "dump_modify d sort id\nrun 0\n")

    def calculate(self, structure: Structure):
        log = self.run(structure)
        thermo = self.parse_thermo(
            log, ["PotEng", "c_s[1]"]) or self.parse_thermo(
            log, ["pe", "c_s[1]"])
        forces = []
        with open(os.path.join(self.workdir, "forces.dump")) as fh:
            grab = False
            for line in fh:
                if line.startswith("ITEM: ATOMS"):
                    grab = True
                    continue
                if grab:
                    toks = line.split()
                    forces.append([float(x) for x in toks[1:4]])
        pe = thermo.get("PotEng", thermo.get("pe"))
        stress_bar = np.array([thermo.get(f"c_s[{i}]", 0.0)
                               for i in range(1, 7)])
        # LAMMPS pressure components in bar; stress = -P;
        # 1 bar = 1e-4 GPa = 1e-4 / 160.21766208 eV/A^3
        stress = -stress_bar * 1e-4 / 160.21766208
        return {"energy": pe, "forces": np.asarray(forces),
                "stress": stress}


class LatticeConstant(LammpsDriver):
    """Relax cell at zero pressure -> equilibrium lattice constants."""

    def script(self, structure: Structure) -> str:
        return (self._header() +
                "fix r all box/relax iso 0.0 vmax 0.001\n"
                "min_style cg\nminimize 1e-12 1e-12 10000 100000\n"
                "variable lx equal lx\nvariable ly equal ly\n"
                "variable lz equal lz\n"
                "thermo_style custom lx ly lz pe\nrun 0\n")

    def calculate(self, structure: Structure):
        log = self.run(structure)
        thermo = self.parse_thermo(log, ["Lx", "Ly", "Lz"]) or \
            self.parse_thermo(log, ["lx", "ly", "lz"])
        return {k.lower(): v for k, v in thermo.items()}


class ElasticConstant(LammpsDriver):
    """Finite-deformation elastic constants via LAMMPS (simplified
    version of the mlearn template: one strain per run)."""

    def __init__(self, *args, delta: float = 1e-3, **kwargs):
        super().__init__(*args, **kwargs)
        self.delta = delta

    def script(self, structure: Structure) -> str:
        return (self._header() +
                "compute s all pressure NULL virial\n"
                "thermo_style custom pe c_s[1] c_s[2] c_s[3] "
                "c_s[4] c_s[5] c_s[6]\nrun 0\n")

    def calculate(self, structure: Structure) -> np.ndarray:
        from .elastic import strain_matrix, apply_strain
        efs = EnergyForceStress(self.pair_style, self.pair_coeff,
                                self.workdir)
        c = np.zeros((6, 6))
        for j in range(6):
            sp = efs.calculate(apply_strain(
                structure, strain_matrix(j, +self.delta)))["stress"]
            sm = efs.calculate(apply_strain(
                structure, strain_matrix(j, -self.delta)))["stress"]
            c[:, j] = (sp - sm) / (2 * self.delta) * 160.21766208
        return 0.5 * (c + c.T)


class DefectFormation(LammpsDriver):
    """Vacancy-formation energy: E_defect - (N-1)/N E_bulk."""

    def script(self, structure: Structure) -> str:
        return (self._header() +
                "min_style cg\nminimize 1e-10 1e-10 5000 50000\n"
                "thermo_style custom pe\nrun 0\n")

    def calculate(self, structure: Structure, site: int = 0):
        log = self.run(structure)
        e_bulk = self.parse_thermo(log, ["PotEng"]).get("PotEng")
        keep = [i for i in range(len(structure)) if i != site]
        defect = Structure(structure.numbers[keep],
                           structure.positions[keep],
                           structure.cell.copy(), structure.pbc.copy())
        log2 = self.run(defect)
        e_def = self.parse_thermo(log2, ["PotEng"]).get("PotEng")
        n = len(structure)
        return e_def - (n - 1) / n * e_bulk


class NudgedElasticBand(LammpsDriver):
    """NEB migration barrier (requires a LAMMPS build with replica
    support; deck generation only unless $LAMMPS_COMMAND supports
    `-partition`)."""

    def __init__(self, *args, n_replicas: int = 7, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_replicas = n_replicas

    def script(self, structure: Structure) -> str:
        return (self._header() +
                "fix neb all neb 1.0\nmin_style quickmin\n"
                "thermo_style custom pe\n"
                f"neb 1e-8 1e-8 5000 5000 10 final final.coords\n")

    def write_final_coords(self, final: Structure) -> str:
        """LAMMPS `neb ... final <file>` format: natoms, then
        `id x y z` per (moved) atom."""
        path = os.path.join(self.workdir, "final.coords")
        with open(path, "w") as fh:
            fh.write(f"{len(final)}\n")
            for k, p in enumerate(final.positions):
                fh.write(f"{k + 1} {p[0]:.10f} {p[1]:.10f} {p[2]:.10f}\n")
        return path

    @staticmethod
    def parse_neb_log(log: str) -> Dict[str, float]:
        """Forward/reverse barriers from the NEB master log: the last
        data row's EBF/EBR columns (`Step MaxReplicaForce MaxAtomForce
        GradV0 GradV1 GradVc EBF EBR RDT RD1 PE1 ...`)."""
        header_cols = None
        last_row = None
        for line in log.splitlines():
            toks = line.split()
            if "EBF" in toks and "EBR" in toks:
                header_cols = toks
                continue
            if header_cols and len(toks) >= len(header_cols):
                try:
                    [float(t) for t in toks[:len(header_cols)]]
                except ValueError:
                    continue
                last_row = toks
        if header_cols is None or last_row is None:
            raise RuntimeError("no NEB rows found in log")
        out = {}
        for key in ("EBF", "EBR", "RDT"):
            out[key] = float(last_row[header_cols.index(key)])
        return out

    def calculate(self, initial: Structure, final: Structure
                  ) -> Dict[str, float]:
        """Run replica-parallel LAMMPS NEB (needs a binary with the
        REPLICA package; `$LAMMPS_COMMAND` must accept `-partition`).
        Returns forward/reverse barriers (eV) and the reaction-path
        length. The native on-device `tensoralloy_tpu_torch.neb` covers
        barrier searches without LAMMPS."""
        cmd = get_lammps_command()
        if cmd is None:
            raise RuntimeError(
                "LAMMPS_COMMAND is not set or the binary is missing")
        self.write_deck(initial)
        self.write_final_coords(final)
        out = subprocess.run(
            cmd.split() + ["-partition", f"{self.n_replicas}x1",
                           "-in", "in.lammps", "-log", "log.lammps",
                           "-screen", "none"],
            cwd=self.workdir, capture_output=True, text=True,
            timeout=1800)
        if out.returncode != 0:
            raise RuntimeError(f"LAMMPS NEB failed: {out.stderr[-2000:]}")
        log = open(os.path.join(self.workdir, "log.lammps")).read()
        parsed = self.parse_neb_log(log)
        return {"barrier_forward": parsed["EBF"],
                "barrier_reverse": parsed["EBR"],
                "path_length": parsed["RDT"]}
