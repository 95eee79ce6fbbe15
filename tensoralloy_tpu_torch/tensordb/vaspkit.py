"""VASP job inspection helpers (port of
`tensoralloy_tpu/tensordb/vaspkit.py`; reference `tensordb/vaspkit.py`):
INCAR/OSZICAR/OUTCAR parsing, SCF convergence checks, cost accounting.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class ServiceUnit:
    """CPU-hour cost estimate of a VASP job."""
    ncores: int
    elapsed_seconds: float

    @property
    def core_hours(self) -> float:
        return self.ncores * self.elapsed_seconds / 3600.0


class VaspJob:
    """Parse a finished/running VASP job directory."""

    def __init__(self, jobdir):
        self.jobdir = Path(jobdir)
        self._incar: Optional[Dict[str, str]] = None

    # ----------------------------- INCAR ---------------------------
    @property
    def incar(self) -> Dict[str, str]:
        if self._incar is None:
            params: Dict[str, str] = {}
            path = self.jobdir / "INCAR"
            if path.exists():
                for line in path.read_text().splitlines():
                    line = line.split("#")[0].strip()
                    # multiple "KEY = value" items may share one line
                    for item in line.split(";"):
                        if "=" in item:
                            key, value = item.split("=", 1)
                            params[key.strip().upper()] = value.strip()
            self._incar = params
        return self._incar

    def get_incar_parameter(self, key: str) -> Optional[str]:
        return self.incar.get(key.upper())

    # ---------------------------- OSZICAR --------------------------
    def read_oszicar(self) -> List[dict]:
        """Ionic steps: [{'F', 'E0', 'dE', 'nscf', 'mag'}]."""
        path = self.jobdir / "OSZICAR"
        steps: List[dict] = []
        nscf = 0
        if not path.exists():
            return steps
        for line in path.read_text().splitlines():
            if re.match(r"^(DAV|RMM|CG):", line.strip()):
                nscf += 1
                continue
            m = re.match(
                r"^\s*(\d+)\s+F=\s*([-.\dEe+]+)\s+E0=\s*([-.\dEe+]+)"
                r"\s+d\s*E\s*=\s*([-.\dEe+]+)", line)
            if m:
                steps.append({"step": int(m.group(1)),
                              "F": float(m.group(2)),
                              "E0": float(m.group(3)),
                              "dE": float(m.group(4)),
                              "nscf": nscf})
                nscf = 0
        return steps

    # ---------------------------- OUTCAR ---------------------------
    def get_vasp_mpi_omp_ranks(self) -> Dict[str, int]:
        path = self.jobdir / "OUTCAR"
        out = {"mpi": 0, "threads": 0, "nodes": 0}
        if path.exists():
            for line in path.open():
                m = re.search(
                    r"running\s+(\d+)\s+mpi-ranks,\s+with\s+(\d+)\s+"
                    r"threads/rank,\s+on\s+(\d+)\s+nodes", line)
                if m:
                    out = {"mpi": int(m.group(1)),
                           "threads": int(m.group(2)),
                           "nodes": int(m.group(3))}
                    break
        return out

    def get_vasp_elapsed_time(self) -> float:
        """Total LOOP real time (s) from OUTCAR."""
        path = self.jobdir / "OUTCAR"
        total = 0.0
        if path.exists():
            for line in path.open():
                m = re.search(r"LOOP\+?:.*real time\s+([\d.]+)", line)
                if m:
                    total += float(m.group(1))
        return total

    def get_vasp_job_service_unit(self):
        """-> ServiceUnit, or None when the job has not produced an
        OUTCAR with timing yet (callers use None as the 'job never
        ran' gate — returning a zero-hour unit would make every
        unstarted task count as completed)."""
        if not (self.jobdir / "OUTCAR").exists():
            return None
        elapsed = self.get_vasp_elapsed_time()
        if elapsed <= 0.0:
            return None
        ranks = self.get_vasp_mpi_omp_ranks()
        ncores = max(ranks["mpi"] * max(ranks["threads"], 1), 1)
        return ServiceUnit(ncores, elapsed)

    # -------------------------- convergence ------------------------
    def check_vasp_job_scf_convergence(self) -> bool:
        """Every ionic step must have finished in fewer than NELM SCF
        iterations (reference `vaspkit.py:142-172`)."""
        nelm = int(self.get_incar_parameter("NELM") or 60)
        steps = self.read_oszicar()
        if not steps:
            return False
        return all(s["nscf"] < nelm for s in steps)

    def get_atoms(self, index=-1, is_finite_temperature: bool = False):
        from ..io.vasp import read_vasp_xml
        return read_vasp_xml(str(self.jobdir / "vasprun.xml"),
                             index=index,
                             finite_temperature=is_finite_temperature)
