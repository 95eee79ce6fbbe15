"""AIMD sampling pipeline (port of `tensoralloy_tpu/tensordb/sampler.py`;
reference `tensordb/sampler.py`):
phase structures, temperature ladders, VASP task creation with a
file-based lifecycle (status: created -> submitted -> finished ->
processed), snapshot extraction into training databases, and ingestion
of pre-existing trajectories.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from ..atoms import Structure
from ..elements import atomic_masses, atomic_numbers

KB = 8.617330337217213e-05   # eV/K


# ----------------------------------------------------------------------
def make_phase_structure(element: str, phase: str, a: float,
                         c_over_a: float = 1.633) -> Structure:
    """Unit cells for fcc/bcc/hcp/sc/diamond phases."""
    if phase == "fcc":
        frac = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
                         [0, 0.5, 0.5]])
        cell = np.eye(3) * a
    elif phase == "bcc":
        frac = np.array([[0, 0, 0], [0.5, 0.5, 0.5]])
        cell = np.eye(3) * a
    elif phase == "sc":
        frac = np.array([[0.0, 0.0, 0.0]])
        cell = np.eye(3) * a
    elif phase == "hcp":
        c = a * c_over_a
        cell = np.array([[a, 0, 0],
                         [-a / 2, a * np.sqrt(3) / 2, 0],
                         [0, 0, c]])
        frac = np.array([[0, 0, 0], [1 / 3, 2 / 3, 0.5]])
    elif phase == "diamond":
        frac = np.array([[0, 0, 0], [0.25, 0.25, 0.25],
                         [0.5, 0.5, 0], [0.75, 0.75, 0.25],
                         [0.5, 0, 0.5], [0.75, 0.25, 0.75],
                         [0, 0.5, 0.5], [0.25, 0.75, 0.75]])
        cell = np.eye(3) * a
    else:
        raise ValueError(f"unknown phase '{phase}'")
    return Structure.from_symbols([element] * len(frac), frac @ cell,
                                  cell, pbc=[True] * 3)


def temperature_ladder(t0: float, t1: float, size: int,
                       method: str = "linear") -> np.ndarray:
    """NVT/NPT temperature ladders (reference `sampler.py:273-306`)."""
    if method == "linear":
        return np.linspace(t0, t1, size)
    if method == "log":
        return np.exp(np.linspace(np.log(max(t0, 1.0)), np.log(t1),
                                  size))
    raise ValueError(method)


# ----------------------------------------------------------------------
def write_poscar(path, structure: Structure, comment: str = "tensordb"):
    symbols = structure.symbols
    uniq: List[str] = []
    for s in symbols:
        if s not in uniq:
            uniq.append(s)
    counts = [symbols.count(u) for u in uniq]
    order = np.argsort([uniq.index(s) for s in symbols], kind="stable")
    with open(path, "w") as fh:
        fh.write(f"{comment}\n1.0\n")
        for row in structure.cell:
            fh.write("  " + " ".join(f"{x:20.12f}" for x in row) + "\n")
        fh.write(" ".join(uniq) + "\n")
        fh.write(" ".join(str(c) for c in counts) + "\n")
        fh.write("Cartesian\n")
        for i in order:
            fh.write("  " + " ".join(
                f"{x:20.12f}" for x in structure.positions[i]) + "\n")


def write_incar(path, params: Dict):
    with open(path, "w") as fh:
        fh.write("INCAR created by tensoralloy_tpu/tensordb\n")
        for key, value in params.items():
            if isinstance(value, bool):
                value = ".TRUE." if value else ".FALSE."
            fh.write(f" {key.upper()} = {value}\n")


def write_slurm_script(path, jobname: str, command: str,
                       partition: str = "normal", nodes: int = 1,
                       ntasks: int = 64, walltime: str = "24:00:00"):
    with open(path, "w") as fh:
        fh.write("#!/bin/bash\n"
                 f"#SBATCH --job-name={jobname}\n"
                 f"#SBATCH --partition={partition}\n"
                 f"#SBATCH --nodes={nodes}\n"
                 f"#SBATCH --ntasks={ntasks}\n"
                 f"#SBATCH --time={walltime}\n\n"
                 f"{command}\n")
    os.chmod(path, 0o755)


# ----------------------------------------------------------------------
class BaseSampler:
    """Task lifecycle over a root directory (reference
    `sampler.py:28-220`). Each task is a directory with a `status.json`
    advancing created -> submitted -> finished -> processed."""

    def __init__(self, root, config: dict):
        self.root = Path(root)
        self.config = dict(config)
        self.species: List[str] = list(config.get("species", []))
        self.phases: List[str] = list(config.get("phases", []))
        self.root.mkdir(parents=True, exist_ok=True)

    # ------------------------- structures --------------------------
    def get_base_structure(self, phase: str) -> Structure:
        cfg = self.config.get(phase, {})
        element = self.species[0]
        a = cfg.get("a")
        if a is None:
            # element-aware default from the covalent radius (nearest-
            # neighbor contact): fcc a = 2*sqrt(2) r, bcc a = 4r/sqrt(3)
            from ..elements import covalent_radii
            r = float(covalent_radii[atomic_numbers[element]])
            a = {"fcc": 2.0 * np.sqrt(2.0) * r,
                 "bcc": 4.0 * r / np.sqrt(3.0),
                 "hcp": 2.0 * r,
                 "sc": 2.0 * r}.get(phase, 2.5 * r)
        return make_phase_structure(element, phase, float(a))

    def get_supercells_at_volume(self, phase: str,
                                 scale: float = 1.0) -> Structure:
        cfg = self.config.get(phase, {})
        reps = cfg.get("supercell", [[2, 2, 2]])[0]
        base = self.get_base_structure(phase)
        sc = base.repeat(tuple(reps))
        out = sc.copy()
        out.cell = sc.cell * scale ** (1.0 / 3.0)
        out.positions = sc.positions * scale ** (1.0 / 3.0)
        return out

    # --------------------------- lifecycle -------------------------
    def task_iterator(self) -> Iterator[Path]:
        for status_file in sorted(self.root.glob("**/status.json")):
            yield status_file.parent

    def create_task(self, taskdir: Path, metadata: dict):
        taskdir.mkdir(parents=True, exist_ok=True)
        with open(taskdir / "status.json", "w") as fh:
            json.dump({"status": "created", **metadata}, fh)

    def get_status(self, taskdir: Path) -> dict:
        path = Path(taskdir) / "status.json"
        if not path.exists():
            return {"status": "unknown"}
        return json.loads(path.read_text())

    def set_status(self, taskdir: Path, status: str):
        data = self.get_status(taskdir)
        data["status"] = status
        with open(Path(taskdir) / "status.json", "w") as fh:
            json.dump(data, fh)

    @staticmethod
    def is_task_finished(taskdir: Path) -> bool:
        return (Path(taskdir) / "vasprun.xml").exists()

    TRAJECTORY_FILE = "trajectory.extxyz"

    def post_process_task(self, taskdir: Path):
        """Extract a finished task's vasprun.xml into
        trajectory.extxyz (idempotent; reference
        `sampler.py:666-706`)."""
        taskdir = Path(taskdir)
        vasprun = taskdir / "vasprun.xml"
        out = taskdir / self.TRAJECTORY_FILE
        if not vasprun.exists() or out.exists():
            return
        from ..io.vasp import read_vasp_xml
        from ..io.extxyz import write_extxyz
        try:
            frames = read_vasp_xml(
                str(vasprun), index=slice(None),
                finite_temperature=self.config.get(
                    "finite_temperature", False))
        except Exception as exc:
            print(f"[sampling/postprocess] FAILED to read {vasprun}: "
                  f"{exc}")
            return
        if not frames:
            return
        for i, s in enumerate(frames):
            s.info["_source"] = f"{taskdir}@{i}"
        write_extxyz(str(out), frames)
        self.set_status(taskdir, "processed")

    def post_process(self):
        for task in self.task_iterator():
            if self.is_task_finished(task):
                self.post_process_task(task)

    def update_status(self):
        for task in self.task_iterator():
            data = self.get_status(task)
            if data["status"] in ("created", "submitted") and \
                    self.is_task_finished(task):
                self.set_status(task, "finished")

    def list_unsubmitted_tasks(self) -> List[Path]:
        return [t for t in self.task_iterator()
                if self.get_status(t)["status"] == "created"]

    def purge(self):
        """Reset tasks whose jobs died before producing output."""
        for task in self.task_iterator():
            data = self.get_status(task)
            if data["status"] == "submitted" and \
                    not self.is_task_finished(task):
                self.set_status(task, "created")

    # ------------------------- extraction --------------------------
    def get_samples(self, taskdir: Path, interval: int = 50,
                    finite_temperature: bool = False) -> List[Structure]:
        from ..io.vasp import read_vasp_xml
        frames = read_vasp_xml(str(Path(taskdir) / "vasprun.xml"),
                               index=slice(None),
                               finite_temperature=finite_temperature)
        return frames[::max(interval, 1)]


class AimdSampler(BaseSampler):
    """NVT/NPT AIMD task ladders (reference `sampler.py:222-366`)."""

    def nvt_tasks(self) -> List[dict]:
        out = []
        aimd = self.config.get("aimd", {}).get("sampling", {})
        for ensemble in ("nvt", "npt"):
            for phase, cfg in aimd.get(ensemble, {}).items():
                temps = temperature_ladder(
                    cfg.get("t0", 300.0), cfg.get("t1", 1000.0),
                    cfg.get("size", 4),
                    cfg.get("vt_method", "linear"))
                scales = cfg.get("scales", [1.0])
                for t in temps:
                    for v in scales:
                        out.append({"phase": phase, "ensemble": ensemble,
                                    "temperature": float(t),
                                    "scale": float(v)})
        return out

    def create_tasks(self, override: bool = False) -> List[Path]:
        created = []
        for spec in self.nvt_tasks():
            name = (f"{spec['phase']}_{spec['ensemble']}_"
                    f"T{spec['temperature']:.0f}_V{spec['scale']:.3f}")
            taskdir = self.root / name
            if taskdir.exists() and not override:
                continue
            self.create_task(taskdir, spec)
            structure = self.get_supercells_at_volume(
                spec["phase"], spec["scale"])
            write_poscar(taskdir / "POSCAR", structure)
            created.append(taskdir)
        return created


class VaspAimdSampler(AimdSampler):
    """Writes full VASP AIMD inputs + slurm scripts
    (reference `sampler.py:368-705`)."""

    def vasp_sampling_parameters(self, temperature: float,
                                 npt: bool = False) -> Dict:
        cfg = self.config.get("vasp", {}).get("sampling", {})
        params = {
            "encut": cfg.get("encut", 400),
            "ediff": cfg.get("ediff", 1e-5),
            "ibrion": 0,
            "isif": 3 if npt else 2,
            "nsw": cfg.get("nsw", 1000),
            "potim": cfg.get("potim", 2.0),
            "tebeg": temperature,
            "teend": temperature,
            "mdalgo": 3,
            "langevin_gamma": cfg.get("langevin_gamma", 10),
            "ismear": cfg.get("ismear", 1),
            "sigma": round(KB * temperature, 6)
            if self.config.get("finite_temperature") else
            cfg.get("sigma", 0.05),
            "nsim": cfg.get("nsim", 4),
        }
        return params

    def create_tasks(self, override: bool = False) -> List[Path]:
        created = super().create_tasks(override)
        for taskdir in created:
            spec = self.get_status(taskdir)
            params = self.vasp_sampling_parameters(
                spec["temperature"], spec["ensemble"] == "npt")
            write_incar(taskdir / "INCAR", params)
            slurm = self.config.get("slurm", {})
            write_slurm_script(
                taskdir / "run.sh", taskdir.name,
                slurm.get("command", "mpirun vasp_std"),
                partition=slurm.get("partition", "normal"),
                nodes=slurm.get("nodes", 1),
                ntasks=slurm.get("ntasks", 64),
                walltime=slurm.get("walltime", "24:00:00"))
        return created

    def post_process(self, db=None, interval: int = 50):
        """Without `db`: extract each finished task's vasprun.xml into
        trajectory.extxyz (base behavior, reference
        `sampler.py:666-706`). With `db`: additionally harvest the
        snapshots into the database."""
        self.update_status()
        if db is None:
            return super().post_process()
        count = 0
        for task in self.task_iterator():
            if self.get_status(task)["status"] != "finished":
                continue
            for s in self.get_samples(
                    task, interval,
                    self.config.get("finite_temperature", False)):
                db.write(s)
                count += 1
            self.set_status(task, "processed")
        return count


class ExistedTrajectorySampler(BaseSampler):
    """Ingest external extxyz trajectories
    (reference `sampler.py:706-797`)."""

    def __init__(self, root, config: dict):
        super().__init__(root, config)
        self.trajectories = config.get(
            "trajectories", config.get("external", {}).get(
                "trajectories", []))

    def task_iterator(self) -> Iterator[Path]:
        """Each external trajectory FILE is one task (the base
        status.json-directory iterator would hand directories to
        get_samples)."""
        for f in self.trajectories:
            yield Path(f)

    def post_process(self, db=None, interval: int = 50):
        return None  # external files need no extraction

    def get_samples(self, path=None, interval: int = 1,
                    **kwargs) -> List[Structure]:
        from ..io.extxyz import read_extxyz
        out = []
        files = [path] if path else self.trajectories
        for f in files:
            out.extend(read_extxyz(str(f))[::max(interval, 1)])
        return out

    def ingest(self, db, interval: int = 1) -> int:
        samples = self.get_samples(interval=interval)
        for s in samples:
            db.write(s)
        return len(samples)


class RecomputeCalculator:
    """High-precision static recompute of sampled snapshots (reference
    `tensordb/calculator/calculator.py`: `BaseCalculator` /
    `VaspCalculator`): writes one static-VASP task per snapshot."""

    def __init__(self, root, config: dict):
        self.root = Path(root)
        self.config = dict(config)
        self.root.mkdir(parents=True, exist_ok=True)

    def vasp_calc_parameters(self, structure: Structure) -> Dict:
        cfg = self.config.get("vasp", {}).get("calc", {})
        params = {
            "encut": cfg.get("encut", 500),
            "kspacing": cfg.get("kspacing", 0.5),
            "ediff": cfg.get("ediff", 1e-6),
            "ibrion": -1,
            "nsw": 0,
            "ismear": cfg.get("ismear", 1),
            "sigma": cfg.get("sigma", 0.05),
            "prec": "Accurate",
            "lwave": ".FALSE.",
            "lcharg": ".FALSE.",
            "nsim": cfg.get("nsim", 4),
        }
        if cfg.get("kpar"):
            params["kpar"] = cfg["kpar"]
        if cfg.get("npar"):
            params["npar"] = cfg["npar"]
        if self.config.get("finite_temperature"):
            t = structure.info.get("etemperature")
            if t:
                params["sigma"] = round(float(t), 6)
        return params

    def create_tasks(self, structures, prefix: str = "calc",
                     override: bool = False):
        created = []
        slurm = self.config.get("slurm", {})
        for idx, s in enumerate(structures):
            taskdir = self.root / f"{prefix}_{idx:05d}"
            if taskdir.exists() and not override:
                continue
            taskdir.mkdir(parents=True, exist_ok=True)
            write_poscar(taskdir / "POSCAR", s)
            write_incar(taskdir / "INCAR",
                        self.vasp_calc_parameters(s))
            write_slurm_script(
                taskdir / "run.sh", taskdir.name,
                slurm.get("command", "mpirun vasp_std"),
                partition=slurm.get("partition", "normal"),
                nodes=slurm.get("nodes", 1),
                ntasks=slurm.get("ntasks", 64),
                walltime=slurm.get("walltime", "8:00:00"))
            with open(taskdir / "status.json", "w") as fh:
                json.dump({"status": "created", "index": idx}, fh)
            created.append(taskdir)
        return created

    def collect(self, db, finite_temperature: bool = False) -> int:
        """Harvest finished recompute tasks into a database."""
        from ..io.vasp import read_vasp_xml
        count = 0
        for status_file in sorted(self.root.glob("*/status.json")):
            taskdir = status_file.parent
            data = json.loads(status_file.read_text())
            if data.get("status") == "collected":
                continue
            xml = taskdir / "vasprun.xml"
            if not xml.exists():
                continue
            # an unconverged SCF (hit NELM) still writes vasprun.xml;
            # its energies/forces are garbage and must not enter the
            # training database (same gate as VaspCalculator.harvest)
            from .vaspkit import VaspJob
            if not VaspJob(taskdir).check_vasp_job_scf_convergence():
                continue
            s = read_vasp_xml(str(xml), index=-1,
                              finite_temperature=finite_temperature)
            db.write(s)
            data["status"] = "collected"
            status_file.write_text(json.dumps(data))
            count += 1
        return count
