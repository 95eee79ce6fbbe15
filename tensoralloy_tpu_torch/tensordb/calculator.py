"""High-precision DFT recompute calculators with microstructure
generation (port of `tensoralloy_tpu/tensordb/calculator.py`; reference
`tensordb/calculator/calculator.py:25-485` and
`tensordb/calculator/microstructure/{aging,neq,porous}.py`).

`BaseCalculator.create_tasks` drains every sampler's finished AIMD /
trajectory tasks, subsamples snapshots, optionally transforms each one
through `may_modify_atoms` (identity here; aging / non-equilibrium /
porous subclasses override it), dedups by content hash, and lays tasks
out as `<workdir>/<N>atoms/group<G>/task<T>` with at most 100 tasks per
group — the same on-disk contract as the reference so its slurm tooling
applies.

`VaspCalculator` writes POSCAR/INCAR/metadata.json per task, tracks
SCF convergence + CPU/GPU service units via `VaspJob`, and harvests
converged results. The microstructure calculators reproduce the
reference's stochastic modifications: irradiation transmutation +
Fibonacci-sphere helium-bubble injection (`aging.py`), nearest-neighbor
displacement (`neq.py`), and porosity thinning (`porous.py`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..atoms import Structure
from ..elements import atomic_numbers, chemical_symbols, covalent_radii
from ..neighbor import neighbor_list
from .sampler import (BaseSampler, write_incar, write_poscar,
                      write_slurm_script)
from .vaspkit import ServiceUnit, VaspJob

K_B = 8.617333262e-5  # eV/K


# ----------------------------------------------------------------------
def structure_hash(s: Structure) -> str:
    """Content hash of (numbers, cell, positions) rounded to 1e-6."""
    h = hashlib.sha256()
    h.update(np.asarray(s.numbers, dtype=np.int64).tobytes())
    h.update(np.round(np.asarray(s.cell, float), 6).tobytes())
    h.update(np.round(np.asarray(s.positions, float), 6).tobytes())
    return h.hexdigest()[:16]


# per-atom labels of a snapshot: an edit that removes or adds atoms
# leaves them describing other atoms
PER_ATOM_LABELS = ("forces", "velocities")


def _edited_info(s: Structure) -> dict:
    """`s.info` for a copy of `s` with atoms removed or added: without the
    per-atom labels. The JAX package keeps them, so that a porous copy
    carries misaligned forces and one with a helium bubble (more atoms
    than forces) cannot be written to extxyz."""
    return {k: v for k, v in s.info.items() if k not in PER_ATOM_LABELS}


def delete_atoms(s: Structure, indices) -> Structure:
    keep = np.setdiff1d(np.arange(len(s)), np.asarray(indices, int))
    return Structure(numbers=s.numbers[keep].copy(),
                     positions=s.positions[keep].copy(),
                     cell=s.cell.copy(), pbc=s.pbc.copy(),
                     info=_edited_info(s))


def append_atoms(s: Structure, element: str,
                 positions: np.ndarray) -> Structure:
    positions = np.atleast_2d(positions)
    z = atomic_numbers[element]
    return Structure(
        numbers=np.concatenate([s.numbers,
                                np.full(len(positions), z, int)]),
        positions=np.concatenate([s.positions, positions]),
        cell=s.cell.copy(), pbc=s.pbc.copy(), info=_edited_info(s))


def _mic(d: np.ndarray, cell: np.ndarray, pbc) -> np.ndarray:
    """Minimum-image displacements (shared helper in atoms.py)."""
    from ..atoms import minimum_image
    return minimum_image(d, cell, pbc)


# ----------------------------------------------------------------------
class BaseCalculator:
    """Task lifecycle shared by every recompute calculator (reference
    `calculator.py:25-160`)."""

    HASH_FILE = "hash.json"
    CALC_FILE = "accurate_dft_calc.extxyz"
    subdir = "calc"

    def __init__(self, root, config: Union[dict, str, Path]):
        self.root = Path(root)
        if isinstance(config, (str, Path)):
            import tomllib
            with open(config, "rb") as fp:
                config = tomllib.load(fp)
        self.config = dict(config)
        self.species = list(self.config.get("species", []))
        self.sampling_interval = int(
            self.config.get("calc", {}).get("interval", 50))
        self.workdir = self.root / self.subdir
        self.rng = np.random.RandomState(self.random_seed)

    @property
    def software(self) -> str:
        return ""

    @property
    def random_seed(self) -> int:
        return 0

    def purge(self):
        import shutil
        if self.workdir.exists():
            shutil.rmtree(self.workdir, ignore_errors=True)

    def may_modify_atoms(self, structure: Structure
                         ) -> Optional[Structure]:
        """Hook: transform a sampled snapshot before recompute (return
        None to drop it)."""
        return structure

    def task_iterator(self):
        return sorted(self.workdir.glob("*atoms/group*/task*"))

    # ------------------------------------------------------------------
    def gather_structures(self, samplers: Dict[str, BaseSampler],
                          **kwargs) -> List[Structure]:
        """Drain samplers -> modified, deduped snapshot list; maintains
        the global hash table and extxyz aggregate."""
        from ..io.extxyz import read_extxyz, write_extxyz
        self.workdir.mkdir(parents=True, exist_ok=True)
        hash_file = self.workdir / self.HASH_FILE
        calc_file = self.workdir / self.CALC_FILE
        if hash_file.exists():
            hash_table = json.loads(hash_file.read_text())
            calc_list = read_extxyz(str(calc_file))
            if len(calc_list) != len(hash_table):
                raise IOError(
                    f"{calc_file} (n={len(calc_list)}) does not match "
                    f"{hash_file} (n={len(hash_table)})")
            # restore identity info lost in the extxyz round-trip
            # (insertion order of the json table matches file order)
            for s, (hid, val) in zip(calc_list, hash_table.items()):
                s.info["_hash"], s.info["_aid"] = hid, val["aid"]
                s.info["_source"] = val["source"]
        else:
            hash_table, calc_list = {}, []
        subset_id = Counter(len(a) for a in calc_list)
        for name, sampler in samplers.items():
            for task in sampler.task_iterator():
                try:
                    selected = sampler.get_samples(
                        task, interval=self.sampling_interval, **kwargs)
                except FileNotFoundError:
                    continue  # task not finished (no vasprun.xml yet)
                except (IOError, OSError) as exc:
                    print(f"[{name}/gather] skipping {task}: {exc}")
                    continue
                for s in selected:
                    src = f"{name}:{Path(task).name}"
                    s = self.may_modify_atoms(s)
                    if s is None:
                        continue
                    hid = structure_hash(s)
                    if hid in hash_table:
                        continue
                    n = len(s)
                    aid = f"{n}.{subset_id[n]}"
                    s.info["_hash"], s.info["_source"] = hid, src
                    s.info["_aid"] = aid
                    hash_table[hid] = {"aid": aid, "source": src}
                    calc_list.append(s)
                    subset_id[n] += 1
        hash_file.write_text(json.dumps(hash_table, indent=2) + "\n")
        write_extxyz(str(calc_file), calc_list)
        return calc_list

    def create_tasks(self, samplers: Dict[str, BaseSampler], **kwargs):
        raise NotImplementedError

    def update_status(self):
        raise NotImplementedError

    def get_atoms(self, taskdir, check_job_status: bool = False):
        raise NotImplementedError


# ----------------------------------------------------------------------
class VaspCalculator(BaseCalculator):
    """VASP recompute tasks (reference `calculator.py:162-485`)."""

    @property
    def software(self) -> str:
        return "vasp"

    # ------------------------------------------------------------------
    def vasp_parameters(self, structure: Structure) -> Dict[str, object]:
        """Static high-precision INCAR parameters; honors every
        `[vasp.calc]` key, finite-T Fermi smearing at the snapshot's
        electron temperature, and scalar / per-size dict / lambda-string
        NBANDS rules (reference `setup_vasp_accurate_dft_parameters`)."""
        cfg = dict(self.config.get("vasp", {}).get("calc", {}))
        params = {
            "prec": cfg.pop("prec", "Accurate"),
            "encut": cfg.pop("encut", 500),
            "ediff": cfg.pop("ediff", 1e-6),
            "kspacing": cfg.pop("kspacing", 0.2),
            "ismear": cfg.pop("ismear", 1),
            "sigma": cfg.pop("sigma", 0.05),
            "algo": cfg.pop("algo", "normal"),
            "isym": cfg.pop("isym", 0),
            "nelmin": cfg.pop("nelmin", 4),
            "isif": cfg.pop("isif", 2),
            "ibrion": cfg.pop("ibrion", -1),
            "nsw": cfg.pop("nsw", 1),
            "nwrite": cfg.pop("nwrite", 1),
            "lcharg": cfg.pop("lcharg", False),
            "lwave": cfg.pop("lwave", False),
            "nblock": cfg.pop("nblock", 1),
            "lreal": cfg.pop("lreal", False),
        }
        nbands = cfg.pop("nbands", None)
        magmom = cfg.pop("magmom", None)
        params.update(cfg)  # any further key passes through verbatim
        if self.config.get("finite_temperature", False):
            t = structure.info.get("etemperature")
            if t is not None:
                params["sigma"] = round(float(t), 8)   # eV (k_B T)
                params["ismear"] = -1
        if nbands is not None:
            if isinstance(nbands, str) and nbands.startswith("lambda"):
                a, n = structure, len(structure)
                v = structure.volume / max(n, 1)
                t = structure.info.get("etemperature", 0.0)
                params["nbands"] = int(eval(nbands)(a, n, v, t))
            elif isinstance(nbands, dict):
                params["nbands"] = int(nbands[str(len(structure))])
            else:
                params["nbands"] = int(nbands)
        if magmom is not None:
            mult = 3 if params.get("lsorbit") else 1
            params["magmom"] = f"{len(structure) * mult}*{magmom}"
        return params

    # ------------------------------------------------------------------
    def create_tasks(self, samplers: Dict[str, BaseSampler], **kwargs):
        """Lay out `<N>atoms/group<G>/task<T>` VASP jobs (<=100 per
        group) with POSCAR/INCAR/run.sh/metadata.json."""
        calc_list = self.gather_structures(samplers, **kwargs)
        slurm = self.config.get("slurm", {})
        group_counts = Counter()
        for s in calc_list:
            natoms = len(s)
            sid = int(s.info["_aid"].split(".")[1])
            gid, tid = sid // 100, sid % 100
            taskdir = self.workdir / f"{natoms}atoms" / f"group{gid}" \
                / f"task{tid}"
            if (taskdir / "metadata.json").exists():
                continue
            taskdir.mkdir(parents=True, exist_ok=True)
            write_poscar(taskdir / "POSCAR", s)
            write_incar(taskdir / "INCAR", self.vasp_parameters(s))
            write_slurm_script(
                taskdir / "run.sh", f"{natoms}.{gid}.{tid}",
                slurm.get("command", "mpirun vasp_std"),
                partition=slurm.get("partition", "normal"),
                nodes=slurm.get("nodes", 1),
                ntasks=slurm.get("ntasks", 64),
                walltime=slurm.get("walltime", "8:00:00"))
            metadata = {"source": s.info["_source"],
                        "hash": s.info["_hash"], "aid": s.info["_aid"],
                        "group_id": gid, "task_id": tid}
            if self.config.get("finite_temperature", False) and \
                    s.info.get("etemperature") is not None:
                metadata["etemperature(K)"] = \
                    float(s.info["etemperature"]) / K_B
            (taskdir / "metadata.json").write_text(
                json.dumps(metadata, indent=2) + "\n")
            group_counts[(natoms, gid)] += 1
        for (natoms, gid), size in sorted(group_counts.items()):
            print(f"{type(self).__name__} creates "
                  f"{natoms}atoms/group{gid} ({size} tasks)")
        return calc_list

    # ------------------------------------------------------------------
    def update_status(self) -> Optional[dict]:
        """Scan all jobs: convergence + service units, per-group
        metadata, aggregate status table (reference
        `calculator.py:342-452`)."""
        if not (self.workdir / self.HASH_FILE).exists():
            return None
        acc: Dict[tuple, dict] = {}
        for taskdir in self.task_iterator():
            meta_path = taskdir / "metadata.json"
            if not meta_path.exists():
                continue
            metadata = json.loads(meta_path.read_text())
            natoms = int(metadata["aid"].split(".")[0])
            key = (natoms, metadata["group_id"])
            entry = acc.setdefault(key, {
                "n_total": 0, "n_completed": 0, "n_converged": 0,
                "CPU(jobs)": 0, "GPU(jobs)": 0,
                "CPU(hours)": 0.0, "GPU(hours)": 0.0,
                "completed_tasks": [], "converged_tasks": []})
            entry["n_total"] += 1
            job = VaspJob(taskdir)
            su = job.get_vasp_job_service_unit()
            if su is None:
                continue
            converged = job.check_vasp_job_scf_convergence()
            entry["n_completed"] += 1
            entry["completed_tasks"].append(str(taskdir))
            if converged:
                entry["n_converged"] += 1
                entry["converged_tasks"].append(str(taskdir))
            device = getattr(su, "device", "cpu")
            hours = getattr(su, "core_hours", None)
            hours = float(hours) if hours is not None else 0.0
            if device == "gpu":
                entry["GPU(jobs)"] += 1
                entry["GPU(hours)"] += hours
            else:
                entry["CPU(jobs)"] += 1
                entry["CPU(hours)"] += hours
            metadata["SU"] = dataclasses.asdict(su) \
                if dataclasses.is_dataclass(su) else dict(su.__dict__)
            metadata["converged"] = bool(converged)
            meta_path.write_text(json.dumps(metadata, indent=2) + "\n")
        for (natoms, gid), entry in acc.items():
            groupdir = self.workdir / f"{natoms}atoms" / f"group{gid}"
            (groupdir / "metadata.json").write_text(
                json.dumps(entry, indent=2) + "\n")
        # aggregate table
        status = {"group": [], "total_jobs": [], "completed_jobs": [],
                  "converged_jobs": [], "CPU(jobs)": [], "CPU(hours)": [],
                  "GPU(jobs)": [], "GPU(hours)": []}
        for (natoms, gid), e in sorted(acc.items()):
            status["group"].append(f"{natoms}.g{gid}")
            status["total_jobs"].append(e["n_total"])
            status["completed_jobs"].append(e["n_completed"])
            status["converged_jobs"].append(e["n_converged"])
            for k in ("CPU(jobs)", "GPU(jobs)"):
                status[k].append(e[k])
            for k in ("CPU(hours)", "GPU(hours)"):
                status[k].append(round(e[k], 2))
        status["group"].append("overall")
        for k in status:
            if k != "group":
                status[k].append(round(sum(status[k]), 2))
        lines = ["  ".join(status)]
        for i in range(len(status["group"])):
            lines.append("  ".join(str(status[k][i]) for k in status))
        report = "\n".join(lines)
        print(f"{type(self).__name__} status:\n{report}")
        (self.workdir / "status").write_text(report + "\n")
        return status

    # ------------------------------------------------------------------
    def get_atoms(self, taskdir, check_job_status: bool = False
                  ) -> Optional[Structure]:
        """Harvest one converged job as a labeled Structure."""
        taskdir = Path(taskdir)
        metadata = {}
        if check_job_status:
            job = VaspJob(taskdir)
            if job.get_vasp_job_service_unit() is None:
                return None
            if not job.check_vasp_job_scf_convergence():
                return None
            meta_path = taskdir / "metadata.json"
            if meta_path.exists():
                metadata = json.loads(meta_path.read_text())
        else:
            meta_path = taskdir / "metadata.json"
            if not meta_path.exists():
                return None
            metadata = json.loads(meta_path.read_text())
            if not metadata.get("converged", False):
                return None
            if not metadata.get("SU"):
                return None
        s = VaspJob(taskdir).get_atoms(
            index=-1, is_finite_temperature=self.config.get(
                "finite_temperature", False))
        if s is None:
            return None
        for key in ("hash", "aid", "group_id", "task_id"):
            if key in metadata:
                s.info[key] = metadata[key]
        return s

    def harvest(self, db, check_job_status: bool = False) -> int:
        """Collect every converged task into a CoreDatabase."""
        count = 0
        for taskdir in self.task_iterator():
            s = self.get_atoms(taskdir, check_job_status)
            if s is not None:
                db.write(s)
                count += 1
        return count


# ----------------------------------------------------------------------
# Microstructure generators (reference `microstructure/aging.py`)
# ----------------------------------------------------------------------
@dataclasses.dataclass
class Transmutation:
    """Irradiation-induced transmutation src -> dst."""
    src: str
    dst: str
    prob: float
    nmax: int = 1
    used: int = 0


@dataclasses.dataclass
class HeliumBubbleInjection:
    target: str
    max_target_size: int
    max_bubble_size: int
    max_ratio: float = 3.0
    min_ratio: float = 1.0
    cutoff: float = 4.0

    def __post_init__(self):
        assert 1 <= self.max_target_size <= 5
        assert 1 <= self.max_bubble_size <= 10
        assert self.max_ratio <= 4.0
        assert 0.5 <= self.min_ratio <= self.max_ratio


def fibonacci_sphere(n: int, radius: float = 1.0) -> np.ndarray:
    """n points spread evenly over the sphere via the Fibonacci
    lattice (golden-angle spiral). Unlike the reference's batched
    rejection variant (`aging.py:369-395`, which takes the first n of
    1000 candidates and therefore clusters them near a pole), the
    denominator is n itself, so coverage is uniform for any n."""
    if n == 1:
        return np.array([[0.0, 0.0, radius]])
    idx = np.arange(n)
    phi = np.arccos(1.0 - 2.0 * (idx + 0.5) / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * idx
    return np.stack([radius * np.sin(phi) * np.cos(theta),
                     radius * np.sin(phi) * np.sin(theta),
                     radius * np.cos(phi)], axis=1)


def find_cluster(structure: Structure, center: int, cluster_size: int,
                 cutoff: float = 5.0) -> List[int]:
    """The `cluster_size` same-element atoms nearest to `center`
    (inclusive), via the periodic neighbor list."""
    # bound must match HeliumBubbleInjection.max_target_size <= 5
    # (inclusive), which _inject_bubble draws up to
    assert 1 <= cluster_size <= 5
    sym = structure.symbols[center]
    ii, jj, _, d, _ = neighbor_list(structure, cutoff)
    sel = (ii == center) & (np.asarray(structure.symbols)[jj] == sym)
    order = np.argsort(d[sel])
    picked: List[int] = []
    for j in jj[sel][order]:
        if j != center and j not in picked:
            picked.append(int(j))
        if len(picked) >= cluster_size - 1:
            break
    return [center] + picked


class FibonacciSphereHeliumBubbleInjector:
    """Replace a small same-element cluster with an optimized He bubble
    (reference `aging.py:190-395`): positions seeded on a Fibonacci
    sphere around the PBC-aware centroid, refined by L-BFGS-B on a
    repulsion + uniformity + centroid-attraction loss."""

    def __init__(self, cutoff: float = 4.0,
                 optimization_steps: int = 100):
        self.cutoff = cutoff
        self.optimization_steps = optimization_steps

    @staticmethod
    def pbc_aware_centroid(positions, cell, pbc) -> np.ndarray:
        if not np.any(pbc):
            return np.mean(positions, axis=0)
        ref = positions[0]
        disp = _mic(positions - ref, cell, pbc)
        return ref + np.mean(disp, axis=0)

    def _loss(self, structure: Structure, positions: np.ndarray,
              others: np.ndarray, centroid: np.ndarray) -> float:
        cell, pbc = structure.cell, structure.pbc
        # repulsion: each He should not sit on top of a host atom
        repulsion = 0.0
        for p in positions:
            d = np.linalg.norm(_mic(others - p, cell, pbc), axis=1)
            repulsion += 1.0 / max(float(d.min()), 1e-3)
        # uniform He-He spacing
        self_interaction = 0.0
        if len(positions) > 1:
            dd = [np.linalg.norm(_mic(positions[j] - positions[i],
                                      cell, pbc))
                  for i in range(len(positions))
                  for j in range(i + 1, len(positions))]
            dd = np.asarray(dd)
            self_interaction = float(np.linalg.norm(dd - dd.mean()))
        # stay near the cavity centroid
        center_term = float(np.mean(np.linalg.norm(
            _mic(positions - centroid, cell, pbc), axis=1)))
        return 0.6 * repulsion + 0.2 * self_interaction \
            + 0.2 * center_term

    def inject(self, structure: Structure, center: int,
               cluster_size: int, bubble_size: int) -> Structure:
        cluster = find_cluster(structure, center, cluster_size,
                               self.cutoff)
        centroid = self.pbc_aware_centroid(
            structure.positions[cluster], structure.cell, structure.pbc)
        sphere = fibonacci_sphere(bubble_size, radius=1.0)
        r_he = covalent_radii[atomic_numbers["He"]]
        r_host = max(covalent_radii[z] for z in structure.numbers)
        safe_radius = 2.0 * (r_he + r_host)
        x0 = centroid + sphere * safe_radius * bubble_size ** 0.33
        stripped = delete_atoms(structure, cluster)
        others = stripped.positions

        from scipy.optimize import minimize
        res = minimize(
            lambda x: self._loss(stripped, x.reshape(-1, 3), others,
                                 centroid),
            x0.ravel(), method="L-BFGS-B",
            options={"maxiter": self.optimization_steps})
        out = append_atoms(stripped, "He", res.x.reshape(-1, 3))
        return out.wrap()


class VaspAgingCalculator(VaspCalculator):
    """Irradiation-aging structures: transmutation + He bubbles
    (reference `aging.py:47-187`). Config block::

        [aging]
        interval = 100
        cutoff = 4.0
        [aging.transmutation]
        U-Th = {prob = 0.5, nmax = 1}
        [aging.helium_bubble]
        target = "U"
        max_target_size = 2
        max_bubble_size = 4
        max_ratio = 3.0
    """

    subdir = "aging"
    defaults = {"prob": 0.5, "nmax": 1, "interval": 100, "cutoff": 4.0}

    def __init__(self, root, config):
        super().__init__(root, config)
        params = self.config.get("aging", {})
        self.sampling_interval = params.get(
            "interval", self.defaults["interval"])
        self.cutoff = params.get("cutoff", self.defaults["cutoff"])
        self.transmutations: List[Transmutation] = []
        for key, value in params.get("transmutation", {}).items():
            if not isinstance(value, dict):
                raise ValueError(f"value of {key} must be a table")
            src, dst = key.split("-")
            if src not in self.species:
                raise ValueError(f"source element {src} not in species")
            self.transmutations.append(Transmutation(
                src, dst, value.get("prob", self.defaults["prob"]),
                nmax=value.get("nmax", self.defaults["nmax"])))
        self.helium_bubble_injection = None
        args = params.get("helium_bubble", {})
        if args:
            self.helium_bubble_injection = HeliumBubbleInjection(
                target=args["target"],
                max_target_size=args["max_target_size"],
                max_bubble_size=args["max_bubble_size"],
                max_ratio=args.get("max_ratio", 3.0),
                min_ratio=args.get("min_ratio", 1.0),
                cutoff=args.get("cutoff", self.cutoff))

    @property
    def random_seed(self) -> int:
        return 1

    def _inject_bubble(self, structure: Structure,
                       shuffled: np.ndarray) -> Structure:
        args = self.helium_bubble_injection
        if args is None:
            return structure
        syms = np.asarray(structure.symbols)
        centers = [i for i in shuffled if syms[i] == args.target]
        if not centers:
            return structure
        for _ in range(100):
            cluster_size = self.rng.randint(1, args.max_target_size + 1)
            bubble_size = self.rng.randint(1, args.max_bubble_size + 1)
            ratio = bubble_size / cluster_size
            if args.min_ratio <= ratio <= args.max_ratio:
                break
        else:
            raise ValueError("no valid cluster/bubble size combination")
        injector = FibonacciSphereHeliumBubbleInjector(cutoff=args.cutoff)
        return injector.inject(structure, int(centers[0]),
                               cluster_size, bubble_size)

    def may_modify_atoms(self, structure: Structure
                         ) -> Optional[Structure]:
        if len(structure) < 16:
            return None
        for t in self.transmutations:
            t.used = 0
        out = structure.copy()
        shuffled = self.rng.permutation(len(structure))
        out = self._inject_bubble(out, shuffled)
        modified = np.zeros(len(out), dtype=bool)
        syms = np.asarray(out.symbols)
        for t in self.transmutations:
            for i in shuffled:
                if i >= len(out) or modified[i] or syms[i] != t.src:
                    continue
                if self.rng.uniform(0.0, 1.0) <= t.prob:
                    out.numbers[i] = atomic_numbers[t.dst]
                    modified[i] = True
                    t.used += 1
                    if t.used >= t.nmax:
                        break
        return out


class VaspNonEquilibriumCalculator(VaspCalculator):
    """Non-equilibrium structures: move up to nmax random atoms toward
    their nearest neighbor, keeping all distances >= dmin (reference
    `neq.py:8-82`)."""

    subdir = "neq"

    def __init__(self, root, config):
        super().__init__(root, config)
        params = self.config.get("neq", {})
        self.dmin = params.get("dmin", 1.2)
        self.nmax = params.get("nmax", 3)
        if self.nmax < 1:
            raise ValueError("'nmax' must be >= 1")
        self.move_factor = params.get("move_factor", 0.6)
        if self.move_factor <= 0:
            raise ValueError("'move_factor' must be > 0")
        self.sampling_interval = params.get("interval", 500)

    @property
    def random_seed(self) -> int:
        return 1

    def may_modify_atoms(self, structure: Structure
                         ) -> Optional[Structure]:
        size = len(structure)
        n = min(size // 4, self.rng.randint(1, self.nmax + 1))
        if n == 0:
            return None
        out = structure.copy()
        indices = self.rng.choice(size, n, replace=False)
        for i in indices:
            ii, jj, _, d, vec = neighbor_list(out, 5.0)
            sel = ii == i
            if not np.any(sel):
                continue
            dd, vv = d[sel], vec[sel]
            j = int(np.argmin(dd))
            if dd[j] < self.dmin:
                continue
            smax = min(self.dmin / dd[j], 1.0)
            for s in np.arange(smax * self.move_factor, 0.0, -0.05):
                x = out.positions[i] + vv[j] * s
                if np.all(np.linalg.norm(
                        out.positions[i] + vv - x, axis=1) >= self.dmin):
                    out.positions[i] = x
                    break
        return out


class VaspPorousCalculator(VaspCalculator):
    """Porous structures by random removal: keep n/porosity atoms
    (reference `porous.py:9-68`)."""

    subdir = "porous"

    def __init__(self, root, config):
        super().__init__(root, config)
        params = self.config.get("porosity", {})
        if "porosity" not in params:
            raise ValueError("missing 'porosity' key in [porosity]")
        porosity = params["porosity"]
        if isinstance(porosity, (int, float)):
            if porosity <= 1:
                raise ValueError(
                    f"porosity must be > 1 (n_keep = n/porosity); "
                    f"got {porosity}")
            self.get_porosity = lambda: float(porosity)
        else:
            pmin, pmax = sorted(float(x) for x in porosity)
            if pmin <= 1:
                pmin = 1.01
            self.get_porosity = \
                lambda: float(self.rng.uniform(pmin, pmax))
        self.sampling_interval = params.get("interval", 500)

    def may_modify_atoms(self, structure: Structure
                         ) -> Optional[Structure]:
        porosity = self.get_porosity()
        n = len(structure)
        nd = max(1, n - int(n / porosity))
        indices = self.rng.choice(n, nd, replace=False)
        return delete_atoms(structure, indices)
