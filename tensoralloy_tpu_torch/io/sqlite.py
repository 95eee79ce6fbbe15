"""ASE-db-compatible SQLite structure database (copy of
`tensoralloy_tpu/io/sqlite.py`; numpy and `sqlite3` only).

Reads and writes the `ase.db` version-8 SQLite schema directly, so both
packages open the same training databases, and caches dataset metadata
in the `information` table (the file is written to when a value is
first computed):

  * ``max_occurs``          per-element maximum atom counts
  * ``forces/stress/periodic`` label availability flags
  * ``neighbors``           per-(k_max, rc) padding bounds
                            {nij_max, nnl_max, nijk_max}
  * ``atomic_static_energy`` least-squares per-element reference
                            energies
"""
from __future__ import annotations

import json
import os
import sqlite3
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from hashlib import md5
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..atoms import Structure
from ..neighbor import find_neighbor_size_of_atoms, NeighborSize

_COLUMNS = [
    ("unique_id", "TEXT"), ("ctime", "REAL"), ("mtime", "REAL"),
    ("username", "TEXT"), ("numbers", "BLOB"), ("positions", "BLOB"),
    ("cell", "BLOB"), ("pbc", "INTEGER"), ("initial_magmoms", "BLOB"),
    ("initial_charges", "BLOB"), ("masses", "BLOB"), ("tags", "BLOB"),
    ("momenta", "BLOB"), ("constraints", "TEXT"), ("calculator", "TEXT"),
    ("calculator_parameters", "TEXT"), ("energy", "REAL"),
    ("free_energy", "REAL"), ("forces", "BLOB"), ("stress", "BLOB"),
    ("dipole", "BLOB"), ("magmoms", "BLOB"), ("magmom", "REAL"),
    ("charges", "BLOB"), ("key_value_pairs", "TEXT"), ("data", "TEXT"),
    ("natoms", "INTEGER"), ("fmax", "REAL"), ("smax", "REAL"),
    ("volume", "REAL"), ("mass", "REAL"), ("charge", "REAL"),
]


def _blob(arr: Optional[np.ndarray]) -> Optional[bytes]:
    if arr is None:
        return None
    return np.ascontiguousarray(arr).tobytes()


def _deblob(buf, dtype, shape=None):
    if buf is None:
        return None
    arr = np.frombuffer(buf, dtype=dtype).copy()
    return arr.reshape(shape) if shape is not None else arr


class CoreDatabase:
    """SQLite structure database with cached metadata."""

    def __init__(self, filename: str):
        self.filename = str(filename)
        self._con = sqlite3.connect(self.filename)
        self._ensure_schema()

    # sqlite3.Connection is unpicklable; drop it for process fan-out
    # (Dataset.build(serial=False)) and reconnect lazily in the worker
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_con"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._con = sqlite3.connect(self.filename)

    # ------------------------------------------------------------------
    def _ensure_schema(self):
        cur = self._con.cursor()
        tables = {r[0] for r in cur.execute(
            "select name from sqlite_master where type='table'")}
        if "systems" not in tables:
            cols = ", ".join(f"{n} {t}" for n, t in _COLUMNS)
            cur.execute("create table systems "
                        f"(id integer primary key autoincrement, {cols})")
        if "information" not in tables:
            cur.execute("create table information (name text, value text)")
            cur.execute("insert into information values ('version', '8')")
        self._con.commit()

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return self._con.execute("select count(*) from systems").fetchone()[0]

    def _row_to_structure(self, row, columns) -> Structure:
        d = dict(zip(columns, row))
        natoms = d["natoms"]
        numbers = _deblob(d["numbers"], np.int32)
        if numbers is None or len(numbers) != natoms:
            numbers = _deblob(d["numbers"], np.int64)
        positions = _deblob(d["positions"], np.float64, (natoms, 3))
        cell = _deblob(d["cell"], np.float64, (3, 3))
        pbc_int = int(d["pbc"] or 0)
        pbc = np.array([(pbc_int >> k) & 1 for k in range(3)], dtype=bool)
        info: Dict = {}
        if d["energy"] is not None:
            info["energy"] = float(d["energy"])
        if d["free_energy"] is not None:
            info["free_energy"] = float(d["free_energy"])
        forces = _deblob(d["forces"], np.float64)
        if forces is not None:
            info["forces"] = forces.reshape(natoms, 3)
        stress = _deblob(d["stress"], np.float64)
        if stress is not None:
            info["stress"] = (stress if stress.size == 6
                              else stress.reshape(3, 3))
        kvp = json.loads(d["key_value_pairs"] or "{}")
        data = json.loads(d["data"] or "{}")
        for key in ("source", "eentropy", "etemperature", "kinetic_energy"):
            if key in kvp:
                info[key] = kvp[key]
            if key in data:
                info[key] = data[key]
        if "weights" in data:
            info["weights"] = np.asarray(data["weights"], dtype=np.float64)
        info["db_id"] = d["id"]
        return Structure(numbers.astype(np.int32), positions, cell, pbc,
                         info=info)

    def get(self, idx: int) -> Structure:
        """1-based id lookup (ase.db convention)."""
        cur = self._con.execute("select * from systems where id=?", (idx,))
        row = cur.fetchone()
        if row is None:
            raise KeyError(f"no row with id={idx}")
        cols = [c[0] for c in cur.description]
        return self._row_to_structure(row, cols)

    def __iter__(self) -> Iterator[Structure]:
        cur = self._con.execute("select * from systems order by id")
        cols = [c[0] for c in cur.description]
        for row in cur:
            yield self._row_to_structure(row, cols)

    def select_all(self) -> List[Structure]:
        return list(self)

    # ------------------------------------------------------------------
    def write(self, structure: Structure, commit: bool = True):
        s = structure
        info = s.info
        pbc_int = int(s.pbc[0]) | (int(s.pbc[1]) << 1) | (int(s.pbc[2]) << 2)
        forces = s.forces
        stress = s.stress
        kvp = {k: info[k] for k in
               ("source", "eentropy", "etemperature", "kinetic_energy")
               if k in info}
        data = {}
        if "weights" in info:
            data["weights"] = np.asarray(info["weights"]).tolist()
        fmax = float(np.abs(forces).max()) if forces is not None else None
        uid = md5((repr(s.numbers.tolist()) + repr(s.positions.tobytes()) +
                   repr(time.time())).encode()).hexdigest()
        values = {
            "unique_id": uid, "ctime": time.time(), "mtime": time.time(),
            "username": os.environ.get("USER", "user"),
            "numbers": _blob(s.numbers.astype(np.int32)),
            "positions": _blob(s.positions),
            "cell": _blob(s.cell), "pbc": pbc_int,
            "calculator": "unknown", "calculator_parameters": "{}",
            "energy": info.get("energy"),
            "free_energy": info.get("free_energy"),
            "forces": _blob(forces), "stress": _blob(stress),
            "key_value_pairs": json.dumps(kvp), "data": json.dumps(data),
            "natoms": len(s), "fmax": fmax,
            "volume": s.volume if s.volume > 0 else None,
            "mass": float(s.masses.sum()), "charge": 0.0,
        }
        names = ", ".join(values)
        marks = ", ".join("?" for _ in values)
        self._con.execute(
            f"insert into systems ({names}) values ({marks})",
            tuple(values.values()))
        if commit:
            self._con.commit()
        # cached dataset metadata (max_occurs, padding bounds, static
        # energies) describes the PREVIOUS contents — drop it so the
        # next consumer recomputes instead of reading stale bounds
        self._invalidate_derived_metadata()

    def write_many(self, structures: List[Structure]):
        # one transaction for the whole batch: per-row commits are one
        # journal fsync each and dominate bulk-ingestion wall time
        for s in structures:
            self.write(s, commit=False)
        self._con.commit()

    _DERIVED_KEYS = ("max_occurs", "forces", "stress", "periodic",
                     "neighbors", "atomic_static_energy")

    def _invalidate_derived_metadata(self):
        if getattr(self, "_derived_stale", False):
            return
        md = self.metadata
        kept = {k: v for k, v in md.items()
                if k not in self._DERIVED_KEYS}
        if len(kept) != len(md):
            self.metadata = kept
        self._derived_stale = True

    # ------------------------------------------------------------------
    @property
    def metadata(self) -> dict:
        row = self._con.execute(
            "select value from information where name='metadata'").fetchone()
        return json.loads(row[0]) if row else {}

    @metadata.setter
    def metadata(self, value: dict):
        self._con.execute("delete from information where name='metadata'")
        self._con.execute("insert into information values ('metadata', ?)",
                          (json.dumps(value),))
        self._con.commit()

    def _update_metadata(self, **kwargs):
        md = self.metadata
        md.update(kwargs)
        self.metadata = md
        # fresh derived values were just written; allow a later write()
        # to invalidate them again
        self._derived_stale = False

    # ------------------------------------------------------------------
    @property
    def max_occurs(self) -> Counter:
        md = self.metadata
        if "max_occurs" not in md:
            occurs = Counter()
            has_forces, has_stress, periodic = False, False, False
            for s in self:
                for e, c in s.count().items():
                    occurs[e] = max(occurs[e], c)
                has_forces |= s.forces is not None
                has_stress |= s.stress is not None
                periodic |= bool(s.pbc.any())
            self._update_metadata(
                max_occurs=dict(occurs), forces=has_forces,
                stress=has_stress, periodic=periodic)
        return Counter(self.metadata["max_occurs"])

    @property
    def has_forces(self) -> bool:
        self.max_occurs  # noqa — ensure computed
        return bool(self.metadata.get("forces"))

    @property
    def has_stress(self) -> bool:
        self.max_occurs  # noqa
        return bool(self.metadata.get("stress"))

    @property
    def has_periodic_structures(self) -> bool:
        self.max_occurs  # noqa
        return bool(self.metadata.get("periodic"))

    # ------------------------------------------------------------------
    def get_neighbor_sizes(self, rc: float, angular: bool = False,
                           n_jobs: int = 0,
                           acut: float = None) -> NeighborSize:
        """Cached padding bounds over the whole dataset for cutoff rc
        (triples counted within `acut`, default rc — see
        find_neighbor_size_of_atoms).

        The cache key follows the layout of the published databases
        (`metadata['neighbors'][k_max][str(int(rc*100))]`)."""
        k_max = "3" if angular else "2"
        key = str(int(round(rc * 100)))
        if angular and acut is not None and abs(acut - rc) > 1e-9:
            key += f"a{int(round(acut * 100))}"
        md = self.metadata
        cached = md.get("neighbors", {}).get(k_max, {}).get(key)
        # nnl_tot/ntl were added for the dense descriptor backends and
        # ttrans for the triple transpose tables (angular only);
        # recompute when a pre-existing cache entry lacks them
        if cached and "nnl_tot_max" in cached and (
                not angular or "ttrans_max" in cached):
            return NeighborSize(nnl=cached["nnl_max"],
                                nij=cached["nij_max"],
                                nijk=cached.get("nijk_max", 0), ij2k=0,
                                nnl_tot=cached["nnl_tot_max"],
                                ntl=cached.get("ntl_max", 0),
                                ttrans=cached.get("ttrans_max", 0))
        structures = list(self)
        if n_jobs and n_jobs > 1:
            import multiprocessing
            with ProcessPoolExecutor(
                    max_workers=n_jobs,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                sizes = list(ex.map(
                    _nbr_size_worker,
                    [(s, rc, angular, acut) for s in structures],
                    chunksize=16))
        else:
            sizes = [find_neighbor_size_of_atoms(s, rc, angular,
                                                 acut=acut)
                     for s in structures]
        out = NeighborSize(nnl=max(x.nnl for x in sizes),
                           nij=max(x.nij for x in sizes),
                           nijk=max(x.nijk for x in sizes), ij2k=0,
                           nnl_tot=max(x.nnl_tot for x in sizes),
                           ntl=max(x.ntl for x in sizes),
                           ttrans=max(x.ttrans for x in sizes))
        nbrs = md.get("neighbors", {})
        nbrs.setdefault(k_max, {})[key] = {
            "nnl_max": out.nnl, "nij_max": out.nij, "nijk_max": out.nijk,
            "nnl_tot_max": out.nnl_tot, "ntl_max": out.ntl,
            "ttrans_max": out.ttrans}
        self._update_metadata(neighbors=nbrs)
        return out

    # ------------------------------------------------------------------
    def get_atomic_static_energy(self, allow_calculation: bool = True
                                 ) -> Dict[str, float]:
        """Least-squares per-element energies: solve  A x = E  where
        A[s, e] = count of element e in structure s."""
        md = self.metadata
        if "atomic_static_energy" not in md and allow_calculation:
            elements = sorted(self.max_occurs.keys())
            rows, b = [], []
            for s in self:
                if s.energy is None:
                    continue
                c = s.count()
                rows.append([c.get(e, 0) for e in elements])
                b.append(s.energy)
            a = np.asarray(rows, dtype=np.float64)
            b = np.asarray(b, dtype=np.float64)
            x = np.linalg.lstsq(a, b, rcond=None)[0]
            self._update_metadata(
                atomic_static_energy={e: float(v)
                                      for e, v in zip(elements, x)})
        return dict(self.metadata.get("atomic_static_energy", {}))

    @property
    def elements(self) -> List[str]:
        return sorted(self.max_occurs.keys())

    def close(self):
        self._con.close()


def _nbr_size_worker(args):
    s, rc, angular, acut = args
    return find_neighbor_size_of_atoms(s, rc, angular, acut=acut)


def connect(filename: str) -> CoreDatabase:
    return CoreDatabase(filename)


def read_file(path: str, db_path: Optional[str] = None,
              unit_energy: float = 1.0, unit_forces: float = 1.0,
              unit_stress: float = 1.0, fmax_limit: Optional[float] = None,
              vacuum: float = 20.0) -> CoreDatabase:
    """Ingest extxyz/xyz/db into a `CoreDatabase`."""
    if path.endswith(".db"):
        return connect(path)
    from .extxyz import iread_extxyz
    if db_path is None:
        base = os.path.splitext(os.path.basename(path))[0]
        db_path = os.path.join(os.path.dirname(path), base + ".db")
    if os.path.exists(db_path):
        os.remove(db_path)
    db = connect(db_path)
    for s in iread_extxyz(path):
        if fmax_limit is not None and s.forces is not None and \
                np.abs(s.forces).max() > fmax_limit:
            continue
        if s.volume < 1e-8:
            s = s.ensure_cell(vacuum)
        info = s.info
        if unit_energy != 1.0:
            # every energy-like label shares the energy unit:
            # free_energy/eentropy (stored as eV, docstring atoms.py)
            # and etemperature (kT in eV) must convert WITH energy or
            # finite-temperature training sees mixed units
            for key in ("energy", "free_energy", "eentropy",
                        "etemperature"):
                if key in info:
                    info[key] = info[key] * unit_energy
        if "forces" in info and unit_forces != 1.0:
            info["forces"] = np.asarray(info["forces"]) * unit_forces
        if "stress" in info and unit_stress != 1.0:
            info["stress"] = np.asarray(info["stress"]) * unit_stress
        db.write(s, commit=False)
    db._con.commit()
    db.max_occurs  # trigger metadata computation
    db._update_metadata(unit_conversion={"energy": unit_energy,
                                         "forces": unit_forces,
                                         "stress": unit_stress})
    return db
