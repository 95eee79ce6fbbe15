"""Extended-XYZ reader/writer (standalone; no ASE).

Covers what the reference ingests via `ase.io.read` + its own
`tensoralloy/io/read.py:43-187` logic: Lattice, Properties columns
(species/pos/forces/...), scalar key=values (energy, pulay_stress,
eentropy, etemperature, weights, source) and the 3x3 `stress` entry
(eV/A^3, row major) which is converted to Voigt.
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional

import numpy as np

from ..atoms import Structure, full_3x3_to_voigt, voigt_to_full_3x3
from ..elements import atomic_numbers

_KV_RE = re.compile(
    r"""(?P<key>[A-Za-z_][A-Za-z0-9_\-]*)\s*=\s*"""
    r"""(?:"(?P<quoted>[^"]*)"|(?P<plain>\S+))""")


def _parse_value(raw: str):
    toks = raw.split()
    if len(toks) == 0:
        return ""
    def scalar(t):
        if t in ("T", "True", "true"):
            return True
        if t in ("F", "False", "false"):
            return False
        try:
            return int(t)
        except ValueError:
            pass
        try:
            return float(t)
        except ValueError:
            return t
    vals = [scalar(t) for t in toks]
    if len(vals) == 1:
        return vals[0]
    if all(isinstance(v, (int, float, bool)) and not isinstance(v, str)
           for v in vals):
        return np.asarray(vals, dtype=np.float64 if not all(
            isinstance(v, bool) for v in vals) else bool)
    return vals


def _parse_comment(line: str) -> dict:
    out = {}
    for m in _KV_RE.finditer(line):
        raw = m.group("quoted") if m.group("quoted") is not None \
            else m.group("plain")
        key = m.group("key")
        out[key] = raw if key == "Properties" else _parse_value(raw)
    return out


def _parse_properties(spec: str):
    """'species:S:1:pos:R:3:forces:R:3' -> [(name, kind, ncols), ...]."""
    toks = spec.split(":")
    cols = []
    for i in range(0, len(toks), 3):
        cols.append((toks[i], toks[i + 1], int(toks[i + 2])))
    return cols


def iread_extxyz(path: str) -> Iterator[Structure]:
    with open(path) as fh:
        while True:
            line = fh.readline()
            if not line:
                return
            line = line.strip()
            if not line:
                continue
            natoms = int(line)
            header = _parse_comment(fh.readline())
            spec = _parse_properties(
                header.pop("Properties", "species:S:1:pos:R:3"))
            rows = [fh.readline().split() for _ in range(natoms)]

            symbols: List[str] = []
            arrays = {}
            c0 = 0
            for name, kind, ncols in spec:
                block = [r[c0:c0 + ncols] for r in rows]
                c0 += ncols
                if name == "species":
                    symbols = [b[0] for b in block]
                elif kind in ("R", "I"):
                    arr = np.asarray(block, dtype=np.float64)
                    arrays[name] = arr[:, 0] if ncols == 1 else arr
            numbers = np.array([atomic_numbers[s] for s in symbols], np.int32)

            cell = header.pop("Lattice", None)
            if cell is not None:
                cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
            pbc = header.pop("pbc", None)
            if pbc is None:
                pbc = np.array([cell is not None] * 3)
            else:
                pbc = np.atleast_1d(np.asarray(pbc)).astype(bool)
                if pbc.size == 1:
                    pbc = np.repeat(pbc, 3)

            info = dict(header)
            if "stress" in info:
                s = np.asarray(info["stress"], dtype=np.float64)
                if s.size == 9:
                    s = full_3x3_to_voigt(s.reshape(3, 3))
                info["stress"] = s
            pos = arrays.pop("pos", np.zeros((natoms, 3)))
            if "forces" in arrays:
                info["forces"] = arrays.pop("forces")
            info.update(arrays)
            yield Structure(numbers, pos, cell, pbc, info=info)


def read_extxyz(path: str, index: Optional[slice] = None) -> List[Structure]:
    items = list(iread_extxyz(path))
    return items[index] if index is not None else items


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    if isinstance(v, np.ndarray):
        flat = v.reshape(-1)
        if v.dtype == bool:
            return '"' + " ".join("T" if x else "F" for x in flat) + '"'
        return '"' + " ".join(repr(float(x)) for x in flat) + '"'
    return f'"{v}"' if " " in str(v) else str(v)


def write_extxyz(path: str, structures, append: bool = False):
    if isinstance(structures, Structure):
        structures = [structures]
    mode = "a" if append else "w"
    with open(path, mode) as fh:
        for s in structures:
            keys = {}
            if s.volume > 1e-12:
                keys["Lattice"] = s.cell
            props = "species:S:1:pos:R:3"
            forces = s.forces
            if forces is not None:
                props += ":forces:R:3"
            velocities = s.info.get("velocities")
            if velocities is not None:
                velocities = np.asarray(velocities)
                props += ":velocities:R:3"
            keys["Properties"] = props
            for k, v in s.info.items():
                if k in ("forces", "velocities"):
                    continue
                if k == "stress" and v is not None:
                    v = voigt_to_full_3x3(np.asarray(v))
                keys[k] = v
            keys["pbc"] = s.pbc
            parts = []
            for k, v in keys.items():
                parts.append(f"{k}={_fmt_value(v)}" if k != "Properties"
                             else f"Properties={v}")
            fh.write(f"{len(s)}\n{' '.join(parts)}\n")
            for sym, pos, i in zip(s.symbols, s.positions, range(len(s))):
                row = f"{sym:2s} " + " ".join(f"{x:16.8f}" for x in pos)
                if forces is not None:
                    row += " " + " ".join(f"{x:16.8f}" for x in forces[i])
                if velocities is not None:
                    row += " " + " ".join(f"{x:16.10f}"
                                          for x in velocities[i])
                fh.write(row + "\n")
