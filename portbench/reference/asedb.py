"""Read an ASE-format SQLite structure database (the `systems` table of
`ase.db`, version 8) with `sqlite3` and numpy: the rows in id order."""
from __future__ import annotations

import json
import sqlite3

import numpy as np


def read(path: str) -> list:
    """-> one dict a row: numbers, positions [n, 3] (A), cell [3, 3],
    pbc [3], energy (eV), forces [n, 3] (eV/A) and the label weights
    (energy, forces, stress; 1 where the row gives none)."""
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        rows = con.execute(
            "select natoms, numbers, positions, cell, pbc, energy, forces,"
            " data from systems order by id").fetchall()
    finally:
        con.close()
    out = []
    for natoms, numbers, positions, cell, pbc, energy, forces, data in rows:
        z = np.frombuffer(numbers, np.int32)
        if len(z) != natoms:
            z = np.frombuffer(numbers, np.int64)
        weights = json.loads(data or "{}").get("weights", [1.0, 1.0, 1.0])
        out.append({
            "numbers": z.astype(np.int64),
            "positions": np.frombuffer(positions, np.float64).reshape(-1, 3),
            "cell": np.frombuffer(cell, np.float64).reshape(3, 3),
            "pbc": np.array([(int(pbc) >> k) & 1 for k in range(3)], bool),
            "energy": float(energy),
            "forces": np.frombuffer(forces, np.float64).reshape(-1, 3),
            "weights": np.asarray(list(weights) + [1.0] * (3 - len(weights)),
                                  np.float64),
        })
    return out
