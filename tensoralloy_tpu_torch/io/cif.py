"""Minimal CIF reader: P1 cells plus symmetrized CIFs carrying
`_symmetry_equiv_pos_as_xyz` operator lists (the Materials-Project form
of the reference's bundled crystals, `data/crystals/*.cif`)."""
from __future__ import annotations

import re
from typing import List

import numpy as np

from ..atoms import Structure
from ..elements import atomic_numbers


def cellpar_to_cell(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Standard crystallographic cell-parameter -> matrix conversion
    (a along x, b in the xy plane)."""
    alpha, beta, gamma = np.radians([alpha, beta, gamma])
    bx = b * np.cos(gamma)
    by = b * np.sin(gamma)
    cx = c * np.cos(beta)
    cy = c * (np.cos(alpha) - np.cos(beta) * np.cos(gamma)) / np.sin(gamma)
    cz = np.sqrt(max(c * c - cx * cx - cy * cy, 0.0))
    return np.array([[a, 0.0, 0.0], [bx, by, 0.0], [cx, cy, cz]])


def read_cif(path: str) -> Structure:
    with open(path) as fh:
        lines = fh.read().splitlines()

    values = {}
    loops: List[dict] = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("_"):
            parts = line.split(None, 1)
            if len(parts) == 2:
                values[parts[0]] = parts[1].strip().strip('"\'')
        elif line.startswith("loop_"):
            headers = []
            i += 1
            while i < len(lines) and lines[i].strip().startswith("_"):
                headers.append(lines[i].strip())
                i += 1
            rows = []
            while i < len(lines):
                row = lines[i].strip()
                if not row or row.startswith(("_", "loop_", "data_")):
                    break
                rows.append(_split_cif_row(row))
                i += 1
            loops.append({"headers": headers, "rows": rows})
            continue
        i += 1

    cell = cellpar_to_cell(
        float(_num(values["_cell_length_a"])),
        float(_num(values["_cell_length_b"])),
        float(_num(values["_cell_length_c"])),
        float(_num(values["_cell_angle_alpha"])),
        float(_num(values["_cell_angle_beta"])),
        float(_num(values["_cell_angle_gamma"])))

    # symmetry operators (one xyz expression per row), identity default
    symops = [("x", "y", "z")]
    for loop in loops:
        heads = loop["headers"]
        cols = [h for h in heads
                if h in ("_symmetry_equiv_pos_as_xyz",
                         "_space_group_symop_operation_xyz")]
        if not cols:
            continue
        ic = heads.index(cols[0])
        symops = []
        for row in loop["rows"]:
            expr = row[ic].strip("'\"")
            symops.append(tuple(t.strip() for t in expr.split(",")))

    symbols, frac = [], []
    for loop in loops:
        heads = loop["headers"]
        if not any("_atom_site_fract_x" in h for h in heads):
            continue
        ix = heads.index("_atom_site_fract_x")
        iy = heads.index("_atom_site_fract_y")
        iz = heads.index("_atom_site_fract_z")
        if "_atom_site_type_symbol" in heads:
            isym = heads.index("_atom_site_type_symbol")
        else:
            isym = heads.index("_atom_site_label")
        for row in loop["rows"]:
            sym = re.match(r"[A-Z][a-z]?", row[isym]).group(0)
            if sym not in atomic_numbers:
                raise ValueError(f"unknown element {sym}")
            symbols.append(sym)
            frac.append([_num(row[ix]), _num(row[iy]), _num(row[iz])])
    frac = np.asarray(frac, dtype=np.float64)
    if len(symops) > 1:
        symbols, frac = _apply_symops(symbols, frac, symops)
    positions = frac @ cell
    return Structure.from_symbols(symbols, positions, cell,
                                  pbc=[True, True, True])


def _apply_symops(symbols, frac, symops, tol: float = 1e-4):
    """Expand the asymmetric unit through the operator list, merging
    duplicates (fractional coordinates wrapped into [0, 1))."""
    out_sym, out_frac = [], []
    for sym, xyz in zip(symbols, frac):
        env = {"x": xyz[0], "y": xyz[1], "z": xyz[2]}
        for op in symops:
            p = np.array([_eval_symop(expr, env) for expr in op])
            p = p % 1.0
            p = np.where(p > 1.0 - tol, 0.0, p)
            dup = any(s == sym and np.max(np.abs(
                (np.asarray(q) - p + 0.5) % 1.0 - 0.5)) < tol
                for s, q in zip(out_sym, out_frac))
            if not dup:
                out_sym.append(sym)
                out_frac.append(p)
    return out_sym, np.asarray(out_frac)


_SYMOP_RE = re.compile(r"^[xyz0-9+\-*/. ]+$")


def _eval_symop(expr: str, env: dict) -> float:
    expr = expr.strip().lower()
    if not _SYMOP_RE.match(expr):
        raise ValueError(f"unsupported symmetry operator {expr!r}")
    return float(eval(expr, {"__builtins__": {}}, env))


def _split_cif_row(row: str) -> List[str]:
    return re.findall(r"'[^']*'|\"[^\"]*\"|\S+", row)


def _num(token: str) -> float:
    token = str(token).strip().strip("'\"")
    token = re.sub(r"\(\d+\)$", "", token)  # drop uncertainty suffix
    return float(token)
