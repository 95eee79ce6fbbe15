"""Unit-expression parsing (reference `tensoralloy/io/units.py:31-50`):
convert expressions like 'kcal/mol', 'Hartree', 'kbar' into
multiplicative factors to the internal units (eV, eV/A, eV/A^3)."""
from __future__ import annotations

import ast
import operator

_AVOGADRO = 6.02214076e23
_EV_JOULE = 1.602176634e-19

# value of 1 unit in internal (eV / Angstrom) units
_UNITS = {
    "eV": 1.0,
    "meV": 1e-3,
    "Hartree": 27.211386024367243,
    "hartree": 27.211386024367243,
    "Ry": 13.605693012183621,
    "kcal": 4184.0 / _EV_JOULE,      # 1 kcal in eV
    "kJ": 1000.0 / _EV_JOULE,        # 1 kJ in eV
    "J": 1.0 / _EV_JOULE,
    "mol": _AVOGADRO,
    "Angstrom": 1.0,
    "Bohr": 0.5291772105638411,
    "nm": 10.0,
    "GPa": 1.0 / 160.21766208,       # 1 GPa in eV/A^3
    "kbar": 0.1 / 160.21766208,
}

_OPS = {ast.Mult: operator.mul, ast.Div: operator.truediv,
        ast.Pow: operator.pow}


def _eval(node):
    if isinstance(node, ast.Expression):
        return _eval(node.body)
    if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
        return _OPS[type(node.op)](_eval(node.left), _eval(node.right))
    if isinstance(node, ast.Constant):
        return float(node.value)
    if isinstance(node, ast.Name):
        if node.id in _UNITS:
            return _UNITS[node.id]
        raise ValueError(f"unknown unit '{node.id}'")
    raise ValueError(f"unsupported expression element {node!r}")


def get_conversion_factor(expression: str) -> float:
    """'kcal/mol' -> eV per kcal/mol (~0.04336); 'Hartree' -> 27.21."""
    if not expression:
        return 1.0
    tree = ast.parse(expression, mode="eval")
    return float(_eval(tree))


def get_unit_conversions(units: dict) -> dict:
    """{'energy': 'kcal/mol', ...} -> multiplicative factors."""
    return {key: get_conversion_factor(value)
            for key, value in (units or {}).items()}
