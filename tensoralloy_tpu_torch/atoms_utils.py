"""Accessors for finite-temperature per-structure quantities
(reference `tensoralloy/atoms_utils.py:30-68`): electron temperature,
electron entropy and kinetic energy stored in `Structure.info`."""
from __future__ import annotations

from .atoms import Structure


def get_electron_temperature(structure: Structure) -> float:
    return float(structure.info.get("etemperature", 0.0))


def set_electron_temperature(structure: Structure, t: float):
    structure.info["etemperature"] = float(t)


def get_electron_entropy(structure: Structure) -> float:
    return float(structure.info.get("eentropy", 0.0))


def set_electron_entropy(structure: Structure, s: float):
    structure.info["eentropy"] = float(s)


def get_kinetic_energy(structure: Structure) -> float:
    return float(structure.info.get("kinetic_energy", 0.0))


def set_kinetic_energy(structure: Structure, e: float):
    structure.info["kinetic_energy"] = float(e)
