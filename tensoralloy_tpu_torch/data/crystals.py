"""Built-in crystal library for the constraint losses (port of
`tensoralloy_tpu/data/crystals.py`, with its own copy of the data files
under `data/crystals/`).

Crystals are resolvable BY NAME in experiment TOMLs (e.g.
``crystals = ['Ni', 'Mo/dft', 'Ni3Mo']``); the elastic constants are the
published experimental / Materials-Project values (GPa). Multi-element
cells load from the bundled CIFs; elemental phases are built
analytically.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..atoms import Structure

_CRYSTAL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "crystals")


def crystal_data_dir() -> str:
    return _CRYSTAL_DIR


def fcc(symbol: str, a: float) -> Structure:
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    return Structure.from_symbols([symbol] * 4, base * a, np.eye(3) * a,
                                  pbc=[True] * 3)


def bcc(symbol: str, a: float) -> Structure:
    base = np.array([[0, 0, 0], [.5, .5, .5]])
    return Structure.from_symbols([symbol] * 2, base * a, np.eye(3) * a,
                                  pbc=[True] * 3)


def hcp(symbol: str, a: float, c: float,
        basis=((0.0, 0.0, 0.0), (1 / 3, 2 / 3, 0.5))) -> Structure:
    cell = np.array([[a, 0, 0],
                     [-a / 2, a * np.sqrt(3) / 2, 0],
                     [0, 0, c]])
    pos = np.asarray(basis) @ cell
    return Structure.from_symbols([symbol] * len(basis), pos, cell,
                                  pbc=[True] * 3)


def _cif(name: str) -> Structure:
    from ..io.cif import read_cif
    return read_cif(os.path.join(_CRYSTAL_DIR, name))


def _spec(name, phase, structure, bulk_modulus, constants):
    """constants: {(vi, vj) 1-based Voigt: GPa}."""
    from ..nn.constraints import CrystalSpec, ElasticConstant
    return CrystalSpec(
        name=name, structure=structure, phase=phase,
        bulk_modulus=float(bulk_modulus),
        elastic_constants=[ElasticConstant(vi=i, vj=j, value=float(v))
                           for (i, j), v in constants.items()])


def _build() -> Dict[str, object]:
    # DFT hcp Be
    be_dft = hcp("Be", 2.26440844, 3.56733004,
                 basis=((2 / 3, 1 / 3, 3 / 4), (1 / 3, 2 / 3, 1 / 4)))
    return {
        "Be": _spec("Be", "hcp", hcp("Be", 2.29, 3.59), 117,
                    {(1, 1): 294, (3, 3): 357, (4, 4): 162,
                     (6, 6): 133, (1, 2): 27, (1, 3): 14}),
        "Be/dft": _spec("Be", "hcp", be_dft, 120,
                        {(1, 1): 322, (3, 3): 378, (4, 4): 162,
                         (6, 6): 151, (1, 2): 21, (1, 3): 8}),
        "Al": _spec("Al", "fcc", fcc("Al", 4.05), 76,
                    {(1, 1): 104, (1, 2): 73, (4, 4): 32}),
        "Al/bcc": _spec("Al", "bcc",
                        _cif("Al_bcc_conventional_standard.cif"), 0,
                        {(1, 1): 36, (1, 2): 86, (4, 4): 42}),
        "Ni": _spec("Ni", "fcc", fcc("Ni", 3.524), 188,
                    {(1, 1): 276, (1, 2): 159, (4, 4): 132}),
        "Mo": _spec("Mo", "bcc", bcc("Mo", 3.147), 259,
                    {(1, 1): 472, (1, 2): 158, (4, 4): 106}),
        "Mo/dft": _spec("Mo/dft", "bcc", bcc("Mo", 3.168), 259,
                        {(1, 1): 472, (1, 2): 158, (4, 4): 106}),
        "Ni4Mo": _spec(
            "Ni4Mo", "cubic",
            _cif("Ni4Mo_mp-11507_conventional_standard.cif"), 0,
            {(1, 1): 300, (1, 2): 186, (2, 3): 166, (2, 2): 313,
             (3, 3): 313, (4, 4): 106, (5, 5): 130, (6, 6): 130}),
        "Ni3Mo": _spec(
            "Ni3Mo", "cubic",
            _cif("Ni3Mo_mp-11506_conventional_standard.cif"), 0,
            {(1, 1): 385, (1, 2): 166, (1, 3): 145, (2, 2): 402,
             (2, 3): 131, (3, 3): 402, (4, 4): 58, (5, 5): 66,
             (6, 6): 94}),
    }


_cache: Dict[str, object] = {}


def built_in_crystals() -> Dict[str, object]:
    if not _cache:
        _cache.update(_build())
    return _cache
