"""Microstructure generators for training-set diversity (port of
`tensoralloy_tpu/tensordb/microstructure.py`; reference
`tensordb/calculator/microstructure/{aging,neq,porous}.py`):
transmutation / helium-bubble insertion, non-equilibrium rattling,
vacancy clusters."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..atoms import Structure, minimum_image
from ..elements import atomic_numbers


def transmute(structure: Structure, fraction: float, new_element: str,
              seed: int = 0) -> Structure:
    """Randomly transmute a fraction of atoms into `new_element`
    (radioactive-decay aging, reference `aging.py`)."""
    rng = np.random.RandomState(seed)
    out = structure.copy()
    n = len(out)
    count = max(1, int(round(fraction * n)))
    idx = rng.choice(n, size=count, replace=False)
    out.numbers[idx] = atomic_numbers[new_element]
    return out


def insert_interstitials(structure: Structure, element: str,
                         count: int, min_distance: float = 1.2,
                         seed: int = 0,
                         max_trials: int = 2000) -> Structure:
    """Insert interstitial atoms (e.g. He bubbles) at random positions
    at least `min_distance` from every existing atom."""
    rng = np.random.RandomState(seed)
    out = structure.copy()
    positions = [out.positions]
    numbers = [out.numbers]
    added = 0
    all_pos = out.positions.copy()
    for _ in range(max_trials):
        if added >= count:
            break
        frac = rng.uniform(0, 1, 3)
        cand = frac @ out.cell
        # minimum-image: a candidate near a cell face must also clear
        # the periodic images of atoms at the opposite face
        d = np.linalg.norm(
            minimum_image(all_pos - cand, out.cell, out.pbc), axis=1)
        if np.all(d > min_distance):
            all_pos = np.vstack([all_pos, cand])
            positions.append(cand[None])
            numbers.append(np.array([atomic_numbers[element]], np.int32))
            added += 1
    return Structure(np.concatenate(numbers),
                     np.concatenate(positions), out.cell, out.pbc)


def rattle(structure: Structure, stdev: float = 0.1,
           seed: int = 0) -> Structure:
    """Non-equilibrium random displacement (reference `neq.py`)."""
    rng = np.random.RandomState(seed)
    out = structure.copy()
    out.positions = out.positions + rng.normal(0, stdev,
                                               out.positions.shape)
    return out


def random_strain(structure: Structure, magnitude: float = 0.02,
                  seed: int = 0) -> Structure:
    """Random symmetric cell deformation."""
    rng = np.random.RandomState(seed)
    eps = rng.normal(0, magnitude, (3, 3))
    eps = 0.5 * (eps + eps.T)
    m = np.eye(3) + eps
    out = structure.copy()
    out.cell = structure.cell @ m.T
    out.positions = structure.positions @ m.T
    return out


def make_vacancy_cluster(structure: Structure, count: int,
                         center: Optional[Sequence[float]] = None,
                         seed: int = 0) -> Structure:
    """Remove a cluster of nearby atoms (porous/void structures,
    reference `porous.py`)."""
    rng = np.random.RandomState(seed)
    n = len(structure)
    count = min(count, n - 1)
    if center is None:
        center = structure.positions[rng.randint(n)]
    d = np.linalg.norm(
        minimum_image(structure.positions - np.asarray(center),
                      structure.cell, structure.pbc), axis=1)
    remove = set(np.argsort(d)[:count].tolist())
    keep = [i for i in range(n) if i not in remove]
    return Structure(structure.numbers[keep],
                     structure.positions[keep],
                     structure.cell.copy(), structure.pbc.copy())
