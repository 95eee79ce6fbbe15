"""Virtual-Atom Map: fixed-shape atom layout for arbitrary stoichiometries.

Re-implementation of the reference's VAP data model
(`tensoralloy/transformer/vap.py:18-197`): any structure whose per-element
counts fit within ``max_occurs`` maps into one static layout of
``1 + sum(max_occurs)`` rows — row 0 is the virtual padding atom "X",
then ``max_occurs[e]`` contiguous rows per element (elements sorted).

This layout is what makes per-element MLPs static row slices: atom
rows of element ``e`` always live at ``offset[e] : offset[e]+max_occurs[e]``.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

import numpy as np


class VirtualAtomMap:
    """Maps a structure's local atom order into the global sorted layout."""

    REAL_ATOM_START = 1

    def __init__(self, max_occurs: Counter, symbols: List[str]):
        self.symbols = list(symbols)
        self.max_occurs = Counter(max_occurs)
        self.n_atoms_vap = int(sum(max_occurs.values()) + 1)

        elements = sorted(self.max_occurs.keys())
        self.elements = elements
        offsets = np.concatenate(
            [[0], np.cumsum([self.max_occurs[e] for e in elements])[:-1]])
        self.element_offsets: Dict[str, int] = {
            e: int(offsets[i]) + self.REAL_ATOM_START
            for i, e in enumerate(elements)}

        # local index (0-based) -> vap row
        seen = Counter()
        l2g = np.zeros(len(symbols), dtype=np.int32)
        mask = np.zeros(self.n_atoms_vap, dtype=bool)
        for i, s in enumerate(symbols):
            if seen[s] >= self.max_occurs[s]:
                raise ValueError(
                    f"more than max_occurs[{s}]={self.max_occurs[s]} atoms")
            row = self.element_offsets[s] + seen[s]
            l2g[i] = row
            seen[s] += 1
            mask[row] = True
        self.local_to_vap = l2g            # [n_local] int32
        self.atom_masks = mask.astype(np.float64)  # [n_vap]
        g2l = np.full(self.n_atoms_vap, -1, dtype=np.int32)
        g2l[l2g] = np.arange(len(symbols), dtype=np.int32)
        self.vap_to_local = g2l            # [n_vap], -1 for padding rows

    # ------------------------------------------------------------------
    @property
    def vap_symbols(self) -> List[str]:
        out = ["X"]
        for e in self.elements:
            out.extend([e] * self.max_occurs[e])
        return out

    def map_positions(self, array: np.ndarray) -> np.ndarray:
        """[n_local, d] -> [n_vap, d]; padding rows are zero."""
        array = np.asarray(array)
        out = np.zeros((self.n_atoms_vap,) + array.shape[1:], array.dtype)
        out[self.local_to_vap] = array
        return out

    map_forces = map_positions
    map_array = map_positions

    def reverse_map(self, array: np.ndarray) -> np.ndarray:
        """[n_vap, ...] -> [n_local, ...]."""
        return np.asarray(array)[self.local_to_vap]

    def reverse_map_hessian(self, hessian: np.ndarray,
                            phonopy_format: bool = False) -> np.ndarray:
        """[n_vap, 3, n_vap, 3] -> [3N, 3N] (or phonopy [N, N, 3, 3])."""
        idx = self.local_to_vap
        n = len(self.symbols)
        h = np.asarray(hessian)[idx][:, :, idx, :]   # [N, 3, N, 3]
        if phonopy_format:
            return np.transpose(h, (0, 2, 1, 3))
        return h.reshape(3 * n, 3 * n)
