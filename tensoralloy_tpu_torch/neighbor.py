"""Periodic neighbor lists and padding-bound computation.

Standalone, vectorized (numpy + scipy cKDTree) replacement for the
reference's ASE-backed neighbor machinery
(`tensoralloy/neighbor.py:50-146`, which wraps
`ase.neighborlist.neighbor_list`). Semantics match ASE's
``neighbor_list('ijSdD')``: for every ordered pair (i, j) with
``|R_j + S @ cell - R_i| < cutoff`` one entry is produced; both (i, j, S)
and (j, i, -S) appear; the self-pair (i, i, 0) is excluded.

These bounds size the dense per-atom neighbor and triple layouts that
the device path consumes.

The pairs come from the native C++ cell list (`native/`) where it can be
built, else from scipy's ``cKDTree``; both paths return the same list,
sorted by (i, j, shift). Setting ``TENSORALLOY_TPU_NO_NATIVE`` selects
the ``cKDTree`` path.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

from .atoms import Structure
from .utils import cantor_pairing

__all__ = ["neighbor_list", "NeighborSize", "find_neighbor_size_of_atoms"]


def _cell_heights(cell: np.ndarray) -> np.ndarray:
    """Distance between opposite cell faces along each lattice direction."""
    vol = abs(np.linalg.det(cell))
    if vol < 1e-12:
        return np.full(3, np.inf)
    cross = np.cross(cell[[1, 2, 0]], cell[[2, 0, 1]])  # a2xa3, a3xa1, a1xa2
    areas = np.linalg.norm(cross, axis=1)
    return vol / np.maximum(areas, 1e-300)


def neighbor_list(structure: Structure, cutoff: float,
                  use_native: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, np.ndarray]:
    """Build the full periodic neighbor list.

    Returns
    -------
    ilist : [nij] int32 — first atom index
    jlist : [nij] int32 — second atom index
    shift : [nij, 3] float64 — integer lattice shifts S
    dist : [nij] float64 — |R_j + S @ cell - R_i|
    vec : [nij, 3] float64 — R_j + S @ cell - R_i
    """
    pos = structure.positions
    cell = structure.cell
    pbc = structure.pbc.copy()
    n = len(structure)
    if abs(np.linalg.det(cell)) < 1e-12:
        # singular cell: only legitimate when every near-zero lattice
        # vector is non-periodic (slab/wire/cluster). Pad those axes
        # with large orthogonal vectors so the in-plane periodicity is
        # KEPT; refuse a periodic axis with a degenerate vector rather
        # than silently dropping its periodic images.
        cell = cell.copy()
        span = pos.max(axis=0) - pos.min(axis=0) if n else np.zeros(3)
        for ax in range(3):
            if np.linalg.norm(cell[ax]) < 1e-8:
                if pbc[ax]:
                    raise ValueError(
                        f"cell vector {ax} is zero but pbc[{ax}] is "
                        f"True — a periodic axis needs a real lattice "
                        f"vector")
                normal = np.cross(cell[(ax + 1) % 3],
                                  cell[(ax + 2) % 3])
                if np.linalg.norm(normal) > 1e-8:
                    unit = normal / np.linalg.norm(normal)
                else:
                    unit = np.zeros(3)
                    unit[ax] = 1.0
                cell[ax] = unit * (2.0 * cutoff + span[ax] + 1.0)
        if abs(np.linalg.det(cell)) < 1e-12:
            pbc = np.zeros(3, dtype=bool)

    # The image-shift enumeration below assumes positions lie (near)
    # the home cell; unwrapped MD-trajectory coordinates would silently
    # lose pairs. Wrap along periodic axes and fold the per-atom wrap
    # offsets back into the returned shifts so callers can keep using
    # the RAW positions:  R_j + S@cell - R_i  stays exact.
    wrap_off = np.zeros((n, 3), dtype=np.float64)
    if pbc.any() and n:
        frac = pos @ np.linalg.inv(cell)
        wrap_off[:, pbc] = np.floor(frac[:, pbc])
        if np.abs(wrap_off).max() > 0:
            pos = pos - wrap_off @ cell
        else:
            wrap_off = None
    else:
        wrap_off = None

    def _unwrap(ii, jj, shift, d, vec):
        if wrap_off is not None:
            shift = shift + wrap_off[ii] - wrap_off[jj]
        return ii, jj, shift, d, vec

    if use_native and not os.environ.get("TENSORALLOY_TPU_NO_NATIVE"):
        from .native import native_neighbor_list
        got = native_neighbor_list(pos, cell, pbc, cutoff)
        if got is not None:
            ii, jj, shift, d, vec = _unwrap(*got)
            order = np.lexsort((shift[:, 2], shift[:, 1], shift[:, 0],
                                jj, ii))
            return (ii[order], jj[order], shift[order], d[order],
                    vec[order])

    heights = _cell_heights(cell)
    reps = np.where(pbc, np.ceil(cutoff / heights).astype(np.int64), 0)
    rng = [np.arange(-reps[d], reps[d] + 1) for d in range(3)]
    shifts = np.array(np.meshgrid(*rng, indexing="ij"),
                      dtype=np.float64).reshape(3, -1).T  # [ns, 3]

    # All periodic images of every atom: [ns * n, 3]
    disp = shifts @ cell
    images = (pos[None, :, :] + disp[:, None, :]).reshape(-1, 3)

    tree_i = cKDTree(pos)
    tree_img = cKDTree(images)
    coo = tree_i.sparse_distance_matrix(
        tree_img, max_distance=cutoff, output_type="coo_matrix")
    ii = coo.row.astype(np.int64)
    flat = coo.col.astype(np.int64)
    d = coo.data
    s_idx = flat // n
    jj = flat % n

    # strictly inside the cutoff and not the trivial self pair
    keep = (d < cutoff) & (d > 1e-10)
    ii, jj, s_idx, d = ii[keep], jj[keep], s_idx[keep], d[keep]
    shift = shifts[s_idx]
    vec = pos[jj] + shift @ cell - pos[ii]
    ii, jj, shift, d, vec = _unwrap(ii, jj, shift, d, vec)

    order = np.lexsort((s_idx, jj, ii))
    return (ii[order].astype(np.int32), jj[order].astype(np.int32),
            shift[order], d[order], vec[order])


@dataclass(frozen=True)
class NeighborSize:
    """Padding bounds for one structure (reference `neighbor.py:34-47`).

    `nnl_tot` (max neighbors of any center, all elements together) and
    `ntl` (max symmetric j<k triples of any center) size the dense
    per-atom [n_vap, nnl] / [n_vap, ntl] layouts of the matmul/Pallas
    descriptor backends; the reference's per-element `nnl` sizes its
    scatter g-tensor.
    """
    nnl: int
    nij: int
    nijk: int
    ij2k: int
    nnl_tot: int = 0
    ntl: int = 0
    # Width bound for the triple TRANSPOSE tables (scatter-free force
    # assembly): max over atoms a of sum_{i in N_acut(a)} (deg(i) - 1)
    # — the number of triples in which a appears as a NON-center (j or
    # k side). Ordering-independent, so it bounds either side of any
    # j<k enumeration; the per-side actual is typically ~half.
    ttrans: int = 0

    def __getitem__(self, item: str):
        return getattr(self, item)

    def union(self, other: "NeighborSize") -> "NeighborSize":
        return NeighborSize(nnl=max(self.nnl, other.nnl),
                            nij=max(self.nij, other.nij),
                            nijk=max(self.nijk, other.nijk),
                            ij2k=max(self.ij2k, other.ij2k),
                            nnl_tot=max(self.nnl_tot, other.nnl_tot),
                            ntl=max(self.ntl, other.ntl),
                            ttrans=max(self.ttrans, other.ttrans))


def find_neighbor_size_of_atoms(structure: Structure, rc: float,
                                angular: bool = False,
                                acut: float = None) -> NeighborSize:
    """Compute (nij, nnl, nijk) padding bounds.

    * ``nij``  — number of directed pairs within ``rc``.
    * ``nnl``  — max neighbor count over (center atom, neighbor element).
    * ``nijk`` — sum_i n_i (n_i - 1) / 2 over symmetric j<k triples of
      pairs within ``acut`` (default ``rc``; only when ``angular``).
      Counting triples at ``rc`` when the angular cutoff is smaller
      would overshoot the dominant nijk-scale padding ~(rc/acut)^6.
    * ``ij2k`` — kept for schema parity with the reference; the flat
      triple layout used here never needs it, so it is always 0.
    """
    acut = rc if acut is None else float(acut)
    ilist_all, jlist_all, _, dist_all, _ = neighbor_list(
        structure, max(rc, acut) if angular else rc)
    within = dist_all < rc
    ilist, jlist = ilist_all[within], jlist_all[within]
    nij = len(ilist)
    numbers = structure.numbers
    nnl = 0
    nnl_tot = 0
    if nij:
        pair_class = cantor_pairing(ilist.astype(np.int64) * 1000 +
                                    numbers[ilist], numbers[jlist])
        nnl = int(max(Counter(pair_class).values()))
        nnl_tot = int(np.bincount(ilist, minlength=len(structure)).max())
    nijk = 0
    ntl = 0
    ttrans = 0
    if angular:
        ang = dist_all < acut
        i_ang = ilist_all[ang]
        if len(i_ang):
            counts = np.bincount(i_ang, minlength=len(structure))
            trip_counts = counts * (counts - 1) // 2
            nijk = int(np.sum(trip_counts))
            ntl = int(trip_counts.max())
            # triples containing atom a as a NON-center: one per
            # (center i in N(a), other neighbor of i)
            j_ang = jlist_all[ang]
            ttrans = int(np.bincount(
                j_ang, weights=(counts[i_ang] - 1).astype(np.float64),
                minlength=len(structure)).max())
    return NeighborSize(nnl=nnl, nij=nij, nijk=nijk, ij2k=0,
                        nnl_tot=nnl_tot, ntl=ntl, ttrans=ttrans)
