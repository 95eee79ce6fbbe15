"""Featurization: structures -> fixed-shape arrays, on the host (port of
`tensoralloy_tpu/transform/featurizer.py`).

numpy, with the triples enumerated by the native C++ list where it can
be built (`native/`; the Python loop otherwise, in the same order). It
emits the same keys with the same values as the JAX featurizer, so both
packages read one feature contract. Two layouts: the dense per-atom
rows ('dense': the 'dense' and 'pallas' descriptor backends and the
EAM family's fast EFS), and the flat pair and triple arrays ('segment':
the EAM family and the 'segment' descriptor backends); 'both' emits the
two.

Shape contract (`Features` dict; A = n_vap rows, N = nnl, Nt = ntl):
  positions     [A, 3]    VAP layout, row 0 = virtual atom
  cell          [3, 3]
  atom_masks    [A]       1.0 for real atoms
  n_atoms       []        number of real atoms (int32)
  etemperature  []        electron temperature (eV)
  (layout 'segment' or 'both'; nij = padded pair count)
  pair_i / pair_j [nij]   int32 VAP rows (0 for padding)
  pair_shift    [nij, 3]  integer cell shifts (float dtype)
  pair_islot    [nij]     int32 radial slot within the center's terms
  pair_term     [nij]     int32 global radial k-body term id
  pair_mask     [nij]     1.0 for real pairs
  (angular, layout 'segment' or 'both'; nijk = padded triple count)
  trip_i / trip_j / trip_k       [nijk]     int32 VAP rows
  trip_shift_j / trip_shift_k    [nijk, 3]  integer cell shifts
  trip_aslot    [nijk]    int32 angular slot within the center's terms
  trip_mask     [nijk]    1.0 for real triples
  (layout 'dense' or 'both')
  pair_j_d      [A, N]    int32 VAP row of each neighbor
  pair_simg_d   [A, N]    int32 packed periodic image (`encode_simg_np`)
  pair_mask_d   [A, N]    1.0 for real pairs
  pair_islot_d  [A, N]    radial slot, carried as float
  (angular only)
  trip_j_d / trip_k_d            [A, Nt] int32
  trip_simg_j_d / trip_simg_k_d  [A, Nt] int32
  trip_mask_d / trip_aslot_d     [A, Nt]
  (transpose=True)
  pair_trans_d / pair_trans_mask_d                 [A, N]
  trip_trans_{j,k}_d / trip_trans_{j,k}_mask_d     [A, Ttrans]
"""
from __future__ import annotations

import os
from collections import Counter
from typing import Dict, List, Optional

import numpy as np

from ..atoms import Structure
from ..elements import atomic_numbers
from ..neighbor import NeighborSize, find_neighbor_size_of_atoms, neighbor_list
from ..utils import get_kbody_terms
from ..vap import VirtualAtomMap

Features = Dict[str, np.ndarray]

# Periodic-image triples are packed into one int32 per pair slot, so
# every dense feature is a 2-D [A, N] array. `ops.dense.decode_simg`
# reverses the packing on the device.
SIMG_BASE = 31
SIMG_OFF = 15          # components must lie in [-15, 15]
SIMG_ZERO = SIMG_OFF * (1 + SIMG_BASE + SIMG_BASE * SIMG_BASE)


def encode_simg_np(shift) -> np.ndarray:
    """numpy [*, 3] integer image counts -> packed int32 [*]."""
    s = np.asarray(np.rint(shift), np.int64)
    if s.size and (np.abs(s) > SIMG_OFF).any():
        raise ValueError(
            f"periodic image count exceeds +-{SIMG_OFF}: "
            f"{np.abs(s).max()} (cell too small for this cutoff)")
    return ((s[..., 0] + SIMG_OFF)
            + SIMG_BASE * (s[..., 1] + SIMG_OFF)
            + SIMG_BASE * SIMG_BASE * (s[..., 2] + SIMG_OFF)
            ).astype(np.int32)


class Featurizer:
    """Stateless structure -> dense arrays transformer.

    Parameters
    ----------
    elements : supported chemical symbols (defines term tables & layout).
    rcut : radial cutoff (Angstrom).
    acut : angular cutoff; defaults to ``rcut`` when ``angular``.
    angular : build 3-body triples.
    symmetric : merge jk/kj angular classes (reference default True).
    """

    def __init__(self, elements: List[str], rcut: float,
                 acut: Optional[float] = None, angular: bool = False,
                 symmetric: bool = True, periodic: bool = True):
        all_terms, terms_per_elem, elements = get_kbody_terms(
            elements, angular=angular, symmetric=symmetric)
        self.elements = elements
        self.n_elements = len(elements)
        self.rcut = float(rcut)
        self.acut = float(acut if acut else rcut) if angular else 0.0
        self.angular = bool(angular)
        self.symmetric = bool(symmetric)
        self.periodic = bool(periodic)
        self.all_kbody_terms = all_terms
        self.kbody_terms_for_element = terms_per_elem

        n = self.n_elements
        self.n_radial_slots = n
        self.n_angular_slots = (n * (n + 1) // 2) if symmetric else n * n

        # (center_idx, neighbor_idx) -> slot within center's radial terms
        # and -> global term id
        self._rslot = np.zeros((n, n), dtype=np.int32)
        self._rterm = np.zeros((n, n), dtype=np.int32)
        for ci, ce in enumerate(elements):
            for ni, ne in enumerate(elements):
                self._rslot[ci, ni] = terms_per_elem[ce].index(ce + ne)
                self._rterm[ci, ni] = all_terms.index(ce + ne)
        if angular:
            self._aslot = np.zeros((n, n, n), dtype=np.int32)
            for ci, ce in enumerate(elements):
                for ji, je in enumerate(elements):
                    for ki, ke in enumerate(elements):
                        if symmetric:
                            suffix = "".join(sorted([je, ke]))
                        else:
                            suffix = je + ke
                        # slot among angular terms only
                        self._aslot[ci, ji, ki] = (
                            terms_per_elem[ce].index(ce + suffix) - n)

    # ------------------------------------------------------------------
    @property
    def max_cutoff(self) -> float:
        return max(self.rcut, self.acut)

    def neighbor_size(self, structure: Structure) -> NeighborSize:
        return find_neighbor_size_of_atoms(
            structure, self.rcut, angular=self.angular,
            acut=self.acut if self.angular else None)

    def make_vap(self, structure: Structure,
                 max_occurs: Optional[Counter] = None) -> VirtualAtomMap:
        if max_occurs is None:
            max_occurs = Counter(structure.symbols)
        return VirtualAtomMap(max_occurs, structure.symbols)

    # ------------------------------------------------------------------
    def featurize(self, structure: Structure,
                  vap: Optional[VirtualAtomMap] = None,
                  dtype=np.float64,
                  nnl_max: Optional[int] = None,
                  ntl_max: Optional[int] = None,
                  nnl_bucket=None, ntl_bucket=None,
                  layout: str = "dense",
                  transpose: bool = False,
                  ttrans_max: Optional[int] = None,
                  nij_max: Optional[int] = None,
                  pair_bucket=None,
                  nijk_max: Optional[int] = None,
                  trip_bucket=None) -> Features:
        """Build the feature arrays for one structure.

        `layout` is 'dense' (the per-atom rows), 'segment' (the flat
        pair and triple arrays) or 'both'. `nij_max` / `nijk_max` fix
        the padded lengths of the flat pair / triple arrays; by default
        they are this structure's counts, rounded up by `pair_bucket` /
        `trip_bucket` when given.
        `nnl_max`/`ntl_max` fix the widths of the per-atom neighbor and
        triple rows; by default they are this structure's own maxima,
        rounded up by `nnl_bucket`/`ntl_bucket` (or `pair_bucket` /
        `trip_bucket`) when given (bounded shape variety for serving).
        `transpose=True` adds the transpose tables that
        `ops.dense.make_dense_efs_fn` assembles forces with;
        `ttrans_max` fixes the width of the triple tables (pass the
        dataset's `NeighborSize.ttrans` so that structures stack)."""
        if layout not in ("both", "segment", "dense"):
            raise ValueError(f"unknown layout {layout!r}")
        structure = structure.ensure_cell()
        if vap is None:
            vap = self.make_vap(structure)
        ilist, jlist, shift, dists, _ = neighbor_list(
            structure, self.max_cutoff)
        if self.angular and self.acut > self.rcut:
            all_pairs = (ilist, jlist, shift, dists)
            within_r = dists < self.rcut
            ilist, jlist, shift, dists = (ilist[within_r], jlist[within_r],
                                          shift[within_r], dists[within_r])
        else:
            all_pairs = None

        # vectorized symbol -> element-index map
        lut = np.full(128, -1, dtype=np.int32)
        for idx, e in enumerate(self.elements):
            lut[atomic_numbers[e]] = idx
        elem_idx_local = lut[structure.numbers]
        if elem_idx_local.min(initial=0) < 0:
            bad = sorted(set(np.asarray(structure.symbols)[
                elem_idx_local < 0].tolist()))
            raise ValueError(f"unsupported element(s): {bad}")

        feats: Features = {}
        feats["positions"] = vap.map_positions(
            structure.positions).astype(dtype)
        feats["cell"] = structure.cell.astype(dtype)
        feats["atom_masks"] = vap.atom_masks.astype(dtype)
        feats["n_atoms"] = np.int32(len(structure))
        feats["etemperature"] = np.asarray(
            structure.info.get("etemperature", 0.0), dtype=dtype)

        ci = elem_idx_local[ilist]
        cj = elem_idx_local[jlist]
        if layout in ("both", "segment"):
            nij = len(ilist)
            if nij_max is None:
                nij_max = pair_bucket(nij) if pair_bucket else nij
            pad = nij_max - nij
            if pad < 0:
                raise ValueError(f"nij={nij} exceeds nij_max={nij_max}")
            feats["pair_i"] = _pad(vap.local_to_vap[ilist], nij_max, 0)
            feats["pair_j"] = _pad(vap.local_to_vap[jlist], nij_max, 0)
            feats["pair_shift"] = np.concatenate(
                [shift, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["pair_islot"] = _pad(self._rslot[ci, cj], nij_max, 0)
            feats["pair_term"] = _pad(self._rterm[ci, cj], nij_max, 0)
            feats["pair_mask"] = np.concatenate(
                [np.ones(nij), np.zeros(pad)]).astype(dtype)
        if layout in ("both", "dense"):
            self._dense_pairs(feats, structure, vap, ilist, jlist, shift,
                              ci, cj, dtype, nnl_max, nnl_bucket,
                              pair_bucket, transpose)
        if self.angular:
            a_i, a_j, a_s, a_d = all_pairs if all_pairs is not None else (
                ilist, jlist, shift, dists)
            self._build_triples(feats, structure, vap, a_i, a_j, a_s,
                                a_d, elem_idx_local, dtype, ntl_max,
                                ntl_bucket, transpose, ttrans_max, layout,
                                nijk_max, trip_bucket)
        return feats

    def _dense_pairs(self, feats, structure, vap, ilist, jlist, shift, ci,
                     cj, dtype, nnl_max, nnl_bucket, pair_bucket,
                     transpose):
        # Row = VAP index of the center, column = neighbor counter.
        cols, nnl = _columns_of(ilist, len(structure))
        if nnl_max is not None:
            if nnl > nnl_max:
                raise ValueError(f"nnl={nnl} exceeds nnl_max={nnl_max}")
            nnl = int(nnl_max)
        elif nnl_bucket is not None or pair_bucket is not None:
            nnl = int((nnl_bucket or pair_bucket)(nnl))
        nnl = max(nnl, 1)
        n_vap = vap.n_atoms_vap
        rows = vap.local_to_vap[ilist]
        pjd = np.zeros((n_vap, nnl), np.int32)
        # padding slots carry the zero-image code so decoded garbage
        # geometry stays small and finite
        psd = np.full((n_vap, nnl), SIMG_ZERO, np.int32)
        pmd = np.zeros((n_vap, nnl), dtype)
        pisd = np.zeros((n_vap, nnl), dtype)
        pjd[rows, cols] = vap.local_to_vap[jlist]
        psd[rows, cols] = encode_simg_np(shift)
        pmd[rows, cols] = 1.0
        pisd[rows, cols] = self._rslot[ci, cj]
        feats["pair_j_d"] = pjd
        feats["pair_simg_d"] = psd
        feats["pair_mask_d"] = pmd
        feats["pair_islot_d"] = pisd
        if transpose:
            # For each atom a, the FLAT slot indices (into [n_vap * nnl])
            # of every pair whose NEIGHBOR is a. Full directed lists make
            # in-degree == out-degree, so the nnl width always fits.
            tcols, _ = _columns_of(jlist, len(structure))
            ptd = np.zeros((n_vap, nnl), np.int32)
            ptm = np.zeros((n_vap, nnl), dtype)
            jrows = vap.local_to_vap[jlist]
            ptd[jrows, tcols] = rows * nnl + cols
            ptm[jrows, tcols] = 1.0
            feats["pair_trans_d"] = ptd
            feats["pair_trans_mask_d"] = ptm

    def _build_triples(self, feats, structure, vap, ilist, jlist, shift,
                       dists, elem_idx_local, dtype, ntl_max=None,
                       ntl_bucket=None, transpose=False, ttrans_max=None,
                       layout="dense", nijk_max=None, trip_bucket=None):
        within = dists < self.acut
        ii, jj, ss = ilist[within], jlist[within], shift[within]
        # group pairs by center atom; emit j<k combinations
        order = np.argsort(ii, kind="stable")
        ii, jj, ss = ii[order], jj[order], ss[order]

        pq = None
        if not os.environ.get("TENSORALLOY_TPU_NO_NATIVE"):
            from ..native import native_triple_list
            pq = native_triple_list(ii, len(structure))
        if pq is not None:
            p, q = pq
            t_i = ii[p].astype(np.int64)
            t_j, t_k = jj[p], jj[q]
            t_sj, t_sk = ss[p], ss[q]
        else:
            counts = np.bincount(ii, minlength=len(structure))
            offsets = np.concatenate([[0], np.cumsum(counts)])
            t_i, t_j, t_k, t_sj, t_sk = [], [], [], [], []
            for a in range(len(structure)):
                lo, hi = offsets[a], offsets[a + 1]
                m = hi - lo
                if m < 2:
                    continue
                p, q = np.triu_indices(m, k=1)
                t_i.append(np.full(len(p), a, dtype=np.int64))
                t_j.append(jj[lo + p])
                t_k.append(jj[lo + q])
                t_sj.append(ss[lo + p])
                t_sk.append(ss[lo + q])
            if t_i:
                t_i = np.concatenate(t_i)
                t_j = np.concatenate(t_j)
                t_k = np.concatenate(t_k)
                t_sj = np.concatenate(t_sj)
                t_sk = np.concatenate(t_sk)
            else:
                t_i = np.zeros(0, np.int64)
                t_j = np.zeros(0, np.int64)
                t_k = np.zeros(0, np.int64)
                t_sj = np.zeros((0, 3))
                t_sk = np.zeros((0, 3))
        ci = elem_idx_local[t_i]
        cj = elem_idx_local[t_j]
        ck = elem_idx_local[t_k]
        if layout in ("both", "segment"):
            nijk = len(t_i)
            if nijk_max is None:
                nijk_max = trip_bucket(nijk) if trip_bucket else nijk
            pad = nijk_max - nijk
            if pad < 0:
                raise ValueError(f"nijk={nijk} exceeds nijk_max={nijk_max}")
            feats["trip_i"] = _pad(vap.local_to_vap[t_i], nijk_max, 0)
            feats["trip_j"] = _pad(vap.local_to_vap[t_j], nijk_max, 0)
            feats["trip_k"] = _pad(vap.local_to_vap[t_k], nijk_max, 0)
            feats["trip_shift_j"] = np.concatenate(
                [t_sj, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["trip_shift_k"] = np.concatenate(
                [t_sk, np.zeros((pad, 3))], axis=0).astype(dtype)
            feats["trip_aslot"] = _pad(self._aslot[ci, cj, ck], nijk_max, 0)
            feats["trip_mask"] = np.concatenate(
                [np.ones(nijk), np.zeros(pad)]).astype(dtype)
            if layout == "segment":
                return
        tcols, ntl = _columns_of(t_i, len(structure))
        if ntl_max is not None:
            if ntl > ntl_max:
                raise ValueError(f"ntl={ntl} exceeds ntl_max={ntl_max}")
            ntl = int(ntl_max)
        elif ntl_bucket is not None or trip_bucket is not None:
            ntl = int((ntl_bucket or trip_bucket)(ntl))
        ntl = max(ntl, 1)
        n_vap = vap.n_atoms_vap
        rows = vap.local_to_vap[t_i]
        tjd = np.zeros((n_vap, ntl), np.int32)
        tkd = np.zeros((n_vap, ntl), np.int32)
        tsjd = np.full((n_vap, ntl), SIMG_ZERO, np.int32)
        tskd = np.full((n_vap, ntl), SIMG_ZERO, np.int32)
        tmd = np.zeros((n_vap, ntl), dtype)
        tasd = np.zeros((n_vap, ntl), dtype)
        tjd[rows, tcols] = vap.local_to_vap[t_j]
        tkd[rows, tcols] = vap.local_to_vap[t_k]
        tsjd[rows, tcols] = encode_simg_np(t_sj)
        tskd[rows, tcols] = encode_simg_np(t_sk)
        tmd[rows, tcols] = 1.0
        tasd[rows, tcols] = self._aslot[ci, cj, ck]
        feats["trip_j_d"] = tjd
        feats["trip_k_d"] = tkd
        feats["trip_simg_j_d"] = tsjd
        feats["trip_simg_k_d"] = tskd
        feats["trip_mask_d"] = tmd
        feats["trip_aslot_d"] = tasd
        if not transpose:
            return
        # triple transpose tables: for each atom a, the flat slot
        # indices of every triple where a is the j (resp. k) neighbor
        flat = (rows * ntl + tcols).astype(np.int64)
        for side, t_side in (("j", t_j), ("k", t_k)):
            scols, sw = _columns_of(np.asarray(t_side, np.int64),
                                    len(structure))
            sw = max(int(sw), 1)
            if ttrans_max is not None:
                if sw > ttrans_max:
                    raise ValueError(
                        f"triple {side}-side in-degree {sw} exceeds "
                        f"ttrans_max={ttrans_max}")
                sw = max(int(ttrans_max), 1)
            elif ntl_bucket is not None or trip_bucket is not None:
                sw = int((ntl_bucket or trip_bucket)(sw))
            std = np.zeros((n_vap, sw), np.int32)
            stm = np.zeros((n_vap, sw), dtype)
            srows = vap.local_to_vap[np.asarray(t_side, np.int64)]
            std[srows, scols] = flat
            stm[srows, scols] = 1.0
            feats[f"trip_trans_{side}_d"] = std
            feats[f"trip_trans_{side}_mask_d"] = stm

    # ------------------------------------------------------------------
    def as_dict(self) -> dict:
        return {"class": "Featurizer", "elements": self.elements,
                "rcut": self.rcut, "acut": self.acut,
                "angular": self.angular, "symmetric": self.symmetric,
                "periodic": self.periodic}

    @classmethod
    def from_dict(cls, d: dict) -> "Featurizer":
        return cls(elements=d["elements"], rcut=d["rcut"],
                   acut=d.get("acut") or None, angular=d.get("angular", False),
                   symmetric=d.get("symmetric", True),
                   periodic=d.get("periodic", True))


def _columns_of(centers: np.ndarray, n_atoms: int):
    """Per-entry column index within its center's dense row.

    -> (cols [len(centers)] int64, width = max entries of any center).
    """
    centers = np.asarray(centers, dtype=np.int64)
    if len(centers) == 0:
        return np.zeros(0, np.int64), 0
    counts = np.bincount(centers, minlength=n_atoms)
    order = np.argsort(centers, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)])[:-1]
    cols = np.zeros(len(centers), dtype=np.int64)
    cols[order] = np.arange(len(centers)) - start[centers[order]]
    return cols, int(counts.max())


def _pad(arr: np.ndarray, size: int, fill) -> np.ndarray:
    arr = np.asarray(arr, dtype=np.int32)
    out = np.full(size, fill, dtype=np.int32)
    out[:len(arr)] = arr
    return out


def batch_features(feature_list: List[Features]) -> Features:
    """Stack per-structure feature dicts along a leading batch axis."""
    keys = feature_list[0].keys()
    return {k: np.stack([f[k] for f in feature_list], axis=0) for k in keys}
