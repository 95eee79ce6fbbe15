"""Periodic neighbor list built on the device: cell binning and a static
stencil (port of `tensoralloy_tpu/transform/device_nl.py`).

The host featurizer (`transform/featurizer.py`) builds the index arrays
in numpy and C++ and copies them to the card; for MD and large single
frames that host work is most of a request. Here the list is built from
the positions on their own device, so binning, pair enumeration,
descriptors, energy and forces need no host round trip.

Algorithm (every shape fixed by the capacities):
  1. fractional coordinates, wrapped along periodic axes; the wrap
     offsets are folded back into the emitted images, so the RAW
     positions satisfy ``R_j + S @ cell - R_i`` (`neighbor.py`'s
     contract);
  2. atoms binned into a ``g0 x g1 x g2`` grid (cell width >= cutoff,
     or a deeper stencil when the box is thinner than the cutoff),
     atom ids sorted by cell id (one stable `argsort`), per-cell
     offsets by `searchsorted`;
  3. for all ``prod(2 s + 1)`` stencil offsets at once, up to
     ``cell_cap`` candidates per atom are gathered;
  4. the ``n_stencil * cell_cap`` candidate columns are compacted to
     the ``nnl_cap`` dense width by a prefix sum over each row: a valid
     column's rank among the valid columns before it is its output
     slot, so the output keeps the reference's column order (stencil
     block, then slot) without a sort of the [n, n_stencil * cell_cap]
     keys;
  5. the feature contract of `Featurizer.featurize` is emitted (dense
     and/or flat layout, dense triples for an angular featurizer) in
     VAP row order, key by key as the host featurizer emits it.

Capacities are fixed when the builder is made; `build` also returns a
diagnostics dict of the sizes that were needed, which `check` reads on
the host (one synchronisation) and `grow` turns into a larger builder.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..atoms import Structure
from ..elements import atomic_numbers
from ..vap import VirtualAtomMap
from .featurizer import SIMG_BASE, SIMG_OFF, SIMG_ZERO

__all__ = ["DeviceNeighborList", "diag_to_host"]


def _cell_heights(cell: np.ndarray) -> np.ndarray:
    vol = abs(np.linalg.det(cell))
    cross = np.cross(cell[[1, 2, 0]], cell[[2, 0, 1]])
    areas = np.linalg.norm(cross, axis=1)
    return vol / np.maximum(areas, 1e-300)


def _round_up(n: int, mult: int = 8) -> int:
    return max(mult, ((int(n) + mult - 1) // mult) * mult)


def diag_to_host(diag) -> Dict[str, int]:
    """A `build` diagnostics dict as host ints, read in one transfer."""
    keys = sorted(diag)
    if not keys or not isinstance(diag[keys[0]], torch.Tensor):
        return {k: int(diag[k]) for k in keys}
    values = torch.stack([diag[k].to(torch.int64) for k in keys]).tolist()
    return dict(zip(keys, values))


def _compact(valid: torch.Tensor, width: int):
    """valid [n, C] bool -> (key [n, width] int64, needed [n]): key holds
    the columns of each row's first `width` valid entries in column
    order and C after them; `needed` is each row's count of valid
    entries. A prefix sum ranks the valid entries; the others (and those
    past `width`) land in a dump column that is dropped."""
    n, c = valid.shape
    rank = torch.cumsum(valid, dim=1, dtype=torch.int32) - 1
    slot = torch.where(valid & (rank < width), rank,
                       torch.full_like(rank, width)).long()
    out = torch.full((n, width + 1), c, dtype=torch.int64,
                     device=valid.device)
    cols = torch.arange(c, device=valid.device).expand(n, c)
    out.scatter_(1, slot, cols)
    needed = (rank[:, -1] + 1) if c else rank.new_zeros(n)
    return out[:, :width], needed


class DeviceNeighborList:
    """Neighbor-list builder for a fixed (cell grid, stoichiometry), run
    on the positions' device.

    Parameters
    ----------
    featurizer : the model's `Featurizer` (elements, cutoffs, slot and
        term tables, whether triples are needed).
    vap : the `VirtualAtomMap` of the structures to be evaluated (the
        model's row layout).
    structure : a representative `Structure`: cell, pbc, symbols, and
        the positions that size the capacities.
    cutoff : pair cutoff (default `featurizer.max_cutoff`); pass
        ``rcut + skin`` for skinned MD lists (every model family masks
        ``r >= rcut`` itself, so the skin leaves the energy unchanged).
    nnl_cap / cell_cap / ntl_cap : capacities (sized from `structure`
        with `margin` when omitted).
    layout : 'dense', 'segment' or 'both'.
    angular : emit triples (default `featurizer.angular`).
    census : 'exact' sizes the capacities from one host neighbor list;
        'density' from the fullest bin's density and the cutoff sphere
        (numpy binning only; an angular builder keeps 'exact'); 'mean'
        from the same host list, each width the margin over an atom's
        mean count where that covers the most any atom has (else as
        'exact'), so a jittered or thermal crystal's width does not
        follow the tail of its displacements.
    """

    def __init__(self, featurizer, vap: VirtualAtomMap,
                 structure: Structure, *, cutoff: Optional[float] = None,
                 nnl_cap: Optional[int] = None,
                 cell_cap: Optional[int] = None,
                 ntl_cap: Optional[int] = None,
                 layout: str = "dense", angular: Optional[bool] = None,
                 margin: float = 1.3, census: str = "exact"):
        if layout not in ("dense", "segment", "both"):
            raise ValueError(f"unknown layout {layout!r}")
        self.fz = featurizer
        self.vap = vap
        self.layout = layout
        self.cutoff = float(cutoff if cutoff else featurizer.max_cutoff)
        self.angular = bool(featurizer.angular if angular is None
                            else angular)
        structure = structure.ensure_cell()
        self._template = structure.copy()
        cell = np.asarray(structure.cell, dtype=np.float64)
        self.cell0 = cell
        self.pbc = np.asarray(structure.pbc, dtype=bool).copy()
        n = len(structure)
        self.n = n

        heights = _cell_heights(cell)
        if not np.all(heights > 0):
            raise ValueError("singular cell after ensure_cell()")
        # cell width = height / g >= cutoff where possible; a box thinner
        # than the cutoff gets g = 1 and a deeper stencil
        g = np.maximum(np.floor(heights / self.cutoff).astype(int), 1)
        widths = heights / g
        s = np.maximum(np.ceil(self.cutoff / widths - 1e-9).astype(int), 1)
        # non-periodic axes never need image layers beyond the box
        s = np.where(self.pbc, s, 1)
        self.grid = tuple(int(x) for x in g)
        self.stencil_extent = tuple(int(x) for x in s)
        offs = np.stack(np.meshgrid(
            *[np.arange(-s[d], s[d] + 1) for d in range(3)],
            indexing="ij"), axis=-1).reshape(-1, 3).astype(np.int64)
        self.offsets = offs                       # [nsten, 3]
        self.n_stencil = len(offs)

        lut = np.full(128, -1, dtype=np.int64)
        for idx, e in enumerate(featurizer.elements):
            lut[atomic_numbers[e]] = idx
        elem_idx = lut[structure.numbers]
        if elem_idx.min(initial=0) < 0:
            raise ValueError("structure has elements outside the model")
        self.elem_idx_local = elem_idx
        self.local_to_vap = vap.local_to_vap.astype(np.int64)
        v2l = vap.vap_to_local.astype(np.int64)
        self.row_is_real = v2l >= 0
        self.vap_to_local = np.where(self.row_is_real, v2l, 0)
        self.n_vap = vap.n_atoms_vap

        if census not in ("exact", "density", "mean"):
            raise ValueError(f"unknown census mode {census!r}")
        self.census = census
        if cell_cap is None or nnl_cap is None or (
                self.angular and ntl_cap is None):
            if census == "density" and not self.angular and n:
                occ, nnl_need, ntl_need = self._density_census(
                    structure.positions)
            else:
                occ, nnl_need, ntl_need = self._host_census(
                    structure.positions,
                    margin=margin if census == "mean" else None)
            if cell_cap is None:
                cell_cap = _round_up(int(np.ceil(occ * margin)))
            if nnl_cap is None:
                nnl_cap = _round_up(int(np.ceil(nnl_need * margin)))
            if self.angular and ntl_cap is None:
                ntl_cap = _round_up(int(np.ceil(ntl_need * margin)))
        self.cell_cap = int(cell_cap)
        self.nnl_cap = int(nnl_cap)
        self.ntl_cap = int(ntl_cap) if self.angular else 0
        self._device_tables: Dict[torch.device, dict] = {}

    # ------------------------------------------------------------------
    def _bins(self, positions) -> Tuple[np.ndarray, np.ndarray]:
        """numpy mirror of the binning: -> (cell id of each atom, wrap)."""
        cell, g = self.cell0, np.asarray(self.grid)
        frac = positions @ np.linalg.inv(cell)
        wrap = np.where(self.pbc, np.floor(frac), 0.0)
        c = np.clip(((frac - wrap) * g).astype(int), 0, g - 1)
        return (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2], wrap

    def _density_census(self, positions) -> Tuple[int, int, int]:
        """Capacities without a host neighbor list: the exact cell
        occupancy from numpy binning, and the neighbors an atom has at
        the fullest bin's density inside the cutoff sphere (an
        underestimate is repaired by `grow`)."""
        cid, _ = self._bins(positions)
        g = np.asarray(self.grid)
        occ = int(np.bincount(cid, minlength=g.prod()).max())
        vol = float(abs(np.linalg.det(self.cell0)))
        local_density = occ / (vol / float(g.prod()))
        sphere = 4.0 / 3.0 * np.pi * self.cutoff ** 3
        nnl = int(np.ceil(sphere * local_density))
        return occ, max(nnl, 1), 0

    def _host_census(self, positions, margin: Optional[float] = None
                     ) -> Tuple[float, float, float]:
        """Exact (max cell occupancy, max neighbors, max triples of an
        atom) for the given positions, from the host neighbor list. With
        a `margin` ('mean' census), a width's need is an atom's mean
        count wherever `margin` times it covers the max."""
        if not self.n:
            return 0, 0, 0

        def need(counts):
            mean = float(np.mean(counts))
            most = int(np.max(counts))
            return mean if margin and margin * mean >= most else most
        cid, wrap = self._bins(positions)
        occ = int(np.bincount(cid, minlength=np.prod(self.grid)).max())
        from ..neighbor import neighbor_list
        s = Structure(np.full(self.n, 1), positions - wrap @ self.cell0,
                      self.cell0, self.pbc)
        ii, _, _, dd, _ = neighbor_list(s, self.cutoff)
        cnt = np.bincount(ii, minlength=self.n) if len(ii) else \
            np.zeros(self.n, int)
        ntl = 0
        if self.angular:
            ca = np.bincount(ii[dd < self.fz.acut], minlength=self.n) \
                if len(ii) else np.zeros(self.n, int)
            ntl = need(ca * (ca - 1) // 2)
        return occ, need(cnt), ntl

    # ------------------------------------------------------------------
    def check(self, diag) -> None:
        """Raise when a `build` overflowed a capacity (pairs were
        dropped) or an image code left the packed range. Reads the
        diagnostics on the host in one transfer."""
        diag = diag_to_host(diag)
        nnl, occ = diag["nnl_needed"], diag["cell_needed"]
        if occ > self.cell_cap or nnl > self.nnl_cap:
            raise RuntimeError(
                f"device neighbor list overflow: needed cell occupancy "
                f"{occ} (cap {self.cell_cap}), nnl {nnl} (cap "
                f"{self.nnl_cap}) — rebuild with grow()")
        if self.angular and diag["ntl_needed"] > self.ntl_cap:
            raise RuntimeError(
                f"device neighbor list overflow: needed ntl "
                f"{diag['ntl_needed']} (cap {self.ntl_cap})")
        if diag.get("simg_overflow", 0) > 0:
            raise RuntimeError(
                f"shift-image overflow: {diag['simg_overflow']} "
                f"pair components exceeded +-{SIMG_OFF} cells — "
                f"positions have drifted too far from the home cell "
                f"for the packed image code (the host featurizer "
                f"raises on the same condition); wrap coordinates or "
                f"rebuild from wrapped positions")

    def stencil_reach(self, cell) -> np.ndarray:
        """Distance [3] (A) the stencil spans per axis for another cell:
        the grid is fixed in fractional space, so a shrinking cell
        shrinks the bins with it."""
        heights = _cell_heights(np.asarray(cell, dtype=np.float64))
        return (np.asarray(self.stencil_extent, float) * heights /
                np.asarray(self.grid, float))

    def covers(self, cell, cutoff: Optional[float] = None) -> bool:
        """True while the stencil spans `cutoff` (default this builder's
        cutoff) for `cell`; False means re-grid (`rebuilt_for`)."""
        want = self.cutoff if cutoff is None else float(cutoff)
        reach = self.stencil_reach(cell)
        return bool(np.all(reach[self.pbc] >= want - 1e-9))

    def rebuilt_for(self, structure: Structure) -> "DeviceNeighborList":
        """A builder re-gridded for `structure`'s cell (same cutoff and
        layout; capacities sized again from its positions)."""
        return DeviceNeighborList(
            self.fz, self.vap, structure, cutoff=self.cutoff,
            layout=self.layout, angular=self.angular, census=self.census)

    def grow(self, diag, margin: float = 1.3) -> "DeviceNeighborList":
        """A builder whose capacities cover `diag` (same grid and
        layout). A truncated build under-reports what it needed, so the
        caller checks again and grows until `check` passes."""
        diag = diag_to_host(diag)

        def up(needed, cur):
            return max(_round_up(int(np.ceil(int(needed) * margin))),
                       _round_up(cur + 1))
        return DeviceNeighborList(
            self.fz, self.vap, self._template,
            cutoff=self.cutoff, layout=self.layout, angular=self.angular,
            census=self.census,
            nnl_cap=up(diag["nnl_needed"], self.nnl_cap),
            cell_cap=up(diag["cell_needed"], self.cell_cap),
            ntl_cap=up(diag.get("ntl_needed", 0), self.ntl_cap)
            if self.angular else None)

    # ------------------------------------------------------------------
    def _tables(self, device, dtype) -> dict:
        """The builder's static tables on `device` (float ones in `dtype`),
        made once: a build copies nothing from the host."""
        t = self._device_tables.get((device, dtype))
        if t is None:
            def put(x):
                return torch.as_tensor(np.asarray(x), device=device)
            t = {"grid": put(np.asarray(self.grid, np.int64)),
                 "pbc": put(self.pbc), "offsets": put(self.offsets),
                 "l2v": put(self.local_to_vap),
                 "v2l": put(self.vap_to_local),
                 "real": put(self.row_is_real),
                 "elem": put(self.elem_idx_local),
                 "rslot": put(self.fz._rslot.astype(np.int64)),
                 "rterm": put(self.fz._rterm.astype(np.int64)),
                 "slot": torch.arange(self.cell_cap, device=device),
                 "atom_masks": torch.as_tensor(self.vap.atom_masks,
                                               dtype=dtype, device=device),
                 "cell0": torch.as_tensor(self.cell0, dtype=dtype,
                                          device=device),
                 "n_atoms": torch.tensor(self.n, dtype=torch.int32,
                                         device=device)}
            if self.angular:
                p, q = np.triu_indices(self.nnl_cap, k=1)
                t["tri_p"], t["tri_q"] = put(p), put(q)
                t["aslot"] = put(self.fz._aslot.astype(np.int64))
            self._device_tables[(device, dtype)] = t
        return t

    @torch.no_grad()
    def build(self, positions_vap: torch.Tensor, cell=None,
              etemperature=0.0
              ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """positions_vap [n_vap, 3] (RAW, VAP layout) -> (features, diag)
        on the positions' device, with no host synchronisation.

        diag holds ``nnl_needed`` / ``cell_needed`` / ``simg_overflow``
        (and ``ntl_needed``) as device scalars: `check` compares them
        with the capacities; an excess means pairs were dropped and the
        caller must build again with `grow(diag)`."""
        fdt, device = positions_vap.dtype, positions_vap.device
        t = self._tables(device, fdt)
        cell = t["cell0"] if cell is None else torch.as_tensor(
            cell, dtype=fdt, device=device)
        n, K, NNL = self.n, self.cell_cap, self.nnl_cap
        gx, gy, gz = self.grid
        g, pbc = t["grid"], t["pbc"]
        pos = positions_vap[t["l2v"]]                  # [n, 3] local order

        # inv_ex: no singularity check, which would read back to the host
        frac = pos @ torch.linalg.inv_ex(cell).inverse
        wrap = torch.where(pbc[None, :], torch.floor(frac),
                           torch.zeros_like(frac))
        posw = pos - wrap @ cell                       # home cell
        c = torch.minimum(torch.clamp((frac - wrap) * g, min=0.0)
                          .to(torch.int64), g - 1)     # [n, 3]
        cid = (c[:, 0] * gy + c[:, 1]) * gz + c[:, 2]
        perm = torch.argsort(cid, stable=True)
        starts = torch.searchsorted(
            cid[perm], torch.arange(gx * gy * gz + 1, device=device))
        counts = torch.diff(starts)                    # [ncells]

        # every stencil offset at once: [n, S, 3] cells, [n, S, K] slots
        nc = c[:, None, :] + t["offsets"][None]
        quot = torch.div(nc, g, rounding_mode="floor")
        rem = nc - quot * g
        in_range = torch.where(pbc, torch.ones_like(nc, dtype=torch.bool),
                               (nc >= 0) & (nc < g)).all(dim=-1)
        s_sten = torch.where(pbc, quot, torch.zeros_like(quot))
        ncid = (rem[..., 0] * gy + rem[..., 1]) * gz + rem[..., 2]
        slot = t["slot"]
        idx = starts[ncid][..., None] + slot            # [n, S, K]
        have = slot < counts[ncid][..., None]
        j = perm[torch.clamp(idx, 0, max(n - 1, 0))]
        sf = s_sten.to(fdt)
        d2 = torch.zeros(j.shape, dtype=fdt, device=device)
        for a in range(3):
            sc_a = (sf[..., 0] * cell[0, a] + sf[..., 1] * cell[1, a]
                    + sf[..., 2] * cell[2, a])         # [n, S]
            v_a = posw[:, a][j] + sc_a[..., None] - posw[:, a][:, None, None]
            d2 = d2 + v_a * v_a
        rc2 = self.cutoff * self.cutoff
        valid = have & in_range[..., None] & (d2 < rc2) & (d2 > 1e-20)
        j_all = j.reshape(n, -1)                       # block, then slot
        C = j_all.shape[1]

        key_o, needed = _compact(valid.reshape(n, C), NNL)
        zero = torch.zeros((), dtype=torch.int32, device=device)
        diag = {"nnl_needed": needed.max().to(torch.int32) if n else zero,
                "cell_needed": counts.max().to(torch.int32)}
        m_o = key_o < C
        j_o = torch.gather(j_all, 1, torch.clamp(key_o, 0, C - 1))
        blk = torch.clamp(key_o // K, 0, self.n_stencil - 1)
        # fold the wraps back so RAW positions satisfy R_j + S@cell - R_i,
        # packed into one code per slot; an image past the packed range
        # is counted (check() raises) and clamped
        wrap_i = wrap.to(torch.int64)
        o_tab = t["offsets"]
        simg_o = torch.zeros(j_o.shape, dtype=torch.int64, device=device)
        simg_over = torch.zeros((), dtype=torch.int64, device=device)
        mult = (1, SIMG_BASE, SIMG_BASE * SIMG_BASE)
        for a in range(3):
            if self.pbc[a]:
                s_a = torch.div(c[:, a][:, None] + o_tab[:, a][blk],
                                self.grid[a], rounding_mode="floor")
            else:
                s_a = torch.zeros_like(j_o)
            s_a = s_a + wrap_i[:, a][:, None] - wrap_i[:, a][j_o]
            simg_over = simg_over + ((s_a.abs() > SIMG_OFF) & m_o).sum()
            s_a = torch.clamp(s_a, -SIMG_OFF, SIMG_OFF)
            simg_o = simg_o + mult[a] * (torch.where(m_o, s_a, 0)
                                         + SIMG_OFF)
        diag["simg_overflow"] = simg_over.to(torch.int32)
        j_o = torch.where(m_o, j_o, 0)

        elem, l2v = t["elem"], t["l2v"]
        ci = elem[:, None]
        cj = elem[j_o]
        islot_o = torch.where(m_o, t["rslot"][ci, cj], 0)
        term_o = torch.where(m_o, t["rterm"][ci, cj], 0)
        jv_o = torch.where(m_o, l2v[j_o], 0)           # VAP index of j

        v2l, real = t["v2l"], t["real"]

        def to_vap(x, fill=0):
            if not n:
                return torch.full((self.n_vap,) + tuple(x.shape[1:]), fill,
                                  dtype=x.dtype, device=device)
            m = real.reshape((-1,) + (1,) * (x.dim() - 1))
            return torch.where(m, x[v2l], torch.as_tensor(
                fill, dtype=x.dtype, device=device))

        i32 = torch.int32
        if not isinstance(etemperature, torch.Tensor):
            etemperature = torch.full((), float(etemperature), dtype=fdt,
                                      device=device)
        feats: Dict[str, torch.Tensor] = {
            "positions": positions_vap,
            "cell": cell,
            "atom_masks": t["atom_masks"],
            "n_atoms": t["n_atoms"],
            "etemperature": etemperature.to(fdt),
        }
        pjd = to_vap(jv_o).to(i32)
        psd = to_vap(simg_o, fill=SIMG_ZERO).to(i32)
        pmd = to_vap(m_o.to(fdt))
        if self.layout in ("dense", "both"):
            feats["pair_j_d"] = pjd
            feats["pair_simg_d"] = psd
            feats["pair_mask_d"] = pmd
            feats["pair_islot_d"] = to_vap(islot_o.to(fdt))
        if self.layout in ("segment", "both"):
            from ..ops.dense import decode_simg
            real_pair = pmd.reshape(-1) > 0
            rows = torch.arange(self.n_vap, device=device, dtype=i32)[
                :, None].expand(self.n_vap, NNL).reshape(-1)
            feats["pair_i"] = torch.where(real_pair, rows, 0)
            feats["pair_j"] = torch.where(real_pair, pjd.reshape(-1), 0)
            # the flat layout keeps its [nij, 3] float images
            feats["pair_shift"] = torch.stack(
                decode_simg(psd.reshape(-1), fdt), dim=-1)
            feats["pair_islot"] = torch.where(
                real_pair, to_vap(islot_o).reshape(-1), 0).to(i32)
            feats["pair_term"] = torch.where(
                real_pair, to_vap(term_o).reshape(-1), 0).to(i32)
            feats["pair_mask"] = pmd.reshape(-1)

        if self.angular:
            self._triples(feats, diag, t, posw, cell, j_o, m_o, simg_o,
                          wrap, to_vap, fdt)
        return feats, diag

    # ------------------------------------------------------------------
    def _triples(self, feats, diag, t, posw, cell, j_o, m_o, simg_o, wrap,
                 to_vap, fdt):
        """Dense j < k triples from the compacted pair rows (acut mask)."""
        from ..ops.dense import decode_simg
        n, NTL = self.n, self.ntl_cap
        device = posw.device
        # distances of the compacted pairs in the wrapped frame (the wrap
        # folds cancel between centre and neighbour)
        sw = [s - wrap[:, a][:, None] + wrap[:, a][j_o]
              for a, s in enumerate(decode_simg(simg_o, fdt))]
        d2 = torch.zeros(j_o.shape, dtype=fdt, device=device)
        for a in range(3):
            sv_a = (sw[0] * cell[0, a] + sw[1] * cell[1, a]
                    + sw[2] * cell[2, a])
            v_a = posw[:, a][j_o] + sv_a - posw[:, a][:, None]
            d2 = d2 + v_a * v_a
        amask = m_o & (d2 < self.fz.acut * self.fz.acut)   # [n, NNL]

        p, q = t["tri_p"], t["tri_q"]
        T2 = p.shape[0]
        key_s, needed = _compact(amask[:, p] & amask[:, q], NTL)
        diag["ntl_needed"] = (needed.max().to(torch.int32) if n else
                              torch.zeros((), dtype=torch.int32,
                                          device=device))
        tm = key_s < T2
        pq = torch.clamp(key_s, 0, max(T2 - 1, 0))
        pp, qq = p[pq], q[pq]                            # [n, NTL]
        tj = torch.gather(j_o, 1, pp)
        tk = torch.gather(j_o, 1, qq)
        tsj = torch.gather(simg_o, 1, pp)
        tsk = torch.gather(simg_o, 1, qq)
        elem, l2v = t["elem"], t["l2v"]
        tslot = t["aslot"][elem[:, None].expand_as(tj), elem[tj], elem[tk]]
        i32 = torch.int32

        def z(x):
            return torch.where(tm, x, 0)

        tjd = to_vap(z(l2v[tj])).to(i32)
        tkd = to_vap(z(l2v[tk])).to(i32)
        tsjd = to_vap(torch.where(tm, tsj, SIMG_ZERO),
                      fill=SIMG_ZERO).to(i32)
        tskd = to_vap(torch.where(tm, tsk, SIMG_ZERO),
                      fill=SIMG_ZERO).to(i32)
        tmd = to_vap(tm.to(fdt))
        tad = to_vap(z(tslot))
        if self.layout in ("dense", "both"):
            feats["trip_j_d"] = tjd
            feats["trip_k_d"] = tkd
            feats["trip_simg_j_d"] = tsjd
            feats["trip_simg_k_d"] = tskd
            feats["trip_mask_d"] = tmd
            feats["trip_aslot_d"] = tad.to(fdt)
        if self.layout in ("segment", "both"):
            real = tmd.reshape(-1) > 0
            rows = torch.arange(self.n_vap, device=device, dtype=i32)[
                :, None].expand(self.n_vap, NTL)

            def w(x):
                return torch.where(real, x.reshape(-1), 0).to(i32)

            feats["trip_i"] = w(rows)
            feats["trip_j"] = w(tjd)
            feats["trip_k"] = w(tkd)
            feats["trip_shift_j"] = torch.stack(
                decode_simg(tsjd.reshape(-1), fdt), dim=-1)
            feats["trip_shift_k"] = torch.stack(
                decode_simg(tskd.reshape(-1), fdt), dim=-1)
            feats["trip_aslot"] = w(tad)
            feats["trip_mask"] = tmd.reshape(-1)
