"""Behler-Parrinello symmetry-function descriptors on the dense per-atom
layout (port of `tensoralloy_tpu/nn/sf.py`).

G2 (radial), for center i, k-body slot s (neighbor element class), and
parameter tau = (eta, omega):

    G2[i, s, tau] = sum_{j in s} exp(-eta (r_ij - omega)^2 / rc^2) fc(r_ij)

G4 (angular), slot s = unordered neighbor-element pair, tau = (beta,
gamma, zeta):

    G4[i, s, tau] = sum_{j<k in s} 2^(1-zeta) (1 + gamma cos t_ijk)^zeta
                    exp(-beta (r_ij^2 + r_ik^2 + r_jk^2)/rc^2)
                    fc(r_ij) fc(r_ik) fc(r_jk)

Backends: 'segment' (the default, as in the JAX package) reads the flat
pair and triple arrays: every pair / triple contributes one row to
an `index_add` keyed by ``atom_row * n_slots + slot``; 'dense' runs
the plain PyTorch twins of `ops/fused.py` on the per-atom rows;
'pallas' (the JAX package's name for its fused kernels) runs the CUDA
kernels through their autograd Functions on the same rows.
Parameter-grid ordering is sklearn's `ParameterGrid` (sorted keys, last
key fastest).
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..ops.cutoffs import apply_cutoff
from ..ops.dense import (as_rows, dense_pair_geometry,
                         dense_triple_geometry)
from ..ops.fused import (G2Function, G4Function, _g4_values, g2_reference,
                         g4_reference)
from ..ops.pairs import pair_distances, reduce_rows, triple_distances

BACKENDS = ("segment", "dense", "pallas")


def segment_rows(values: torch.Tensor, center: torch.Tensor,
                 slot: torch.Tensor, n_vap: int, n_slots: int
                 ) -> torch.Tensor:
    """Sum the flat per-entry `values` [.., n, ...] by (center row, slot)
    -> [.., n_vap, n_slots, ...]. A batch's entries ([B, n]) address
    their own structure's rows: structure b's sums are rows
    b * n_vap * n_slots of one accumulator. Where the pair or triple
    axis is sharded the sums run over every rank's entries
    (`ops.pairs.reduce_rows`)."""
    lead = center.shape[:-1]
    seg = center.long() * n_slots + slot.long()
    if lead:
        b = seg.shape[0]
        seg = seg + torch.arange(0, b * n_vap * n_slots, n_vap * n_slots,
                                 device=seg.device).view(b, 1)
    tail = values.shape[center.dim():]
    out = values.new_zeros((lead.numel() * n_vap * n_slots,) + tail)
    out = reduce_rows(out.index_add(0, seg.reshape(-1),
                                    values.reshape((-1,) + tail)))
    return out.reshape(lead + (n_vap, n_slots) + tail)


class SymmetryFunction:
    """Config + compute for SF descriptors (no trainable parameters)."""

    name = "SF"

    def __init__(self, elements, eta=(0.05, 4.0, 20.0, 80.0), omega=(0.0,),
                 beta=(0.005,), gamma=(1.0, -1.0), zeta=(1.0, 4.0),
                 cutoff_function: str = "cosine", backend: str = "segment"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown descriptor backend {backend!r}")
        self.backend = backend
        self.elements = sorted(elements)
        self.eta = np.asarray(eta, dtype=np.float64)
        self.omega = np.asarray(omega, dtype=np.float64)
        self.beta = np.asarray(beta, dtype=np.float64)
        self.gamma = np.asarray(gamma, dtype=np.float64)
        self.zeta = np.asarray(zeta, dtype=np.float64)
        self.cutoff_function = cutoff_function
        self.radial_grid = np.array(
            list(product(self.eta, self.omega)))       # [T2, 2]
        self.angular_grid = np.array(
            list(product(self.beta, self.gamma, self.zeta)))  # [T4, 3]

    @property
    def n_radial_params(self) -> int:
        return len(self.radial_grid)

    @property
    def n_angular_params(self) -> int:
        return len(self.angular_grid)

    def feature_dim(self, n_radial_slots: int, n_angular_slots: int,
                    angular: bool) -> int:
        dim = n_radial_slots * self.n_radial_params
        if angular:
            dim += n_angular_slots * self.n_angular_params
        return dim

    # ------------------------------------------------------------------
    def radial(self, features, rcut: float, n_slots: int) -> torch.Tensor:
        """-> [.., n_vap, n_slots * n_radial_params]; a batch [B, A, N]
        is B * A rows of one call."""
        if self.backend == "segment":
            return self._radial_segment(features, rcut, n_slots)
        g2 = G2Function.apply if self.backend == "pallas" else g2_reference
        rij, _, islotf, mask = dense_pair_geometry(features, with_unit=False)
        g = g2(*as_rows(rij, islotf, mask), self.radial_grid, float(rcut),
               self.cutoff_function, n_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def angular(self, features, acut: float, n_slots: int) -> torch.Tensor:
        """-> [.., n_vap, n_slots * n_angular_params]."""
        if self.backend == "segment":
            return self._angular_segment(features, acut, n_slots)
        g4 = G4Function.apply if self.backend == "pallas" else g4_reference
        rij, rik, rjk, aslotf, mask = dense_triple_geometry(features)
        g = g4(*as_rows(rij, rik, rjk, aslotf, mask), self.angular_grid,
               float(acut), self.cutoff_function, n_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def _radial_segment(self, features, rcut: float, n_slots: int
                        ) -> torch.Tensor:
        _, rij = pair_distances(features)
        mask = features["pair_mask"]
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
        grid = torch.as_tensor(self.radial_grid, dtype=rij.dtype,
                               device=rij.device)
        z = torch.square(rij[..., None] - grid[:, 1]) / (rcut * rcut)
        v = torch.exp(-grid[:, 0] * z) * fc[..., None]      # [.., nij, T2]
        n_vap = features["positions"].shape[-2]
        g = segment_rows(v, features["pair_i"], features["pair_islot"],
                         n_vap, n_slots)
        return g.reshape(*g.shape[:-3], n_vap,
                         n_slots * self.n_radial_params)

    def _angular_segment(self, features, acut: float, n_slots: int
                         ) -> torch.Tensor:
        rij, rik, rjk = triple_distances(features)
        v = torch.stack(_g4_values(self.angular_grid, self.cutoff_function,
                                   acut, rij, rik, rjk), dim=-1)
        v = v * features["trip_mask"][..., None]            # [.., nijk, T4]
        n_vap = features["positions"].shape[-2]
        g = segment_rows(v, features["trip_i"], features["trip_aslot"],
                         n_vap, n_slots)
        return g.reshape(*g.shape[:-3], n_vap,
                         n_slots * self.n_angular_params)

    def compute(self, features, rcut: float, acut: float,
                n_radial_slots: int, n_angular_slots: int,
                angular: bool, params=None,
                vap_element_idx=None) -> torch.Tensor:
        g = self.radial(features, rcut, n_radial_slots)
        if angular:
            g4 = self.angular(features, acut, n_angular_slots)
            g = torch.cat([g, g4], dim=-1)
        return g

    def sweep_bytes_per_pair(self, n_slots: int, itemsize: int = 4) -> int:
        """Working bytes per pair slot of one descriptor evaluation (the
        [pairs, T2] terms and the slot selection, with a 2x allowance);
        sizes the chunks of the trainer's min/max sweep."""
        return itemsize * 2 * self.n_radial_params * (n_slots + 1)

    def sweep_bytes_per_triple(self, n_slots: int,
                               itemsize: int = 4) -> int:
        return itemsize * 2 * self.n_angular_params * (n_slots + 1)

    def as_dict(self) -> dict:
        return {"class": "SymmetryFunction", "elements": self.elements,
                "eta": self.eta.tolist(), "omega": self.omega.tolist(),
                "beta": self.beta.tolist(), "gamma": self.gamma.tolist(),
                "zeta": self.zeta.tolist(),
                "cutoff_function": self.cutoff_function,
                "backend": self.backend}
