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

Backends: 'dense' runs the plain PyTorch twins of `ops/fused.py`;
'pallas' (the JAX package's name for its fused kernels) runs the CUDA
kernels through their autograd Functions. Parameter-grid ordering is
sklearn's `ParameterGrid` (sorted keys, last key fastest).
"""
from __future__ import annotations

from itertools import product

import numpy as np
import torch

from ..ops.dense import (as_rows, dense_pair_geometry,
                         dense_triple_geometry)
from ..ops.fused import G2Function, G4Function, g2_reference, g4_reference

BACKENDS = ("dense", "pallas")


class SymmetryFunction:
    """Config + compute for SF descriptors (no trainable parameters)."""

    name = "SF"

    def __init__(self, elements, eta=(0.05, 4.0, 20.0, 80.0), omega=(0.0,),
                 beta=(0.005,), gamma=(1.0, -1.0), zeta=(1.0, 4.0),
                 cutoff_function: str = "cosine", backend: str = "dense"):
        if backend == "segment":
            raise NotImplementedError(
                "the 'segment' descriptor backend is not ported yet (a "
                "later slice); use 'dense' or 'pallas'")
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
        g2 = G2Function.apply if self.backend == "pallas" else g2_reference
        rij, _, islotf, mask = dense_pair_geometry(features, with_unit=False)
        g = g2(*as_rows(rij, islotf, mask), self.radial_grid, float(rcut),
               self.cutoff_function, n_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def angular(self, features, acut: float, n_slots: int) -> torch.Tensor:
        """-> [.., n_vap, n_slots * n_angular_params]."""
        g4 = G4Function.apply if self.backend == "pallas" else g4_reference
        rij, rik, rjk, aslotf, mask = dense_triple_geometry(features)
        g = g4(*as_rows(rij, rik, rjk, aslotf, mask), self.angular_grid,
               float(acut), self.cutoff_function, n_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def compute(self, features, rcut: float, acut: float,
                n_radial_slots: int, n_angular_slots: int,
                angular: bool) -> torch.Tensor:
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
