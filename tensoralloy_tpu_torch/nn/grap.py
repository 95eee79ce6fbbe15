"""GRAP — Generic Radial Atomic Potential descriptors on the dense per-atom
layout (port of `tensoralloy_tpu/nn/grap.py`).

Radial filter bank H x moment-tensor basis M -> rotation-invariant
per-atom features:

    P[i, s, k, d] = sum_{j in s} H_k(r_ij) fc(r_ij) M_d(r̂_ij)
    S = P^2;  Q[i, s, k, m] = sum_d S[i, s, k, d] T[d, m]
    G = [sign(P_0) sqrt(Q_0 + eps), Q_1, ..., Q_mm]

with T the multiplicity tensor over the compressed monomial basis (the
multinomial count of each unique monomial, with the optional traceless
"symmetric" correction for moments 2-3).

Radial algorithms: 'sf' (eta, omega), 'density' (A, beta, re), 'morse'
(D, gamma, r0) and 'pexp' (rl, pl). Backends: 'dense' runs the plain
PyTorch twin `ops.fused.grap_reference`; 'pallas' (the JAX package's
name for its fused kernels) runs the CUDA kernel through
`ops.fused.GrapFunction`.

Not ported yet: the 'segment' backend and `legacy_mode` (training
slice), and the learned 'nn' filter (a later slice; no saved model
uses it and it never reaches a kernel).
"""
from __future__ import annotations

from itertools import combinations_with_replacement
from itertools import product as iter_product
from math import factorial
from typing import List, Optional, Union

import numpy as np
import torch

from ..ops.dense import as_rows, dense_pair_geometry
from ..ops.fused import GRAP_ALGORITHMS, GrapFunction, grap_reference
from ..ops.generic import density_exp, morse, power_exp

BACKENDS = ("dense", "pallas")


def _param_grid(algorithm: str, parameters: dict, method: str):
    """-> ([K, n_keys] parameter table, sorted keys); 'cross' = product
    over the sorted keys (sklearn ParameterGrid order, last key
    fastest), 'pair' = aligned lists."""
    keys = sorted(GRAP_ALGORITHMS[algorithm])
    cols = [np.atleast_1d(np.asarray(parameters[k], np.float64))
            for k in keys]
    if method == "cross":
        rows = np.array(list(iter_product(*cols)))
    else:
        if len({len(c) for c in cols}) > 1:
            raise ValueError("pair param space needs equal-length lists")
        rows = np.stack(cols, axis=1)
    return rows, keys


# ----------------------------------------------------------------------
# Compressed monomial bases and multiplicity tensors
# ----------------------------------------------------------------------

def moment_monomials(max_moment: int):
    """Unique (sorted) monomial index tuples per degree 0..max_moment:
    [(), (0,), (1,), (2,), (0, 0), (0, 1), ...], C(m+2, 2) per degree m
    (56 in all at moment 5)."""
    cols = [()]
    for m in range(1, max_moment + 1):
        cols += [tuple(c) for c in combinations_with_replacement(range(3), m)]
    return cols


def multiplicity_tensor(max_moment: int, symmetric: bool = False
                        ) -> np.ndarray:
    """T[d, m] over the compressed basis: each squared monomial sum enters
    its moment's invariant with its multinomial multiplicity
    m!/(cx! cy! cz!). The symmetric (trace-removal) corrections exist for
    moments 2-3 only."""
    cols = moment_monomials(max_moment)
    t = np.zeros((len(cols), max_moment + 1))
    for d, mono in enumerate(cols):
        m = len(mono)
        mult = factorial(m)
        for ax in range(3):
            mult //= factorial(mono.count(ax))
        t[d, m] = float(mult)
    if symmetric:
        if max_moment >= 2:
            t[0, 2] = -1.0 / 3.0
        if max_moment >= 3:
            t[1:4, 3] = -3.0 / 5.0
    return t


def moment_basis_c(comps, max_moment: int) -> torch.Tensor:
    """M [..., D] from the unit-vector components (ux, uy, uz): the
    unique monomials, each degree-m column the product of its sorted
    degree-(m-1) prefix and one more component."""
    ux = comps[0]
    cols = [torch.ones_like(ux)]
    if max_moment >= 1:
        cols += [comps[0], comps[1], comps[2]]
    prods = {(a,): comps[a] for a in range(3)}
    for mono in moment_monomials(max_moment):
        if len(mono) < 2:
            continue
        prods[mono] = prods[mono[:-1]] * comps[mono[-1]]
        cols.append(prods[mono])
    return torch.stack(cols, dim=-1)


# ----------------------------------------------------------------------
class GenericRadialAtomicPotential:
    """Config + compute for GRAP descriptors (no trainable parameters for
    the grid algorithms)."""

    name = "GRAP"

    def __init__(self, elements: List[str], algorithm: str = "sf",
                 parameters: Optional[dict] = None,
                 param_space_method: str = "pair",
                 moment_tensors: Union[int, List[int]] = 0,
                 cutoff_function: str = "cosine",
                 symmetric: bool = False,
                 legacy_mode: bool = False,
                 backend: str = "dense"):
        if backend == "segment" or legacy_mode:
            what = ("the 'segment' descriptor backend" if not legacy_mode
                    else "legacy-mode GRAP")
            raise NotImplementedError(
                f"{what} is not ported yet; it comes with the training "
                f"slice (slice 1b). Use backend 'dense' or 'pallas'")
        if backend not in BACKENDS:
            raise ValueError(f"unknown descriptor backend {backend!r}")
        if algorithm == "nn":
            raise NotImplementedError(
                "GRAP with learned ('nn') filters is not ported yet; it "
                "comes with a later slice (it needs descriptor parameters "
                "in AtomicNN)")
        if algorithm not in GRAP_ALGORITHMS:
            raise ValueError(f"unknown GRAP algorithm {algorithm!r}")
        self.backend = backend
        self.elements = sorted(elements)
        self.algorithm = algorithm
        self.parameters = parameters or {}
        self.param_space_method = param_space_method
        if isinstance(moment_tensors, int):
            moment_tensors = [moment_tensors]
        self.moment_tensors = sorted(set(moment_tensors))
        self.max_moment = max(self.moment_tensors)
        self.cutoff_function = cutoff_function
        self.symmetric = symmetric
        self.legacy_mode = legacy_mode
        self._grid, self._grid_keys = _param_grid(
            algorithm, self.parameters, param_space_method)
        self.n_filters = len(self._grid)

    def feature_dim(self, n_radial_slots: int, n_angular_slots: int,
                    angular: bool) -> int:
        # As the JAX package computes it: K (max_moment + 1) per slot,
        # which is wider than the descriptor when the moment list has
        # gaps (e.g. [0, 2, 5] emits K * 3 columns); see ROADMAP.md
        # queue 3. No saved model has gaps.
        return n_radial_slots * self.n_filters * (self.max_moment + 1)

    # ------------------------------------------------------------------
    def _filter_values(self, r: torch.Tensor, rcut: float) -> torch.Tensor:
        """H [..., K] before the cutoff."""
        cols = {k: torch.as_tensor(self._grid[:, i], dtype=r.dtype,
                                   device=r.device)
                for i, k in enumerate(self._grid_keys)}
        r = r[..., None]
        if self.algorithm == "sf":
            return torch.exp(-cols["eta"] * torch.square(r - cols["omega"])
                             / (rcut * rcut))
        if self.algorithm == "density":
            return density_exp(r, cols["A"], cols["beta"], cols["re"])
        if self.algorithm == "morse":
            return morse(r, cols["D"], cols["gamma"], cols["r0"])
        return power_exp(r, cols["rl"], cols["pl"])

    def invariants_from_p(self, p: torch.Tensor, n_vap: int,
                          n_slots: int) -> torch.Tensor:
        """P [n_vap * n_slots, K, D] -> G [n_vap, n_slots * K * M], in
        (slot, filter, moment) order, M = len(moment_tensors)."""
        s = torch.square(p)
        t = torch.as_tensor(
            multiplicity_tensor(self.max_moment, self.symmetric),
            dtype=p.dtype, device=p.device)
        q = s @ t                                      # [nseg, K, mm+1]
        g0 = torch.sign(p[..., 0]) * torch.sqrt(q[..., 0] + 1e-16)
        g = torch.cat([g0[..., None], q[..., 1:]], dim=-1)
        if self.moment_tensors != list(range(self.max_moment + 1)):
            # gaps in the requested list (e.g. [0, 2]): emit only the
            # requested moments
            g = g[..., self.moment_tensors]
        return g.reshape(n_vap, n_slots * self.n_filters *
                         len(self.moment_tensors))

    def compute(self, features, rcut: float, acut: float,
                n_radial_slots: int, n_angular_slots: int,
                angular: bool) -> torch.Tensor:
        """-> [.., n_vap, n_radial_slots * K * M]; a batch [B, A, N] is
        B * A rows of one call."""
        grap = (GrapFunction.apply if self.backend == "pallas"
                else grap_reference)
        rij, unit, islotf, mask = dense_pair_geometry(features)
        g = grap(*as_rows(rij, *unit, islotf, mask), self, float(rcut),
                 n_radial_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def sweep_bytes_per_pair(self, n_slots: int, itemsize: int = 4) -> int:
        """Working bytes per pair slot of one descriptor evaluation: the
        moment basis [pairs, D] and the slot-expanded filters
        [pairs, S*K], with a 2x allowance; sizes the chunks of the
        trainer's min/max sweep."""
        d = multiplicity_tensor(self.max_moment, self.symmetric).shape[0]
        return itemsize * 2 * (d + self.n_filters * (n_slots + 1))

    # ------------------------------------------------------------------
    def as_dict(self) -> dict:
        return {"class": "GenericRadialAtomicPotential",
                "elements": self.elements,
                "algorithm": self.algorithm,
                "parameters": self.parameters,
                "param_space_method": self.param_space_method,
                "moment_tensors": self.moment_tensors,
                "cutoff_function": self.cutoff_function,
                "symmetric": self.symmetric,
                "legacy_mode": self.legacy_mode,
                "backend": self.backend}

    @classmethod
    def from_dict(cls, d: dict) -> "GenericRadialAtomicPotential":
        return cls(elements=d["elements"], algorithm=d["algorithm"],
                   parameters=d.get("parameters"),
                   param_space_method=d.get("param_space_method", "pair"),
                   moment_tensors=d.get("moment_tensors", 0),
                   cutoff_function=d.get("cutoff_function", "cosine"),
                   symmetric=d.get("symmetric", False),
                   legacy_mode=d.get("legacy_mode", False),
                   backend=d.get("backend", "segment"))
