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
(D, gamma, r0), 'pexp' (rl, pl), or 'nn': a learned filter MLP shared
across elements (its weights under ``params["descriptor"]["filters"]``
of the model), its input optionally scaled by the covalent radius of
the pair's centre (`h_abck_modifier` 1: r / rcov, 2: exp(-r / rcov)).

Backends: 'segment' (the default, as in the JAX package) reads the flat
pair arrays and sums the H (x) M outer products with one `index_add`
keyed by ``atom_row * n_slots + slot``; 'dense' runs the plain PyTorch
twin `ops.fused.grap_reference` on the per-atom rows; 'pallas' (the JAX
package's name for its fused kernels) runs the CUDA kernel through
`ops.fused.GrapFunction`. The 'nn' filter has no kernel: on 'pallas' it
takes the dense path, as in the JAX package.

`legacy_mode` (segment only): the reference's per-moment scalar
contractions, moments 0-2 (0: sum_j h; 1: sum_a (sum_j h u_a)^2;
2: sum_ab (sum_j h u_a u_b)^2), K len(moment_tensors) columns a slot.
"""
from __future__ import annotations

from itertools import combinations_with_replacement
from itertools import product as iter_product
from math import factorial
from typing import List, Optional, Union

import numpy as np
import torch

from ..elements import atomic_numbers, covalent_radii
from ..ops.cutoffs import apply_cutoff
from ..ops.dense import as_rows, dense_pair_geometry
from ..ops.fused import GRAP_ALGORITHMS, GrapFunction, grap_reference
from ..ops.generic import density_exp, morse, power_exp
from ..ops.pairs import pair_vectors, safe_norm
from .atomic import _dense_stack
from .layers import apply_dense_stack, init_dense_stack
from .sf import segment_rows

BACKENDS = ("segment", "dense", "pallas")


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
    """Config + compute for GRAP descriptors; the 'nn' filter's weights
    are parameters of the model that holds the descriptor."""

    name = "GRAP"

    def __init__(self, elements: List[str], algorithm: str = "sf",
                 parameters: Optional[dict] = None,
                 param_space_method: str = "pair",
                 moment_tensors: Union[int, List[int]] = 0,
                 cutoff_function: str = "cosine",
                 symmetric: bool = False,
                 legacy_mode: bool = False,
                 backend: str = "segment"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown descriptor backend {backend!r}")
        if backend != "segment" and legacy_mode:
            raise ValueError("legacy GRAP supports only backend='segment'")
        if algorithm != "nn" and algorithm not in GRAP_ALGORITHMS:
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
        if algorithm == "nn":
            if legacy_mode:
                raise ValueError("NN filters require non-legacy GRAP")
            p = self.parameters
            self.nn_hidden = list(p.get("hidden_sizes", [32, 32, 32]))
            self.nn_activation = p.get("activation", "softplus")
            self.nn_filters = int(p.get("num_filters", 16))
            self.nn_resnet_dt = bool(p.get("use_resnet_dt", True))
            self.h_modifier = int(p.get("h_abck_modifier", 0))
            self.n_filters = self.nn_filters
            self._grid = None
        else:
            self._grid, self._grid_keys = _param_grid(
                algorithm, self.parameters, param_space_method)
            self.n_filters = len(self._grid)

    def feature_dim(self, n_radial_slots: int, n_angular_slots: int,
                    angular: bool) -> int:
        if self.legacy_mode:
            return n_radial_slots * self.n_filters * len(self.moment_tensors)
        # As the JAX package computes it: K (max_moment + 1) per slot,
        # which is wider than the descriptor when the moment list has
        # gaps (e.g. [0, 2, 5] emits K * 3 columns); see ROADMAP.md
        # queue 3. No saved model has gaps.
        return n_radial_slots * self.n_filters * (self.max_moment + 1)

    # -- the 'nn' filter's parameters ----------------------------------
    def zero_params(self, factory: dict):
        """The filter MLP as a zero-filled module in the JAX tree's
        shape ({"filters": stack}), or None for the grid algorithms."""
        if self.algorithm != "nn":
            return None
        from torch import nn
        return nn.ModuleDict({"filters": _dense_stack(
            1, self.nn_hidden, self.nn_resnet_dt, factory,
            out_dim=self.nn_filters, output_bias=False)})

    def init_params(self, generator, dtype=None, device=None) -> dict:
        """Fresh filter weights drawn from `generator` (the JAX
        distributions and scales, not its bits); {} for the grid
        algorithms."""
        if self.algorithm != "nn":
            return {}
        return {"filters": init_dense_stack(
            generator, 1, self.nn_hidden, out_dim=self.nn_filters,
            output_bias=False, resnet_dt=self.nn_resnet_dt, dtype=dtype,
            device=device)}

    # ------------------------------------------------------------------
    def _filter_values(self, r: torch.Tensor, rcut: float, params=None,
                       rcov: Optional[torch.Tensor] = None) -> torch.Tensor:
        """H [..., K] before the cutoff; `rcov` [...] is the covalent
        radius of each entry's centre (the 'nn' filter's modifiers)."""
        if self.algorithm == "nn":
            x = r
            if self.h_modifier == 1:
                x = r / rcov
            elif self.h_modifier == 2:
                x = torch.exp(-r / rcov)
            return apply_dense_stack(params["filters"]["layers"],
                                     x[..., None], self.nn_activation)
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

    def _rcov_rows(self, vap_element_idx, like: torch.Tensor
                   ) -> Optional[torch.Tensor]:
        """[A] covalent radius of every VAP row's element, where the 'nn'
        filter's modifier reads it; None otherwise."""
        if self.algorithm != "nn" or self.h_modifier == 0:
            return None
        if vap_element_idx is None:
            raise ValueError("h_abck_modifier needs the model's "
                             "vap_element_idx")
        radii = covalent_radii[[atomic_numbers[self.elements[i]]
                                for i in np.asarray(vap_element_idx)]]
        return torch.as_tensor(radii, dtype=like.dtype, device=like.device)

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
                angular: bool, params=None,
                vap_element_idx=None) -> torch.Tensor:
        """-> [.., n_vap, n_radial_slots * K * M]; a batch [B, A, ...] is
        one call. `params` holds the 'nn' filter's weights and
        `vap_element_idx` [A] the element of every row (its covalent
        radii), as the JAX signature."""
        backend = self.backend
        if backend == "pallas" and self.algorithm == "nn":
            backend = "dense"       # the learned filter has no kernel
        if backend == "segment":
            return self._compute_segment(features, rcut, n_radial_slots,
                                         params, vap_element_idx)
        rij, unit, islotf, mask = dense_pair_geometry(features)
        if self.algorithm == "nn":
            return self._compute_dense_nn(rij, unit, islotf, mask, rcut,
                                          n_radial_slots, params,
                                          vap_element_idx)
        grap = GrapFunction.apply if backend == "pallas" else grap_reference
        g = grap(*as_rows(rij, *unit, islotf, mask), self, float(rcut),
                 n_radial_slots)
        return g.reshape(*rij.shape[:-1], g.shape[-1])

    def _compute_dense_nn(self, rij, unit, islotf, mask, rcut: float,
                          n_slots: int, params, vap_element_idx
                          ) -> torch.Tensor:
        """The dense per-atom rows with the learned filter: the twin's
        contraction with H from the filter MLP."""
        lead, a, n = rij.shape[:-2], rij.shape[-2], rij.shape[-1]
        rcov = self._rcov_rows(vap_element_idx, rij)
        if rcov is not None:
            rcov = rcov[:, None].expand(rij.shape)
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
        h = self._filter_values(rij, rcut, params, rcov) * fc[..., None]
        m = moment_basis_c(unit, self.max_moment)          # [.., A, N, D]
        k = self.n_filters
        eye = torch.arange(n_slots, dtype=islotf.dtype, device=islotf.device)
        sel = (islotf[..., None] == eye) * mask[..., None]  # [.., A, N, S]
        hs = (sel[..., None] * h[..., None, :]).reshape(
            *rij.shape, n_slots * k)
        p = torch.einsum("...nx,...nd->...xd", hs, m)
        rows = lead.numel() * a
        g = self.invariants_from_p(p.reshape(rows * n_slots, k, -1), rows,
                                   n_slots)
        return g.reshape(*lead, a, g.shape[-1])

    def _compute_segment(self, features, rcut: float, n_slots: int,
                         params, vap_element_idx) -> torch.Tensor:
        """The flat pair layout: per pair H (x) M, summed by (centre,
        slot) with one `index_add`."""
        vec = pair_vectors(features)
        mask = features["pair_mask"]
        rij = torch.where(mask > 0, safe_norm(vec), 1.0)
        unit = vec / rij[..., None]
        fc = apply_cutoff(self.cutoff_function, rij, rcut) * mask
        rcov = self._rcov_rows(vap_element_idx, rij)
        if rcov is not None:
            rcov = rcov[features["pair_i"].long()]
        h = self._filter_values(rij, rcut, params, rcov) * fc[..., None]
        n_vap = features["positions"].shape[-2]
        lead = mask.shape[:-1]
        comps = (unit[..., 0], unit[..., 1], unit[..., 2])

        def rows(values):
            return segment_rows(values, features["pair_i"],
                                features["pair_islot"], n_vap, n_slots)

        if self.legacy_mode:
            g = self._legacy(h, comps, rows)
        else:
            m = moment_basis_c(comps, self.max_moment)       # [.., nij, D]
            p = rows(h[..., :, None] * m[..., None, :])     # [.., A, S, K, D]
            n = lead.numel() * n_vap
            g = self.invariants_from_p(
                p.reshape(n * n_slots, self.n_filters, -1), n, n_slots)
        return g.reshape(*lead, n_vap, g.shape[-1])

    def _legacy(self, h, comps, rows) -> torch.Tensor:
        """Legacy per-moment scalar contractions (reference
        `grap.py:384-468`): per filter and moment, 0: sum, 1: sum_a
        (sum_j h u_a)^2, 2: sum_ab (sum_j h u_a u_b)^2 over all 9 ordered
        (a, b). -> [.., n_vap, n_slots * K * n_moments]."""
        outs = []
        for moment in self.moment_tensors:
            if moment == 0:
                g = rows(h)
            elif moment == 1:
                u = torch.stack(comps, dim=-1)               # [.., nij, 3]
                g = torch.sum(torch.square(
                    rows(h[..., :, None] * u[..., None, :])), dim=-1)
            elif moment == 2:
                ab = torch.stack([a * b for a in comps for b in comps],
                                 dim=-1)                     # [.., nij, 9]
                g = torch.sum(torch.square(
                    rows(h[..., :, None] * ab[..., None, :])), dim=-1)
            else:
                raise ValueError("legacy GRAP supports moments 0-2")
            outs.append(g)
        g = torch.stack(outs, dim=-1)          # [.., A, S, K, n_moments]
        return g.reshape(*g.shape[:-4], g.shape[-4],
                         g.shape[-3] * self.n_filters * len(outs))

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
