"""Temperature-dependent atomistic NN (port of
`tensoralloy_tpu/nn/finite_temperature.py`).

Per element: descriptors x -> shared trunk MLP (`layers[:-1]` hidden,
`layers[-1]` out, linear) -> H; the electron temperature T (eV) is
appended as one more channel -> Ht; two heads on Ht:

  * internal energy U (output bias = per-element static energy)
  * electron entropy S: "default" S = head(Ht); "Sommerfeld"
    S = head(Ht) * T

Free energy F = U - T S. Forces and stress differentiate the free
energy (`variational_energy`). Weights sit under
``params.<element>.{trunk, head_u, head_s, norm}``, the JAX tree's
names. `AtomicNN.clone_for` serves this class unchanged (the copy keeps
the class and shares the weights).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

import torch
from torch import nn

from .atomic import AtomicNN, _dense_stack
from .layers import (apply_dense_stack, freeze_output_bias,
                     init_dense_stack)


class TemperatureDependentAtomicNN(AtomicNN):
    """Finite-temperature model on the AtomicNN descriptor and layout."""

    def __init__(self, featurizer, max_occurs: Counter, descriptor,
                 layers: Sequence[int] = (128, 128),
                 eentropy_algo: str = "default",
                 ft_activation: str = "softplus",
                 **kwargs):
        # read by `_element_net` while AtomicNN.__init__ builds the
        # weights (plain attributes may be set before nn.Module.__init__)
        self.layers = list(layers)
        self.eentropy_algo = eentropy_algo
        self.ft_activation = ft_activation
        super().__init__(featurizer, max_occurs, descriptor, **kwargs)

    def _element_net(self, element: str, factory: dict) -> nn.ModuleDict:
        trunk_out = self.layers[-1]
        heads = {name: _dense_stack(trunk_out + 1, self.hidden_sizes[element],
                                    self.use_resnet_dt, factory)
                 for name in ("head_u", "head_s")}
        return nn.ModuleDict({
            "trunk": _dense_stack(self.feature_dim, self.layers[:-1],
                                  self.use_resnet_dt, factory,
                                  out_dim=trunk_out),
            **heads})

    # hook: map the raw entropy-head output to S (BeNN overrides it)
    def _entropy_from_head(self, s_raw: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
        if self.eentropy_algo.lower() == "sommerfeld":
            return s_raw * t
        return s_raw

    def _init_element(self, element: str, generator, factory) -> dict:
        trunk_out = self.layers[-1]
        bias0 = float(self.atomic_static_energy.get(element, 0.0))
        common = dict(resnet_dt=self.use_resnet_dt,
                      kernel_init=self.kernel_initializer, **factory)
        return {
            "trunk": init_dense_stack(
                generator, self.feature_dim, self.layers[:-1],
                out_dim=trunk_out, output_bias=True, **common),
            "head_u": init_dense_stack(
                generator, trunk_out + 1, self.hidden_sizes[element],
                out_dim=1, output_bias=True, output_bias_mean=bias0,
                **common),
            "head_s": init_dense_stack(
                generator, trunk_out + 1, self.hidden_sizes[element],
                out_dim=1, output_bias=True, output_bias_mean=0.0,
                **common)}

    # ------------------------------------------------------------------
    def _atomic_heads(self, features, params=None
                      ) -> Dict[str, torch.Tensor]:
        """-> {'energy': U_i, 'eentropy': S_i, 'free_energy': F_i}, each
        [.., n_vap], zero at padding rows."""
        params = self.params if params is None else params
        g = self.descriptors(features, params)
        t = features["etemperature"].to(g.dtype)[..., None]   # [.., 1]
        zero = g.new_zeros(*g.shape[:-2], 1)
        u_rows, s_rows = [zero], [zero]
        for net, x in self._element_rows(g, params):
            h = apply_dense_stack(net["trunk"]["layers"], x,
                                  self.ft_activation)
            ht = torch.cat([h, t[..., None].expand(*h.shape[:-1], 1)],
                           dim=-1)
            head_u = net["head_u"]["layers"]
            if self.fixed_static_energy:
                head_u = freeze_output_bias(head_u)
            u_rows.append(apply_dense_stack(head_u, ht,
                                            self.activation)[..., 0])
            s = apply_dense_stack(net["head_s"]["layers"], ht,
                                  self.activation)[..., 0]
            s_rows.append(self._entropy_from_head(s, t))
        masks = features["atom_masks"]
        u = torch.cat(u_rows, dim=-1) * masks
        s = torch.cat(s_rows, dim=-1) * masks
        return {"energy": u, "eentropy": s, "free_energy": u - t * s}

    def atomic_energies(self, features, params=None) -> torch.Tensor:
        """Atomic internal energies U_i."""
        return self._atomic_heads(features, params)["energy"]

    def energy_ops(self, features, params=None) -> Dict[str, torch.Tensor]:
        """Totals U, S and F = U - T S."""
        return {k: torch.sum(v, dim=-1)
                for k, v in self._atomic_heads(features, params).items()}

    def energy(self, features, params=None) -> torch.Tensor:
        """Internal energy U."""
        return torch.sum(self.atomic_energies(features, params), dim=-1)

    def variational_energy(self, features, params=None) -> torch.Tensor:
        """Free energy F = U - T S; what forces and stress differentiate
        for finite-temperature systems."""
        return self.energy_ops(features, params)["free_energy"]

    def energy_and_aux(self, features, params=None):
        """-> (F, {atomic U_i, and the totals 'energy' U, 'eentropy' S,
        'free_energy' F}) from one pass over the heads."""
        heads = self._atomic_heads(features, params)
        totals = {k: torch.sum(v, dim=-1) for k, v in heads.items()}
        return totals["free_energy"], {"atomic_energies": heads["energy"],
                                       **totals}

    # -- row-chunked evaluation of large cells (AtomicNN._chunked_totals)
    def _chunk_head(self, net, x, features) -> tuple:
        """(U_i, S_i) of one element's rows."""
        t = features["etemperature"].to(x.dtype)
        h = apply_dense_stack(net["trunk"]["layers"], x, self.ft_activation)
        ht = torch.cat([h, t.expand(*h.shape[:-1], 1)], dim=-1)
        head_u = net["head_u"]["layers"]
        if self.fixed_static_energy:
            head_u = freeze_output_bias(head_u)
        u = apply_dense_stack(head_u, ht, self.activation)[..., 0]
        s = apply_dense_stack(net["head_s"]["layers"], ht,
                              self.activation)[..., 0]
        return u, self._entropy_from_head(s, t)

    def heads_chunked(self, features, params=None, atom_chunk: int = 4096
                      ) -> Dict[str, torch.Tensor]:
        """Totals {'energy': U, 'eentropy': S, 'free_energy': U - T S} of
        one structure, evaluated in row blocks."""
        u, s = self._chunked_totals(features, params, atom_chunk)
        t = features["etemperature"].to(u.dtype)
        return {"energy": u, "eentropy": s, "free_energy": u - t * s}

    def energy_chunked(self, features, params=None,
                       atom_chunk: int = 4096) -> torch.Tensor:
        """Internal energy U, evaluated in row blocks."""
        return self.heads_chunked(features, params, atom_chunk)["energy"]

    def make_chunked_energy_fn(self, atom_chunk: int = 4096):
        """-> fn(features, params=None): the chunked free energy F, what
        large-cell forces and stress differentiate."""
        return lambda features, params=None: self.heads_chunked(
            features, params, atom_chunk)["free_energy"]

    def _stacks(self, params):
        return [params[e][key] for e in self.elements
                for key in ("trunk", "head_u", "head_s")]

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["class"] = "TemperatureDependentAtomicNN"
        d["layers"] = self.layers
        d["eentropy_algo"] = self.eentropy_algo
        d["ft_activation"] = self.ft_activation
        return d
