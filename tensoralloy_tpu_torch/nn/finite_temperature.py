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

Not ported yet: `heads_chunked` (with the chunked large-cell path).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

import torch
from torch import nn

from .atomic import AtomicNN, _dense_stack
from .layers import (apply_dense_stack, freeze_output_bias,
                     minmax_normalize_apply)


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

    # ------------------------------------------------------------------
    def _atomic_heads(self, features) -> Dict[str, torch.Tensor]:
        """-> {'energy': U_i, 'eentropy': S_i, 'free_energy': F_i}, each
        [n_vap], zero at padding rows."""
        g = self.descriptors(features)
        t = features["etemperature"].to(g.dtype)
        u_rows, s_rows = [g.new_zeros(1)], [g.new_zeros(1)]
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0:
                continue
            net = self.params[e]
            x = g[lo:lo + cnt]
            if self.minmax_scale:
                x = minmax_normalize_apply(net["norm"], x)
            h = apply_dense_stack(net["trunk"]["layers"], x,
                                  self.ft_activation)
            ht = torch.cat([h, t.reshape(1, 1).expand(cnt, 1)], dim=1)
            head_u = net["head_u"]["layers"]
            if self.fixed_static_energy:
                head_u = freeze_output_bias(head_u)
            u_rows.append(apply_dense_stack(head_u, ht, self.activation)[:, 0])
            s = apply_dense_stack(net["head_s"]["layers"], ht,
                                  self.activation)[:, 0]
            s_rows.append(self._entropy_from_head(s, t))
        masks = features["atom_masks"]
        u = torch.cat(u_rows) * masks
        s = torch.cat(s_rows) * masks
        return {"energy": u, "eentropy": s, "free_energy": u - t * s}

    def atomic_energies(self, features) -> torch.Tensor:
        """Atomic internal energies U_i."""
        return self._atomic_heads(features)["energy"]

    def energy_ops(self, features) -> Dict[str, torch.Tensor]:
        """Totals U, S and F = U - T S."""
        return {k: torch.sum(v)
                for k, v in self._atomic_heads(features).items()}

    def energy(self, features) -> torch.Tensor:
        """Internal energy U."""
        return torch.sum(self.atomic_energies(features))

    def variational_energy(self, features) -> torch.Tensor:
        """Free energy F = U - T S; what forces and stress differentiate
        for finite-temperature systems."""
        return torch.sum(self._atomic_heads(features)["free_energy"])

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["class"] = "TemperatureDependentAtomicNN"
        d["layers"] = self.layers
        d["eentropy_algo"] = self.eentropy_algo
        d["ft_activation"] = self.ft_activation
        return d
