"""Per-atom descriptor NN potential (port of `tensoralloy_tpu/nn/atomic.py`).

Architecture: descriptors g_i -> optional min-max scaling -> per-element
MLP -> atomic energy; the total energy is the masked sum. The VAP layout
puts each element's atoms in one static row slice, so every element's
MLP is one dense matmul chain over its slice.

Weights live in `self.params`, an `nn.ModuleDict` shaped like the JAX
parameter tree: state-dict key ``params.Ni.mlp.layers.0.w`` is the JAX
leaf ``params["Ni"]["mlp"]["layers"][0]["w"]`` (see
`io.model.params_from_jax`). Construction allocates zero weights; load
them with `load_state_dict` (or `io.model.load_model`).
"""
from __future__ import annotations

import copy
from collections import Counter
from typing import Dict, List, Optional, Sequence, Union

import torch
from torch import nn

from ..transform.featurizer import Featurizer
from ..utils import Defaults
from .layers import (apply_dense_stack, freeze_output_bias,
                     minmax_normalize_apply)


def _dense_stack(in_dim: int, hidden_sizes: Sequence[int], resnet_dt: bool,
                 factory: dict, out_dim: int = 1,
                 output_bias: bool = True) -> nn.ModuleDict:
    """Zero-filled stack with the JAX `init_dense_stack` shapes: hidden
    layers with bias (and dt where widths match), a linear output of
    `out_dim`, biased when `output_bias`."""
    sizes = [in_dim] + list(hidden_sizes) + [out_dim]
    layers = nn.ModuleList()
    for li in range(len(sizes) - 1):
        fan_in, fan_out = sizes[li], sizes[li + 1]
        is_output = li == len(sizes) - 2
        layer = {"w": torch.zeros(fan_in, fan_out, **factory)}
        if not is_output or output_bias:
            layer["b"] = torch.zeros(fan_out, **factory)
        if not is_output and resnet_dt and fan_in == fan_out:
            layer["dt"] = torch.zeros(fan_out, **factory)
        layers.append(nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in layer.items()}))
    return nn.ModuleDict({"layers": layers})


class AtomicNN(nn.Module):
    """Descriptor -> per-element MLP energy model."""

    def __init__(self,
                 featurizer: Featurizer,
                 max_occurs: Counter,
                 descriptor,
                 hidden_sizes: Union[Sequence[int], Dict[str, Sequence[int]],
                                     None] = None,
                 activation: str = Defaults.activation,
                 use_resnet_dt: bool = True,
                 minmax_scale: bool = True,
                 atomic_static_energy: Optional[Dict[str, float]] = None,
                 fixed_static_energy: bool = False,
                 *, device=None, dtype=None):
        super().__init__()
        self.featurizer = featurizer
        self.descriptor = descriptor
        self.elements: List[str] = featurizer.elements
        if hidden_sizes is None:
            hidden_sizes = Defaults.hidden_sizes
        if not isinstance(hidden_sizes, dict):
            hidden_sizes = {e: list(hidden_sizes) for e in self.elements}
        self.hidden_sizes = hidden_sizes
        self.activation = activation
        self.use_resnet_dt = use_resnet_dt
        self.minmax_scale = minmax_scale
        self.atomic_static_energy = dict(atomic_static_energy or {})
        self.fixed_static_energy = fixed_static_energy
        self.feature_dim = descriptor.feature_dim(
            featurizer.n_radial_slots, featurizer.n_angular_slots,
            featurizer.angular)

        factory = {"device": device, "dtype": dtype}
        params = nn.ModuleDict()
        for e in self.elements:
            net = self._element_net(e, factory)
            if minmax_scale:
                net["norm"] = nn.ParameterDict({
                    k: nn.Parameter(torch.zeros(self.feature_dim, **factory),
                                    requires_grad=False)
                    for k in ("xlo", "xhi")})
            params[e] = net
        self.params = params
        self._set_layout(max_occurs)

    def _element_net(self, element: str, factory: dict) -> nn.ModuleDict:
        """The element's stacks (subclasses add heads)."""
        return nn.ModuleDict({"mlp": _dense_stack(
            self.feature_dim, self.hidden_sizes[element],
            self.use_resnet_dt, factory)})

    def _set_layout(self, max_occurs: Counter) -> None:
        """Static VAP row layout: row 0 is the virtual atom, then one
        contiguous slice of max_occurs[e] rows per element (sorted)."""
        self.max_occurs = Counter(max_occurs)
        offset = 1
        self.layout: Dict[str, tuple] = {}
        for e in self.elements:
            cnt = int(self.max_occurs.get(e, 0))
            self.layout[e] = (offset, cnt)
            offset += cnt
        self.n_atoms_vap = offset

    def clone_for(self, max_occurs: Counter) -> "AtomicNN":
        """The same weights (shared, not copied) under another VAP row
        layout: params are layout-independent, so serving an arbitrary
        stoichiometry re-lays-out the model and keeps its weights."""
        clone = copy.copy(self)
        clone._set_layout(max_occurs)
        return clone

    # ------------------------------------------------------------------
    def descriptors(self, features) -> torch.Tensor:
        f = self.featurizer
        return self.descriptor.compute(
            features, f.rcut, f.acut, f.n_radial_slots, f.n_angular_slots,
            f.angular)

    def atomic_energies(self, features) -> torch.Tensor:
        """-> [n_vap] atomic energies (zero at padding rows)."""
        g = self.descriptors(features)
        rows = [g.new_zeros(1)]
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0:
                continue
            x = g[lo:lo + cnt]
            if self.minmax_scale:
                x = minmax_normalize_apply(self.params[e]["norm"], x)
            layers = self.params[e]["mlp"]["layers"]
            if self.fixed_static_energy:
                layers = freeze_output_bias(layers)
            rows.append(apply_dense_stack(layers, x, self.activation)[:, 0])
        return torch.cat(rows) * features["atom_masks"]

    def energy(self, features) -> torch.Tensor:
        """Total potential energy (scalar)."""
        return torch.sum(self.atomic_energies(features))

    # what forces and stress differentiate; for the plain AtomicNN it IS
    # the energy (the finite-temperature models use the free energy)
    variational_energy = energy

    def as_dict(self) -> dict:
        return {"class": "AtomicNN",
                "featurizer": self.featurizer.as_dict(),
                "max_occurs": dict(self.max_occurs),
                "descriptor": self.descriptor.as_dict(),
                "hidden_sizes": self.hidden_sizes,
                "activation": self.activation,
                "use_resnet_dt": self.use_resnet_dt,
                "minmax_scale": self.minmax_scale,
                "atomic_static_energy": self.atomic_static_energy,
                "fixed_static_energy": self.fixed_static_energy}
