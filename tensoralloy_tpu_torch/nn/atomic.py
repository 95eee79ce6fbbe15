"""Per-atom descriptor NN potential (port of `tensoralloy_tpu/nn/atomic.py`).

Architecture: descriptors g_i -> optional min-max scaling -> per-element
MLP -> atomic energy; the total energy is the masked sum. The VAP layout
puts each element's atoms in one static row slice, so every element's
MLP is one dense matmul chain over its slice.

Weights live in `self.params`, an `nn.ModuleDict` shaped like the JAX
parameter tree: state-dict key ``params.Ni.mlp.layers.0.w`` is the JAX
leaf ``params["Ni"]["mlp"]["layers"][0]["w"]`` (see
`io.model.params_from_jax`). Construction allocates zero weights; load
them with `load_state_dict`, `load_param_tree` or `io.model.load_model`,
or draw fresh ones with `init_params`.

A descriptor with weights of its own (GRAP's learned 'nn' filter) keeps
them beside the elements, under ``params.descriptor`` (the JAX tree's
``params["descriptor"]``); every loop over elements reads
`self.elements`, never the keys of the tree.

Every compute method takes one structure's features or a batch's
([B, A, ...]): the descriptor kernels are row-independent, so a batch is
B * A rows of one launch, and each element's MLP takes its row slice of
every structure at once. The methods also take `params`, a parameter
tree used in place of the module's own weights (the trainer's raw or
EMA tree).
"""
from __future__ import annotations

import copy
from collections import Counter
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..transform.featurizer import Featurizer
from ..utils import Defaults
from ..utils import tree_flatten, tree_unflatten
from .layers import (apply_dense_stack, freeze_output_bias,
                     init_dense_stack, l2_of_stack,
                     minmax_normalize_apply, minmax_normalize_init)


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
                 kernel_initializer: str = "he_normal",
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
        self.kernel_initializer = kernel_initializer
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
        zero_params = getattr(descriptor, "zero_params", None)
        dmod = zero_params(factory) if zero_params is not None else None
        if dmod is not None:
            params["descriptor"] = dmod
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
        # element index of every VAP row (the virtual row reads 0)
        vei = np.zeros(self.n_atoms_vap, dtype=np.int32)
        for i, e in enumerate(self.elements):
            lo, cnt = self.layout[e]
            vei[lo:lo + cnt] = i
        self.vap_element_idx = vei

    def clone_for(self, max_occurs: Counter) -> "AtomicNN":
        """The same weights (shared, not copied) under another VAP row
        layout: params are layout-independent, so serving an arbitrary
        stoichiometry re-lays-out the model and keeps its weights."""
        clone = copy.copy(self)
        clone._set_layout(max_occurs)
        return clone

    # ------------------------------------------------------------------
    # Parameters as a tree. Every compute method takes `params`, a nested
    # mapping shaped like `self.params` (and like the JAX parameter
    # pytree); None means the module's own weights. The trainer passes
    # its trees (raw or EMA) without touching the module.
    def param_tree(self) -> dict:
        """The module's weights as a tree of detached tensors (shared
        storage, not copies)."""
        return tree_unflatten({k: v.detach()
                               for k, v in tree_flatten(self.params).items()})

    def load_param_tree(self, tree) -> None:
        """Copy a parameter tree (tensors or arrays) into the module."""
        from ..io.model import params_from_jax
        self.load_state_dict(params_from_jax(tree))

    def _factory(self) -> dict:
        first = next(self.parameters())
        return {"device": first.device, "dtype": first.dtype}

    def _init_element(self, element: str, generator, factory) -> dict:
        """Fresh stacks of one element (subclasses add heads)."""
        bias0 = float(self.atomic_static_energy.get(element, 0.0))
        return {"mlp": init_dense_stack(
            generator, self.feature_dim, self.hidden_sizes[element],
            out_dim=1, output_bias=True, output_bias_mean=bias0,
            resnet_dt=self.use_resnet_dt,
            kernel_init=self.kernel_initializer, **factory)}

    def init_params(self, generator: torch.Generator) -> dict:
        """A fresh parameter tree drawn from `generator` (a CPU
        `torch.Generator`; the draws are moved to the module's device
        and dtype): the JAX `init_params` distributions and scales, not
        its bits."""
        factory = self._factory()
        params = {}
        init = getattr(self.descriptor, "init_params", None)
        dparams = init(generator, **factory) if init is not None else {}
        if dparams:
            params["descriptor"] = dparams
        for e in self.elements:
            p = self._init_element(e, generator, factory)
            if self.minmax_scale:
                p["norm"] = minmax_normalize_init(self.feature_dim,
                                                  **factory)
            params[e] = p
        return params

    # ------------------------------------------------------------------
    def descriptors(self, features, params=None) -> torch.Tensor:
        """-> [.., n_vap, D]; `features["descriptors"]`, when given, is
        taken as they are (a committee evaluates them once for all of
        its members, `ensemble.make_ensemble_efs_fn`). `params` (the
        module's own weights when None) carries the descriptor's
        weights, where it has any."""
        if "descriptors" in features:
            return features["descriptors"]
        params = self.params if params is None else params
        f = self.featurizer
        return self.descriptor.compute(
            features, f.rcut, f.acut, f.n_radial_slots, f.n_angular_slots,
            f.angular,
            params=params["descriptor"] if "descriptor" in params else None,
            vap_element_idx=self.vap_element_idx)

    def _element_rows(self, g: torch.Tensor, params):
        """(element net, its min-max scaled descriptor rows [.., cnt, D])
        for every element with rows in the layout, in layout order."""
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0:
                continue
            net = params[e]
            x = g[..., lo:lo + cnt, :]
            if self.minmax_scale:
                x = minmax_normalize_apply(net["norm"], x)
            yield net, x

    def atomic_energies(self, features, params=None) -> torch.Tensor:
        """-> [.., n_vap] atomic energies (zero at padding rows);
        features are one structure's or a batch's ([B, A, ...])."""
        params = self.params if params is None else params
        g = self.descriptors(features, params)
        rows = [g.new_zeros(*g.shape[:-2], 1)]
        for net, x in self._element_rows(g, params):
            layers = net["mlp"]["layers"]
            if self.fixed_static_energy:
                layers = freeze_output_bias(layers)
            rows.append(apply_dense_stack(layers, x,
                                          self.activation)[..., 0])
        return torch.cat(rows, dim=-1) * features["atom_masks"]

    def energy(self, features, params=None) -> torch.Tensor:
        """Total potential energy (a scalar, or [B] for a batch)."""
        return torch.sum(self.atomic_energies(features, params), dim=-1)

    # what forces and stress differentiate; for the plain AtomicNN it IS
    # the energy (the finite-temperature models use the free energy)
    variational_energy = energy

    def energy_and_aux(self, features, params=None):
        """-> (variational energy, by-products of the same pass): what
        `make_dense_efs_fn` / `make_efs_fn` differentiate."""
        atomic = self.atomic_energies(features, params)
        return torch.sum(atomic, dim=-1), {"atomic_energies": atomic}

    # ------------------------------------------------------------------
    # Row-chunked evaluation of large cells: the dense layout in blocks of
    # `atom_chunk` centre rows, each block's descriptors and MLPs under
    # `torch.utils.checkpoint`, so the force and stress backward holds one
    # block's intermediates instead of the whole cell's. Equal to the
    # monolithic energy up to summation order. On the card each block
    # launches the descriptor kernels twice: in the forward, and again
    # when the backward recomputes the block.
    def _chunk_head(self, net, x, features) -> tuple:
        """Per-row outputs of one element's net on its descriptor rows x:
        (atomic energy,)."""
        layers = net["mlp"]["layers"]
        if self.fixed_static_energy:
            layers = freeze_output_bias(layers)
        return (apply_dense_stack(layers, x, self.activation)[..., 0],)

    def row_blocks(self, features, atom_chunk: int):
        """-> [(lo, hi)] row blocks of at most `atom_chunk` centre rows
        covering the dense layout, after the JAX guards."""
        self._check_chunkable(features)
        a_tot = features["pair_j_d"].shape[0]
        chunk = max(1, int(min(atom_chunk, a_tot)))
        return [(lo, min(lo + chunk, a_tot)) for lo in range(0, a_tot, chunk)]

    def block_totals(self, features, trees, lo: int, hi: int
                     ) -> torch.Tensor:
        """-> [K, n_heads]: the masked sums of `_chunk_head` over rows
        lo:hi for each of the K parameter trees `trees`, on one
        evaluation of the block's descriptors (they have no weights
        where rows are chunked)."""
        f, g = self.block_descriptors(features, lo, hi)
        return self.block_heads(f, g, trees, lo, hi)

    def block_descriptors(self, features, lo: int, hi: int) -> tuple:
        """-> (the block's features: rows lo:hi of the dense layout with
        their centres, the block's descriptors [hi - lo, D])."""
        d_keys = [k for k in features if k.endswith("_d")]
        f = {k: v for k, v in features.items() if k not in d_keys}
        f["positions_rows"] = features["positions"][lo:hi]
        f.update({k: features[k][lo:hi] for k in d_keys})
        return f, self.descriptors(f)

    def block_heads(self, features, g, trees, lo: int, hi: int
                    ) -> torch.Tensor:
        """-> [K, n_heads]: `block_totals` on the block's descriptors
        `g`; `features` the block's or the whole structure's."""
        out = []
        for params in trees:
            sums = []
            for e in self.elements:
                elo, cnt = self.layout[e]
                a, b = max(lo, elo), min(hi, elo + cnt)
                if a >= b:
                    continue
                net = params[e]
                x = g[a - lo:b - lo]
                if self.minmax_scale:
                    x = minmax_normalize_apply(net["norm"], x)
                m = features["atom_masks"][a:b]
                sums.append(torch.stack([torch.sum(y * m) for y in
                                         self._chunk_head(net, x, features)]))
            out.append(torch.stack(sums).sum(0))
        return torch.stack(out)

    def _chunked_totals(self, features, params, atom_chunk: int
                        ) -> torch.Tensor:
        """-> [n_heads] masked sums of `_chunk_head` over every row,
        evaluated block by block."""
        from torch.utils.checkpoint import checkpoint
        trees = [self.params if params is None else params]
        return sum(checkpoint(lambda lo, hi: self.block_totals(
            features, trees, lo, hi)[0], lo, hi, use_reentrant=False)
            for lo, hi in self.row_blocks(features, atom_chunk))

    def _check_chunkable(self, features) -> None:
        """The JAX guards of row-chunked evaluation."""
        if getattr(self.descriptor, "algorithm", None) == "nn":
            raise NotImplementedError(
                "chunked evaluation with learned ('nn') GRAP filters "
                "is not supported — the rcov channel indexes the full "
                "VAP layout")
        if getattr(self.descriptor, "backend", "segment") == "segment":
            raise ValueError(
                "energy_chunked requires a dense-layout descriptor "
                "backend ('dense' or 'pallas'); the flat segment "
                "layout cannot be row-chunked")
        if "pair_j_d" not in features:
            raise KeyError("energy_chunked needs the dense layout "
                           "('pair_j_d' ...)")

    def energy_chunked(self, features, params=None,
                       atom_chunk: int = 4096) -> torch.Tensor:
        """Total energy of one structure, evaluated in row blocks."""
        return self._chunked_totals(features, params, atom_chunk)[0]

    def make_chunked_energy_fn(self, atom_chunk: int = 4096):
        """-> fn(features, params=None): the chunked variational energy
        (what large-cell forces and stress differentiate)."""
        return lambda features, params=None: self.energy_chunked(
            features, params, atom_chunk)

    def _stacks(self, params):
        """Every dense stack that carries kernel weights."""
        return [params[e]["mlp"] for e in self.elements]

    def l2_loss(self, params=None) -> torch.Tensor:
        """Sum of squared kernel weights of every stack, the descriptor's
        trainable stacks (the 'nn' filter) included."""
        params = self.params if params is None else params
        stacks = self._stacks(params)
        if "descriptor" in params:
            stacks += [stack for stack in params["descriptor"].values()
                       if "layers" in stack]
        return sum(l2_of_stack(stack) for stack in stacks)

    # ------------------------------------------------------------------
    def norm_sweep_bytes_per_structure(self, feats) -> int:
        """Working-set estimate (bytes) of ONE structure inside a batched
        descriptor evaluation; the trainer chunks the whole-set min/max
        sweep by it."""
        if "pair_j_d" in feats:
            sh = feats["pair_j_d"].shape
            pairs = int(sh[-2]) * int(sh[-1])
        elif "pair_i" in feats:
            pairs = int(feats["pair_i"].shape[-1])
        else:
            return 0
        per_pair = getattr(self.descriptor, "sweep_bytes_per_pair", None)
        total = (pairs * per_pair(self.featurizer.n_radial_slots)
                 if per_pair is not None else pairs * 512)
        if "trip_j_d" in feats:
            sh = feats["trip_j_d"].shape
            triples = int(sh[-2]) * int(sh[-1])
            per_trip = getattr(self.descriptor, "sweep_bytes_per_triple",
                               None)
            total += (triples * per_trip(self.featurizer.n_angular_slots)
                      if per_trip is not None else triples * 256)
        return total

    @torch.no_grad()
    def update_norm_stats(self, params: dict, features_batch) -> dict:
        """Running min/max of the descriptors over a batch -> a new tree
        with the `norm` leaves widened (the other leaves shared)."""
        g = self.descriptors(features_batch, params)   # [B, n_vap, D]
        masks = features_batch["atom_masks"]
        params = {e: dict(params[e]) for e in params}
        for e in self.elements:
            lo, cnt = self.layout[e]
            if cnt == 0 or not self.minmax_scale:
                continue
            ge = g[..., lo:lo + cnt, :].reshape(-1, g.shape[-1])
            me = (masks[..., lo:lo + cnt].reshape(-1) > 0)[:, None]
            inf = torch.full_like(ge, float("inf"))
            big = torch.where(me, ge, -inf).amax(0)
            small = torch.where(me, ge, inf).amin(0)
            norm = params[e]["norm"]
            params[e]["norm"] = {
                "xlo": torch.minimum(norm["xlo"].detach(), small),
                "xhi": torch.maximum(norm["xhi"].detach(), big)}
        return params

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
