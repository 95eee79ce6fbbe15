"""Spatial (pair-axis) parallelism for single large structures (port of
`tensoralloy_tpu/parallel/spatial.py`).

One structure's PAIR and TRIPLE arrays are split over the ranks while
positions, the cell and every per-atom array stay whole on each. Under
XLA's SPMD the JAX package let the partitioner insert the `psum`; here
it is explicit. Every per-atom accumulation over the pair axis (the EAM
family's `_segment_sum`: rho, ADP's dipole and quadrupole sums, the pair
energy; `nn.sf.segment_rows`, which also carries GRAP's P sums) passes
through `ops.pairs.reduce_rows`, and a `row_reduction` context makes
that the sum over the ranks (`collectives.psum`: sum forward, identity
backward) before any nonlinear stage. The energy is then the same on
every rank, each rank's gradient is the share of its own pairs, and one
all-reduce of the position gradient and the virial completes forces and
stress. Flat triples carry their own atom indices and shifts, so pair
and triple shards are independent.

The dense (scatter-free) fast EAM path shards the neighbor COLUMNS of
the [n_vap, nnl] rows instead; `nn.eam.fast_efs` sums its row
reductions through its `reduce` argument.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..nn.fields import make_efs_fn, stress_outputs
from ..ops.pairs import row_reduction
from .collectives import all_reduce, all_reduce_many, psum
from .mesh import Mesh

# feature keys whose LEADING axis is the pair / triple dimension. Dense
# columns ("*_d") are per-atom [n_vap, nnl] arrays and stay whole here.
_PAIR_PREFIXES = ("pair_", "trip_", "rij")


def is_pairwise_key(key: str) -> bool:
    return (any(key.startswith(p) for p in _PAIR_PREFIXES)
            and not key.endswith("_d"))


def _is_dense_key(key: str, value) -> bool:
    return (key.startswith(("pair_", "trip_")) and key.endswith("_d")
            and np.ndim(value) >= 2)


def _pad(value, axis: int, rem: int):
    """`value` (numpy or tensor) with `rem` zero entries appended along
    `axis`."""
    if isinstance(value, torch.Tensor):
        shape = list(value.shape)
        shape[axis] = rem
        return torch.cat([value, value.new_zeros(shape)], dim=axis)
    width = [(0, 0)] * np.ndim(value)
    width[axis] = (0, rem)
    return np.pad(np.asarray(value), width)


def pad_pair_axis(feats: Dict, multiple: int) -> Dict:
    """Pad every pair/triple array's leading axis to a multiple of the
    mesh size with zeros: a padding entry names row 0 (the virtual atom)
    with mask 0, as the featurizer's own padding does."""
    out = dict(feats)
    for k, v in feats.items():
        if not is_pairwise_key(k) or np.ndim(v) == 0:
            continue
        rem = (-v.shape[0]) % multiple
        if rem:
            out[k] = _pad(v, 0, rem)
    return out


def shard_features_spatial(feats: Dict, mesh: Mesh,
                           axis_name: str = "pairs") -> Dict:
    """This rank's features: its block of every pair/triple array
    (padded to a multiple of the mesh first), everything else
    (positions, cell, per-atom arrays, scalars) whole. Numpy arrays or
    tensors, returned as given."""
    feats = pad_pair_axis(feats, mesh.size)
    return {k: v[mesh.block(v.shape[0])]
            if is_pairwise_key(k) and np.ndim(v) > 0 else v
            for k, v in feats.items()}


def make_spatial_efs_fn(energy_fn: Callable, mesh: Mesh,
                        axis_name: str = "pairs") -> Callable:
    """An EFS function whose pair work is split over the mesh.

    `energy_fn(features, params) -> energy` (a model's `energy`). Returns
    fn(params, local_features) -> energy, forces, virial, stress,
    stress_voigt, total_pressure, the same on every rank; pass the
    features through `shard_features_spatial` first."""
    def reduce(x):
        return psum(x, mesh)

    def efs(params, features) -> Dict[str, torch.Tensor]:
        fn = make_efs_fn(lambda f: (energy_fn(f, params), {}))
        with row_reduction(reduce):
            out = fn(features)
        forces, virial = all_reduce_many([out["forces"], out["virial"]],
                                         mesh)
        return {"energy": out["energy"], "forces": forces,
                **stress_outputs(virial, features["cell"])}

    return efs


def _pad_dense_columns(feats: Dict, multiple: int) -> Dict:
    """Pad the COLUMN (neighbor) axis of dense [n_vap, nnl, ...] arrays
    to a multiple of the mesh size. Padded columns reproduce the
    featurizer's padding exactly (index 0, mask 0). Transpose tables
    encode FLAT indices `row * width + col`, so when the source width
    changes they are remapped to the new stride (corrupt silently
    otherwise)."""
    out = dict(feats)
    widths = {}
    for k, v in feats.items():
        if not _is_dense_key(k, v):
            continue
        rem = (-v.shape[1]) % multiple
        if rem:
            out[k] = _pad(v, 1, rem)
        widths[k] = (v.shape[1], v.shape[1] + rem)
    for trans_key, src_key in (("pair_trans_d", "pair_j_d"),
                               ("trip_trans_j_d", "trip_j_d"),
                               ("trip_trans_k_d", "trip_j_d")):
        if trans_key not in out or src_key not in widths:
            continue
        old_w, new_w = widths[src_key]
        if old_w == new_w:
            continue
        t = out[trans_key]
        out[trans_key] = (t // old_w) * new_w + t % old_w
    return out


def shard_features_spatial_dense(feats: Dict, mesh: Mesh,
                                 axis_name: str = "pairs") -> Dict:
    """Spatial sharding of the DENSE layout (the scatter-free fast
    paths): this rank's block of the [n_vap, nnl] neighbor-column axis of
    every dense array, everything else whole. The column widths are
    power-of-two buckets, so any mesh size divides after padding."""
    feats = _pad_dense_columns(feats, mesh.size)
    return {k: v[:, mesh.block(v.shape[1])] if _is_dense_key(k, v) else v
            for k, v in feats.items()}


def make_spatial_fast_efs_fn(model, mesh: Mesh) -> Callable:
    """The scatter-free analytic EFS of an EAM-family model
    (`nn.eam.fast_efs`) over column-sharded dense features
    (`shard_features_spatial_dense`): fn(params, local_features) ->
    the `make_fast_efs_fn` outputs, the same on every rank."""
    from ..nn.eam.fast_efs import make_fast_efs_fn
    fast = make_fast_efs_fn(model, reduce=lambda x: all_reduce(x, mesh))
    return lambda params, features: fast(features, params)
