"""Dense per-atom neighbor layout on the device: gathers in, no scatters
(port of `tensoralloy_tpu/ops/dense.py`, row-gather layout only).

The featurizer builds `[A, N]` neighbor and triple tables on the host;
here the geometry is gathered from the positions, kept as three `[A, N]`
component tensors, and forces are assembled through the host-built
transpose tables, so the backward pass is a gather and a row sum too.
Every function takes one structure's arrays or a batch's (`[B, A, N]`,
as the trainer stacks them): a single structure is a batch of one.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..transform.featurizer import SIMG_BASE, SIMG_OFF, encode_simg_np
from ..nn.fields import stress_outputs


def decode_simg(simg: torch.Tensor, dtype: torch.dtype):
    """packed int32 [*] -> (sx, sy, sz) float [*] components."""
    sx = simg % SIMG_BASE - SIMG_OFF
    rest = simg // SIMG_BASE
    sy = rest % SIMG_BASE - SIMG_OFF
    sz = rest // SIMG_BASE - SIMG_OFF
    return (sx.to(dtype), sy.to(dtype), sz.to(dtype))


def convert_legacy_shifts(feats: dict) -> dict:
    """Host-side upgrade of a feature dict or cache from before the
    packed images: float [A, N, 3] shift arrays -> packed int32 [A, N]
    (`*_simg_*`). No-op when the packed keys already exist."""
    for old, new in (("pair_shift_d", "pair_simg_d"),
                     ("trip_shift_j_d", "trip_simg_j_d"),
                     ("trip_shift_k_d", "trip_simg_k_d")):
        if old in feats and new not in feats:
            feats[new] = encode_simg_np(np.asarray(feats.pop(old)))
    return feats


def shift_dot_cell(simg: torch.Tensor, cell: torch.Tensor, dtype):
    """packed images [B, A, N] and cells [B, 3, 3] -> cartesian offset
    components (sv_x, sv_y, sv_z): sv = s @ cell done per component so no
    [*, 3] array exists."""
    sx, sy, sz = decode_simg(simg, dtype)
    c = cell[:, :, :, None, None]                  # [B, 3, 3, 1, 1]
    return tuple(sx * c[:, 0, a] + sy * c[:, 1, a] + sz * c[:, 2, a]
                 for a in range(3))


def spread_padding(jd: torch.Tensor, mask: torch.Tensor, n_rows: int
                   ) -> torch.Tensor:
    """`jd` with every masked slot pointed at a row of its own spread over
    the `n_rows` rows. The featurizers write row 0 into every padding
    slot; where the positions gather is differentiated, CUDA accumulates
    a run of equal indices serially, so a large padding made one row the
    bottleneck of the backward. The masked slots' values and gradients
    are zero either way."""
    spread = torch.arange(jd.shape[-2] * jd.shape[-1], device=jd.device,
                          dtype=jd.dtype).view(jd.shape[-2:]) % n_rows
    return torch.where(mask > 0, jd, spread)


def _gather_rows(jd: torch.Tensor, mask: torch.Tensor, pos: torch.Tensor):
    """The rows to gather: `jd` itself, or spread off row 0 where the
    positions are differentiated (the masked entries' garbage geometry
    then differs from the reference's; every consumer masks it)."""
    if pos.requires_grad:
        return spread_padding(jd, mask, pos.shape[-2])
    return jd


def gather_vec(pos: torch.Tensor, jd: torch.Tensor, simg: torch.Tensor,
               cell: torch.Tensor, centers=None):
    """Per-pair vectors r_j + S @ cell - r_i as THREE [B, A, N] component
    tensors, from one row gather over the batch's [B * A, 3] positions
    (structure b's neighbor indices are offset by b * A). A single
    structure ([A, 3] positions) is a batch of one. `centers` (the rows
    of a row block, [R, 3] with `jd` [R, N]) defaults to `pos`."""
    if pos.dim() == 2:
        return tuple(v[0] for v in gather_vec(
            pos[None], jd[None], simg[None], cell[None],
            None if centers is None else centers[None]))
    b, a, _ = pos.shape
    c = pos if centers is None else centers
    sv = shift_dot_cell(simg, cell, pos.dtype)
    offset = torch.arange(0, b * a, a, device=pos.device).view(b, 1, 1)
    g = pos.reshape(b * a, 3)[jd + offset]         # [B, R, N, 3]
    return tuple(g[..., k] + sv[k] - c[..., k, None] for k in range(3))


def safe_norm_components(vec, eps: float = 1e-14):
    """sqrt(vx^2 + vy^2 + vz^2 + eps): a NaN-free gradient at zero."""
    return torch.sqrt(vec[0] * vec[0] + vec[1] * vec[1]
                      + vec[2] * vec[2] + eps)


def as_rows(*tensors: torch.Tensor):
    """[.., A, N] tensors -> contiguous [rows, N]: the descriptor kernels
    are row-independent, so a batch is B * A rows of one launch."""
    n = tensors[0].shape[-1]
    return tuple(t.reshape(-1, n).contiguous() for t in tensors)


def dense_pair_geometry(features, with_unit: bool = True):
    """-> (rij_d [.., A, N], (ux, uy, uz) [.., A, N] each or None,
    islotf_d, mask_d), for one structure's features or a batch's.

    Padding entries (mask 0) carry FINITE garbage geometry (they alias
    the virtual-atom row): every consumer must multiply by the mask
    before reducing, which also zeroes their gradients. The unit
    vectors are skipped with `with_unit=False` (the symmetry functions
    read distances only)."""
    if "pair_j_d" not in features:
        raise KeyError("features lack the dense pair layout "
                       "('pair_j_d' ...)")
    mask = features["pair_mask_d"]
    if "pair_vec_d" in features:
        # vector-fed evaluation (`make_dense_efs_fn`)
        vec = features["pair_vec_d"]
    else:
        # a row block (`positions_rows`, the chunked energies) gathers
        # from the full positions
        pos = features["positions"]
        vec = gather_vec(pos, _gather_rows(features["pair_j_d"], mask, pos),
                         features["pair_simg_d"], features["cell"],
                         features.get("positions_rows"))
    rij = safe_norm_components(vec)
    rij = torch.where(mask > 0, rij, 1.0)
    unit = tuple(v / rij for v in vec) if with_unit else None
    return rij, unit, features["pair_islot_d"], mask


def dense_triple_geometry(features):
    """-> (rij_d, rik_d, rjk_d [.., A, Nt], aslotf_d, mask_d); masked
    entries read 1.0."""
    if "trip_j_d" not in features:
        raise KeyError("features lack the dense triple layout "
                       "('trip_j_d' ...)")
    mask = features["trip_mask_d"]

    def distv(v):
        return torch.where(mask > 0, safe_norm_components(v), 1.0)

    if "trip_vec_j_d" in features:      # vector-fed (make_dense_efs_fn)
        vj = features["trip_vec_j_d"]
        vk = features["trip_vec_k_d"]
    else:
        pos, cell = features["positions"], features["cell"]
        centers = features.get("positions_rows")
        vj, vk = (gather_vec(pos, _gather_rows(features[f"trip_{s}_d"],
                                               mask, pos),
                             features[f"trip_simg_{s}_d"], cell, centers)
                  for s in ("j", "k"))
    return (distv(vj), distv(vk),
            distv(tuple(k - j for j, k in zip(vj, vk))),
            features["trip_aslot_d"], mask)


# Calls of the force assembly's two Functions since the last
# `reset_assembly_counts()`, forward and backward, as host integers: a
# dense train step differentiates each of its assemblies once, so it adds
# one "transpose_reduce_bwd" a table (pairs, triples' j and k sides).
assembly_counts: Dict[str, int] = {"transpose_reduce": 0,
                                   "transpose_reduce_bwd": 0,
                                   "forward_gather": 0,
                                   "forward_gather_bwd": 0}


def reset_assembly_counts() -> None:
    for key in assembly_counts:
        assembly_counts[key] = 0


def _row_offsets(b: int, stride: int, device) -> torch.Tensor:
    """[B, 1, 1] offsets of each structure's rows in a batch's flat table."""
    return torch.arange(0, b * stride, stride, device=device).view(b, 1, 1)


class TransposeReduce(torch.autograd.Function):
    """out[b, a, :] = sum_c tab[b].flat[trans_idx[b, a, c], :]
    * trans_mask[b, a, c] for a [B, A, N, K] table. Its backward is
    `ForwardGather` through the forward table (`j`, `mask`), so no order of
    differentiation scatters."""

    @staticmethod
    def forward(ctx, tab, trans_idx, trans_mask, j, mask):
        assembly_counts["transpose_reduce"] += 1
        ctx.save_for_backward(trans_idx, trans_mask, j, mask)
        b, a, n, k = tab.shape
        offset = _row_offsets(b, a * n, tab.device)
        gt = tab.reshape(b * a * n, k)[trans_idx + offset]   # [B, A, C, K]
        return torch.stack([torch.sum(gt[..., c] * trans_mask, dim=-1)
                            for c in range(k)], dim=-1)

    @staticmethod
    def backward(ctx, gout):
        assembly_counts["transpose_reduce_bwd"] += 1
        trans_idx, trans_mask, j, mask = ctx.saved_tensors
        return (ForwardGather.apply(gout, j, mask, trans_idx, trans_mask),
                None, None, None, None)


class ForwardGather(torch.autograd.Function):
    """gin[b, i, s, :] = gout[b, j[b, i, s], :] * mask[b, i, s]: the
    transpose of `TransposeReduce`, which is its backward."""

    @staticmethod
    def forward(ctx, gout, j, mask, trans_idx, trans_mask):
        assembly_counts["forward_gather"] += 1
        ctx.save_for_backward(j, mask, trans_idx, trans_mask)
        b, a, k = gout.shape
        offset = _row_offsets(b, a, gout.device)
        return gout.reshape(b * a, k)[j + offset] * mask[..., None]

    @staticmethod
    def backward(ctx, ggin):
        assembly_counts["forward_gather_bwd"] += 1
        j, mask, trans_idx, trans_mask = ctx.saved_tensors
        return (TransposeReduce.apply(ggin, trans_idx, trans_mask, j, mask),
                None, None, None, None)


def transpose_reduce(g, trans_idx: torch.Tensor, trans_mask: torch.Tensor,
                     j: torch.Tensor, mask: torch.Tensor):
    """scatter-add(g by index table) as a GATHER + row reduction through
    the host-built transpose table: out[a] = sum_c g.flat[trans_idx[a, c]]
    * trans_mask[a, c], per structure. `g` is a tuple of [B, A, N]
    components (or [A, N]: a batch of one), stacked into one [B, A, N, 3]
    table; structure b's indices are offset by b * A * N.

    `j` and `mask` are the forward table the transpose table inverts
    (`pair_j_d` / `pair_mask_d`, `trip_j_d` or `trip_k_d` /
    `trip_mask_d`). The backward rests on the featurizer's contract: over
    the masked entries the transpose table is the inverse of the forward
    table, every real slot p appearing once, in row j.flat[p]. So the
    gradient w.r.t. g is the gather gout[j] * mask, with no accumulation."""
    if trans_idx.dim() == 2:
        return tuple(r[0] for r in transpose_reduce(
            [gc[None] for gc in g], trans_idx[None], trans_mask[None],
            j[None], mask[None]))
    tab = torch.stack(tuple(g), dim=-1)                      # [B, A, N, 3]
    return TransposeReduce.apply(tab, trans_idx, trans_mask, j,
                                 mask).unbind(-1)


def make_dense_efs_fn(energy_fn: Callable,
                      create_graph: bool = False) -> Callable:
    """Scatter-free E+F+stress for dense-layout descriptor models (the
    JAX `make_dense_efs_fn` contract, with the by-products returned by
    the differentiated pass itself, as `jax.value_and_grad(...,
    has_aux=True)`).

    `energy_fn(features) -> (energy, aux)`: `energy` is what forces and
    stress differentiate (the variational energy: the free energy of a
    finite-temperature model), a scalar for one structure or [B] for a
    batch; `aux` is a dict of by-products of the same pass (atomic
    energies, the finite-temperature heads). The energy is
    differentiated w.r.t. the pair and triple VECTORS, and forces are
    assembled exactly:

        dE/dpos_k = sum_{slots of row k} (-g)            (center side)
                  + sum_{slots pointing AT k} g          (neighbor side)

    with the neighbor side read through the featurizer's transpose
    tables. The virial is sum g (x) v per slot. Needs features built
    with `transpose=True`.

    Returns fn(features) -> dict of energy, forces [.., A, 3], virial and
    stress [.., 3, 3], stress_voigt [.., 6] and total_pressure (GPa),
    updated with `aux` (so a finite-temperature model's 'energy' is its
    internal energy U and 'free_energy' what was differentiated). With
    `create_graph` the outputs stay in the autograd graph, so a loss on
    the forces can be differentiated w.r.t. the model's parameters;
    without it everything is returned detached and no graph is kept."""

    def efs(features) -> Dict[str, torch.Tensor]:
        pos = features["positions"]
        cell = features["cell"]
        angular = "trip_j_d" in features
        if "pair_trans_d" not in features:
            raise KeyError(
                "make_dense_efs_fn needs the featurizer's transpose "
                "tables — featurize with transpose=True")
        if angular and "trip_trans_j_d" not in features:
            # without the triple transpose tables the 3-body force
            # contributions would be silently dropped
            raise KeyError(
                "features carry dense triples but no trip_trans "
                "tables — featurize with transpose=True")
        specs = [("pair_vec_d", "pair_j_d", "pair_simg_d")]
        if angular:
            specs += [("trip_vec_j_d", "trip_j_d", "trip_simg_j_d"),
                      ("trip_vec_k_d", "trip_k_d", "trip_simg_k_d")]
        f = dict(features)
        vecs = []
        for key, jkey, skey in specs:
            with torch.no_grad():
                v = gather_vec(pos, features[jkey], features[skey], cell)
            v = tuple(c.requires_grad_() for c in v)
            f[key] = v
            vecs.append(v)

        with torch.enable_grad():
            energy, aux = energy_fn(f)
            leaves = [c for v in vecs for c in v]
            flat = torch.autograd.grad(energy.sum(), leaves,
                                       create_graph=create_graph)
        grads = [flat[3 * i:3 * i + 3] for i in range(len(vecs))]

        def assemble(g, tidx, tmask, jd, mask):
            rev = transpose_reduce(g, tidx, tmask, jd, mask)
            return tuple(torch.sum(gc, dim=-1) - rc
                         for gc, rc in zip(g, rev))

        def outer_virial(g, vv):
            return torch.stack(
                [torch.stack([torch.sum(g[a] * vv[b].detach(),
                                        dim=(-2, -1))
                              for b in range(3)], dim=-1)
                 for a in range(3)], dim=-2)

        tables = [("pair_trans_d", "pair_trans_mask_d", "pair_j_d",
                   "pair_mask_d"),
                  ("trip_trans_j_d", "trip_trans_j_mask_d", "trip_j_d",
                   "trip_mask_d"),
                  ("trip_trans_k_d", "trip_trans_k_mask_d", "trip_k_d",
                   "trip_mask_d")]
        fc = None
        virial = None
        for g, vv, keys in zip(grads, vecs, tables):
            fi = assemble(g, *(features[key] for key in keys))
            wi = outer_virial(g, vv)
            fc = fi if fc is None else tuple(a + b for a, b in zip(fc, fi))
            virial = wi if virial is None else virial + wi
        out = {"energy": energy, "forces": torch.stack(fc, dim=-1),
               **stress_outputs(virial, cell), **aux}
        if not create_graph:
            out = {k: v.detach() for k, v in out.items()}
        return out

    return efs
