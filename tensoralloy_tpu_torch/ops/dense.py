"""Dense per-atom neighbor layout on the device: gathers in, no scatters
(port of `tensoralloy_tpu/ops/dense.py`, row-gather layout only).

The featurizer builds `[A, N]` neighbor and triple tables on the host;
here the geometry is gathered from the positions, kept as three `[A, N]`
component tensors, and forces are assembled through the host-built
transpose tables, so the backward pass is a gather and a row sum too.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..transform.featurizer import SIMG_BASE, SIMG_OFF
from ..nn.fields import full_to_voigt, EV_ANGSTROM3_TO_GPA


def decode_simg(simg: torch.Tensor, dtype: torch.dtype):
    """packed int32 [*] -> (sx, sy, sz) float [*] components."""
    sx = simg % SIMG_BASE - SIMG_OFF
    rest = simg // SIMG_BASE
    sy = rest % SIMG_BASE - SIMG_OFF
    sz = rest // SIMG_BASE - SIMG_OFF
    return (sx.to(dtype), sy.to(dtype), sz.to(dtype))


def shift_dot_cell(simg: torch.Tensor, cell: torch.Tensor, dtype):
    """packed images -> cartesian offset components (sv_x, sv_y, sv_z):
    sv = s @ cell done per component so no [*, 3] array exists."""
    sx, sy, sz = decode_simg(simg, dtype)
    return tuple(sx * cell[0, a] + sy * cell[1, a] + sz * cell[2, a]
                 for a in range(3))


def gather_vec(pos: torch.Tensor, jd: torch.Tensor, simg: torch.Tensor,
               cell: torch.Tensor):
    """Per-pair vectors r_j + S @ cell - r_i as THREE [A, N] component
    tensors, from one row gather `pos[jd]`."""
    sv = shift_dot_cell(simg, cell, pos.dtype)
    g = pos[jd]                                    # [A, N, 3]
    return tuple(g[..., a] + sv[a] - pos[:, a, None] for a in range(3))


def safe_norm_components(vec, eps: float = 1e-14):
    """sqrt(vx^2 + vy^2 + vz^2 + eps): a NaN-free gradient at zero."""
    return torch.sqrt(vec[0] * vec[0] + vec[1] * vec[1]
                      + vec[2] * vec[2] + eps)


def dense_pair_geometry(features, with_unit: bool = True):
    """-> (rij_d [A, N], (ux, uy, uz) [A, N] each or None, islotf_d,
    mask_d).

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
        vec = gather_vec(features["positions"], features["pair_j_d"],
                         features["pair_simg_d"], features["cell"])
    rij = safe_norm_components(vec)
    rij = torch.where(mask > 0, rij, 1.0)
    unit = tuple(v / rij for v in vec) if with_unit else None
    return rij, unit, features["pair_islot_d"], mask


def dense_triple_geometry(features):
    """-> (rij_d, rik_d, rjk_d [A, Nt], aslotf_d, mask_d); masked
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
        vj = gather_vec(pos, features["trip_j_d"],
                        features["trip_simg_j_d"], cell)
        vk = gather_vec(pos, features["trip_k_d"],
                        features["trip_simg_k_d"], cell)
    return (distv(vj), distv(vk),
            distv(tuple(k - j for j, k in zip(vj, vk))),
            features["trip_aslot_d"], mask)


def transpose_reduce(g, trans_idx: torch.Tensor, trans_mask: torch.Tensor):
    """scatter-add(g by index table) as a GATHER + row reduction through
    the host-built transpose table: out[a] = sum_c g.flat[trans_idx[a, c]]
    * trans_mask[a, c]. `g` is a tuple of [A, N] components; they are
    stacked into one [A*N, 3] table fetched by a single row gather."""
    tab = torch.stack([gc.reshape(-1) for gc in g], dim=-1)  # [A*N, 3]
    gt = tab[trans_idx]                                      # [A, C, 3]
    return tuple(torch.sum(gt[..., c] * trans_mask, dim=1)
                 for c in range(len(g)))


def make_dense_efs_fn(energy_fn: Callable,
                      extras_fn: Optional[Callable] = None) -> Callable:
    """Scatter-free E+F+stress for dense-layout descriptor models (the
    JAX `make_dense_efs_fn(energy_fn, extras_fn)` contract).

    `energy_fn(features) -> scalar` is the energy that forces and stress
    differentiate (the variational energy: the free energy of a
    finite-temperature model). It is differentiated w.r.t. the pair and
    triple VECTORS, and forces are assembled exactly:

        dE/dpos_k = sum_{slots of row k} (-g)            (center side)
                  + sum_{slots pointing AT k} g          (neighbor side)

    with the neighbor side read through the featurizer's transpose
    tables. The virial is sum g (x) v per slot. Needs features built
    with `transpose=True`.

    Returns fn(features) -> dict of energy, forces [A, 3], virial and
    stress [3, 3], stress_voigt [6] and total_pressure (GPa), plus what
    `extras_fn(features) -> dict` returns (e.g. atomic energies, the
    finite-temperature heads), all detached. Eager PyTorch does not
    share work between the two calls: the extras are a second forward
    pass, run without autograd."""

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
            energy = energy_fn(f)
            leaves = [c for v in vecs for c in v]
            flat = torch.autograd.grad(energy, leaves)
        grads = [flat[3 * i:3 * i + 3] for i in range(len(vecs))]

        def assemble(g, tidx, tmask):
            rev = transpose_reduce(g, tidx, tmask)
            return tuple(torch.sum(gc, dim=1) - rc
                         for gc, rc in zip(g, rev))

        def outer_virial(g, vv):
            return torch.stack(
                [torch.stack([torch.sum(g[a] * vv[b].detach())
                              for b in range(3)]) for a in range(3)])

        tables = [("pair_trans_d", "pair_trans_mask_d"),
                  ("trip_trans_j_d", "trip_trans_j_mask_d"),
                  ("trip_trans_k_d", "trip_trans_k_mask_d")]
        fc = None
        virial = None
        for g, vv, (tkey, mkey) in zip(grads, vecs, tables):
            fi = assemble(g, features[tkey], features[mkey])
            wi = outer_virial(g, vv)
            fc = fi if fc is None else tuple(a + b for a, b in zip(fc, fi))
            virial = wi if virial is None else virial + wi
        forces = torch.stack(fc, dim=-1)
        volume = torch.clamp(torch.abs(torch.linalg.det(cell)), min=1e-12)
        stress = virial / volume
        out = {"energy": energy.detach(), "forces": forces,
               "virial": virial, "stress": stress,
               "stress_voigt": full_to_voigt(stress),
               "total_pressure": -torch.trace(stress) / 3.0
               * EV_ANGSTROM3_TO_GPA}
        if extras_fn is not None:
            with torch.no_grad():
                out.update(extras_fn(f))
        return out

    return efs
