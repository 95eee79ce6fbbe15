"""Deep-ensemble inference and uncertainty-driven sampling (port of
`tensoralloy_tpu/ensemble.py`).

K independently trained members of ONE architecture answer a request
together: the structure is featurized once, a descriptor model's
descriptors are evaluated once (one launch of each descriptor kernel on
the card) and shared by the K members' heads, and the K members' forces
and stress come from one batched vector-Jacobian product, split at the
descriptors: the K one-hot cotangents of the stacked energies give the
K descriptor cotangents [K, A, F] through the heads
(`torch.autograd.grad(..., is_grads_batched=True)`), each descriptor
kernel's VJP kernel takes them in one launch (B = K,
`ops.fused.descriptor_vjp`), and the geometry carries the result to the
vectors or positions. A descriptor with weights of its own (GRAP's
learned 'nn' filter, which has no kernel) is evaluated once per member,
with that member's weights, and differentiated in one batched VJP
throughout. The EAM family has no shared stage: each member's analytic
EFS runs on the shared features.

The chunked large-cell route (`chunked`, as the calculator routes it)
takes the dense layout in row blocks: per block the descriptors once
(`model.block_descriptors`), the K members' heads on them
(`model.block_heads`), and the same split batched VJP of the block's K
energies, accumulated over the blocks; the block's graph is freed
before the next block, so each descriptor kernel and its VJP kernel
launch once a block.

With `n_shards` ranks of a `torch.distributed` group, each rank takes
its contiguous block of K / n_shards members (its own batched VJP over
them) and the members' outputs ([K] energies, [K, A, 3] forces, ...) are
gathered, so the mean and the disagreement are computed replicated on
every rank; the chunked route shards the same way.

`EnsembleCalculator` returns the ensemble mean for every property of
`TensorAlloyCalculator` plus uncertainty channels (`energy_std`,
`forces_std`, per-atom force disagreement); `select_by_uncertainty`
is the active-learning selection step.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .atoms import Structure
from .calculator import TensorAlloyCalculator
from .nn.fields import stress_outputs
from .ops.dense import gather_vec, transpose_reduce
from .ops.fused import descriptor_vjp, record_calls
from .precision import resolve_device, resolve_dtype

__all__ = ["make_ensemble_efs_fn", "EnsembleCalculator",
           "select_by_uncertainty"]


def _member_grads(model, trees: Sequence[dict]) -> Callable:
    """fn(features, leaves) -> (energies [K], by-products stacked over K,
    the K energies' gradients w.r.t. each of `leaves` [K, *leaf.shape]),
    the leaves being what `features` was computed from. Shared
    descriptors are evaluated once and the gradients split at them
    (module docstring); otherwise one batched VJP throughout."""
    shared = hasattr(model, "descriptors") and not any(
        "descriptor" in tree for tree in trees)

    def heads(features):
        outs = [model.energy_and_aux(features, tree) for tree in trees]
        aux = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
        return torch.stack([o[0] for o in outs]), aux

    def grads(features, leaves):
        with torch.enable_grad():
            if not shared:
                e, aux = heads(features)
                return e, aux, _one_hot_grad(e, leaves)
            with record_calls() as calls:
                g = model.descriptors(features)
            g_leaf = g.detach().requires_grad_()
            e, aux = heads(dict(features, descriptors=g_leaf))
            g_bar, = _one_hot_grad(e, [g_leaf])
            return e, aux, descriptor_vjp(g, g_bar, calls, leaves)

    return grads


def _one_hot_grad(e: torch.Tensor, leaves) -> tuple:
    """The gradients of each of the K entries of `e` w.r.t. `leaves`, by
    one VJP batched over the K one-hot cotangents."""
    eye = torch.eye(len(e), dtype=e.dtype, device=e.device)
    return torch.autograd.grad(e, leaves, eye, is_grads_batched=True)


def make_ensemble_efs_fn(model, trees: Sequence[dict],
                         transpose: bool = True) -> Callable:
    """fn(features) -> the `make_dense_efs_fn` / `make_efs_fn` outputs of
    every member, stacked along a leading K axis (energy [K], forces
    [K, A, 3], stress [K, 3, 3], stress_voigt [K, 6], total_pressure [K],
    the by-products [K, ...]). `trees` are the members' parameter trees
    over `model`'s architecture.

    `transpose=True` differentiates w.r.t. the dense pair and triple
    vectors and assembles the forces through the featurizer's transpose
    tables (the calculator's route on host lists); otherwise w.r.t.
    positions and cell (device-built lists, the flat pair layout)."""
    member_grads = _member_grads(model, trees)
    k = len(trees)

    def efs_vectors(features) -> Dict[str, torch.Tensor]:
        pos, cell = features["positions"], features["cell"]
        specs = [("pair_vec_d", "pair_j_d", "pair_simg_d",
                  "pair_trans_d", "pair_trans_mask_d", "pair_mask_d")]
        if "trip_j_d" in features:
            specs += [("trip_vec_j_d", "trip_j_d", "trip_simg_j_d",
                       "trip_trans_j_d", "trip_trans_j_mask_d",
                       "trip_mask_d"),
                      ("trip_vec_k_d", "trip_k_d", "trip_simg_k_d",
                       "trip_trans_k_d", "trip_trans_k_mask_d",
                       "trip_mask_d")]
        f = dict(features)
        vecs = []
        for key, jkey, skey, *_ in specs:
            with torch.no_grad():
                v = gather_vec(pos, features[jkey], features[skey], cell)
            f[key] = tuple(c.requires_grad_() for c in v)
            vecs.append(f[key])
        e, aux, flat = member_grads(f, [c for v in vecs for c in v])
        forces = 0.0
        virial = 0.0
        for i, (_, jkey, _, tkey, mkey, fmkey) in enumerate(specs):
            g = flat[3 * i:3 * i + 3]                      # [K, A, N] each
            rev = transpose_reduce(g, *(
                features[key].expand((k,) + features[key].shape)
                for key in (tkey, mkey, jkey, fmkey)))
            forces = forces + torch.stack(
                [torch.sum(gc, dim=-1) - rc for gc, rc in zip(g, rev)],
                dim=-1)
            vv = vecs[i]
            virial = virial + torch.stack(
                [torch.stack([torch.sum(g[a] * vv[b].detach(),
                                        dim=(-2, -1)) for b in range(3)],
                             dim=-1) for a in range(3)], dim=-2)
        out = {"energy": e, "forces": forces,
               **stress_outputs(virial, cell), **aux}
        return {key: v.detach() for key, v in out.items()}

    def efs_positions(features) -> Dict[str, torch.Tensor]:
        pos = features["positions"].detach().requires_grad_()
        cell = features["cell"].detach().requires_grad_()
        e, aux, (gpos, gcell) = member_grads(
            dict(features, positions=pos, cell=cell), (pos, cell))
        virial = (gpos.transpose(-1, -2) @ pos.detach()
                  + gcell.transpose(-1, -2) @ cell.detach())
        out = {"energy": e, "forces": -gpos,
               **stress_outputs(virial, cell.detach()), **aux}
        return {key: v.detach() for key, v in out.items()}

    return efs_vectors if transpose else efs_positions


def make_chunked_ensemble_efs_fn(model, trees: Sequence[dict],
                                 atom_chunk: int = 4096) -> Callable:
    """fn(features) -> the K members' energy [K], forces [K, A, 3] and
    stress of one structure on the dense layout, evaluated in row blocks
    of `atom_chunk` centre rows: each block's descriptors once
    (`model.block_descriptors`), the K members' heads on them
    (`model.block_heads`), and the K variational energies differentiated
    w.r.t. positions and cell by one batched VJP split at the
    descriptors (`ops.fused.descriptor_vjp`), the gradients accumulated.
    A finite-temperature model adds its totals U ('energy'), S and F."""
    finite_t = hasattr(model, "heads_chunked")

    def efs(features) -> Dict[str, torch.Tensor]:
        pos0, cell0 = features["positions"].detach(), \
            features["cell"].detach()
        gpos, gcell, totals = 0.0, 0.0, 0.0
        for lo, hi in model.row_blocks(features, atom_chunk):
            pos = pos0.clone().requires_grad_()
            cell = cell0.clone().requires_grad_()
            with torch.enable_grad():
                with record_calls() as calls:
                    f, g = model.block_descriptors(
                        dict(features, positions=pos, cell=cell), lo, hi)
                g_leaf = g.detach().requires_grad_()
                t = model.block_heads(f, g_leaf, trees, lo, hi)  # [K, heads]
                e = t[:, 0]
                if finite_t:
                    e = e - f["etemperature"].to(e.dtype) * t[:, 1]
                g_bar, = _one_hot_grad(e, [g_leaf])
                gp, gc = descriptor_vjp(g, g_bar, calls, (pos, cell))
            gpos, gcell = gpos + gp, gcell + gc
            totals = totals + t.detach()
        virial = (gpos.transpose(-1, -2) @ pos0
                  + gcell.transpose(-1, -2) @ cell0)
        out = {"forces": -gpos, **stress_outputs(virial, cell0)}
        out["energy"] = totals[:, 0]
        if finite_t:
            temp = features["etemperature"].to(totals.dtype)
            out["eentropy"] = totals[:, 1]
            out["free_energy"] = totals[:, 0] - temp * totals[:, 1]
        return out

    return efs


def _make_fast_ensemble_fn(model, trees: Sequence[dict]) -> Callable:
    """The EAM family's analytic EFS of each member, stacked over K."""
    from .nn.eam.fast_efs import make_fast_efs_fn
    fast = make_fast_efs_fn(model)

    def efs(features) -> Dict[str, torch.Tensor]:
        outs = [fast(features, tree) for tree in trees]
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return efs


def _make_member_chunked_fn(model, trees: Sequence[dict],
                            chunk: int) -> Callable:
    """The EAM family's chunked EFS of each member (its flat pair
    blocks), stacked over K."""
    from .nn.fields import make_efs_fn
    e_fn = model.make_chunked_energy_fn(chunk)
    fns = [make_efs_fn(lambda f, tree=tree: (e_fn(f, tree), {}))
           for tree in trees]

    def efs(features) -> Dict[str, torch.Tensor]:
        outs = [fn(features) for fn in fns]
        return {key: torch.stack([o[key] for o in outs]) for key in outs[0]}

    return efs


class EnsembleCalculator(TensorAlloyCalculator):
    """Mean + disagreement over K members of ONE architecture.

    Construct from a list of saved-model paths (the featurizers must
    match, as the JAX class checks; the members' parameters differ by
    training seed or replica) or from a list of K models on one device
    in one dtype. The first member's model (its descriptor included)
    serves the shared stages; the others contribute their parameters.
    All `TensorAlloyCalculator` getters return the ensemble MEAN;
    `get_energy_std`, `get_forces_std`, `get_max_force_std` expose the
    disagreement. `device`, `dtype` and `backend` load the paths as the
    calculator does; `fast_efs`, `device_nl` and `chunked` route as
    there. `n_shards > 1` splits the members over that many ranks of the
    current `torch.distributed` group (module docstring); the members
    must divide evenly and the group must have the ranks (ValueError
    otherwise)."""

    def __init__(self, members: Sequence, n_shards: int = 1, *,
                 device="cuda", dtype="high", backend=None,
                 chunked: "bool | str" = "auto", **kwargs):
        members = list(members)
        if len(members) < 2:
            raise ValueError("an ensemble needs at least 2 members")
        from .parallel.mesh import group_size, make_mesh
        if n_shards > 1:
            if len(members) % n_shards:
                raise ValueError(
                    f"{len(members)} members not divisible by "
                    f"n_shards={n_shards}")
            if n_shards > group_size():
                raise ValueError(
                    f"n_shards={n_shards} > available devices")
        self.mesh = make_mesh(n_shards, axis_name="member")
        if all(isinstance(m, str) for m in members):
            from .io.model import load_model
            device, dtype = resolve_device(device), resolve_dtype(dtype)
            members = [load_model(p, device=device, dtype=dtype,
                                  backend=backend)[0] for p in members]
        elif backend is not None:
            raise ValueError("backend= applies to saved model paths; set "
                             "the descriptor's backend on the models")
        a0 = members[0].featurizer.as_dict()
        for m in members[1:]:
            if m.featurizer.as_dict() != a0:
                raise ValueError(
                    "ensemble members disagree on the featurizer "
                    "(elements/cutoffs) — they are not one architecture")
        super().__init__(members[0], device=device, dtype=dtype,
                         chunked=chunked, **kwargs)
        for m in members:
            m.requires_grad_(False)
        self.member_trees: List[dict] = [m.param_tree() for m in members]
        self.n_members = len(members)
        # this rank's members
        self._trees = self.member_trees[self.mesh.block(self.n_members)]

    def _get_variant(self, structure: Structure, use_device: bool = False):
        occurs = self._bucketed_occurs(structure)
        key = (tuple(sorted(occurs.items())), bool(use_device))
        hit = self._variant_cache.get(key)
        if hit is None:
            model = self.model.clone_for(occurs)
            trees = self._trees
            if self.fast_efs:
                efs = _make_fast_ensemble_fn(model, trees)
            else:
                efs = make_ensemble_efs_fn(
                    model, trees,
                    transpose=self.layout == "dense" and not use_device)
            efs_chunked = None
            if self.chunked and self.can_chunk(model):   # "auto" or True
                if getattr(model, "descriptor", None) is None:
                    efs_chunked = _make_member_chunked_fn(
                        model, trees, self.chunk_rows())
                else:
                    efs_chunked = make_chunked_ensemble_efs_fn(
                        model, trees, self.chunk_rows())
            efs = self._gathered(efs)
            efs_chunked = efs_chunked and self._gathered(efs_chunked)
            hit = (model, efs, efs_chunked)
            self._variant_cache[key] = hit
        return hit

    def _gathered(self, efs: Callable) -> Callable:
        """`efs` of this rank's members -> every member's outputs (`efs`'s
        own on a mesh without a group)."""
        from .parallel.collectives import all_gather

        def run(features) -> Dict[str, torch.Tensor]:
            return {k: all_gather(v, self.mesh)
                    for k, v in efs(features).items()}
        return run

    @staticmethod
    def _assemble(out, vap) -> Dict[str, np.ndarray]:
        forces_k = out["forces"]                       # [K, n_vap, 3]
        energy_k = out["energy"]                       # [K]
        stress_k = out["stress_voigt"]
        results = {
            "energy": float(energy_k.mean()),
            "free_energy": float(out.get("free_energy", energy_k).mean()),
            "forces": vap.reverse_map(forces_k.mean(axis=0)),
            "stress": stress_k.mean(axis=0),
            "pressure": float(out["total_pressure"].mean()),
            "energy_std": float(energy_k.std(axis=0)),
            # per-atom std of the force VECTOR (norm over xyz of the
            # component-wise std): the usual query-by-committee score
            "forces_std": np.linalg.norm(
                vap.reverse_map(forces_k.std(axis=0)), axis=1),
            "stress_std": stress_k.std(axis=0),
        }
        if "atomic_energies" in out:
            results["atomic_energies"] = vap.reverse_map(
                out["atomic_energies"].mean(axis=0))
        if "eentropy" in out:           # finite-temperature heads
            results["eentropy"] = float(out["eentropy"].mean())
        return results

    # ------------------------------------------------------------------
    def get_energy_std(self, structure: Structure = None) -> float:
        return self._maybe_calculate(structure)["energy_std"]

    def get_forces_std(self, structure: Structure = None) -> np.ndarray:
        """[n_atoms] committee disagreement per atom (eV/A)."""
        return self._maybe_calculate(structure)["forces_std"]

    def get_max_force_std(self, structure: Structure = None) -> float:
        return float(self._maybe_calculate(structure)["forces_std"].max())

    def get_hessian(self, structure, phonopy_format: bool = False):
        raise NotImplementedError(
            "ensemble Hessians are not reduced — evaluate a member "
            "with TensorAlloyCalculator on one parameter set")


def select_by_uncertainty(calc: EnsembleCalculator,
                          structures: List[Structure],
                          n_select: int = 0,
                          threshold: float = 0.0) -> List[int]:
    """Active-learning selection: rank `structures` by the committee's
    max per-atom force disagreement, descending. Returns the indices of
    the top `n_select` (all, if 0) whose score exceeds `threshold`."""
    scores = [calc.get_max_force_std(s) for s in structures]
    order = sorted(range(len(structures)), key=lambda i: -scores[i])
    picked = [i for i in order if scores[i] >= threshold]
    return picked[:n_select] if n_select else picked
