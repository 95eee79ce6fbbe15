"""Derived physical properties by autograd (port of
`tensoralloy_tpu/nn/fields.py`).

  forces  F = -dE/dR
  virial  W = (dE/dR)^T R + (dE/dh)^T h        (h = cell rows)
  stress  sigma = W / V (eV/A^3), Voigt order [xx, yy, zz, yz, xz, xy]
  total pressure P = -tr(sigma)/3 in GPa

`make_efs_fn` differentiates w.r.t. positions and cell (the EAM family's
route on the flat pair layout, and the trainer's where a batch carries
no transpose tables); the calculator serves descriptor models through
the scatter-free `ops.dense.make_dense_efs_fn`, and the tests hold the
two against each other. `make_hessian_fn` gives the force constants
that `nn.constraints.ForceConstantsConstraint` fits and the calculator's
`get_hessian`. `make_rij_efs_fn` differentiates w.r.t. displacement
vectors that the caller supplies (the contract of an external MD
engine).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

# eV/A^3 -> GPa
EV_ANGSTROM3_TO_GPA = 160.21766208
GPa = 1.0 / EV_ANGSTROM3_TO_GPA  # 1 GPa in eV/A^3


def full_to_voigt(s: torch.Tensor) -> torch.Tensor:
    return torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
                        0.5 * (s[..., 1, 2] + s[..., 2, 1]),
                        0.5 * (s[..., 0, 2] + s[..., 2, 0]),
                        0.5 * (s[..., 0, 1] + s[..., 1, 0])], dim=-1)


def stress_outputs(virial: torch.Tensor, cell: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """virial [.., 3, 3], cell [.., 3, 3] -> virial, stress = W / V,
    stress_voigt and total_pressure (GPa)."""
    volume = torch.clamp(torch.abs(torch.linalg.det(cell)), min=1e-12)
    stress = virial / volume[..., None, None]
    trace = stress.diagonal(dim1=-2, dim2=-1).sum(-1)
    return {"virial": virial, "stress": stress,
            "stress_voigt": full_to_voigt(stress),
            "total_pressure": -trace / 3.0 * EV_ANGSTROM3_TO_GPA}


def make_efs_fn(energy_fn: Callable, create_graph: bool = False
                ) -> Callable:
    """`energy_fn(features) -> (energy, aux)`, differentiated w.r.t.
    positions and cell (the JAX `make_efs_fn` contract, with the
    by-products `aux` returned by the differentiated pass itself).
    `energy` is a scalar for one structure or [B] for a batch.

    Returns fn(features) -> dict with energy, forces [.., A, 3], virial
    and stress [.., 3, 3], stress_voigt [.., 6] and total_pressure (GPa),
    updated with `aux`. With `create_graph` the outputs stay in the
    autograd graph (a loss on the forces can be differentiated w.r.t.
    the model's parameters); without it all are detached."""

    def efs(features) -> Dict[str, torch.Tensor]:
        pos = features["positions"].detach().requires_grad_()
        cell = features["cell"].detach().requires_grad_()
        f = dict(features, positions=pos, cell=cell)
        with torch.enable_grad():
            energy, aux = energy_fn(f)
            gpos, gcell = torch.autograd.grad(energy.sum(), (pos, cell),
                                              create_graph=create_graph)
        virial = (gpos.transpose(-1, -2) @ pos.detach()
                  + gcell.transpose(-1, -2) @ cell.detach())
        out = {"energy": energy, "forces": -gpos,
               **stress_outputs(virial, cell.detach()), **aux}
        if not create_graph:
            out = {k: v.detach() for k, v in out.items()}
        return out

    return efs


def make_hessian_fn(energy_fn: Callable, create_graph: bool = False
                    ) -> Callable:
    """`energy_fn(features) -> (energy, aux)` of one structure ->
    fn(features) -> the Hessian d^2E/dpos^2 [A, 3, A, 3] (the JAX
    `make_hessian_fn`), one backward pass per row. With `create_graph`
    it stays in the autograd graph (a loss on it can be differentiated
    w.r.t. the model's parameters)."""

    def hess(features) -> torch.Tensor:
        pos = features["positions"].detach().requires_grad_()
        f = dict(features, positions=pos)
        with torch.enable_grad():
            energy, _ = energy_fn(f)
            grad, = torch.autograd.grad(energy, pos, create_graph=True)
            flat = grad.reshape(-1)
            rows = [torch.autograd.grad(flat[i], pos, retain_graph=True,
                                        create_graph=create_graph)[0]
                    for i in range(flat.numel())]
        h = torch.stack(rows).reshape(pos.shape + pos.shape)
        return h if create_graph else h.detach()

    return hess


def make_rij_efs_fn(energy_fn: Callable) -> Callable:
    """rij-fed evaluation (the JAX `make_rij_efs_fn`): the caller supplies
    the displacement vectors ("rij" [nij, 3] of the flat pair layout, and
    "trip_rij" / "trip_rik" for angular models) and the energy is
    differentiated w.r.t. them; positions and cell stay out of the graph.
    `energy_fn(features) -> (energy, aux)` of one structure.

    Returns fn(features) -> dict with energy, pair_forces dE/drij
    [nij, 3] (what an engine accumulates itself), the forces [n_vap, 3]
    assembled from them (F_i = sum over pairs centred at i - sum over
    pairs pointing at i), the virial W = sum_p g_p (x) rij_p, stress and
    stress_voigt; with triples also trip_rij_forces / trip_rik_forces.
    """

    def efs(features) -> Dict[str, torch.Tensor]:
        keys = [k for k in ("rij", "trip_rij", "trip_rik") if k in features]
        vecs = [features[k].detach().requires_grad_() for k in keys]
        with torch.enable_grad():
            energy, _ = energy_fn(dict(features, **dict(zip(keys, vecs))))
            grads = dict(zip(keys, torch.autograd.grad(energy, vecs)))
        n_vap = features["positions"].shape[0]

        def seg(v, index_key):
            out = v.new_zeros((n_vap, 3))
            return out.index_add(0, features[index_key].long(), v)

        g = grads["rij"]
        forces = seg(g, "pair_i") - seg(g, "pair_j")
        virial = g.T @ features["rij"]
        out = {"energy": energy.detach(), "pair_forces": g}
        for gk, (src, dst) in (("trip_rij", ("trip_i", "trip_j")),
                               ("trip_rik", ("trip_i", "trip_k"))):
            if gk in grads:
                gt = grads[gk]
                forces = forces + seg(gt, src) - seg(gt, dst)
                virial = virial + gt.T @ features[gk]
                out[f"{gk}_forces"] = gt
        volume = torch.clamp(torch.abs(torch.linalg.det(features["cell"])),
                             min=1e-12)
        stress = virial / volume
        out.update({"forces": forces, "virial": virial, "stress": stress,
                    "stress_voigt": full_to_voigt(stress)})
        return out

    return efs
