"""Derived physical properties by autograd (port of
`tensoralloy_tpu/nn/fields.py`).

  forces  F = -dE/dR
  virial  W = (dE/dR)^T R + (dE/dh)^T h        (h = cell rows)
  stress  sigma = W / V (eV/A^3), Voigt order [xx, yy, zz, yz, xz, xy]
  total pressure P = -tr(sigma)/3 in GPa

`make_efs_fn` differentiates w.r.t. positions and cell; the calculator
serves through the scatter-free `ops.dense.make_dense_efs_fn`, and the
tests hold the two against each other.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

# eV/A^3 -> GPa
EV_ANGSTROM3_TO_GPA = 160.21766208
GPa = 1.0 / EV_ANGSTROM3_TO_GPA  # 1 GPa in eV/A^3


def full_to_voigt(s: torch.Tensor) -> torch.Tensor:
    return torch.stack([s[..., 0, 0], s[..., 1, 1], s[..., 2, 2],
                        0.5 * (s[..., 1, 2] + s[..., 2, 1]),
                        0.5 * (s[..., 0, 2] + s[..., 2, 0]),
                        0.5 * (s[..., 0, 1] + s[..., 1, 0])], dim=-1)


def make_efs_fn(energy_fn: Callable,
                extras_fn: Optional[Callable] = None) -> Callable:
    """`energy_fn(features) -> scalar`, differentiated w.r.t. positions
    and cell (the JAX `make_efs_fn(energy_fn, extras_fn)` contract).

    Returns fn(features) -> dict with energy, forces [A, 3], virial and
    stress [3, 3], stress_voigt [6] and total_pressure (GPa), plus what
    `extras_fn(features) -> dict` returns (a second forward pass, run
    without autograd), all detached."""

    def efs(features) -> Dict[str, torch.Tensor]:
        pos = features["positions"].detach().requires_grad_()
        cell = features["cell"].detach().requires_grad_()
        f = dict(features, positions=pos, cell=cell)
        with torch.enable_grad():
            energy = energy_fn(f)
            gpos, gcell = torch.autograd.grad(energy, (pos, cell))
        pos, cell = pos.detach(), cell.detach()
        virial = gpos.T @ pos + gcell.T @ cell
        volume = torch.clamp(torch.abs(torch.linalg.det(cell)), min=1e-12)
        stress = virial / volume
        out = {"energy": energy.detach(), "forces": -gpos,
               "virial": virial, "stress": stress,
               "stress_voigt": full_to_voigt(stress),
               "total_pressure": -torch.trace(stress) / 3.0
               * EV_ANGSTROM3_TO_GPA}
        if extras_fn is not None:
            with torch.no_grad():
                out.update(extras_fn(dict(features, positions=pos,
                                          cell=cell)))
        return out

    return efs
