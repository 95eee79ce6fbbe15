"""Behler symmetry functions of the plain reference, on each centre's
row of neighbour vectors (one element, so one radial and one angular
slot):

    G2[i, (eta, omega)] = sum_j exp(-eta (r_ij - omega)^2 / rc^2) fc(r_ij; rc)
    G4[i, (beta, gamma, zeta)] = sum_{j < k} 2^(1 - zeta) (1 + gamma cos t_ijk)^zeta
        exp(-beta (r_ij^2 + r_ik^2 + r_jk^2) / ac^2) fc(r_ij; ac) fc(r_ik; ac) fc(r_jk; ac)

over the neighbours j, k of i within ac, the angular cutoff; grids in
(eta, omega) and (beta, gamma, zeta) order, the last key fastest, and the
descriptor G2 then G4. A row may list neighbours beyond the cutoffs (a
skinned list): their terms are 0.
"""
from __future__ import annotations

import itertools

import torch

from .grap import cosine_cutoff


def grids(config: dict):
    radial = list(itertools.product(config["eta"], config["omega"]))
    angular = list(itertools.product(config["beta"], config["gamma"],
                                     config["zeta"]))
    return radial, angular


def _length(vec: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """|vec|, 1 on padding, so that no derivative is taken at 0."""
    w = real.to(vec.dtype)
    return torch.sqrt(torch.sum(vec * vec, dim=-1) + (1.0 - w))


def _within(vec: torch.Tensor, mask: torch.Tensor, r: torch.Tensor,
            cutoff: float):
    """Each row's neighbours within `cutoff` moved to its front -> (their
    vectors [rows, w, 3], mask [rows, w]), w the most any row has."""
    near = mask & (r.detach() < cutoff)
    width = int(near.sum(dim=1).max()) if near.numel() else 0
    order = torch.argsort((~near).to(torch.int8), dim=1, stable=True)
    order = order[:, :width]
    return (torch.gather(vec, 1, order[..., None].expand(-1, -1, 3)),
            torch.gather(near, 1, order))


def descriptors(vec: torch.Tensor, mask: torch.Tensor, config: dict
                ) -> torch.Tensor:
    """Neighbour vectors [rows, width, 3] of each centre, mask [rows,
    width] -> G [rows, T2 + T4]."""
    radial, angular = grids(config)
    rc, ac = config["rcut"], config["acut"]
    r = _length(vec, mask)
    fc = cosine_cutoff(r, rc) * mask.to(vec.dtype)
    g2 = torch.stack([torch.exp(-eta * torch.square(r - omega) / (rc * rc))
                      * fc for eta, omega in radial], dim=-1).sum(dim=1)
    va, na = _within(vec, mask, r, ac)
    a, b = torch.triu_indices(va.shape[1], va.shape[1], offset=1,
                              device=vec.device)
    vj, vk = va[:, a], va[:, b]
    both = na[:, a] & na[:, b]
    rij, rik = _length(vj, both), _length(vk, both)
    rjk = _length(vk - vj, both)
    cos = torch.sum(vj * vk, dim=-1) / (rij * rik)
    fc3 = (cosine_cutoff(rij, ac) * cosine_cutoff(rik, ac)
           * cosine_cutoff(rjk, ac) * both.to(vec.dtype))
    z = (rij * rij + rik * rik + rjk * rjk) / (ac * ac)
    terms = [2.0 ** (1.0 - zeta) * torch.clamp(1.0 + gamma * cos, min=0.0)
             ** zeta * torch.exp(-beta * z) * fc3
             for beta, gamma, zeta in angular]
    g4 = torch.stack(terms, dim=-1).sum(dim=1)
    return torch.cat([g2, g4], dim=-1)
