"""Pair geometry from the flat ('segment') feature arrays (port of
`tensoralloy_tpu/ops/pairs.py`).

Every function takes one structure's features or a batch's: pair arrays
[nij] or [B, nij] with positions [A, 3] or [B, A, 3]; a batch's pair
indices address their own structure's rows.
"""
from __future__ import annotations

import torch


def safe_norm(vec: torch.Tensor, eps: float = 1e-14, dim: int = -1):
    """Norm with a smooth, NaN-free gradient at zero."""
    return torch.sqrt(torch.sum(torch.square(vec), dim=dim) + eps)


def pair_vectors(features) -> torch.Tensor:
    """r_ij vectors [.., nij, 3]: R[j] + S @ cell - R[i].

    If the features carry an explicit "rij" array it is returned as it
    is: an external engine supplies the displacement vectors and
    differentiates the energy w.r.t. them instead of the positions."""
    if "rij" in features:
        return features["rij"]
    pos = features["positions"]
    cell = features["cell"]
    pi, pj = features["pair_i"].long(), features["pair_j"].long()
    if pos.dim() == 2:
        return pos[pj] + features["pair_shift"] @ cell - pos[pi]
    b, a, _ = pos.shape
    flat = pos.reshape(b * a, 3)
    offset = torch.arange(0, b * a, a, device=pos.device).view(b, 1)
    return (flat[pj + offset] + torch.bmm(features["pair_shift"], cell)
            - flat[pi + offset])


def pair_distances(features, eps: float = 1e-14):
    """(rij [.., nij], masked-safe rij): padding entries give 1."""
    rij = safe_norm(pair_vectors(features), eps=eps)
    rij_safe = torch.where(features["pair_mask"] > 0, rij, 1.0)
    return rij, rij_safe
