"""Neighbour search of the plain reference for large cells, slab by slab.

The same pairs as `neighbors.pairs`, in the same order, found with
less work: the atoms are binned by their fractional coordinate along
the cell's first axis into slabs no thinner than the cutoff, so a pair
within the cutoff joins a slab to itself or to one beside it, and each
slab's centres are searched against those three slabs alone, by brute
force over blocks of centres under the minimum image. A cell of fewer
than three such slabs, or too thin for the minimum image, is searched
by `neighbors.pairs` itself. Positions that are not finite are
refused with a ValueError, before any binning.
"""
from __future__ import annotations

import torch

from . import neighbors


def pairs(positions: torch.Tensor, cell: torch.Tensor, cutoff: float,
          block: int = 512):
    """-> (i [P], j [P], shift [P, 3]) as `neighbors.pairs` gives them:
    sorted by centre, then by neighbour."""
    pos = positions.detach()
    if not bool(torch.isfinite(pos).all()):
        raise ValueError("neighbour search of positions that are not "
                         "finite")
    cell = cell.to(pos)
    h = neighbors.heights(cell)
    n_slabs = int(float(h[0]) // cutoff)
    if n_slabs < 3 or float(h.min()) <= 2.0 * cutoff:
        return neighbors.pairs(positions, cell, cutoff, block)
    n = pos.shape[0]
    inv = torch.linalg.inv(cell.double()).to(pos)
    frac = torch.remainder((pos @ inv)[:, 0], 1.0)
    slab = torch.clamp((frac * n_slabs).long(), max=n_slabs - 1)
    order = torch.argsort(slab, stable=True)
    counts = torch.bincount(slab, minlength=n_slabs).tolist()
    starts = [sum(counts[:s]) for s in range(n_slabs + 1)]
    members = [order[starts[s]:starts[s + 1]] for s in range(n_slabs)]
    cut2 = cutoff * cutoff
    out_i, out_j, out_s = [], [], []
    for s in range(n_slabs):
        cand = torch.cat([members[(s + k) % n_slabs] for k in (-1, 0, 1)])
        for lo in range(0, len(members[s]), block):
            centres = members[s][lo:lo + block]
            d = pos[cand][None, :, :] - pos[centres][:, None, :]
            shift = -torch.round(d @ inv)
            d = d + shift @ cell
            r2 = torch.sum(d * d, dim=-1)
            r2[centres[:, None] == cand[None, :]] = float("inf")
            i, j = torch.nonzero(r2 < cut2, as_tuple=True)
            out_i.append(centres[i])
            out_j.append(cand[j])
            out_s.append(shift[i, j])
    i, j, shift = torch.cat(out_i), torch.cat(out_j), torch.cat(out_s)
    key = torch.argsort(i * n + j)
    return i[key], j[key], shift[key].reshape(-1, 3)
