"""Blocked neighbour search of the plain reference.

Every pair (i, j, n) of a periodic cell with |r_j + n @ cell - r_i| below
the cutoff, i != j or n != 0, by brute force over blocks of centres: the
minimum image where every height of the cell exceeds twice the cutoff,
else every image within reach.
"""
from __future__ import annotations

import itertools
import math

import torch


def heights(cell: torch.Tensor) -> torch.Tensor:
    """The three distances between opposite faces of the cell."""
    c = cell.double()
    volume = torch.abs(torch.linalg.det(c))
    areas = torch.stack([torch.linalg.norm(torch.linalg.cross(c[1], c[2])),
                         torch.linalg.norm(torch.linalg.cross(c[2], c[0])),
                         torch.linalg.norm(torch.linalg.cross(c[0], c[1]))])
    return volume / areas


def pairs(positions: torch.Tensor, cell: torch.Tensor, cutoff: float,
          block: int = 512):
    """-> (i [P], j [P], shift [P, 3]): the pairs within `cutoff`, sorted
    by centre, `shift` the integer image n of j (float, in the positions'
    dtype), so that the pair vector is r_j + n @ cell - r_i."""
    pos = positions.detach()
    cell = cell.to(pos)
    n = pos.shape[0]
    cut2 = cutoff * cutoff
    reach = [math.ceil(cutoff / float(h)) for h in heights(cell)]
    out_i, out_j, out_s = [], [], []
    if min(float(h) for h in heights(cell)) > 2.0 * cutoff:
        inv = torch.linalg.inv(cell.double()).to(pos)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            d = pos[None, :, :] - pos[lo:hi, None, :]          # [b, n, 3]
            s = -torch.round(d @ inv)
            d = d + s @ cell
            r2 = torch.sum(d * d, dim=-1)
            rows = torch.arange(hi - lo, device=pos.device)
            r2[rows, rows + lo] = float("inf")
            i, j = torch.nonzero(r2 < cut2, as_tuple=True)
            out_i.append(i + lo)
            out_j.append(j)
            out_s.append(s[i, j])
    else:
        images = torch.tensor(list(itertools.product(
            *[range(-m, m + 1) for m in reach])), dtype=pos.dtype,
            device=pos.device)                                 # [I, 3]
        offsets = images @ cell                                # [I, 3]
        home = torch.all(images == 0, dim=1)
        for lo in range(0, n, block):
            hi = min(lo + block, n)
            d = (pos[None, :, None, :] + offsets[None, None]
                 - pos[lo:hi, None, None, :])                  # [b, n, I, 3]
            r2 = torch.sum(d * d, dim=-1)
            same = (torch.arange(lo, hi, device=pos.device)[:, None]
                    == torch.arange(n, device=pos.device)[None, :])
            r2[same[:, :, None] & home[None, None, :]] = float("inf")
            i, j, k = torch.nonzero(r2 < cut2, as_tuple=True)
            out_i.append(i + lo)
            out_j.append(j)
            out_s.append(images[k])
    return (torch.cat(out_i), torch.cat(out_j),
            torch.cat(out_s).reshape(-1, 3))


def vectors(positions: torch.Tensor, cell: torch.Tensor, i, j, shift):
    """Pair vectors r_j + n @ cell - r_i, differentiable in `positions`."""
    return positions[j] + shift @ cell.to(positions) - positions[i]


def table(i: torch.Tensor, n: int):
    """Pairs sorted by centre -> (index [n, width] of each centre's pairs,
    mask [n, width]); padding points at pair 0 with mask 0."""
    counts = torch.bincount(i, minlength=n)
    width = max(int(counts.max()) if len(i) else 1, 1)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(len(i), device=i.device) - first[i]
    index = torch.zeros((n, width), dtype=torch.long, device=i.device)
    mask = torch.zeros((n, width), dtype=torch.bool, device=i.device)
    index[i, slot] = torch.arange(len(i), device=i.device)
    mask[i, slot] = True
    return index, mask


def rows(vec: torch.Tensor, i: torch.Tensor, n: int):
    """Pair vectors [P, 3] sorted by centre `i` -> (each centre's row of
    vectors [n, width, 3], 0 on padding; mask [n, width])."""
    index, mask = table(i, n)
    return vec[index] * mask[..., None].to(vec.dtype), mask
