"""GRAP descriptors of the plain reference (TensorAlloy's generic radial
atomic potential with the 'pexp' filters and moment tensors):

    H_k(r) = exp(-(r / rl_k)^pl_k) fc(r),   fc(r) = (cos(pi r / rc) + 1) / 2
    M_d(u) = the unique monomials u_x^a u_y^b u_z^c, a + b + c <= max moment
    P[i, k, d] = sum_j H_k(r_ij) M_d(u_ij)
    Q[i, k, m] = sum_{d of degree m} mult_d P[i, k, d]^2
    G[i, k, 0] = sign(P[i, k, 0]) sqrt(Q[i, k, 0] + 1e-16),  G[i, k, m] = Q[i, k, m]

with mult_d the multinomial count m! / (a! b! c!) of the monomial; the
descriptor is G in (filter, moment) order, one element so one slot.
"""
from __future__ import annotations

import itertools
import math

import torch


def monomials(max_moment: int):
    """The unique monomials by degree, each a sorted tuple of axes:
    (), (0,), (1,), (2,), (0, 0), (0, 1), ..."""
    out = [()]
    for m in range(1, max_moment + 1):
        out += list(itertools.combinations_with_replacement(range(3), m))
    return out


def contraction(max_moment: int, moments, dtype, device) -> torch.Tensor:
    """T [D, len(moments)]: the multiplicity of each monomial in the
    column of its degree."""
    cols = monomials(max_moment)
    t = torch.zeros((len(cols), len(moments)), dtype=torch.float64)
    for d, mono in enumerate(cols):
        if len(mono) in moments:
            mult = math.factorial(len(mono))
            for axis in range(3):
                mult //= math.factorial(mono.count(axis))
            t[d, moments.index(len(mono))] = float(mult)
    return t.to(dtype=dtype, device=device)


def basis(unit: torch.Tensor, max_moment: int) -> torch.Tensor:
    """unit [..., 3] -> M [..., D], the monomials in `monomials` order."""
    cols = []
    for mono in monomials(max_moment):
        value = torch.ones_like(unit[..., 0])
        for axis in mono:
            value = value * unit[..., axis]
        cols.append(value)
    return torch.stack(cols, dim=-1)


def cosine_cutoff(r: torch.Tensor, rc: float) -> torch.Tensor:
    return 0.5 * (torch.cos(math.pi * torch.clamp(r / rc, max=1.0)) + 1.0)


def descriptors(vec: torch.Tensor, mask: torch.Tensor, config: dict
                ) -> torch.Tensor:
    """Pair vectors [rows, width, 3] of each centre's neighbours, mask
    [rows, width] -> G [rows, K * M]."""
    dtype, device = vec.dtype, vec.device
    moments = list(config["moment_tensors"])
    top = max(moments)
    rl = torch.tensor(config["rl"], dtype=dtype, device=device)
    pl = torch.tensor(config["pl"], dtype=dtype, device=device)
    w = mask.to(dtype)
    r = torch.sqrt(torch.sum(vec * vec, dim=-1) + (1.0 - w))
    unit = vec / r[..., None]
    fc = cosine_cutoff(r, config["rcut"]) * w
    h = torch.exp(-torch.pow(r[..., None] / rl, pl)) * fc[..., None]
    m = basis(unit, top)                                    # [rows, n, D]
    p = torch.einsum("rnk,rnd->rkd", h, m)                  # [rows, K, D]
    q = torch.square(p) @ contraction(top, moments, dtype, device)
    if 0 in moments:
        g0 = torch.sign(p[..., 0]) * torch.sqrt(q[..., 0] + 1e-16)
        q = torch.cat([g0[..., None], q[..., 1:]], dim=-1)
    return q.reshape(q.shape[0], -1)
