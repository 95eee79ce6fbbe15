"""Generic analytic radial forms (port of `tensoralloy_tpu/ops/generic.py`),
as plain functions of torch tensors; parameters broadcast."""
from __future__ import annotations

import torch


def morse(r, d, gamma, r0):
    """d [exp(-2 g (r-r0)) - 2 exp(-g (r-r0))]."""
    x = gamma * (r - r0)
    return d * (torch.exp(-2.0 * x) - 2.0 * torch.exp(-x))


def buckingham(r, a, rho, c, order=6):
    """A exp(-r/rho) - C / r^order."""
    return a * torch.exp(-r / rho) - c / r ** order


def density_exp(r, a, b, re):
    """a exp(-b (r/re - 1))."""
    return a * torch.exp(-b * (r / re - 1.0))


def zhou_exp(r, a, b, c, re, order=20):
    """a exp(-b (r/re - 1)) / (1 + (r/re - c)^order)."""
    x = r / re
    return a * torch.exp(-b * (x - 1.0)) / (1.0 + (x - c) ** order)


def power_exp(r, rl, pl):
    """exp(-(r/rl)^pl) (Oganov)."""
    return torch.exp(-((r / rl) ** pl))


def mishin_cutoff(x):
    """psi(x) = z^4/(1+z^4) with z = relu(-x); 0 for x >= 0."""
    z = torch.clamp(-x, min=0.0)
    z4 = z ** 4
    return z4 / (1.0 + z4)


def mishin_polar(x, p1, p2, p3, rc, h):
    """(p1 exp(-p2 x) + p3) psi((x - rc)/h)."""
    return (p1 * torch.exp(-p2 * x) + p3) * mishin_cutoff((x - rc) / h)
