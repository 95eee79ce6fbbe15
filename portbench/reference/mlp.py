"""The atomic heads of the plain reference: min-max scaled descriptors
through a softplus MLP whose hidden layers of equal width are resnet-dt
layers, x_{l+1} = softplus(x_l W + b) * dt + x_l, and a linear output."""
from __future__ import annotations

import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), written so that no order of its derivative
    overflows."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def scale(g: torch.Tensor, xlo: torch.Tensor, xhi: torch.Tensor):
    """(g - xlo) / (xhi - xlo), the span held at least 1e-12."""
    return (g - xlo) / torch.clamp(xhi - xlo, min=1e-12)


def energies(x: torch.Tensor, layers) -> torch.Tensor:
    """Scaled descriptors [rows, D] -> atomic energies [rows]. `layers`
    is a list of {"w": [in, out], "b": [out], "dt": [out] where the
    layer keeps its width}."""
    for layer in layers[:-1]:
        h = softplus(x @ layer["w"] + layer["b"])
        x = h * layer["dt"] + x if "dt" in layer else h
    last = layers[-1]
    return (x @ last["w"] + last["b"])[:, 0]
