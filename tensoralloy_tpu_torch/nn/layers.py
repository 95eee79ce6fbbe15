"""Dense-stack building blocks (port of `tensoralloy_tpu/nn/layers.py`).

A stack is a sequence of layers, each a mapping with "w" [in, out],
optionally "b" [out] and, where consecutive widths match, the resnet-dt
scale "dt" [out]: x_{l+1} = f(x_l W + b) * dt + x_l. `nn.atomic`
holds them as `nn.ParameterDict`s, so the names match the JAX
parameter tree leaf for leaf.
"""
from __future__ import annotations

from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F


def softplus(x):
    # log(1 + e^x) without torch's linear cut-over above x = 20, which
    # is off by ~2e-9 there; jax.nn.softplus is this same logaddexp
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def squareplus(x, b: float = 4.0):
    """x/2 + sqrt(x^2 + b)/2."""
    return 0.5 * (x + torch.sqrt(torch.square(x) + b))


ACTIVATIONS = {
    "softplus": softplus,
    "squareplus": squareplus,
    "tanh": torch.tanh,
    "relu": F.relu,
    "leaky_relu": F.leaky_relu,
    "elu": F.elu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
}


def get_activation(name: str):
    return ACTIVATIONS[name]


def apply_dense_stack(layers: Sequence[Mapping[str, torch.Tensor]],
                      x: torch.Tensor,
                      activation: str = "softplus") -> torch.Tensor:
    """Apply the MLP along the last axis of ``x``."""
    act = get_activation(activation)
    for li, layer in enumerate(layers):
        h = x @ layer["w"]
        if "b" in layer:
            h = h + layer["b"]
        if li < len(layers) - 1:
            h = act(h)
            if "dt" in layer:
                h = h * layer["dt"] + x
        x = h
    return x


def minmax_normalize_apply(state: Mapping[str, torch.Tensor],
                           x: torch.Tensor) -> torch.Tensor:
    """Scale by the (non-trainable) running min/max stats."""
    xlo, xhi = state["xlo"].detach(), state["xhi"].detach()
    span = torch.clamp(xhi - xlo, min=1e-12)
    return (x - xlo) / span


def freeze_output_bias(layers: Sequence[Mapping[str, torch.Tensor]]
                       ) -> List[Mapping[str, torch.Tensor]]:
    """Detach the LAST layer's bias, so the per-element static energy
    it carries stays pinned when a model is trained with
    `fixed_static_energy`."""
    layers = list(layers)
    last = dict(layers[-1])
    if "b" in last:
        last["b"] = last["b"].detach()
    layers[-1] = last
    return layers
