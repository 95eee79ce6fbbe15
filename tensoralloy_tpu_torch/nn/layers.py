"""Dense-stack building blocks (port of `tensoralloy_tpu/nn/layers.py`).

A stack is a sequence of layers, each a mapping with "w" [in, out],
optionally "b" [out] and, where consecutive widths match, the resnet-dt
scale "dt" [out]: x_{l+1} = f(x_l W + b) * dt + x_l. `nn.atomic`
holds them as `nn.ParameterDict`s, so the names match the JAX
parameter tree leaf for leaf.
"""
from __future__ import annotations

import math
from typing import List, Mapping, Sequence

import torch
import torch.nn.functional as F


def softplus(x):
    """log(1 + e^x), as jax.nn.softplus: x + log1p(e^-x) above 0,
    log1p(e^x) below (torch's `F.softplus` turns linear above x = 20,
    ~2e-9 off there). Each branch reads an input clamped to its own side,
    so no derivative of any order overflows where |x| is large
    (`torch.logaddexp`'s second derivative is NaN below x = -709, which
    the force loss's parameter gradient reaches on an unscaled
    descriptor)."""
    pos = x > 0
    xp = torch.where(pos, x, 0.0)
    xn = torch.where(pos, 0.0, x)
    return torch.where(pos, xp + torch.log1p(torch.exp(-xp)),
                       torch.log1p(torch.exp(xn)))


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


# Kernel initializers. The variance-scaling *normal* variants draw from a
# normal truncated at +-2 sigma, with the standard deviation corrected
# for the truncation; the *uniform* variants from U(-limit, limit) with
# limit = sqrt(3 * scale / fan).
_TRUNC_STD_CORRECTION = 0.8796256610342398  # std of N(0,1)|[-2,2]

KERNEL_INITIALIZERS = (
    "he_normal", "he_uniform", "lecun_normal", "lecun_uniform",
    "glorot_normal", "glorot_uniform", "xavier_normal",
    "xavier_uniform", "truncated_normal", "random_normal",
    "random_uniform", "zeros", "constant")


def _uniform(generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return lo + (hi - lo) * u


def _truncated_normal(generator, shape) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], by the inverse of its distribution
    function on a uniform draw."""
    phi = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = _uniform(generator, shape, phi, 1.0 - phi)
    return math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)


def sample_kernel(generator: torch.Generator, name: str, fan_in: int,
                  fan_out: int, dtype=None, value: float = 0.0,
                  stddev: float = 0.05, limit: float = 0.05,
                  device=None) -> torch.Tensor:
    """Draw a [fan_in, fan_out] kernel from the named initializer with a
    CPU `torch.Generator` (drawn at float64 on the host, then cast and
    moved): the distributions and scales of the JAX package's
    `sample_kernel`, not its bits."""
    name = (name or "he_normal").lower()
    shape = (fan_in, fan_out)
    scaled = {"he_normal": 2.0 / fan_in, "he_uniform": 2.0 / fan_in,
              "lecun_normal": 1.0 / fan_in,
              "lecun_uniform": 1.0 / fan_in,
              "glorot_normal": 2.0 / (fan_in + fan_out),
              "glorot_uniform": 2.0 / (fan_in + fan_out),
              "xavier_normal": 2.0 / (fan_in + fan_out),
              "xavier_uniform": 2.0 / (fan_in + fan_out)}
    if name in scaled:
        if name.endswith("_uniform"):
            lim = math.sqrt(3.0 * scaled[name])
            w = _uniform(generator, shape, -lim, lim)
        else:
            std = math.sqrt(scaled[name]) / _TRUNC_STD_CORRECTION
            w = _truncated_normal(generator, shape) * std
    elif name == "truncated_normal":
        w = _truncated_normal(generator, shape) * (
            stddev / _TRUNC_STD_CORRECTION)
    elif name == "random_normal":
        w = torch.randn(shape, generator=generator,
                        dtype=torch.float64) * stddev
    elif name == "random_uniform":
        w = _uniform(generator, shape, -limit, limit)
    elif name == "zeros":
        w = torch.zeros(shape, dtype=torch.float64)
    elif name == "constant":
        w = torch.full(shape, value, dtype=torch.float64)
    else:
        raise ValueError(f"unknown kernel initializer {name!r} "
                         f"(allowed: {KERNEL_INITIALIZERS})")
    return w.to(device=device, dtype=dtype or torch.float32)


def init_dense_stack(generator: torch.Generator, in_dim: int,
                     hidden_sizes: Sequence[int], out_dim: int = 1,
                     output_bias: bool = True,
                     output_bias_mean: float = 0.0,
                     resnet_dt: bool = False,
                     kernel_init: str = "he_normal",
                     dtype=None, device=None) -> dict:
    """Initialize an MLP parameter tree {"layers": [...]}: hidden layers
    (zero bias, dt = 0.1 where widths match) and a linear output."""
    factory = {"dtype": dtype or torch.float32, "device": device}
    sizes = [in_dim] + list(hidden_sizes) + [out_dim]
    layers = []
    for li in range(len(sizes) - 1):
        fan_in, fan_out = sizes[li], sizes[li + 1]
        layer = {"w": sample_kernel(generator, kernel_init, fan_in,
                                    fan_out, **factory)}
        is_output = li == len(sizes) - 2
        if not is_output:
            layer["b"] = torch.zeros(fan_out, **factory)
            if resnet_dt and fan_in == fan_out:
                layer["dt"] = torch.full((fan_out,), 0.1, **factory)
        elif output_bias:
            layer["b"] = torch.full((fan_out,), output_bias_mean, **factory)
        layers.append(layer)
    return {"layers": layers}


def l2_of_stack(stack) -> torch.Tensor:
    """Sum of squared kernel weights (for L2 regularization)."""
    return sum(torch.sum(torch.square(layer["w"]))
               for layer in stack["layers"])


def minmax_normalize_init(feature_dim: int, dtype=None, device=None) -> dict:
    """Running min-max input scaling state: xlo = 0, xhi = 1."""
    factory = {"dtype": dtype or torch.float32, "device": device}
    return {"xlo": torch.zeros(feature_dim, **factory),
            "xhi": torch.ones(feature_dim, **factory)}


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
