"""Element-specific finite-temperature models (port of
`tensoralloy_tpu/nn/special.py`)."""
from __future__ import annotations

import torch

from .finite_temperature import TemperatureDependentAtomicNN
from .layers import softplus


class BeNN(TemperatureDependentAtomicNN):
    """Be free-electron-model entropy head: a fitted semi-analytic
    S0(T) = a T^2 f(T) + b T + c (1 - f(T)), f = relu(1 - 1.45 T)^2,
    modulated by the softplus of the NN entropy head's output."""

    _A, _B, _C, _D = -0.5718444, 0.83744317, -0.2110962, 1.45

    def _entropy_from_head(self, s_raw: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
        ft = torch.square(torch.relu(1.0 - self._D * t))
        s0 = self._A * t * t * ft + self._B * t + self._C * (1.0 - ft)
        # exact softplus, as jax.nn.softplus (nn/layers.py)
        return s0 * softplus(s_raw)

    def as_dict(self) -> dict:
        d = super().as_dict()
        d["class"] = "BeNN"
        return d
