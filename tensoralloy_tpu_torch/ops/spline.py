"""Differentiable cubic-spline evaluation on uniform grids (port of
`tensoralloy_tpu/ops/spline.py`).

The spline coefficients are computed once on the host (scipy); the
evaluation is plain PyTorch: a gather of coefficient rows and a cubic
in the offset, C2-smooth, so forces and Hessians from autograd are
well defined.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


class UniformCubicSpline:
    """y(x) tabulated on x = x0 + i*dx, i in [0, n)."""

    def __init__(self, y: np.ndarray, x0: float, dx: float,
                 bc_type: str = "not-a-knot",
                 extrapolate_zero: bool = True):
        from scipy.interpolate import CubicSpline
        y = np.asarray(y, dtype=np.float64)
        self.n = len(y)
        self.x0 = float(x0)
        self.dx = float(dx)
        self.extrapolate_zero = extrapolate_zero
        x = x0 + np.arange(self.n) * dx
        cs = CubicSpline(x, y, bc_type=bc_type)
        # coefficients per interval: value = sum_k c[k, i] * t^(3-k)
        self.coeffs = np.ascontiguousarray(cs.c.T)  # [n-1, 4]
        self.y = y
        self._tables: Dict[Tuple[torch.dtype, torch.device],
                           torch.Tensor] = {}

    def _table(self, r: torch.Tensor) -> torch.Tensor:
        key = (r.dtype, r.device)
        c = self._tables.get(key)
        if c is None:
            c = torch.as_tensor(self.coeffs, dtype=r.dtype, device=r.device)
            self._tables[key] = c
        return c

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        """Evaluate at `r` (any shape)."""
        c = self._table(r)
        idx_f = (r - self.x0) / self.dx
        # truncation toward zero, then clipped into the table
        idx = torch.clamp(idx_f.detach().to(torch.int64), 0, self.n - 2)
        t = r - (self.x0 + idx.to(r.dtype) * self.dx)
        rows = c[idx]                                   # [..., 4]
        val = ((rows[..., 0] * t + rows[..., 1]) * t +
               rows[..., 2]) * t + rows[..., 3]
        if self.extrapolate_zero:
            upper = self.x0 + (self.n - 1) * self.dx
            val = torch.where(r >= upper, 0.0, val)
        return val
