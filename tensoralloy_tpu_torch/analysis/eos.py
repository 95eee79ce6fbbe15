"""Equation-of-state fitting (reference `tensoralloy/analysis/eos.py`,
which extends ASE's EOS with the Rose universal form).

Supported forms: birchmurnaghan, murnaghan, vinet, sj (polynomial in
V^(-2/3)), and rose (with the beta correction term the reference adds).
Units: volumes A^3, energies eV; bulk modulus returned in eV/A^3.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.optimize import least_squares


def birchmurnaghan(v, e0, b0, bp, v0):
    eta = (v0 / v) ** (2.0 / 3.0)
    return e0 + 9.0 * b0 * v0 / 16.0 * (eta - 1.0) ** 2 * \
        (6.0 + bp * (eta - 1.0) - 4.0 * eta)


def murnaghan(v, e0, b0, bp, v0):
    return e0 + b0 * v / bp * (((v0 / v) ** bp) / (bp - 1.0) + 1.0) - \
        v0 * b0 / (bp - 1.0)


def vinet(v, e0, b0, bp, v0):
    x = (v / v0) ** (1.0 / 3.0)
    xi = 1.5 * (bp - 1.0)
    return e0 + (2.0 * b0 * v0 / (bp - 1.0) ** 2) * \
        (2.0 - (5.0 + 3.0 * bp * (x - 1.0) - 3.0 * x) *
         np.exp(-xi * (x - 1.0)))


def rose(v, e0, b0, beta, v0):
    """Rose universal EOS with the reference's beta term
    (`analysis/eos.py:20-182`, `nn/constraint/rose.py`):
    E(x) = E0 (1 + a x + beta (a x)^3 (2x + 3)/(x + 1)^2) exp(-a x),
    x = (V/V0)^(1/3) - 1, a = sqrt(9 B V0 / |E0|)."""
    x = (v / v0) ** (1.0 / 3.0) - 1.0
    a = np.sqrt(9.0 * b0 * v0 / np.abs(e0))
    ax = a * x
    poly = 1.0 + ax + beta * ax ** 3 * (2.0 * x + 3.0) / (x + 1.0) ** 2
    return e0 * poly * np.exp(-ax)


_FORMS = {"birchmurnaghan": birchmurnaghan, "murnaghan": murnaghan,
          "vinet": vinet, "rose": rose, "sj": None}


class EquationOfState:
    """Fit E(V) data to an analytic EOS."""

    def __init__(self, volumes, energies, eos: str = "birchmurnaghan",
                 beta: float = 0.005):
        self.volumes = np.asarray(volumes, dtype=np.float64)
        self.energies = np.asarray(energies, dtype=np.float64)
        self.eos = eos
        self.beta = beta
        if eos not in _FORMS:
            raise ValueError(f"unknown eos '{eos}' "
                             f"(choose from {sorted(_FORMS)})")
        self.params = None

    def _fit_sj(self) -> Tuple[float, float, float]:
        """Stabilized-jellium EOS (ASE 'sj'): exact cubic polynomial
        fit in t = V^(-1/3); the minimum and B follow analytically."""
        t = self.volumes ** (-1.0 / 3.0)
        poly = np.poly1d(np.polyfit(t, self.energies, 3))
        d1, d2 = np.polyder(poly, 1), np.polyder(poly, 2)
        self.params = poly
        self.residual = float(np.sqrt(np.mean(
            (poly(t) - self.energies) ** 2)))
        for root in np.roots(d1):
            if abs(root.imag) < 1e-12 and root.real > 0 and \
                    d2(root.real) > 0:
                t0 = float(root.real)
                return (t0 ** -3, float(poly(t0)),
                        float(t0 ** 5 * d2(t0) / 9.0))
        raise RuntimeError("sj fit found no physical E(V) minimum")

    def fit(self) -> Tuple[float, float, float]:
        """-> (v0, e0, B) with B in eV/A^3."""
        if self.eos == "sj":
            return self._fit_sj()
        v = self.volumes
        e = self.energies
        i0 = int(np.argmin(e))
        # quadratic seed around the minimum
        e0_seed = e[i0]
        v0_seed = v[i0]
        b0_seed = 0.5  # ~80 GPa in eV/A^3
        fn = _FORMS[self.eos]

        if self.eos == "rose":
            x0 = [e0_seed, b0_seed, self.beta, v0_seed]
        else:
            x0 = [e0_seed, b0_seed, 4.0, v0_seed]

        def residuals(p):
            return fn(v, *p) - e

        res = least_squares(residuals, x0, method="lm", max_nfev=10000)
        self.params = res.x
        e0, b0 = res.x[0], res.x[1]
        v0 = res.x[3]
        self.residual = float(np.sqrt(np.mean(res.fun ** 2)))
        return float(v0), float(e0), float(b0)

    def evaluate(self, v) -> np.ndarray:
        if self.params is None:
            self.fit()
        v = np.asarray(v, dtype=np.float64)
        if self.eos == "sj":
            return self.params(v ** (-1.0 / 3.0))
        return _FORMS[self.eos](v, *self.params)
