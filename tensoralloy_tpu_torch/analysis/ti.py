"""Absolute free energies by Frenkel-Ladd thermodynamic integration.

The reference framework has no free-energy capability (its MD is
delegated to LAMMPS). Here the potential is a pure function, so the
lambda-coupled Hamiltonian

    U(lambda) = lambda * U_model + (1 - lambda) * U_Einstein

is just another energy — `LambdaMix` wraps any model of the port
(EAM/ADP, descriptor NNs, finite-T) and the device-resident
`dynamics.VelocityVerlet` integrates it unchanged (port of
`tensoralloy_tpu/analysis/ti.py`; the Langevin noise is a
`torch.Generator`'s, so runs are held to the JAX package by statistics
and analytic oracles, not step for step). The classical
Einstein reference free energy is analytic, so

    F_model = F_Einstein + int_0^1 <U_model - U_Einstein>_lambda dlambda

(Frenkel & Ladd, J. Chem. Phys. 81, 3188 (1984)). The quadrature is
Gauss-Legendre (the integrand is smooth in lambda and the endpoints
need no special treatment because BOTH terms are evaluated at every
lambda).

Center-of-mass treatment (the classic Frenkel-Ladd subtlety): for
EQUAL masses the mixed Hamiltonian separates EXACTLY into a COM
oscillator of spring (1-lambda) k N and mass N m, plus 3N-3 internal
modes. The COM part of the integrand, -3kT / (2 (1-lambda)), diverges
logarithmically at lambda -> 1 (the crystal's COM is free) and would
be silently mis-sampled by any quadrature. It is therefore removed
ANALYTICALLY from the measured integrand, the Einstein reference is
taken with 3N-3 modes, and the free COM in the periodic volume
contributes its exact classical term -kT ln(V / Lambda_th(M)^3).
No approximation is involved for monatomic (equal-mass) systems; for
mixed compositions the separation is inexact and the same correction
is applied as the leading term (warns).

Units: eV, A, fs, amu, K (as `dynamics.py`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..atoms import Structure
from ..dynamics import KB, FORCE_TO_ACC, VelocityVerlet, _model_factory

__all__ = ["LambdaMix", "einstein_free_energy", "frenkel_ladd"]

# hbar in eV*fs
HBAR_EV_FS = 0.6582119569


class LambdaMix(nn.Module):
    """U(lambda) = lambda * model + (1 - lambda) * Einstein springs.

    An `nn.Module` holding the wrapped model as its submodule (so that
    the MD engine finds its device and dtype) and delegating every other
    attribute to it, so the MD engine, the calculator and autograd treat
    it as a normal model. It is never an EAM-family model
    (`calculator.is_eam_family` is false on it): the analytic fast EFS
    would drop the springs. `centers_vap` [n_vap, 3] are the spring
    anchor points in VAP order (padding rows are masked by the spring
    mask).
    """

    def __init__(self, model, lam: float, centers_vap: np.ndarray,
                 k_spring: float, atom_masks: np.ndarray):
        super().__init__()
        self._model = model
        self.lam = float(lam)
        self.k_spring = float(k_spring)
        # plain tensors on the model's device (a buffer would be looked up
        # first in the wrapped model, which may be a LambdaMix itself)
        device, dtype = _model_factory(model)
        self.centers_vap = torch.as_tensor(np.asarray(centers_vap),
                                           dtype=dtype, device=device)
        self._mask = torch.as_tensor(np.asarray(atom_masks), dtype=dtype,
                                     device=device)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(self._modules["_model"], name)

    def clone_for(self, max_occurs):
        clone = self._model.clone_for(max_occurs)
        if clone.n_atoms_vap != self.centers_vap.shape[0]:
            raise ValueError(
                "LambdaMix must be built for the exact structure it "
                "integrates (VAP layout mismatch)")
        return LambdaMix(clone, self.lam, self.centers_vap.cpu().numpy(),
                         self.k_spring, self._mask.cpu().numpy())

    def einstein_energy(self, features) -> torch.Tensor:
        d = features["positions"] - self.centers_vap
        return 0.5 * self.k_spring * torch.sum(
            torch.sum(torch.square(d), dim=-1) * self._mask, dim=-1)

    def variational_energy(self, features, params=None) -> torch.Tensor:
        e_model = self._model.variational_energy(features, params)
        return (self.lam * e_model
                + (1.0 - self.lam) * self.einstein_energy(features))

    energy = variational_energy

    def energy_and_aux(self, features, params=None):
        """The mixed energy with no by-products (the wrapped model's
        would describe its own energy, not the mix)."""
        return self.variational_energy(features, params), {}


def einstein_free_energy(n_atoms: int, masses_amu: np.ndarray,
                         k_spring: float, temperature: float) -> float:
    """Classical Einstein-crystal Helmholtz free energy (eV, total):
    F = 3 kT sum_i ln(hbar w_i / kT), w_i = sqrt(k / m_i)."""
    m = np.asarray(masses_amu, dtype=np.float64)
    # k in eV/A^2, m in amu -> w in 1/fs via the package force unit
    w = np.sqrt(k_spring / m * FORCE_TO_ACC)
    kt = KB * temperature
    return float(3.0 * kt * np.sum(np.log(HBAR_EV_FS * w / kt)))


def free_com_term(total_mass_amu: float, volume_a3: float,
                  temperature: float) -> float:
    """-kT ln(V / Lambda_th^3) for a free classical particle of the
    TOTAL mass in the periodic volume (eV). Lambda_th = h / sqrt(2 pi
    M kT), evaluated in package units (hbar eV*fs, mass amu via the
    eV/A/amu force constant)."""
    kt = KB * temperature
    # Lambda_th^2 [A^2] = (2 pi hbar)^2 / (2 pi M kT) * FORCE_TO_ACC
    lam2 = ((2.0 * np.pi * HBAR_EV_FS) ** 2
            / (2.0 * np.pi * total_mass_amu * kt)) * FORCE_TO_ACC
    return float(-kt * np.log(volume_a3 / lam2 ** 1.5))


def frenkel_ladd(model, structure: Structure,
                 temperature: float, k_spring: Optional[float] = None,
                 n_lambda: int = 8, equil_steps: int = 1500,
                 prod_steps: int = 3000, timestep: float = 2.0,
                 friction: float = 0.2, sample: int = 10,
                 seed: int = 0,
                 lambdas: Optional[Sequence[float]] = None,
                 com_correction: bool = True) -> Dict[str, object]:
    """Absolute Helmholtz free energy of `structure` with `model` at
    `temperature` by Frenkel-Ladd TI from a classical Einstein crystal.

    `k_spring` (eV/A^2) defaults to 3 kT / <|dr|^2> with <|dr|^2> from
    a short pilot run of the model itself — the standard choice that
    matches the Einstein cloud to the real thermal cloud and keeps the
    integrand flat. Returns total and per-atom F plus the integrand
    samples for convergence checks. The dynamics run on the model's
    device in its dtype (the JAX function also takes `params`).
    """
    centers = structure.positions.copy()
    fz = model.featurizer
    from collections import Counter
    vap = fz.make_vap(structure, Counter(structure.symbols))
    n_vap = model.clone_for(Counter(structure.symbols)).n_atoms_vap
    centers_vap = np.zeros((n_vap, 3))
    centers_vap[vap.local_to_vap] = centers
    masks = np.zeros(n_vap)
    masks[vap.local_to_vap] = 1.0

    if k_spring is None:
        md = VelocityVerlet(model, structure,
                            timestep=timestep, temperature=temperature,
                            seed=seed, target_temperature=temperature,
                            friction=friction, chunk_size=sample)
        md.run(equil_steps, record_trajectory=True)
        hist = md.run(max(prod_steps // 2, 10 * sample),
                      record_trajectory=True)
        disp = np.stack(hist["positions"]) - centers[None]
        msd = float(np.mean(np.sum(disp ** 2, axis=-1)))
        k_spring = 3.0 * KB * temperature / max(msd, 1e-8)

    if lambdas is None:
        nodes, weights = np.polynomial.legendre.leggauss(n_lambda)
        lams = 0.5 * (nodes + 1.0)
        wts = 0.5 * weights
    else:
        lams = np.asarray(lambdas, dtype=np.float64)
        if np.any(lams <= 0.0) or np.any(lams >= 1.0):
            raise ValueError(
                "lambdas must lie strictly inside (0, 1): lam=0 "
                "cannot recover U_model from the recorded mixed "
                "potential, and lam=1 makes the analytic COM term "
                "1/(1-lam) singular (use interior quadrature nodes)")
        wts = None

    du_mean = np.empty(len(lams))
    du_std = np.empty(len(lams))
    for i, lam in enumerate(lams):
        mixed = LambdaMix(model, float(lam), centers_vap, k_spring,
                          masks)
        md = VelocityVerlet(mixed, structure,
                            timestep=timestep, temperature=temperature,
                            seed=seed + 100 + i,
                            target_temperature=temperature,
                            friction=friction, chunk_size=sample)
        md.run(equil_steps, record_trajectory=False)
        hist = md.run(prod_steps, record_trajectory=True)
        # <U_model - U_Einstein> over the recorded frames
        vals = []
        for pos in hist["positions"]:
            pos_vap = np.zeros((n_vap, 3))
            pos_vap[vap.local_to_vap] = pos
            d = pos_vap - centers_vap
            u_e = 0.5 * k_spring * float(
                np.sum(np.sum(d ** 2, axis=-1) * masks))
            # E_pot recorded by the chunk is U(lambda); invert the mix
            vals.append(u_e)
        u_lambda = np.asarray(hist["potential"])
        u_e = np.asarray(vals)
        # exact algebra: U_model = (U(lam) - (1-lam) U_E) / lam
        # (lam > 0 guaranteed: GL nodes are interior, and explicit
        # lambdas are validated to (0, 1))
        u_model = (u_lambda - (1.0 - lam) * u_e) / lam
        du = u_model - u_e
        du_mean[i] = float(np.mean(du))
        du_std[i] = float(np.std(du) / np.sqrt(len(du)))

    # --- exact COM separation (see module docstring) -----------------
    # only valid when the MODEL is translation invariant (any real
    # interatomic potential); disable for spring-anchored test models
    kt = KB * temperature
    if not com_correction:
        if wts is None:
            delta_f = float(np.trapezoid(du_mean, lams)
                            if hasattr(np, "trapezoid")
                            else np.trapz(du_mean, lams))
        else:
            delta_f = float(np.sum(wts * du_mean))
        f_einstein = einstein_free_energy(len(structure),
                                          structure.masses, k_spring,
                                          temperature)
        f_total = f_einstein + delta_f
        return {"free_energy": f_total,
                "free_energy_per_atom": f_total / len(structure),
                "f_einstein": f_einstein, "delta_f": delta_f,
                "k_spring": float(k_spring), "lambdas": lams,
                "du_mean": du_mean, "du_stderr": du_std}
    m = structure.masses
    if np.ptp(m) > 1e-9 * m.mean():
        import warnings
        warnings.warn("Frenkel-Ladd COM separation is exact only for "
                      "equal masses; applying the equal-mass COM "
                      "correction as the leading term")
    # remove the analytic COM part of the integrand (it diverges at
    # lambda -> 1 and must not be sampled numerically)
    du_int = du_mean + 1.5 * kt / (1.0 - lams)
    if wts is None:
        delta_f = float(np.trapezoid(du_int, lams)
                        if hasattr(np, "trapezoid")
                        else np.trapz(du_int, lams))
    else:
        delta_f = float(np.sum(wts * du_int))
    # Einstein reference restricted to the 3N-3 internal modes: the
    # COM oscillator has spring kN and mass N<m> -> the SAME frequency
    # as one atom's spring, so subtract one atom's 3-mode term
    f_einstein = einstein_free_energy(len(structure), m, k_spring,
                                      temperature)
    w_com = np.sqrt(k_spring / m.mean() * FORCE_TO_ACC)
    f_e_com = 3.0 * kt * np.log(HBAR_EV_FS * w_com / kt)
    f_com = free_com_term(float(m.sum()), structure.volume,
                          temperature)
    f_total = (f_einstein - f_e_com) + delta_f + f_com
    return {"free_energy": f_total,
            "free_energy_per_atom": f_total / len(structure),
            "f_einstein": f_einstein, "f_einstein_com": f_e_com,
            "f_com_free": f_com, "delta_f": delta_f,
            "k_spring": float(k_spring), "lambdas": lams,
            "du_mean": du_mean, "du_int": du_int,
            "du_stderr": du_std}
