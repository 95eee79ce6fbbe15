"""Harmonic transition-state kinetics from exact autodiff Hessians.

Vineyard's harmonic TST (Phys. Rev. 1957): the jump rate of a thermally
activated process is

    k(T) = nu_star * exp(-E_m / kT),
    nu_star = prod_i^{3N-3} nu_i(min) / prod_i^{3N-4} nu_i(saddle)

with the frequencies from the mass-weighted Hessian at the minimum and
at the saddle (3 translational zero modes excluded at each; the saddle
contributes exactly ONE imaginary mode, which is checked, not assumed).
Here both Hessians are EXACT autograd evaluations of the trained
potential and the saddle comes from the native climbing-image NEB —
the reference framework can compute neither without exporting to
LAMMPS + external tooling.

`vacancy_diffusivity` composes the whole pipeline: relax the perfect
and vacancy cells, CI-NEB the hop, Vineyard prefactor, and the fcc
vacancy diffusion coefficient D_v(T) = z d^2 k(T) / 6 (z = 12
equivalent jumps, d = a0/sqrt(2) the jump distance; for the TRACER
self-diffusivity multiply by the vacancy concentration and the fcc
correlation factor f = 0.7815).

Units: eV, A, fs, amu; frequencies returned in THz, D in m^2/s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..atoms import Structure
from ..dynamics import FORCE_TO_ACC, KB

__all__ = ["mass_weighted_frequencies", "vineyard_rate",
           "vacancy_diffusivity"]


def mass_weighted_frequencies(hessian: np.ndarray, masses: np.ndarray
                              ) -> np.ndarray:
    """Eigenfrequencies (THz, signed: negative = imaginary) of a
    [3N, 3N] Hessian (eV/A^2) with atomic masses (amu)."""
    n = len(masses)
    rm = np.repeat(1.0 / np.sqrt(masses), 3)
    h = hessian * rm[:, None] * rm[None, :]
    h = 0.5 * (h + h.T)
    lam = np.linalg.eigvalsh(h)                  # eV/(A^2 amu)
    omega = np.sign(lam) * np.sqrt(np.abs(lam) * FORCE_TO_ACC)  # 1/fs
    return omega / (2.0 * np.pi) * 1000.0        # THz


def vineyard_rate(calc, minimum: Structure, saddle: Structure,
                  zero_tol_thz: float = 0.05) -> Dict[str, float]:
    """Harmonic TST rate ingredients for one hop.

    Returns {"e_m" (eV), "nu_star_thz", "nu_min"/"nu_sad" (sorted
    THz arrays), "n_imaginary"}. Raises if the saddle does not have
    exactly one imaginary mode outside the zero-mode tolerance —
    a loose NEB gives a shoulder, not a saddle, and the prefactor
    would be silently wrong.
    """
    e_min = float(calc.get_potential_energy(minimum))
    e_sad = float(calc.get_potential_energy(saddle))
    nu_min = mass_weighted_frequencies(
        np.asarray(calc.get_hessian(minimum)), minimum.masses)
    nu_sad = mass_weighted_frequencies(
        np.asarray(calc.get_hessian(saddle)), saddle.masses)

    def split(nu, expect_neg):
        # the 3 smallest-|nu| modes are the translations (a fixed
        # tolerance misclassifies when the stationary point is only
        # converged to finite fmax); they must still be near zero
        idx = np.argsort(np.abs(nu))
        trans = nu[idx[:3]]
        if np.max(np.abs(trans)) > max(10 * zero_tol_thz, 0.5):
            raise ValueError(
                "translational modes are not near zero "
                f"({trans.tolist()} THz): not a stationary point?")
        rest = nu[idx[3:]]
        neg = rest[rest < 0]
        if len(neg) != expect_neg:
            raise ValueError(
                f"expected {expect_neg} imaginary mode(s), found "
                f"{len(neg)}: {neg.tolist()} THz")
        return rest[rest > 0]

    pos_min = split(nu_min, 0)
    pos_sad = split(nu_sad, 1)
    # log-sum for numerical sanity (products of ~300 THz-scale numbers)
    log_nu = np.sum(np.log(pos_min)) - np.sum(np.log(pos_sad))
    nu_star = float(np.exp(log_nu))
    return {"e_m": e_sad - e_min, "nu_star_thz": nu_star,
            "nu_min": nu_min, "nu_sad": nu_sad,
            "n_imaginary": 1}


def vacancy_diffusivity(calc, bulk: Structure,
                        supercell=(3, 3, 3),
                        temperatures=(600.0, 900.0, 1200.0),
                        site: int = 0,
                        fmax: float = 0.01, n_images: int = 7,
                        neb_fmax: float = 0.03,
                        neb_steps: int = 800) -> Dict[str, object]:
    """fcc vacancy hop kinetics end-to-end: vacancy formation +
    migration energies, Vineyard attempt frequency, jump rates and
    D_v(T) = z d^2 k / 6.

    The hop moves the nearest neighbor of the removed `site` into the
    vacancy. Returns the rate table plus the NEB result for
    inspection. Assumes an fcc-like first shell for (z, d); report
    others via `vineyard_rate` directly.
    """
    from .elastic import relax_positions
    from ..neb import NEB

    sc = bulk.repeat(tuple(supercell))
    sc = relax_positions(calc, sc, fmax=fmax, steps=500)
    e_bulk = float(calc.get_potential_energy(sc))
    n = len(sc)

    # vacancy at `site`; initial state
    keep = np.arange(n) != site
    vac_i = Structure(sc.numbers[keep], sc.positions[keep],
                      sc.cell.copy(), sc.pbc)
    # the hopping atom: nearest neighbor of the removed site
    from ..atoms import minimum_image
    d = minimum_image(sc.positions[keep] - sc.positions[site], sc.cell)
    hopper = int(np.argmin(np.linalg.norm(d, axis=1)))
    jump_d = float(np.linalg.norm(d[hopper]))
    # final state: hopper sits at the old vacancy position
    vac_f = vac_i.copy()
    vac_f.positions = vac_f.positions.copy()
    vac_f.positions[hopper] = sc.positions[site]

    vac_i = relax_positions(calc, vac_i, fmax=fmax, steps=500)
    vac_f = relax_positions(calc, vac_f, fmax=fmax, steps=500)
    e_f = (float(calc.get_potential_energy(vac_i))
           - (n - 1) / n * e_bulk)

    neb = NEB(calc.model, vac_i, vac_f, n_images=n_images, climb=True)
    res = neb.run(fmax=neb_fmax, max_steps=neb_steps)
    saddle = neb.saddle_structure()

    tst = vineyard_rate(calc, vac_i, saddle)
    z, d_jump = 12, jump_d
    out = {"formation_energy": e_f,
           "migration_energy": tst["e_m"],
           "activation_energy": e_f + tst["e_m"],
           "nu_star_thz": tst["nu_star_thz"],
           "jump_distance": d_jump,
           "neb": res,
           "temperatures": np.asarray(temperatures, float)}
    rates, dv = [], []
    for t_k in out["temperatures"]:
        k = tst["nu_star_thz"] * 1e12 * np.exp(
            -tst["e_m"] / (KB * t_k))            # 1/s
        rates.append(k)
        dv.append(z / 6.0 * (d_jump * 1e-10) ** 2 * k)  # m^2/s
    out["jump_rate_hz"] = np.asarray(rates)
    out["d_vacancy_m2_s"] = np.asarray(dv)
    return out
