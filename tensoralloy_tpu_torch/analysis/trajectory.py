"""MD trajectory observables: RDF, MSD, VACF, vibrational DOS, diffusion
(port of `tensoralloy_tpu/analysis/trajectory.py`).

The pair histogram, the O(N^2) loop, runs in torch on the given device
(minimum-image distances and an `index_add` of integer counts per
frame); the time-series reductions over lag origins are host numpy.

Units follow `dynamics.py`: positions A, velocities A/fs, time fs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..atoms import Structure
from ..precision import resolve_device

__all__ = ["radial_distribution", "mean_squared_displacement",
           "velocity_autocorrelation", "vibrational_dos",
           "diffusion_coefficient"]


def _pair_histogram(pos, cell, sel_i, sel_j, nbins: int,
                    rmax: float) -> torch.Tensor:
    """Distance histogram [nbins] (int64) over the minimum-image pairs
    i in sel_i, j in sel_j, i != j; the selections are {0, 1} masks.
    float32, as the reference computes it."""
    frac = pos @ torch.linalg.inv(cell)
    d = frac[:, None, :] - frac[None, :, :]
    d = d - torch.round(d)
    dr = torch.einsum("ijk,kl->ijl", d, cell)
    r = torch.sqrt(torch.sum(dr * dr, dim=-1) + 1e-32)
    pair_w = sel_i[:, None] * sel_j[None, :]
    pair_w = pair_w * (1.0 - torch.eye(pos.shape[0], dtype=pos.dtype,
                                       device=pos.device))
    bins = torch.floor(r / rmax * nbins).to(torch.int64)
    valid = (bins < nbins) & (pair_w > 0)
    bins = torch.where(valid, bins, nbins)        # overflow bucket
    # exact integer counts (a float accumulator loses +1 increments
    # once a bin passes 2^24)
    counts = torch.zeros(nbins + 1, dtype=torch.int64, device=pos.device)
    counts.index_add_(0, bins.reshape(-1), valid.to(torch.int64).reshape(-1))
    return counts[:nbins]


def radial_distribution(
        frames: Union[Structure, Sequence[Structure]],
        rmax: float = 6.0, nbins: int = 200,
        pairs: Optional[Sequence[Tuple[str, str]]] = None,
        device="cuda") -> Dict[str, np.ndarray]:
    """Partial radial distribution functions g_ab(r).

    `frames`: one Structure or a trajectory sharing one stoichiometry
    (cells may differ, e.g. under NPT). `pairs`: species pairs (default
    all unordered pairs; the total is always given). g_ab(r) =
    <n_ab(r)> / (N_a rho_b 4 pi r^2 dr), rho_b = N_b / V. `rmax` must
    stay below half the shortest cell width (checked per frame). The
    histogram runs on `device` (the card unless "cpu" is asked for).

    -> {"r": bin centres [nbins], "total": g [nbins], "Ni-Ni": ...}."""
    device = resolve_device(device)
    if isinstance(frames, Structure):
        frames = [frames]
    symbols = frames[0].symbols
    species = sorted(set(symbols))
    if pairs is None:
        pairs = [(a, b) for i, a in enumerate(species)
                 for b in species[i:]]
    edges = np.linspace(0.0, rmax, nbins + 1)
    dr = edges[1] - edges[0]
    centers = 0.5 * (edges[1:] + edges[:-1])

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    masks = {el: f32([s == el for s in symbols]) for el in species}
    n_of = {el: float(np.sum([s == el for s in symbols])) for el in species}
    acc = {pair: np.zeros(nbins) for pair in pairs}
    acc_total = np.zeros(nbins)
    ones = f32(np.ones(len(symbols)))
    vol_mean = 0.0
    for s in frames:
        if list(s.symbols) != list(symbols):
            raise ValueError("all frames must share one stoichiometry")
        widths = s.volume / np.linalg.norm(
            np.cross(np.roll(s.cell, 1, 0), np.roll(s.cell, 2, 0)),
            axis=1)
        if rmax > 0.5 * widths.min() + 1e-9:
            raise ValueError(
                f"rmax={rmax} exceeds half the shortest cell width "
                f"({0.5 * widths.min():.3f} A): minimum image invalid")
        pos, cell = f32(s.positions), f32(s.cell)
        vol_mean += s.volume / len(frames)
        for a, b in pairs:
            h = _pair_histogram(pos, cell, masks[a], masks[b], nbins,
                                float(rmax))
            acc[(a, b)] += h.cpu().numpy() / len(frames)
        acc_total += _pair_histogram(pos, cell, ones, ones, nbins,
                                     float(rmax)).cpu().numpy() / len(frames)
    shell = 4.0 * np.pi * centers ** 2 * dr
    out = {"r": centers}
    n_all = float(len(symbols))
    out["total"] = acc_total / (shell * n_all * (n_all / vol_mean))
    for a, b in pairs:
        norm = shell * n_of[a] * (n_of[b] / vol_mean)
        out[f"{a}-{b}"] = acc[(a, b)] / np.maximum(norm, 1e-300)
    return out


def mean_squared_displacement(positions: np.ndarray,
                              timestep: float = 1.0,
                              max_lag: Optional[int] = None
                              ) -> Dict[str, np.ndarray]:
    """MSD(tau) over all lag origins and atoms of an unwrapped trajectory
    [T, N, 3] (`timestep` fs between frames). -> {"t": [L], "msd": A^2
    [L]}, L = min(max_lag, T - 1)."""
    pos = np.asarray(positions)
    t_frames = pos.shape[0]
    lmax = min(max_lag or (t_frames - 1), t_frames - 1)
    msd = np.empty(lmax)
    for lag in range(1, lmax + 1):
        d = pos[lag:] - pos[:-lag]
        msd[lag - 1] = np.mean(np.sum(d * d, axis=-1))
    return {"t": np.arange(1, lmax + 1) * timestep, "msd": msd}


def velocity_autocorrelation(velocities: np.ndarray,
                             timestep: float = 1.0,
                             max_lag: Optional[int] = None
                             ) -> Dict[str, np.ndarray]:
    """Normalized VACF(tau) = <v(t).v(t+tau)> / <v.v> of [T, N, 3]
    velocities. -> {"t": [L + 1] (tau = 0 included), "vacf": [L + 1]}."""
    v = np.asarray(velocities)
    t_frames = v.shape[0]
    lmax = min(max_lag or (t_frames - 1), t_frames - 1)
    c = np.empty(lmax + 1)
    for lag in range(lmax + 1):
        a = v[:t_frames - lag] if lag else v
        b = v[lag:] if lag else v
        c[lag] = np.mean(np.sum(a * b, axis=-1))
    return {"t": np.arange(lmax + 1) * timestep, "vacf": c / c[0]}


def vibrational_dos(velocities: np.ndarray, timestep: float = 1.0,
                    masses: Optional[np.ndarray] = None,
                    max_lag: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """Vibrational density of states: the cosine transform of the
    (mass-weighted) velocity autocorrelation with a Hann window.

    `velocities` [T, N, 3] A/fs, `timestep` fs between frames, `masses`
    [N] amu (uniform weights if omitted). -> {"freq_thz", "dos"}, the
    DOS normalized to unit integral over the sampled band (Nyquist =
    500 / timestep THz)."""
    v = np.asarray(velocities, dtype=np.float64)
    t_frames = v.shape[0]
    if t_frames < 2:
        raise ValueError("vibrational_dos needs at least 2 frames "
                         f"(got {t_frames})")
    lmax = min(max_lag or (t_frames - 1), t_frames - 1)
    w = (np.ones(v.shape[1]) if masses is None
         else np.asarray(masses, np.float64))
    c = np.empty(lmax + 1)
    for lag in range(lmax + 1):
        a = v[:t_frames - lag] if lag else v
        b = v[lag:] if lag else v
        c[lag] = np.mean(np.sum(a * b, axis=-1) @ w) / w.sum()
    c /= c[0]
    hann = 0.5 * (1.0 + np.cos(np.pi * np.arange(lmax + 1) / lmax))
    ct = c * hann
    # one-sided cosine transform on the lag grid
    freqs = np.arange(lmax + 1) / (2.0 * lmax * timestep)   # 1/fs
    phase = 2.0 * np.pi * np.outer(freqs, np.arange(lmax + 1) * timestep)
    weights = np.ones(lmax + 1)
    weights[0] = 0.5                                      # trapezoid
    weights[-1] = 0.5
    dos = 2.0 * timestep * (np.cos(phase) * (ct * weights)).sum(axis=1)
    dos = np.maximum(dos, 0.0)
    area = np.trapezoid(dos, freqs) if hasattr(np, "trapezoid") \
        else np.trapz(dos, freqs)
    if area > 0:
        dos /= area
    return {"freq_thz": freqs * 1000.0, "dos": dos / 1000.0}


def diffusion_coefficient(positions: np.ndarray,
                          timestep: float = 1.0,
                          fit_start: float = 0.5) -> float:
    """Einstein diffusion coefficient D = slope(MSD) / 6 in A^2/fs, a
    least-squares fit over the tail of the MSD (`fit_start` as a
    fraction of the largest lag, past the ballistic onset)."""
    res = mean_squared_displacement(positions, timestep)
    t, msd = res["t"], res["msd"]
    i0 = int(len(t) * fit_start)
    if len(t) - i0 < 2:
        i0 = max(0, len(t) - 2)
    slope = np.polyfit(t[i0:], msd[i0:], 1)[0]
    return float(slope / 6.0)
