"""Energies, forces and BAOAB Langevin dynamics of the plain reference,
for one large periodic cell of one element under the configuration's
descriptors (`reference.family`).

Forces are the negative gradient of the energy by autograd, taken block
by block of centres: a block's energy depends on its centres' pair
vectors alone, so each block's vector gradient is added to its centres
and taken from their neighbours.

Units: A, fs, amu, eV; (eV/A) / amu = 9.648533290731905e-3 A/fs^2.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import family, full_precision, mlp, neighbors

FORCE_TO_ACC = 9.648533290731905e-3     # (eV/A) / amu in A/fs^2
KB = 8.617330337217213e-05              # eV/K


def heads_from_npz(path: str, element: str, dtype, device):
    """The saved weights of one element's head -> (layers, xlo, xhi)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k.startswith(f"p/{element}/")}

    def leaf(key):
        return torch.as_tensor(flat[f"p/{element}/{key}"], dtype=dtype,
                               device=device)
    layers, li = [], 0
    while f"p/{element}/mlp/layers/{li}/w" in flat:
        layer = {"w": leaf(f"mlp/layers/{li}/w"),
                 "b": leaf(f"mlp/layers/{li}/b")}
        if f"p/{element}/mlp/layers/{li}/dt" in flat:
            layer["dt"] = leaf(f"mlp/layers/{li}/dt")
        layers.append(layer)
        li += 1
    return layers, leaf("norm/xlo"), leaf("norm/xhi")


def maxwell_boltzmann(masses: np.ndarray, temperature: float, seed: int):
    """Velocities [n, 3] (A/fs) at `temperature`, drawn from numpy's
    `RandomState(seed)` normals scaled by sqrt(kT / m), the mass-weighted
    mean removed."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(KB * temperature / masses * FORCE_TO_ACC)
    v = rng.normal(size=(len(masses), 3)) * sigma[:, None]
    return v - np.average(v, axis=0, weights=masses)


class Cell:
    """E and F of one cell under an atomistic model, on a neighbour list
    built with a margin and rebuilt once an atom has moved half of it."""

    def __init__(self, config: dict, layers, xlo, xhi, cell: torch.Tensor,
                 margin: float = 1.0, block: int = 8192):
        self.config, self.layers = config, layers
        self.descriptors = family(config).descriptors
        self.xlo, self.xhi = xlo, xhi
        self.cell = cell
        self.margin, self.block = margin, block
        self.anchor = None

    def _list(self, pos: torch.Tensor) -> None:
        if self.anchor is not None:
            moved = torch.max(torch.linalg.norm(pos - self.anchor, dim=1))
            if float(moved) < 0.5 * self.margin:
                return
        self.anchor = pos.detach().clone()
        i, self.j, self.shift = neighbors.pairs(
            pos, self.cell, self.config["rcut"] + self.margin)
        self.index, self.mask = neighbors.table(i, pos.shape[0])

    def energy_forces(self, pos: torch.Tensor):
        """pos [n, 3] -> (energy, a float64 scalar tensor; forces [n, 3])."""
        with full_precision():
            self._list(pos)
            pos = pos.detach()
            n = pos.shape[0]
            forces = torch.zeros_like(pos)
            energy = torch.zeros((), dtype=torch.float64, device=pos.device)
            offsets = self.shift @ self.cell.to(pos)
            for lo in range(0, n, self.block):
                hi = min(lo + self.block, n)
                idx, m = self.index[lo:hi], self.mask[lo:hi]
                j = self.j[idx]
                vec = (pos[j] + offsets[idx] - pos[lo:hi, None, :]) \
                    * m[..., None].to(pos)
                vec.requires_grad_(True)
                with torch.enable_grad():
                    g = self.descriptors(vec, m, self.config)
                    e = mlp.energies(mlp.scale(g, self.xlo, self.xhi),
                                     self.layers)
                    (dvec,) = torch.autograd.grad(e.sum(), vec)
                energy = energy + e.detach().double().sum()
                forces[lo:hi] += dvec.sum(dim=1)
                forces.index_add_(0, j[m], -dvec[m])
            return energy, forces


def baoab_chunk(cell_model: Cell, pos, vel, masses, steps: int,
                timestep: float, temperature: float, friction: float,
                generator: torch.Generator, noise_rows: int,
                rows: torch.Tensor):
    """`steps` BAOAB steps from (pos, vel) [n, 3]: half kick, half drift,
    Ornstein-Uhlenbeck, half drift, half kick. The noise of a step is one
    standard normal draw of [noise_rows, 3] from `generator`, of which
    `rows` are the atoms'. -> (pos, vel, potential energy at the end)."""
    dt = timestep
    c1 = math.exp(-friction * dt)
    c2 = math.sqrt(1.0 - c1 * c1)
    m = masses[:, None]
    sigma = torch.sqrt(KB * temperature / m * FORCE_TO_ACC)
    _, f = cell_model.energy_forces(pos)
    acc = f / m * FORCE_TO_ACC
    for _ in range(steps):
        vel = vel + 0.5 * dt * acc
        pos = pos + 0.5 * dt * vel
        xi = torch.randn((noise_rows, 3), generator=generator,
                         dtype=vel.dtype, device=vel.device)[rows]
        vel = c1 * vel + c2 * sigma * xi
        pos = pos + 0.5 * dt * vel
        _, f = cell_model.energy_forces(pos)
        acc = f / m * FORCE_TO_ACC
        vel = vel + 0.5 * dt * acc
    energy, _ = cell_model.energy_forces(pos)
    return pos, vel, energy
