"""The angular-dependent potential (ADP) of one element in the plain
reference: its functions, the energy of each centre, and forces and
virial by autograd on a neighbour list with a margin.

The model (Mishin, Mehl & Papaconstantopoulos, Acta Mater. 53, 4029
(2005); LAMMPS `pair_style adp`):

    E_i = F(rho_i) + 1/2 sum_j phi(r_ij) + 1/2 |mu_i|^2
          + 1/2 sum_ab lam_i,ab^2 - nu_i^2 / 6
    rho_i = sum_j rho(r_ij),  mu_i = sum_j u(r_ij) r_ij,
    lam_i = sum_j w(r_ij) r_ij (x) r_ij,  nu_i = tr lam_i,

r_ij the vector from centre i to neighbour j. rho, phi and F are Zhou,
Johnson & Wadley's (PRB 69, 144113 (2004)):

    g(r; a, b, c) = a exp(-b (r / r_e - 1)) / (1 + (r / r_e - c)^20)
    rho(r) = g(r; f_e, beta, lamda)
    phi(r) = g(r; A, alpha, kappa) - g(r; B, beta, lamda)

and F the three branches of their embedding, F_1 below rho_n = 0.85
rho_e, F_2 up to rho_0 = 1.15 rho_e, F_3 above:

    F_1 = Fn0 + Fn1 x + Fn2 x^2 + Fn3 x^3,   x = rho / rho_n - 1
    F_2 = F0 + F1 y + F2 y^2 + F3 y^3,       y = rho / rho_e - 1
    F_3 = Fe (1 - eta ln z) z^eta,           z = rho / rho_s

u and w are Mishin's (p1 e^{-p2 r} + p3) psi((r - r_c) / h), psi(x) =
x^4 / (1 + x^4) for x < 0 and 0 beyond, with (d1, d2, d3) for u and
(q1, q2, q3) for w.

Departures from the papers, each as TensorAlloy trains and runs the
model (`zjw04xc` and `mishinh`):
  - F blends its three branches by sigmoids instead of switching:
    F = s1 F_1 + (1 - s1 - s3) F_2 + s3 F_3 with s1 = sigmoid(2 (rho_n -
    rho)) and s3 = sigmoid(2 (rho - rho_0)), and z = rho / rho_s + 1e-8,
    so F is smooth everywhere;
  - rho and phi are cut hard at the model's cutoff r_c (6.5 A for ML-ADP
    Mo): a pair at or beyond it adds nothing, where Zhou et al. let the
    functions decay;
  - u and w vanish beyond their own r_c (Mishin's psi), which is a
    trained parameter of the model and lies inside the model's cutoff;
    they are cut at the model's cutoff too, which then changes nothing.

The parameters are the saved model's leaves `p/zjw04xc/<element>/*`
(rho, phi, F) and `p/mishinh/<element><element>/*` (u, w); nothing else
of the model is read.

The port's own tests import this module, with `reference/md.py` and
`portbench/lattice.py` (`tests/test_torch_adp_reference.py`, tier-1):
an edit here changes what those tests hold the program to, so run them
with it.
"""
from __future__ import annotations

import numpy as np
import torch

from . import full_precision, neighbors, slabs

ZJW = "zjw04xc"
MISHIN = "mishinh"


def params_from_npz(path: str, element: str) -> dict:
    """The saved leaves of one element's ADP -> {"zjw04xc": {name:
    float}, "mishinh": {name: float}}."""
    keys = {ZJW: f"p/{ZJW}/{element}/", MISHIN: f"p/{MISHIN}/{element * 2}/"}
    with np.load(path) as z:
        return {name: {k[len(prefix):]: float(z[k]) for k in z.files
                       if k.startswith(prefix)}
                for name, prefix in keys.items()}


def _zhou(r, a, b, c, r_e):
    x = r / r_e
    return a * torch.exp(-b * (x - 1.0)) / (1.0 + (x - c) ** 20)


def density(r, p: dict):
    """rho(r) of the zjw04xc leaves `p`."""
    return _zhou(r, p["f_eq"], p["beta"], p["lamda"], p["r_eq"])


def pair(r, p: dict):
    """phi(r) of the zjw04xc leaves `p`."""
    return (_zhou(r, p["A"], p["alpha"], p["kappa"], p["r_eq"])
            - _zhou(r, p["B"], p["beta"], p["lamda"], p["r_eq"]))


def embedding(rho, p: dict):
    """F(rho) of the zjw04xc leaves `p`, its branches blended."""
    rho_n, rho_0 = 0.85 * p["rho_e"], 1.15 * p["rho_e"]
    x = rho / rho_n - 1.0
    f1 = p["Fn0"] + p["Fn1"] * x + p["Fn2"] * x ** 2 + p["Fn3"] * x ** 3
    y = rho / p["rho_e"] - 1.0
    f2 = p["F0"] + p["F1"] * y + p["F2"] * y ** 2 + p["F3"] * y ** 3
    z = rho / p["rho_s"] + 1e-8
    f3 = p["Fe"] * (1.0 - p["eta"] * torch.log(z)) * z ** p["eta"]
    s1 = torch.sigmoid(2.0 * (rho_n - rho))
    s3 = torch.sigmoid(2.0 * (rho - rho_0))
    return s1 * f1 + (1.0 - s1 - s3) * f2 + s3 * f3


def _mishin(r, p1, p2, p3, r_c, h):
    x = torch.clamp((r_c - r) / h, min=0.0)
    return (p1 * torch.exp(-p2 * r) + p3) * x ** 4 / (1.0 + x ** 4)


def dipole(r, p: dict):
    """u(r) of the mishinh leaves `p`."""
    return _mishin(r, p["d1"], p["d2"], p["d3"], p["rc"], p["h"])


def quadrupole(r, p: dict):
    """w(r) of the mishinh leaves `p`."""
    return _mishin(r, p["q1"], p["q2"], p["q3"], p["rc"], p["h"])


def energies(vec, mask, params: dict, rcut: float):
    """E_i of each centre from its row of neighbour vectors: vec [rows,
    width, 3], mask [rows, width] (True on a listed pair) -> [rows]."""
    zjw, mishin = params[ZJW], params[MISHIN]
    r2 = torch.sum(vec * vec, dim=-1)
    r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
    within = (mask & (r < rcut)).to(vec.dtype)
    rho = torch.sum(density(r, zjw) * within, dim=1)
    phi = 0.5 * torch.sum(pair(r, zjw) * within, dim=1)
    u = dipole(r, mishin) * within
    w = quadrupole(r, mishin) * within
    mu = torch.sum(u[..., None] * vec, dim=1)                   # [rows, 3]
    lam = torch.sum(w[..., None, None] * vec[..., :, None]
                    * vec[..., None, :], dim=1)                 # [rows, 3, 3]
    nu = lam[:, 0, 0] + lam[:, 1, 1] + lam[:, 2, 2]
    angular = (0.5 * torch.sum(mu * mu, dim=-1)
               + 0.5 * torch.sum(lam * lam, dim=(-1, -2)) - nu * nu / 6.0)
    return embedding(rho, zjw) + phi + angular


class Cell:
    """E, forces and virial of one periodic cell of one element under the
    ADP, on a neighbour list (`slabs.pairs`) built with a margin and
    rebuilt once an atom has moved half of it. A block's energy depends
    on its centres' pair vectors alone, so each block's vector gradient
    is added to its centres and taken from their neighbours (as
    `md.Cell` does)."""

    def __init__(self, params: dict, rcut: float, cell: torch.Tensor,
                 margin: float = 1.0, block: int = 8192):
        self.params, self.rcut = params, float(rcut)
        self.cell = cell
        self.margin, self.block = margin, block
        self.anchor = None

    def _list(self, pos: torch.Tensor) -> None:
        if self.anchor is not None:
            moved = torch.max(torch.linalg.norm(pos - self.anchor, dim=1))
            if float(moved) < 0.5 * self.margin:
                return
        self.anchor = pos.detach().clone()
        i, self.j, self.shift = slabs.pairs(
            pos, self.cell, self.rcut + self.margin)
        self.index, self.mask = neighbors.table(i, pos.shape[0])

    def evaluate(self, pos: torch.Tensor):
        """pos [n, 3] -> (energy, a float64 scalar tensor; forces [n, 3];
        virial [3, 3], W_ab = sum over pairs of dE/dr_a r_b)."""
        with full_precision():
            self._list(pos)
            pos = pos.detach()
            n = pos.shape[0]
            forces = torch.zeros_like(pos)
            virial = pos.new_zeros((3, 3))
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
                    e = energies(vec, m, self.params, self.rcut)
                    (dvec,) = torch.autograd.grad(e.sum(), vec)
                energy = energy + e.detach().double().sum()
                forces[lo:hi] += dvec.sum(dim=1)
                forces.index_add_(0, j[m], -dvec[m])
                virial += torch.einsum("rwa,rwb->ab", dvec, vec.detach())
            return energy, forces, virial

    def energy_forces(self, pos: torch.Tensor):
        """pos [n, 3] -> (energy, a float64 scalar tensor; forces [n, 3]):
        what `md.baoab_chunk` asks of a potential."""
        energy, forces, _ = self.evaluate(pos)
        return energy, forces
