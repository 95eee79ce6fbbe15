"""Lattices the benchmark's MD cells start from beyond `generate`'s fcc,
made from `--seed` as `generate.jittered_fcc` makes its own: the same
seed gives the same positions, every seed the same size. The port's
tests import `jittered_bcc` too (`tests/test_torch_adp_reference.py`)."""
from __future__ import annotations

import numpy as np

BCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])


def jittered_bcc(reps: int, a: float, sigma: float, seed: int):
    """Periodic bcc supercell of 2 reps^3 atoms, every coordinate moved by
    N(0, sigma) from numpy's generator on `seed`. -> (positions [n, 3],
    cell [3, 3]) in A, float64."""
    grid = np.stack(np.meshgrid(*[np.arange(reps)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    pos = ((grid[:, None, :] + BCC_BASIS[None]) * a).reshape(-1, 3)
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.eye(3) * a * reps
