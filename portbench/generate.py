"""The benchmark's inputs, made from `--seed`: jittered lattices, the
order of training batches, the split of a structure database and the
initial weights of a head. The same seed gives the same inputs; every
seed gives the same sizes."""
from __future__ import annotations

import math

import numpy as np
import torch

FCC_BASIS = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.5],
                      [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]])


def jittered_fcc(reps: int, a: float, sigma: float, seed: int):
    """Periodic fcc supercell of 4 reps^3 atoms, every coordinate moved by
    N(0, sigma) from numpy's generator on `seed`. -> (positions [n, 3],
    cell [3, 3]) in A, float64."""
    grid = np.stack(np.meshgrid(*[np.arange(reps)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    pos = ((grid[:, None, :] + FCC_BASIS[None]) * a).reshape(-1, 3)
    pos = pos + np.random.default_rng(seed).normal(0.0, sigma, pos.shape)
    return pos, np.eye(3) * a * reps


def legacy_seed(seed: int) -> int:
    """A seed for numpy's `RandomState`, which takes 32 bits."""
    return int(seed) % (2 ** 32)


def split(n_rows: int, test_size: int, split_seed: int):
    """(train rows, test rows) of a database: a permutation by
    `RandomState(split_seed)`, the first `test_size` rows for the test."""
    idx = np.random.RandomState(split_seed).permutation(n_rows)
    return idx[test_size:], idx[:test_size]


def batch_stream(n: int, batch_size: int, seed: int):
    """Endless [batch_size] index arrays into n training rows: a new
    permutation by `RandomState(seed)` an epoch, its full batches in
    order."""
    rng = np.random.RandomState(legacy_seed(seed))
    while True:
        idx = rng.permutation(n)
        for lo in range(0, n - batch_size + 1, batch_size):
            yield idx[lo:lo + batch_size]


def static_energy(energies, counts) -> float:
    """The per-atom energy e0 that fits E = n e0 best by least squares."""
    e, n = np.asarray(energies, np.float64), np.asarray(counts, np.float64)
    return float(np.sum(e * n) / np.sum(n * n))


def head_weights(sizes, seed: int, bias: float, device,
                 dtype=torch.float32) -> list:
    """A resnet-dt MLP of widths `sizes` drawn on `device` from one
    `torch.Generator` seeded with `seed`, in one draw: each weight
    N(0, 2 / fan_in), hidden biases 0, dt 0.1 where a layer keeps its
    width, the output bias `bias`. -> [{"w", "b"(, "dt")}] a layer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(a * b for a, b in zip(sizes, sizes[1:]))
    draw = torch.randn(total, generator=gen, dtype=dtype, device=device)
    layers, at = [], 0
    for li, (a, b) in enumerate(zip(sizes, sizes[1:])):
        w = draw[at:at + a * b].reshape(a, b) * math.sqrt(2.0 / a)
        at += a * b
        last = li == len(sizes) - 2
        layer = {"w": w.contiguous(),
                 "b": torch.full((b,), bias if last else 0.0, dtype=dtype,
                                 device=device)}
        if not last and a == b:
            layer["dt"] = torch.full((b,), 0.1, dtype=dtype, device=device)
        layers.append(layer)
    return layers
