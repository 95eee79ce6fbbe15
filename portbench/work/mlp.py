"""Useful FLOP of the atomic MLP's matrix products: 2 in * out a product
of one atom's row with one layer's weights.

A force evaluation takes two products a layer (the energy forward and
the input gradient); a train step with a force loss takes six (the
forward, the first backward that gives the forces, and four in the loss
backward: the weight gradient of the energy path, and the weight and
input gradients through the first backward and back down the forward).
"""
from __future__ import annotations

FORCE_EVALUATION = 2
ENERGY = 1
TRAIN_STEP = 6


def flop_per_atom(sizes, products: int) -> int:
    """`sizes` the widths from the descriptor to the output, e.g. [96,
    128, 128, 1]."""
    return products * sum(2 * a * b for a, b in zip(sizes, sizes[1:]))
