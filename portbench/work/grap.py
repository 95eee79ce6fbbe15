"""Bytes and useful FLOP of the GRAP kernels, frozen from the formulas
that priced the port's kernel table (PERF.md), as functions of the sizes
of one launch: `rows` centre rows of `width` pair entries, `real` of
them real, K filters, D monomials (56 up to moment 5), M moments, one
nonzero contraction weight a monomial, `n_slots` slots; F = n_slots K M.

Bytes as in `work.sf`, with four geometry arrays (r, ux, uy, uz). FLOP
for the real entries, a transcendental as one:
  grap         per pair 4 (cutoff), D - 1 (monomials), 5 per filter and
               2 K D (the contraction); per (row, slot, filter) 3 per
               nonzero weight
  grap_vjp     the forward's per-pair work once (P recomputed), then per
               member and pair 8, D - 1, 12 per filter, 4 K D and 4 D;
               per member and (row, slot, filter) 2 D M + 3 D
  grap_vjp_bwd per pair 8, 3 (D - 1), 12 per filter, 6 K D; per (row,
               slot, filter) 3 D + 3 D M; with the geometry term per pair
               14 + 6 (D - 1) + 20 K + 10 K D + 15 D more, and per (row,
               slot, filter) 2 D M + 5 D more
"""
from __future__ import annotations

import math

from .sf import ITEMSIZE, _frame


def _forward_pairs(real, k, d):
    return real * (4 + (d - 1) + 5 * k + 2 * k * d)


def grap(rows, width, real, k, d, m, n_slots):
    out = rows * n_slots * k * m * ITEMSIZE
    return (_frame(rows, width, real, 4) + out,
            _forward_pairs(real, k, d) + 3 * rows * n_slots * k * d)


def grap_vjp(rows, width, real, k, d, m, n_slots, batch=1):
    cot = batch * rows * n_slots * k * m * ITEMSIZE
    out = 4 * batch * rows * width * ITEMSIZE
    flop = _forward_pairs(real, k, d) + batch * (
        real * (8 + (d - 1) + 12 * k + 4 * k * d + 4 * d)
        + rows * n_slots * k * (2 * d * m + 3 * d))
    return _frame(rows, width, real, 4) + cot + out, flop


def grap_vjp_bwd(rows, width, real, k, d, m, n_slots, geometry=False):
    f = rows * n_slots * k * m * ITEMSIZE
    out = f + (4 * rows * width * ITEMSIZE if geometry else 0)
    flop = (real * (8 + 3 * (d - 1) + 12 * k + 6 * k * d)
            + rows * n_slots * k * (3 * d + 3 * d * m))
    if geometry:
        flop += (real * (14 + 6 * (d - 1) + 20 * k + 10 * k * d + 15 * d)
                 + rows * n_slots * k * (2 * d * m + 5 * d))
    return _frame(rows, width, real, 8) + f + out, flop


def launches(config: dict, lists: dict, kind: str) -> dict:
    """{kernel: (bytes, FLOP)} of one evaluation of a one-element GRAP
    model on `lists["pairs"]` = (rows, width, real) of one launch:
    `kind` "energy" the forward, "force" the forward and its VJP,
    "train" those and the second order without the geometry term."""
    rows, width, real = lists["pairs"]
    moments = list(config["moment_tensors"])
    k, m = len(config["rl"]), len(moments)
    d = math.comb(max(moments) + 3, 3)
    out = {"grap": grap(rows, width, real, k, d, m, 1)}
    if kind in ("force", "train"):
        out["grap_vjp"] = grap_vjp(rows, width, real, k, d, m, 1)
    if kind == "train":
        out["grap_vjp_bwd"] = grap_vjp_bwd(rows, width, real, k, d, m, 1)
    return out
