"""Bytes and useful FLOP of the symmetry-function kernels, frozen from
the formulas that priced the port's kernel table (the table of kernels
in PERF.md), as functions of the sizes of one launch.

A launch covers `rows` centre rows of `width` entries each (pairs for
G2, triples for G4), of which `real` are real; `n_params` grid rows,
`n_slots` slots, so F = n_slots * n_params output columns; `batch`
cotangents for a VJP. Bytes: the slot and mask arrays read once in
full, the geometry (and the second order's v) of the real entries only,
a cotangent read once, the outputs written once. FLOP for the real
entries only, a transcendental as one:
  g2         per pair 4 (cutoff) + 7 per grid row
  g4         per triple 23 (geometry, three cutoffs) + 11 per grid row
  g2_vjp     per pair 8 (cutoff and slope) + per member 10 per grid row
  g4_vjp     per triple 50 (the geometry, the cosine's three slopes, three
             cutoffs and slopes) + per member 14 per grid row
  g2_vjp_bwd per pair 14 (cutoff, slope, curvature, the weight) + 22 per
             grid row
  g4_vjp_bwd per triple 130 (g4_vjp's geometry, three curvatures, the
             products with v, the Hessians of cos and F, the geometry
             terms) + 32 per grid row
`geometry` says whether a second-order launch writes its geometry term
(a train step's loss backward does not).
"""
from __future__ import annotations

ITEMSIZE = 4


def _frame(rows: int, width: int, real: int, arrays: int) -> int:
    return (2 * rows * width + arrays * real) * ITEMSIZE


def g2(rows, width, real, n_params, n_slots):
    out = rows * n_slots * n_params * ITEMSIZE
    return _frame(rows, width, real, 1) + out, real * (4 + 7 * n_params)


def g4(rows, width, real, n_params, n_slots):
    out = rows * n_slots * n_params * ITEMSIZE
    return _frame(rows, width, real, 3) + out, real * (23 + 11 * n_params)


def g2_vjp(rows, width, real, n_params, n_slots, batch=1):
    cot = batch * rows * n_slots * n_params * ITEMSIZE
    out = batch * rows * width * ITEMSIZE
    return (_frame(rows, width, real, 1) + cot + out,
            real * (8 + batch * 10 * n_params))


def g4_vjp(rows, width, real, n_params, n_slots, batch=1):
    cot = batch * rows * n_slots * n_params * ITEMSIZE
    out = 3 * batch * rows * width * ITEMSIZE
    return (_frame(rows, width, real, 3) + cot + out,
            real * (50 + batch * 14 * n_params))


def g2_vjp_bwd(rows, width, real, n_params, n_slots, geometry=False):
    f = rows * n_slots * n_params * ITEMSIZE
    out = f + (rows * width * ITEMSIZE if geometry else 0)
    return (_frame(rows, width, real, 2) + f + out,
            real * (14 + 22 * n_params))


def g4_vjp_bwd(rows, width, real, n_params, n_slots, geometry=False):
    f = rows * n_slots * n_params * ITEMSIZE
    out = f + (3 * rows * width * ITEMSIZE if geometry else 0)
    return (_frame(rows, width, real, 6) + f + out,
            real * (130 + 32 * n_params))


def launches(config: dict, lists: dict, kind: str) -> dict:
    """{kernel: (bytes, FLOP)} of one evaluation of a one-element
    symmetry-function model on `lists["pairs"]` and `lists["triples"]`,
    each (rows, width, real) of one launch: `kind` "energy" the
    forwards, "force" the forwards and their VJPs, "train" those and the
    second orders without the geometry term."""
    t2 = len(config["eta"]) * len(config["omega"])
    t4 = len(config["beta"]) * len(config["gamma"]) * len(config["zeta"])
    p, t = lists["pairs"], lists["triples"]
    out = {"g2": g2(*p, t2, 1), "g4": g4(*t, t4, 1)}
    if kind in ("force", "train"):
        out.update(g2_vjp=g2_vjp(*p, t2, 1), g4_vjp=g4_vjp(*t, t4, 1))
    if kind == "train":
        out.update(g2_vjp_bwd=g2_vjp_bwd(*p, t2, 1),
                   g4_vjp_bwd=g4_vjp_bwd(*t, t4, 1))
    return out
