"""Bytes and useful FLOP of one analytic energy-and-forces pass of a
one-element ADP (reference/adp.py's physics), counted from the physics
whatever implements it, as functions of `atoms`, the directed pairs of
the full list within the model's cutoff (`pairs`), and those of them
within the cutoff of u and w (`near`).

Bytes: per pair its neighbour index and image code (4 + 4) and the
neighbour's position (12), 20; per atom its position read and its force
written, 24. The pass's own intermediates are not counted: a fused pass
keeps them on the chip.

FLOP, a transcendental as one; a pair's force on its centre carries the
whole pair's term, so each unordered pair is counted twice, once from
each end, and no term is counted twice from one end:
  per pair within the cutoff
    geometry 15: the vector with its image offset 6, r 6, the unit
      vector 3;
    rho and its slope 20: Zhou's g 13 (r / r_e, the exponent 2, exp,
      (x - c)^20 by 6, the quotient 3), its slope 7; phi and its slope
      42: two g with slopes and their difference;
    sums 2: rho_i and phi_i;
    force 10: (F'(rho_i) + F'(rho_j)) rho' + phi' 4, times the unit
      vector and added 6;
  per pair within u and w's cutoff
    u, w and their slopes 44: each (p1 e^{-p2 r} + p3) 4 and psi 7, 12,
      its slope 10;
    moments 24: mu_i 6, lam_i 18 (its 6 distinct entries);
    cotangents 104: through the centre's and the neighbour's dipole 15
      each (u' (m . r) r^ + u m), quadrupole 31 each (w' (r L r) r^ +
      2 w L r), the four summed into the force 12;
  per atom 110: F and F' 80, the angular energy and its adjoints 30.
An energy alone (`kind` "energy") takes per pair the geometry's r 12,
rho 13 and phi 27, and the sums 2; per near pair u and w 24 and the
moments 24; per atom F 37 and the angular energy 25.
"""
from __future__ import annotations

PAIR_BYTES = 20
ATOM_BYTES = 24

FORCE = {"pair": 15 + 20 + 42 + 2 + 10, "near": 44 + 24 + 104,
         "atom": 80 + 30}
ENERGY = {"pair": 12 + 13 + 27 + 2, "near": 24 + 24, "atom": 37 + 25}


def efs_pass(atoms: float, pairs: float, near: float, kind: str = "force"):
    """(bytes, FLOP) of one pass: `kind` "force" the energy and the
    forces, "energy" the energy alone."""
    flop = FORCE if kind == "force" else ENERGY
    return (PAIR_BYTES * pairs + ATOM_BYTES * atoms,
            flop["pair"] * pairs + flop["near"] * near
            + flop["atom"] * atoms)
