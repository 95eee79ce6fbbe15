"""G4's second-order closed form (`g4_vjp_bwd_reference`) against JAX's
second derivatives of `_g4_ref_dense` and of the interpret-mode op, as
tests/test_torch_second_order.py holds G2's: every cutoff, the grids
`G4_GRIDS` (zeta 1, 2, 4 with the clamp active; zeta 2.5), with and
without holes.

`python -m pytest tests/test_torch_second_order_g4.py -q`.
"""
import numpy as np
import pytest

from test_torch_second_order import CUTOFFS, G4_GRIDS, _check_closed_form


@pytest.mark.parametrize("holes", [False, True])
@pytest.mark.parametrize("grid", sorted(G4_GRIDS))
@pytest.mark.parametrize("cutoff", CUTOFFS)
def test_g4_closed_form_second_order_matches_jax(cutoff, grid, holes):
    diff, mask = _check_closed_form("g4", cutoff, holes, grid)
    if grid == "clamp":
        cos = (diff[0] ** 2 + diff[1] ** 2 - diff[2] ** 2) / np.where(
            mask > 0, 2 * diff[0] * diff[1], 1.0)
        assert ((np.abs(cos) > 0.5) & (mask > 0)).sum() > 5
