"""GRAP's second-order closed form (`grap_vjp_bwd_reference`) against
JAX's second derivatives, as tests/test_torch_grap_second_order.py holds
it, for the grid algorithms density and morse at every cutoff (the
other two are in tests/test_torch_grap_second_order_pexp_sf.py).

`python -m pytest tests/test_torch_grap_second_order_density_morse.py -q`.
"""
import numpy as np
import pytest

from tensoralloy_tpu_torch.ops import cutoffs

from test_torch_grap_second_order import MOMENTS, _check, _descriptors, _unit
from test_torch_ops import seeded_rows


@pytest.mark.parametrize("cutoff", sorted(cutoffs.CUTOFFS))
@pytest.mark.parametrize("algorithm", ["density", "morse"])
def test_grap_closed_form_second_order_matches_jax(algorithm, cutoff):
    """Every grid algorithm and cutoff; masked tails of zero distances,
    an empty first row (P0 = 0 exactly, where sign is 0)."""
    rng = np.random.RandomState(41)
    (rij,), slot, mask = seeded_rows(rng, 6, 9, 2, 4.5)
    moments, symmetric = MOMENTS[algorithm]
    _check(*_descriptors(algorithm, moments, symmetric, cutoff),
           _unit(rng, rij, mask), slot, mask)
