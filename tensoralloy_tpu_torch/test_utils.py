"""Shared test fixtures and tolerant array assertions (port of
`tensoralloy_tpu/test_utils.py`; reference
`tensoralloy/test_utils.py:19-124`)."""
from __future__ import annotations

import numpy as np
import torch

from .atoms import Structure


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_array_equal(a, b, err_msg=""):
    np.testing.assert_array_equal(_numpy(a), _numpy(b), err_msg=err_msg)


def assert_array_almost_equal(a, b, delta=None, err_msg=""):
    """Tolerance keyed to the precision of `a` (float64: 1e-8, float32:
    1e-5) unless given explicitly. The JAX package keys it to its global
    float policy; this package has none, so the array's own dtype takes
    its place."""
    a, b = _numpy(a), _numpy(b)
    if delta is None:
        delta = 1e-8 if a.dtype == np.float64 else 1e-5
    np.testing.assert_allclose(a, b, atol=delta, err_msg=err_msg)


def make_pd3o2(seed: int = 611):
    """The canonical permutation fixture pair: Pd3O2 and Pd2O2Pd with
    identical geometry but permuted atom order."""
    rng = np.random.RandomState(seed)
    positions = rng.uniform(1.0, 4.0, size=(5, 3))
    cell = np.eye(3) * 8.0
    a = Structure.from_symbols(["Pd", "Pd", "Pd", "O", "O"], positions,
                               cell, pbc=[True] * 3)
    perm = [0, 3, 4, 1, 2]
    b = Structure.from_symbols([a.symbols[i] for i in perm],
                               positions[perm], cell, pbc=[True] * 3)
    return a, b, perm
