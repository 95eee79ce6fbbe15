"""The port's numpy host layer against the JAX package's: the dense
featurizer output (with transpose tables and triples) must be identical,
integer arrays exactly and float arrays to 1e-12."""
from dataclasses import asdict

import numpy as np
import pytest

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.neighbor import (
    find_neighbor_size_of_atoms as jax_neighbor_size)
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.neighbor import find_neighbor_size_of_atoms
from tensoralloy_tpu_torch.transform import Featurizer
from tensoralloy_tpu_torch.utils import get_kbody_terms


def fcc_ni(reps=2, seed=0):
    """Jittered fcc Ni cell, a = 3.52 A."""
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.array([(i, j, k) for i in range(reps) for j in range(reps)
                     for k in range(reps)])
    pos = ((grid[:, None, :] + basis[None]) * 3.52).reshape(-1, 3)
    pos = pos + np.random.RandomState(seed).normal(0, 0.05, pos.shape)
    return ["Ni"] * len(pos), pos, np.eye(3) * 3.52 * reps


def mo_ni(seed=0, n=24):
    """The binary random cell of tests/test_backends.py."""
    rng = np.random.RandomState(seed)
    symbols = ["Ni"] * (n // 2) + ["Mo"] * (n - n // 2)
    return symbols, rng.uniform(0, 7.0, (n, 3)), np.eye(3) * 7.0


CASES = {
    # the served model's cutoffs: rcut 6, acut 4
    "ni_fcc": (fcc_ni, ["Ni"], dict(rcut=6.0, acut=4.0)),
    "moni": (mo_ni, ["Mo", "Ni"], dict(rcut=4.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("bucketed", [False, True])
def test_featurizer_matches_jax(case, bucketed, monkeypatch):
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    build, elements, kw = CASES[case]
    symbols, pos, cell = build()
    jax_fz = JaxFeaturizer(elements, angular=True, **kw)
    fz = Featurizer(elements, angular=True, **kw)
    opts = dict(transpose=True)
    if bucketed:   # the calculator's widths
        opts.update(nnl_bucket=lambda n: max(32, 1 << (n - 1).bit_length()),
                    ntl_bucket=lambda n: max(64, 1 << (n - 1).bit_length()),
                    dtype=np.float32)
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    ref = jax_fz.featurize(js, jax_fz.make_vap(js), layout="dense", **opts)
    out = fz.featurize(s, fz.make_vap(s), **opts)
    assert sorted(out) == sorted(ref)
    assert "trip_trans_k_d" in out and out["pair_islot_d"].max() >= (
        len(elements) - 1)
    for key, want in ref.items():
        got = out[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12,
                                       err_msg=key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_neighbor_size_and_terms_match_jax(case, monkeypatch):
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    from tensoralloy_tpu.utils import get_kbody_terms as jax_terms
    build, elements, kw = CASES[case]
    symbols, pos, cell = build()
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    acut = kw.get("acut")
    assert (asdict(find_neighbor_size_of_atoms(s, kw["rcut"], True, acut))
            == asdict(jax_neighbor_size(js, kw["rcut"], True, acut)))
    assert get_kbody_terms(elements, angular=True) == jax_terms(
        elements, angular=True)
