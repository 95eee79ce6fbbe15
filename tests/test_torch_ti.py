"""The port's Frenkel-Ladd thermodynamic integration against the JAX
package's: the lambda-mixed energy and its forces to 1e-12, the
wrapper's delegation and refusals, `is_eam_family` false on it (the
analytic EFS would drop the springs), the analytic Einstein and free
centre-of-mass terms, and the Einstein -> Einstein integration against
its closed form (the port's BAOAB noise is a torch.Generator's, so runs
are held to analytic oracles, not step for step to JAX).
"""
import json
from collections import Counter

import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.analysis import ti as jti
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.analysis import ti
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import (TensorAlloyCalculator,
                                              is_eam_family)
from tensoralloy_tpu_torch.dynamics import KB, VelocityVerlet
from tensoralloy_tpu_torch.io.model import model_from_dict

A0 = 3.52


def _ni(reps=2, jitter=0.0):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)])
    pos = frac * A0 + np.random.RandomState(0).normal(0, jitter, frac.shape)
    cell = np.eye(3) * A0 * reps
    return (JaxStructure.from_symbols(["Ni"] * len(frac), pos, cell,
                                      pbc=[True] * 3),
            Structure.from_symbols(["Ni"] * len(frac), pos, cell,
                                   pbc=[True] * 3))


def _eam(n):
    fz = JaxFeaturizer(["Ni"], rcut=4.5)
    model = JaxEamAlloyNN(fz, Counter({"Ni": n}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return model, params, twin


def _springs(model, s):
    """(centers [n_vap, 3], masks [n_vap]) of `s` in the VAP layout."""
    vap = model.featurizer.make_vap(s, Counter(s.symbols))
    n_vap = model.clone_for(Counter(s.symbols)).n_atoms_vap
    centers = np.zeros((n_vap, 3))
    centers[vap.local_to_vap] = s.positions
    masks = np.zeros(n_vap)
    masks[vap.local_to_vap] = 1.0
    return centers, masks


def test_lambda_mix_energy_and_forces_match_jax():
    """U(lambda) of the mix and its forces, through the calculator's
    autograd route, against JAX's at three lambdas: 1e-12."""
    from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalc
    js, s = _ni(jitter=0.1)
    model, params, twin = _eam(len(s))
    centers, masks = _springs(twin, s)
    centers = centers + 0.05           # springs stretched at the start
    for lam in (0.0, 0.37, 1.0):
        mixed = ti.LambdaMix(twin, lam, centers, 2.5, masks)
        jmixed = jti.LambdaMix(model, lam, centers, 2.5, masks)
        assert not is_eam_family(mixed)
        got = TensorAlloyCalculator(mixed, device="cpu").calculate(s)
        want = JaxCalc(jmixed, params).calculate(js)
        assert got["energy"] == pytest.approx(want["energy"], rel=1e-12)
        np.testing.assert_allclose(got["forces"], want["forces"], rtol=0,
                                   atol=1e-12 * np.abs(want["forces"]).max())


def test_lambda_mix_is_a_module_that_delegates():
    _, s = _ni()
    _, _, twin = _eam(len(s))
    centers, masks = _springs(twin, s)
    mixed = ti.LambdaMix(twin, 0.5, centers, 2.0, masks)
    assert isinstance(mixed, torch.nn.Module)
    assert mixed.featurizer is twin.featurizer
    assert mixed.n_atoms_vap == twin.clone_for(
        Counter(s.symbols)).n_atoms_vap
    assert [p.data_ptr() for p in mixed.parameters()] == \
        [p.data_ptr() for p in twin.parameters()]
    assert mixed.centers_vap.dtype == torch.float64
    clone = mixed.clone_for(Counter(s.symbols))
    assert isinstance(clone, ti.LambdaMix) and not is_eam_family(clone)
    with pytest.raises(ValueError, match="VAP layout"):
        mixed.clone_for(Counter({"Ni": 64}))
    # the MD engine treats it as a model: autograd, not the analytic EFS
    md = VelocityVerlet(mixed, s, temperature=100.0, chunk_size=2)
    assert not md._use_fast_efs
    assert np.all(np.isfinite(md.run(4)["total"]))


def test_analytic_terms_match_jax():
    m = np.array([58.69, 58.69, 95.95])
    for k, t in ((4.0, 500.0), (1.3, 80.0)):
        assert ti.einstein_free_energy(3, m, k, t) == pytest.approx(
            jti.einstein_free_energy(3, m, k, t), rel=1e-14)
        assert ti.free_com_term(m.sum(), 300.0, t) == pytest.approx(
            jti.free_com_term(m.sum(), 300.0, t), rel=1e-14)
    w = np.sqrt(4.0 / 10.0 * 9.648533290731905e-3)
    kt = KB * 500.0
    assert ti.einstein_free_energy(2, np.array([10.0, 10.0]), 4.0, 500.0) \
        == pytest.approx(6 * kt * np.log(ti.HBAR_EV_FS * w / kt), rel=1e-12)


def test_einstein_to_einstein_matches_the_closed_form():
    """dF = (3N kT / 2) ln(k1 / k0), to the JAX test's tolerance: the
    TI machinery (LambdaMix inside the port's BAOAB MD, Gauss-Legendre
    quadrature, U_model recovered from the recorded mixed potential).
    The run is `chip_smoke.EINSTEIN_RUN`: 108 atoms, 10 fs steps (BAOAB
    samples a harmonic crystal's positions exactly at any stable step)
    and a light friction, so that 2.5 ps a lambda give nearly independent
    samples: the integral lands within 2.5 % (ten seeds) of a limit of
    5 %, where the JAX test's 32 atoms at 2 fs take 2000 steps."""
    import chip_smoke
    _, s = _ni(reps=3)
    _, _, twin = _eam(len(s))
    centers, masks = _springs(twin, s)
    k0, k1 = chip_smoke.EINSTEIN_K
    temp = 300.0
    fake = ti.LambdaMix(twin, 0.0, centers, k1, masks)
    res = ti.frenkel_ladd(fake, s, temp, k_spring=k0,
                          **chip_smoke.EINSTEIN_RUN)
    n = len(s)
    df_exact = 1.5 * n * KB * temp * np.log(k1 / k0)
    assert res["delta_f"] == pytest.approx(df_exact, rel=0.05)
    f1 = ti.einstein_free_energy(n, s.masses, k1, temp)
    assert res["free_energy"] == pytest.approx(f1, abs=0.06 * abs(df_exact))
    assert np.all(np.isfinite(res["du_mean"]))
    assert len(res["lambdas"]) == 4


def test_frenkel_ladd_refusals_and_com_terms():
    _, s = _ni()
    _, _, twin = _eam(len(s))
    with pytest.raises(ValueError, match="strictly inside"):
        ti.frenkel_ladd(twin, s, 300.0, k_spring=2.0, lambdas=[0.0, 0.5])
    res = ti.frenkel_ladd(twin, s, 300.0, k_spring=2.0,
                          lambdas=[0.2, 0.8], equil_steps=10,
                          prod_steps=20, sample=10)
    m = s.masses
    assert res["f_com_free"] == pytest.approx(
        jti.free_com_term(float(m.sum()), s.volume, 300.0), rel=1e-14)
    assert res["f_einstein"] == pytest.approx(
        jti.einstein_free_energy(len(s), m, 2.0, 300.0), rel=1e-14)
    assert np.isfinite(res["free_energy_per_atom"])
