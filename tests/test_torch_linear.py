"""The port's linear TensorMD against the JAX package's at float64: the
energy, force and virial design rows (the port's GRAP through the
kernels' Function, its twin on the CPU; JAX's 'segment' backend) to
1e-10, the fitted coefficients, the exact fit of labels a linear model
made, the model exported as a zero-hidden-layer AtomicNN and served, the
TensorMD engine's npz keys, and `method="elasticnet"` (sklearn, imported
only there).
"""
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.linear.model import LinearTensorMD as JaxLinear
from tensoralloy_tpu.linear.model import \
    TensorMDPythonCalculator as JaxTensorMDCalculator
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.linear.model import (LinearTensorMD,
                                                TensorMDPythonCalculator)

REL = 1e-10
A0 = 3.6
# ridge strength of the coefficient comparison: the normal matrix of
# these rows has condition ~1e6 there (1e12 and more at the default
# 1e-8, where rows equal to round-off give coefficients apart by 1e-4)
ALPHA = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts six workers on the machine's cores: these small
    CPU evaluations run as fast on one thread and then do not
    oversubscribe the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= rel * scale, what


def labelled_structures(n, seed=0, reps=1):
    """n rattled fcc Ni cells with seeded random E/F/S labels, as
    (JAX, port) lists."""
    rng = np.random.RandomState(seed)
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)]) / reps
    cell = np.eye(3) * A0 * reps
    jss, ss = [], []
    for _ in range(n):
        pos = frac @ cell + rng.normal(0, 0.1, (len(frac), 3))
        info = dict(energy=float(rng.normal() - 4.0 * len(frac)),
                    forces=rng.normal(size=(len(frac), 3)),
                    stress=rng.normal(scale=0.01, size=6))
        for cls, out in ((JaxStructure, jss), (Structure, ss)):
            s = cls.from_symbols(["Ni"] * len(frac), pos, cell,
                                 pbc=[True] * 3)
            s.info.update({k: np.copy(v) for k, v in info.items()})
            out.append(s)
    return jss, ss


@pytest.mark.parametrize("preset,max_moment", [("pexp8", 3), ("sf4", 1)])
def test_design_rows_and_fit_match_jax(preset, max_moment):
    jss, ss = labelled_structures(5, reps=1)
    js2, s2 = labelled_structures(1, seed=1, reps=2)
    jss, ss = jss + js2, ss + s2
    jlm = JaxLinear(["Ni"], rcut=6.0, preset=preset, max_moment=max_moment)
    lm = LinearTensorMD(["Ni"], rcut=6.0, preset=preset,
                        max_moment=max_moment, device="cpu")
    assert lm.n_coef == jlm.n_coef and lm.descriptor.backend == "pallas"
    for s, js in zip(ss, jss):
        got = lm.design_rows(s, with_virial=True)
        want = jlm.design_rows(js, with_virial=True)
        assert sorted(got) == sorted(want)
        for k in ("energy_row", "force_rows", "virial_rows"):
            _close(got[k], want[k], REL, k)
    kw = dict(stress_weight=0.5, alpha=ALPHA)
    fit, jfit = lm.fit(ss, **kw), jlm.fit(jss, **kw)
    assert fit["n_rows"] == jfit["n_rows"] and fit["n_coef"] == lm.n_coef
    _close(lm.coef_, jlm.coef_, REL, "coefficients")
    assert fit["rmse"] == pytest.approx(jfit["rmse"], rel=REL)
    fit, jfit = lm.fit(ss, method="lstsq"), jlm.fit(jss, method="lstsq")
    assert fit["rmse"] == pytest.approx(jfit["rmse"], rel=1e-8)


def test_exact_fit_of_linear_labels_and_serving_match_jax(tmp_path):
    """Labels made by a linear model are fit exactly; the fitted model's
    calculator, its export served by the port's calculator, and the JAX
    calculator over the same coefficients agree."""
    lm = LinearTensorMD(["Ni"], rcut=4.5, preset="sf4", max_moment=1,
                        device="cpu")
    true_coef = np.random.RandomState(1).normal(0, 0.1, lm.n_coef)
    _, ss = labelled_structures(6, seed=2)
    lm.coef_ = true_coef
    calc = TensorMDPythonCalculator(lm)
    for s in ss:
        s.info["energy"] = float(lm.design_rows(s, with_forces=False)
                                 ["energy_row"] @ true_coef)
        s.info["forces"] = calc.get_forces(s)
    lm.coef_ = None
    assert lm.fit(ss, method="lstsq")["rmse"] < 1e-8
    jlm = JaxLinear(["Ni"], rcut=4.5, preset="sf4", max_moment=1)
    jlm.coef_ = lm.coef_
    jss, _ = labelled_structures(2, seed=9)
    _, probe = labelled_structures(2, seed=9)
    calc = TensorMDPythonCalculator(lm)
    path = str(tmp_path / "linear.npz")
    lm.export(path)
    served = TensorAlloyCalculator(path, device="cpu")
    for s, js in zip(probe, jss):
        want = JaxTensorMDCalculator(jlm).calculate(js)
        for got in (calc.calculate(s), served.calculate(s)):
            for k in ("energy", "forces", "stress"):
                _close(got[k], want[k], REL, k)
        assert calc.get_potential_energy(s) == pytest.approx(
            want["energy"], rel=REL)


def test_tensormd_export_matches_jax(tmp_path):
    _, ss = labelled_structures(3)
    jss, _ = labelled_structures(3)
    lm = LinearTensorMD(["Ni"], rcut=6.0, preset="pexp8", max_moment=2,
                        device="cpu")
    jlm = JaxLinear(["Ni"], rcut=6.0, preset="pexp8", max_moment=2)
    with pytest.raises(RuntimeError, match="fit"):
        lm.export_tensormd(str(tmp_path / "x.npz"))
    lm.fit(ss, alpha=ALPHA)
    jlm.fit(jss, alpha=ALPHA)
    for precision in (64, 32):
        got = lm.export_tensormd(str(tmp_path / "p.npz"), precision)
        want = jlm.export_tensormd(str(tmp_path / "j.npz"), precision)
        assert sorted(got) == sorted(want)
        saved = np.load(tmp_path / "p.npz")
        assert sorted(saved.files) == sorted(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            _close(got[k], want[k], 1e-6 if precision == 32 else REL, k)
    sf = LinearTensorMD(["Ni"], rcut=6.0, preset="sf4", device="cpu")
    sf.coef_ = np.zeros(sf.n_coef)
    with pytest.raises(ValueError, match="pexp"):
        sf.export_tensormd(str(tmp_path / "sf.npz"))


def test_elasticnet_needs_sklearn():
    _, ss = labelled_structures(2)
    lm = LinearTensorMD(["Ni"], rcut=4.5, preset="sf4", max_moment=1,
                        device="cpu")
    try:
        import sklearn  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            lm.fit(ss, method="elasticnet")
    else:
        jss, _ = labelled_structures(2)
        jlm = JaxLinear(["Ni"], rcut=4.5, preset="sf4", max_moment=1)
        lm.fit(ss, method="elasticnet", alpha=1e-4)
        jlm.fit(jss, method="elasticnet", alpha=1e-4)
        _close(lm.coef_, jlm.coef_, 1e-8)
    with pytest.raises(ValueError):
        lm.fit(ss, method="nope")
