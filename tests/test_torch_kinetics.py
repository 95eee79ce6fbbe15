"""The port's harmonic transition-state kinetics against the JAX
package's at float64: the mass-weighted frequencies (and their Einstein
oracle), the Vineyard rate of the zjw04 Ni vacancy hop, the whole
`vacancy_diffusivity` pipeline (relax -> NEB -> Vineyard -> D(T)), and
the refusal of a minimum passed as a saddle.

The JAX-reference fixture of the analysis phase of `chip_smoke.py`
(`vacancy_diffusivity` of the saved mleam_ni model on fcc Ni 3x3x3) is
regenerated with

    python -m tests.test_torch_kinetics
"""
import json
from collections import Counter
from pathlib import Path

import chip_smoke
import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.analysis import kinetics as jk
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalculator
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.analysis import kinetics as pk
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import model_from_dict

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
A0 = 3.52
# the chip's fixture: the saved EAM model on fcc Ni 3x3x3 (107 atoms with
# the vacancy; chip_smoke.KINETICS_RUN)
KINETICS_MODEL = "artifacts/mleam_ni/model/snap_Ni_mleam.npz"
FIXTURE_KEYS = chip_smoke.KINETICS_KEYS


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tier-1 run puts six workers on the machine's cores: these small
    CPU evaluations run as fast on one thread and then do not
    oversubscribe the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_twin(model, params):
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def fcc_bulk(cls, a=A0):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]]) * a
    return cls.from_symbols(["Ni"] * 4, base, np.eye(3) * a, pbc=[True] * 3)


@pytest.fixture(scope="module")
def calculators():
    fz = JaxFeaturizer(["Ni"], rcut=6.0)
    model = JaxEamAlloyNN(fz, Counter({"Ni": 4}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    return (JaxCalculator(model, params),
            TensorAlloyCalculator(_port_twin(model, params), device="cpu"))


def test_mass_weighted_frequencies_match_jax_and_the_einstein_oracle():
    k, m = 3.0, 58.6934
    nu = pk.mass_weighted_frequencies(np.eye(6) * k, np.array([m, m]))
    expect = np.sqrt(k / m * 9.648533290731905e-3) / (2 * np.pi) * 1e3
    np.testing.assert_allclose(nu, expect, rtol=1e-12)
    h = np.random.RandomState(0).normal(size=(9, 9))
    masses = np.array([58.69, 95.95, 58.69])
    np.testing.assert_array_equal(pk.mass_weighted_frequencies(h, masses),
                                  jk.mass_weighted_frequencies(h, masses))


def test_vacancy_diffusivity_matches_jax(calculators):
    """The whole pipeline on the 2x2x2 cell: energies, prefactor, rates
    and D(T) to 1e-8; the NEB converged; the Arrhenius slope."""
    jcalc, calc = calculators
    kw = dict(supercell=(2, 2, 2), temperatures=(600.0, 1000.0))
    out = pk.vacancy_diffusivity(calc, fcc_bulk(Structure), **kw)
    want = jk.vacancy_diffusivity(jcalc, fcc_bulk(JaxStructure), **kw)
    for k in FIXTURE_KEYS + ("activation_energy", "temperatures"):
        np.testing.assert_allclose(out[k], want[k], rtol=1e-8, atol=0,
                                   err_msg=k)
    for k in ("converged", "n_steps", "saddle_index"):
        assert out["neb"][k] == want["neb"][k], k
    np.testing.assert_allclose(out["neb"]["energies"],
                               want["neb"]["energies"], rtol=0, atol=1e-10)
    assert out["neb"]["converged"]
    t1, t2 = out["temperatures"]
    k1, k2 = out["jump_rate_hz"]
    slope = np.log(k2 / k1) / (1 / t2 - 1 / t1)
    assert slope == pytest.approx(-out["migration_energy"] / pk.KB,
                                  rel=1e-9)


def test_vineyard_rejects_a_minimum_as_saddle(calculators):
    from tensoralloy_tpu_torch.analysis.elastic import relax_positions
    _, calc = calculators
    sc = relax_positions(calc, fcc_bulk(Structure).repeat((2, 2, 2)),
                         fmax=0.01)
    with pytest.raises(ValueError, match="imaginary"):
        pk.vineyard_rate(calc, sc, sc)


def make_fixture():
    from test_torch_analysis import jax_analysis, jax_saved_calculator
    return chip_smoke.kinetics_workflow(
        jax_saved_calculator(KINETICS_MODEL), jax_analysis(),
        chip_smoke.fcc_conventional(JaxStructure, chip_smoke.PHONON_A))


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT / "tests"))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    path = DATA / "torch_port_ref_kinetics.json"
    path.write_text(json.dumps(make_fixture(), indent=1))
    print(f"wrote {path}")
