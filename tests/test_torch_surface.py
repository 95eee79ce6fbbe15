"""The port's surface, stacking-fault and grain-boundary module against
the JAX package's at float64 (the analytic zjw04 EAM Ni, small cells):
slab geometry, surface energies (relaxed and not), the stacking fault,
gamma lines and surfaces, tilt and twist bicrystals with their boundary
energies.

The JAX-reference fixture of the analysis phase of `chip_smoke.py`
(surface energies and the intrinsic stacking fault of the saved mleam_ni
model) is regenerated with

    python -m tests.test_torch_surface
"""
import json
from collections import Counter
from pathlib import Path

import chip_smoke
import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.analysis import surface as js_
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalculator
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.analysis import surface as ps
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import model_from_dict

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
A0 = 3.52
REL = 1e-8
# the chip's fixture: the saved EAM model, (111) and (100) slabs and the
# intrinsic stacking fault on (111) (chip_smoke.surface_workflow)
SURFACE_MODEL = "artifacts/mleam_ni/model/snap_Ni_mleam.npz"


def bulk(cls, a=A0):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]]) * a
    return cls.from_symbols(["Ni"] * 4, base, np.eye(3) * a, pbc=[True] * 3)


@pytest.fixture(scope="module")
def calcs():
    fz = JaxFeaturizer(["Ni"], rcut=4.5)
    model = JaxEamAlloyNN(fz, Counter({"Ni": 4}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return (JaxCalculator(model, params),
            TensorAlloyCalculator(twin, device="cpu"))


def _same(got, want, rel=REL, what=""):
    """Dicts, arrays, structures and scalars compared alike."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], rel, f"{what}.{k}")
    elif hasattr(want, "positions"):
        assert list(got.symbols) == list(want.symbols), what
        np.testing.assert_allclose(got.positions, want.positions, rtol=0,
                                   atol=1e-9, err_msg=what)
        np.testing.assert_allclose(got.cell, want.cell, rtol=0, atol=1e-9)
    elif isinstance(want, (list, tuple)) and want and \
            isinstance(want[0], (dict, tuple, list)):
        assert len(got) == len(want), what
        for g, w in zip(got, want):
            _same(g, w, rel, what)
    elif isinstance(want, (str, bool)) or want is None:
        assert got == want, what
    else:
        got, want = np.asarray(got, float), np.asarray(want, float)
        assert got.shape == want.shape, what
        scale = max(np.max(np.abs(want)) if want.size else 0.0, 1.0)
        assert np.max(np.abs(got - want), initial=0.0) <= rel * scale, what


def test_slabs_and_bicrystals_match_jax():
    b, jb = bulk(Structure), bulk(JaxStructure)
    for hkl in ((1, 0, 0), (1, 1, 0), (1, 1, 1), (2, 1, 0)):
        _same(ps.make_slab(b, hkl, layers=4, vacuum=10.0),
              js_.make_slab(jb, hkl, layers=4, vacuum=10.0))
    _same(ps.make_tilt_bicrystal(b, (3, 1, 0), layers=4, min_dist=1.8),
          js_.make_tilt_bicrystal(jb, (3, 1, 0), layers=4, min_dist=1.8))
    _same(ps.make_twist_bicrystal(b, (0, 0, 1), 36.8698976458, layers=2),
          js_.make_twist_bicrystal(jb, (0, 0, 1), 36.8698976458, layers=2))
    with pytest.raises(ValueError):
        ps.make_slab(b, (0, 0, 0))


@pytest.mark.parametrize("hkl", [(1, 1, 1), (1, 0, 0)])
def test_surface_energies_match_jax(calcs, hkl):
    jcalc, calc = calcs
    kw = dict(layers=4, relax=True, steps=30)
    _same(ps.surface_energy(calc, bulk(Structure), hkl, **kw),
          js_.surface_energy(jcalc, bulk(JaxStructure), hkl, **kw))


def test_stacking_faults_and_gamma_lines_match_jax(calcs):
    jcalc, calc = calcs
    b, jb = bulk(Structure), bulk(JaxStructure)
    kw = dict(layers=4, steps=30)
    _same(ps.stacking_fault_energy(calc, b, (1, 1, 1), (1 / 3, 1 / 3), **kw),
          js_.stacking_fault_energy(jcalc, jb, (1, 1, 1), (1 / 3, 1 / 3),
                                    **kw))
    kw = dict(layers=4, n_points=4, relax=False)
    _same(ps.gamma_line(calc, b, **kw), js_.gamma_line(jcalc, jb, **kw))
    kw = dict(layers=4, n_grid=(2, 2), relax=False)
    _same(ps.gamma_surface(calc, b, **kw), js_.gamma_surface(jcalc, jb, **kw))


def test_boundary_energies_match_jax(calcs):
    jcalc, calc = calcs
    b, jb = bulk(Structure), bulk(JaxStructure)
    kw = dict(layers=4, translations=[(0.0, 0.0)], steps=20)
    _same(ps.grain_boundary_energy(calc, b, (1, 1, 1), **kw),
          js_.grain_boundary_energy(jcalc, jb, (1, 1, 1), **kw))
    kw = dict(layers=2, translations=[(0.0, 0.0)], relax=False)
    _same(ps.twist_boundary_energy(calc, b, (0, 0, 1), 90.0, **kw),
          js_.twist_boundary_energy(jcalc, jb, (0, 0, 1), 90.0, **kw))


def test_surface_fixture_is_current():
    """The fixture `chip_smoke.py` compares with: the port's workflow on
    the CPU (float64) gives it."""
    ref = json.loads((DATA / "torch_port_ref_surface.json").read_text())
    calc = TensorAlloyCalculator(str(ROOT / SURFACE_MODEL), device="cpu")
    got = chip_smoke.surface_workflow(calc, chip_smoke.port_analysis(),
                                      bulk(Structure))
    _same(got, ref, REL)
    assert got["111"]["gamma_j_m2"] < got["100"]["gamma_j_m2"]


if __name__ == "__main__":
    import sys
    sys.path.insert(0, str(ROOT / "tests"))
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    from test_torch_analysis import jax_analysis, jax_saved_calculator
    path = DATA / "torch_port_ref_surface.json"
    path.write_text(json.dumps(chip_smoke.surface_workflow(
        jax_saved_calculator(SURFACE_MODEL), jax_analysis(),
        bulk(JaxStructure)), indent=1))
    print(f"wrote {path}")
