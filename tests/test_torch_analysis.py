"""The port's analysis modules against the JAX package's at float64, on
the same inputs: `atoms.minimum_image`, the equations of state, the
relaxations and elastic tensors, the ideal strengths, phonons with the
harmonic thermodynamics and the quasi-harmonic approximation,
structure fingerprints, and the LAMMPS deck writers and log parsers.

The models are the analytic zjw04 EAM Ni (the JAX `init_params`, carried
into the port's twin) on small cells. The JAX-reference fixture of the
analysis phase of `chip_smoke.py` (elastic constants and EOS of the saved
snap_ni_sfa model, phonons and QHA of mleam_ni) is regenerated with

    python -m tests.test_torch_analysis
"""
import json
from collections import Counter
from pathlib import Path

import chip_smoke
import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import TensorAlloyCalculator as JaxCalculator
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import model_from_dict

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
A0 = 3.52
REL = 1e-9
# the chip's fixtures: saved models (cells, depths and limits are
# chip_smoke's)
ELASTIC_MODEL = "artifacts/snap_ni_sfa/model/snap_Ni_sfa.npz"
PHONON_MODEL = "artifacts/mleam_ni/model/snap_Ni_mleam.npz"
QHA_SCALES = chip_smoke.QHA_SCALES
QHA_REL = chip_smoke.QHA_REL
Q_POINTS = chip_smoke.Q_POINTS


def _port_twin(model, params):
    twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                           device="cpu", dtype=torch.float64)
    twin.load_param_tree(jax.tree_util.tree_map(np.asarray, params))
    return twin


def _calculators(n=4, rcut=6.0):
    """(JAX, port) calculators of the analytic zjw04 EAM Ni."""
    fz = JaxFeaturizer(["Ni"], rcut=rcut)
    model = JaxEamAlloyNN(fz, Counter({"Ni": n}), custom_potentials="zjw04")
    params = model.init_params(jax.random.PRNGKey(0))
    return (JaxCalculator(model, params),
            TensorAlloyCalculator(_port_twin(model, params), device="cpu"))


def _both(symbols, positions, cell):
    return (JaxStructure.from_symbols(symbols, positions, cell,
                                      pbc=[True] * 3),
            Structure.from_symbols(symbols, positions, cell,
                                   pbc=[True] * 3))


def fcc_conventional(a=A0, jitter=0.0, seed=0):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]]) * a
    base = base + np.random.RandomState(seed).normal(0, jitter, base.shape)
    return _both(["Ni"] * 4, base, np.eye(3) * a)


def fcc_primitive(a=A0):
    cell = 0.5 * a * np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 1.0],
                               [1.0, 1.0, 0.0]])
    return _both(["Ni"], [[0.0, 0.0, 0.0]], cell)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= rel * scale, what


def _same_structure(s, js, atol=1e-9):
    np.testing.assert_allclose(s.positions, js.positions, rtol=0, atol=atol)
    np.testing.assert_allclose(s.cell, js.cell, rtol=0, atol=atol)


# ----------------------------------------------------------------------
def test_minimum_image_matches_jax():
    from tensoralloy_tpu.atoms import minimum_image as jax_mic
    from tensoralloy_tpu_torch.atoms import minimum_image
    rng = np.random.RandomState(4)
    cells = [np.eye(3) * 5.0,
             np.array([[3.0, 0, 0], [-1.5, 2.6, 0], [0.3, 0.2, 4.8]]),
             np.array([[4.0, 0, 0], [3.7, 1.1, 0], [0.5, 0.4, 3.0]])]
    for cell in cells:
        d = rng.normal(scale=6.0, size=(40, 3))
        for pbc in (None, [True, False, True]):
            np.testing.assert_array_equal(minimum_image(d, cell, pbc),
                                          jax_mic(d, cell, pbc))
    np.testing.assert_array_equal(minimum_image(d, np.zeros((3, 3))), d)


@pytest.mark.parametrize("form", ["birchmurnaghan", "murnaghan", "vinet",
                                  "rose", "sj"])
def test_equations_of_state_match_jax(form):
    from tensoralloy_tpu.analysis.eos import EquationOfState as JaxEOS
    from tensoralloy_tpu_torch.analysis.eos import EquationOfState
    v = np.linspace(9.5, 12.5, 9)
    e = -4.45 + 0.6 * (v - 10.9) ** 2 / 10.9 - 0.02 * (v - 10.9) ** 3
    got, want = EquationOfState(v, e, eos=form), JaxEOS(v, e, eos=form)
    _close(got.fit(), want.fit(), 1e-12, form)
    _close(got.evaluate(v), want.evaluate(v), 1e-12, form)
    assert got.residual == pytest.approx(want.residual, rel=1e-9, abs=1e-15)


def test_relaxations_and_elastic_tensors_match_jax():
    """relax_positions, relax_cell (free, hydrostatic, under pressure),
    the clamped-ion and the symmetry-aware fitted tensors (with relaxed
    ions too) of a strained, rattled zjw04 Ni cell."""
    from tensoralloy_tpu.analysis import elastic as je
    from tensoralloy_tpu_torch.analysis import elastic as pe
    jcalc, calc = _calculators()
    js, s = fcc_conventional(a=A0 * 1.01, jitter=0.03, seed=1)
    _same_structure(pe.relax_positions(calc, s, steps=60),
                    je.relax_positions(jcalc, js, steps=60))
    for kw in ({}, {"hydrostatic": True}, {"pressure": 5.0}):
        got = pe.relax_cell(calc, s, steps=150, **kw)
        want = je.relax_cell(jcalc, js, steps=150, **kw)
        _same_structure(got, want)
    js0, s0 = want, got
    _close(pe.compute_elastic_tensor(calc, s0),
           je.compute_elastic_tensor(jcalc, js0), 1e-8)
    for relax_ions in (False, True):
        c, info = pe.fit_elastic_tensor(calc, s0, relax_ions=relax_ions)
        jc, jinfo = je.fit_elastic_tensor(jcalc, js0, relax_ions=relax_ions)
        _close(c, jc, 1e-8)
        assert info["lattice"] == jinfo["lattice"] == "cubic"
        for k in jinfo["cij"]:
            assert info["cij"][k] == pytest.approx(jinfo["cij"][k], rel=1e-8)
    assert pe.bulk_modulus_voigt(c) == pytest.approx(
        je.bulk_modulus_voigt(jc), rel=1e-8)
    assert pe.shear_modulus_voigt(c) == pytest.approx(
        je.shear_modulus_voigt(jc), rel=1e-8)
    assert pe.cubic_constants(c) == pytest.approx(je.cubic_constants(jc),
                                                  rel=1e-8)


def test_ideal_strengths_match_jax():
    from tensoralloy_tpu.analysis import elastic as je
    from tensoralloy_tpu_torch.analysis import elastic as pe
    jcalc, calc = _calculators()
    js, s = fcc_conventional()
    kw = dict(n_points=4, max_strain=0.12, steps=40)
    for fn in ("ideal_strength", "ideal_shear_strength"):
        got = getattr(pe, fn)(calc, s, **kw)
        want = getattr(je, fn)(jcalc, js, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k], 1e-8, f"{fn} {k}")


def test_phonons_thermodynamics_and_qha_match_jax():
    """Frequencies at G, X and L, a band path, the DOS, the harmonic
    thermodynamics over a q-mesh and the quasi-harmonic expansion of
    the fcc Ni primitive cell in a 2x2x2 supercell."""
    from tensoralloy_tpu.analysis import phonon as jp
    from tensoralloy_tpu_torch.analysis import phonon as pp
    jcalc, calc = _calculators(n=8)
    jprim, prim = fcc_primitive()
    ph = pp.PhononCalculator(calc, prim, supercell=(2, 2, 2))
    jph = jp.PhononCalculator(jcalc, jprim, supercell=(2, 2, 2))
    _close(ph.fc, jph.fc, 1e-10, "force constants")
    # at Gamma D sums to zero: its entries are held on the scale of D(X)
    scale = np.abs(jph.dynamical_matrix(np.array(Q_POINTS["X"]))).max()
    for q in ([0, 0, 0], Q_POINTS["X"], Q_POINTS["L"], [0.1, 0.2, 0.3]):
        q = np.array(q)
        np.testing.assert_allclose(ph.dynamical_matrix(q),
                                   jph.dynamical_matrix(q), rtol=0,
                                   atol=1e-10 * scale)
        if q.any():     # at Gamma the modes are square roots of noise
            _close(ph.frequencies(q), jph.frequencies(q), 1e-10, str(q))
    np.testing.assert_allclose(ph.gamma_frequencies(), 0.0, atol=1e-5)
    band, jband = (p.band_structure(jp.FCC_PATH[:3], npoints=3)
                   for p in (ph, jph))
    # signed squares: linear in the eigenvalues, Gamma's noise included
    _close(np.sign(band["frequencies"]) * band["frequencies"] ** 2,
           np.sign(jband["frequencies"]) * jband["frequencies"] ** 2, 1e-10)
    _close(band["distances"], jband["distances"], 1e-12)
    # the DOS grid starts 1 THz below the lowest mode, an acoustic Gamma
    # mode of +-1e-7 THz noise: the grid moves by that much
    for got, want in zip(ph.dos(qmesh=(2, 2, 2)), jph.dos(qmesh=(2, 2, 2))):
        _close(got, want, 1e-6)
    temps = [0.0, 150.0, 900.0]
    th, jth = (p.thermal_properties(temps, qmesh=(3, 3, 3))
               for p in (ph, jph))
    for k in jth:
        _close(th[k], jth[k], 1e-10, k)
    qha = pp.quasi_harmonic(calc, prim, temps, scales=QHA_SCALES,
                            supercell=(2, 2, 2), qmesh=(2, 2, 2))
    jqha = jp.quasi_harmonic(jcalc, jprim, temps, scales=QHA_SCALES,
                             supercell=(2, 2, 2), qmesh=(2, 2, 2))
    for k in jqha:
        _close(qha[k], jqha[k], QHA_REL[k], k)
    _close(chip_smoke.qha_inputs(calc, chip_smoke.port_analysis(), prim,
                                 temps, (2, 2, 2), (2, 2, 2)),
           chip_smoke.qha_inputs(jcalc, jax_analysis(), jprim, temps,
                                 (2, 2, 2), (2, 2, 2)), 1e-10)


def test_harmonic_thermo_matches_jax():
    from tensoralloy_tpu.analysis.phonon import harmonic_thermo as jht
    from tensoralloy_tpu_torch.analysis.phonon import harmonic_thermo
    freqs = np.concatenate([[-0.3, 0.0, 0.01],
                            np.random.RandomState(2).uniform(0.5, 9, 60)])
    temps = [0.0, 10.0, 300.0, 1500.0]
    got, want = harmonic_thermo(freqs, temps), jht(freqs, temps)
    assert got["n_skipped"] == want["n_skipped"] == 3
    for k in want:
        _close(got[k], want[k], 1e-13, k)


def test_fingerprints_match_jax():
    from tensoralloy_tpu.analysis import fingerprints as jf
    from tensoralloy_tpu_torch.analysis import fingerprints as pf
    rng = np.random.RandomState(7)
    pairs = []
    for i in range(3):
        pos = rng.uniform(0, 7.0, size=(10, 3))
        symbols = ["Ni"] * 6 + ["Mo"] * 4
        pairs.append(_both(symbols, pos, np.eye(3) * 7.0))
    jss, ss = [p[0] for p in pairs], [p[1] for p in pairs]
    for s, js in zip(ss, jss):
        fp, jfp = pf.StructureFingerprint(s), jf.StructureFingerprint(js)
        _close(fp.flat(), jfp.flat(), 1e-12)
        for key, v in jfp.individual(3).items():
            _close(fp.individual(3)[key], v, 1e-12)
    assert pf.cosine_distance(pf.StructureFingerprint(ss[0]),
                              pf.StructureFingerprint(ss[1])) == \
        pytest.approx(jf.cosine_distance(jf.StructureFingerprint(jss[0]),
                                         jf.StructureFingerprint(jss[1])),
                      rel=1e-12)
    comp, jcomp = pf.FingerprintsComparator(ss), jf.FingerprintsComparator(jss)
    _close(comp.distance_matrix(), jcomp.distance_matrix(), 1e-12)
    assert comp.find_duplicates(0.3) == jcomp.find_duplicates(0.3)
    assert comp.looks_like(0, 1) == jcomp.looks_like(0, 1)
    got, want = pf.get_motifs(ss[0], rcut=4.0), jf.get_motifs(jss[0],
                                                               rcut=4.0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g.symbols) == list(w.symbols)
        _close(g.positions, w.positions, 1e-12)
        _close(g.cell, w.cell, 1e-12)


def test_lammps_decks_and_parsers_match_jax(tmp_path):
    """Every driver's deck, the data file (orthogonal and triclinic) and
    the NEB coordinates file byte for byte; the log parsers."""
    from tensoralloy_tpu.analysis import lammps as jl
    from tensoralloy_tpu_torch.analysis import lammps as pl
    cell = np.array([[3.6, 0, 0], [0.9, 3.4, 0], [0.4, 0.3, 3.8]])
    pos = np.random.RandomState(3).uniform(0, 3.0, size=(5, 3))
    js, s = _both(["Ni", "Mo", "Ni", "Ni", "Mo"], pos, cell)
    for name in ("EnergyForceStress", "LatticeConstant", "ElasticConstant",
                 "DefectFormation", "NudgedElasticBand"):
        dirs = [tmp_path / f"{name}_{k}" for k in ("jax", "port")]
        for d, mod, st in zip(dirs, (jl, pl), (js, s)):
            d.mkdir()
            getattr(mod, name)("eam/alloy", "* * MoNi.eam.alloy Mo Ni",
                               workdir=str(d)).write_deck(st)
        for f in sorted(p.name for p in dirs[0].iterdir()):
            assert (dirs[1] / f).read_text() == (dirs[0] / f).read_text(), \
                f"{name}: {f}"
    for st, mod, d in ((js, jl, "a"), (s, pl, "b")):
        (tmp_path / d).mkdir()
        mod.NudgedElasticBand("eam/alloy", "* * p Ni", workdir=str(
            tmp_path / d)).write_final_coords(st)
        mod.write_lammps_data(str(tmp_path / d / "data"), st)
    for f in ("data", "final.coords"):
        if (tmp_path / "a" / f).exists():
            assert (tmp_path / "b" / f).read_text() == \
                (tmp_path / "a" / f).read_text()
    new, rot = pl.lower_triangular_cell(cell)
    jnew, jrot = jl.lower_triangular_cell(cell)
    np.testing.assert_array_equal(new, jnew)
    np.testing.assert_array_equal(rot, jrot)
    log = ("Step MaxReplicaForce MaxAtomForce GradV0 GradV1 GradVc EBF EBR "
           "RDT\n0 1.2 0.5 0.1 0.1 0.2 0.99 0.88 2.5\n"
           "100 0.001 0.0005 0.0 0.0 0.0 0.8612 0.8611 2.48\n")
    assert pl.NudgedElasticBand.parse_neb_log(log) == \
        jl.NudgedElasticBand.parse_neb_log(log)
    thermo = "Step PotEng Press\n0 -17.8 12.5\n10 -17.9 3.25\nLoop time\n"
    assert pl.LammpsDriver.parse_thermo(thermo, ["PotEng", "Press"]) == \
        jl.LammpsDriver.parse_thermo(thermo, ["PotEng", "Press"])


# ----------------------------------------------------------------------
# The fixture of the chip's analysis phase, parts (a) and (b)
# ----------------------------------------------------------------------

def jax_analysis():
    from types import SimpleNamespace
    from tensoralloy_tpu.analysis import elastic, eos, kinetics, phonon, \
        surface
    return SimpleNamespace(elastic=elastic, eos=eos, phonon=phonon,
                           surface=surface, kinetics=kinetics)


def jax_saved_calculator(path):
    """The JAX calculator of a saved model, its parameters in float64."""
    from tensoralloy_tpu.io.model import load_model
    model, params, _ = load_model(str(ROOT / path))
    return JaxCalculator(model, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), params))


def make_fixture():
    return {"elastic": chip_smoke.elastic_workflow(
                jax_saved_calculator(ELASTIC_MODEL), jax_analysis(),
                chip_smoke.fcc_conventional(JaxStructure,
                                            chip_smoke.ELASTIC_A)),
            "phonon": chip_smoke.phonon_workflow(
                jax_saved_calculator(PHONON_MODEL), jax_analysis(),
                chip_smoke.fcc_primitive(JaxStructure,
                                         chip_smoke.PHONON_A))}


def test_analysis_fixture_is_current():
    """The fixture holds what `chip_smoke.py` compares with: the port's
    phonons of the saved EAM model at the chip's supercell (float64) give
    its X and L frequencies (the QHA and the elastic part are held on
    the chip)."""
    from tensoralloy_tpu_torch.analysis.phonon import PhononCalculator
    ref = json.loads((DATA / "torch_port_ref_analysis.json").read_text())
    calc = TensorAlloyCalculator(str(ROOT / PHONON_MODEL), device="cpu")
    ph = PhononCalculator(calc, chip_smoke.fcc_primitive(
        Structure, chip_smoke.PHONON_A), supercell=chip_smoke.PHONON_SUPERCELL)
    for k, q in Q_POINTS.items():
        _close(ph.frequencies(np.array(q)), ref["phonon"][k], 1e-10, k)
    assert sorted(ref["phonon"]["qha"]) == sorted(QHA_REL)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from tensoralloy_tpu import set_precision
    set_precision("high")
    path = DATA / "torch_port_ref_analysis.json"
    path.write_text(json.dumps(make_fixture(), indent=1))
    print(f"wrote {path}")
