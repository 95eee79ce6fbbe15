"""The port's committee calculator against the JAX package's at float64:
the three saved Ni GRAP members (snap_ni_v4, snap_ni_v5,
snap_ni_v5_readapt) from their paths on a 32-atom cell, mean and spread
of E/F/S to 1e-10; members given as models; the mean equal to the mean
of single calculators; the descriptors evaluated once a request; a
finite-temperature committee's heads; an EAM committee through the
analytic EFS; the chunked large-cell route (row blocks, one batched VJP
a block) against the JAX committee's, "auto" routing as JAX does; a
committee of 'nn'-filter members, each on its own descriptors; the
selection by uncertainty; and the refusals.
"""
import json
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.ensemble import EnsembleCalculator as JaxEnsemble
from tensoralloy_tpu.ensemble import \
    select_by_uncertainty as jax_select_by_uncertainty
from tensoralloy_tpu.nn.eam import EamAlloyNN as JaxEamAlloyNN
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.ensemble import (EnsembleCalculator,
                                            select_by_uncertainty)
from tensoralloy_tpu_torch.io.model import load_model, model_from_dict

ROOT = Path(__file__).resolve().parent.parent
NI_MEMBERS = [str(ROOT / f"artifacts/{run}/model/snap_Ni.npz")
              for run in ("snap_ni_v4", "snap_ni_v5", "snap_ni_v5_readapt")]
TD_BE = str(ROOT / "artifacts/td_be/model/td_Be.npz")
REL = 1e-10
KEYS = ("energy", "free_energy", "forces", "stress", "pressure",
        "energy_std", "forces_std", "stress_std", "atomic_energies")


@pytest.fixture(autouse=True)
def jax_high_precision():
    """The JAX references at float64 ('high'), whatever an earlier test in
    the same process left: the JAX TrainingManager sets the global
    policy from its run's TOML."""
    from tensoralloy_tpu import set_precision
    set_precision("high")


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = max(np.max(np.abs(want)), 1e-300)
    assert np.max(np.abs(got - want)) <= rel * scale, what


def jittered_ni(reps=2, sigma=0.08, seed=3, a=3.52):
    base = np.array([[0, 0, 0], [.5, .5, 0], [.5, 0, .5], [0, .5, .5]])
    frac = np.concatenate([base + [i, j, k] for i in range(reps)
                           for j in range(reps) for k in range(reps)]) / reps
    cell = np.eye(3) * a * reps
    pos = frac @ cell + np.random.RandomState(seed).normal(
        scale=sigma, size=(len(frac), 3))
    symbols = ["Ni"] * len(pos)
    return (JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3),
            Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3))


@pytest.fixture(scope="module")
def ni_committees():
    return (JaxEnsemble(NI_MEMBERS),
            EnsembleCalculator(NI_MEMBERS, device="cpu", backend="pallas"))


def test_saved_members_match_jax(ni_committees):
    jcalc, calc = ni_committees
    js, s = jittered_ni()
    got, want = calc.calculate(s), jcalc.calculate(js)
    assert set(got) == set(want)
    for k in KEYS:
        _close(got[k], want[k], REL, k)
    assert calc.n_members == 3
    assert calc.get_energy_std(s) > 0 and calc.get_max_force_std(s) > 0


def test_mean_is_the_mean_of_single_members_and_models_equal_paths():
    _, s = jittered_ni(seed=5)
    singles = [TensorAlloyCalculator(p, device="cpu").calculate(s)
               for p in NI_MEMBERS]
    models = [load_model(p, device="cpu")[0] for p in NI_MEMBERS]
    res = EnsembleCalculator(models, device="cpu").calculate(s)
    for k in ("energy", "forces", "stress", "pressure"):
        _close(res[k], np.mean([r[k] for r in singles], axis=0), REL, k)
    _close(res["energy_std"], np.std([r["energy"] for r in singles]), 1e-8)
    f = np.stack([r["forces"] for r in singles])
    _close(res["forces_std"], np.linalg.norm(f.std(axis=0), axis=1), 1e-8)


def test_device_lists_route_matches_the_host_lists():
    """On device-built lists (no transpose tables) the members' forces
    and stress differentiate positions and cell: the same numbers."""
    _, s = jittered_ni(seed=8)
    host = EnsembleCalculator(NI_MEMBERS, device="cpu").calculate(s)
    dev = EnsembleCalculator(NI_MEMBERS, device="cpu",
                             device_nl=True).calculate(s)
    for k in ("energy", "forces", "stress", "energy_std", "forces_std"):
        _close(dev[k], host[k], REL, k)


def test_descriptors_are_evaluated_once_a_request(monkeypatch):
    """One descriptor evaluation (one launch of each kernel on the card)
    serves the three members' heads, forces and stress."""
    calc = EnsembleCalculator(NI_MEMBERS, device="cpu", backend="pallas")
    desc = calc.model.descriptor
    calls = []
    compute = desc.compute
    monkeypatch.setattr(desc, "compute",
                        lambda *a, **k: calls.append(1) or compute(*a, **k))
    _, s = jittered_ni(seed=6)
    calc.calculate(s)
    assert len(calls) == 1


def test_identical_members_have_zero_spread_and_td_heads():
    """A finite-temperature committee of two copies of td_Be: zero
    spread, the single calculator's U, S and F."""
    rng = np.random.RandomState(0)
    a, c = 2.2858, 3.5843
    cell = np.array([[a, 0, 0], [-0.5 * a, 0.5 * np.sqrt(3) * a, 0],
                     [0, 0, c]]) * np.array([[3], [3], [2]])
    frac = np.concatenate([np.array([[1 / 3, 2 / 3, 0.25],
                                     [2 / 3, 1 / 3, 0.75]]) + [i, j, k]
                           for i in range(3) for j in range(3)
                           for k in range(2)]) / [3, 3, 2]
    pos = frac @ cell + rng.normal(scale=0.03, size=frac.shape)
    s = Structure.from_symbols(["Be"] * len(pos), pos, cell, pbc=[True] * 3)
    s.info["etemperature"] = 0.1
    single = TensorAlloyCalculator(TD_BE, device="cpu").calculate(s)
    res = EnsembleCalculator([TD_BE, TD_BE], device="cpu").calculate(s)
    for k in ("energy", "free_energy", "eentropy", "forces", "stress"):
        _close(res[k], single[k], 1e-12, k)
    assert res["energy_std"] == pytest.approx(0.0, abs=1e-12)
    np.testing.assert_allclose(res["forces_std"], 0.0, atol=1e-12)


def test_eam_committee_through_the_analytic_efs_matches_jax():
    """Two zjw04 members, one with its embedding scaled: the analytic EFS
    of each member on the shared features, against the JAX committee."""
    js, s = jittered_ni(seed=7)
    fz = JaxFeaturizer(["Ni"], rcut=6.0)
    model = JaxEamAlloyNN(fz, Counter({"Ni": 32}), custom_potentials="zjw04")
    p0 = model.init_params(jax.random.PRNGKey(0))
    p1 = jax.tree_util.tree_map(lambda x: x * 1.02, p0)
    twins = []
    for p in (p0, p1):
        twin = model_from_dict(json.loads(json.dumps(model.as_dict())),
                               device="cpu", dtype=torch.float64)
        twin.load_param_tree(jax.tree_util.tree_map(np.asarray, p))
        twins.append(twin)
    calc = EnsembleCalculator(twins, device="cpu")
    assert calc.fast_efs
    got = calc.calculate(s)
    want = JaxEnsemble(model, [p0, p1]).calculate(js)
    for k in ("energy", "forces", "stress", "energy_std", "forces_std"):
        _close(got[k], want[k], REL, k)


def test_chunked_committee_matches_jax(monkeypatch):
    """chunked=True on row blocks of 12 (three blocks of the 32-atom cell)
    against the JAX committee's chunked route at float64, the descriptors
    evaluated once a block; "auto" takes the chunked route above
    chunk_auto_pairs and not below, as the JAX committee."""
    js, s = jittered_ni(seed=4)
    want = JaxEnsemble(NI_MEMBERS, chunked=True, chunk_size=12).calculate(js)
    calc = EnsembleCalculator(NI_MEMBERS, device="cpu", backend="pallas",
                              chunked=True, chunk_size=12)
    desc = calc.model.descriptor
    calls = []
    compute = desc.compute
    monkeypatch.setattr(desc, "compute",
                        lambda *a, **k: calls.append(1) or compute(*a, **k))
    got = calc.calculate(s)
    assert len(calls) == 3
    assert "atomic_energies" not in got and "atomic_energies" not in want
    for k in KEYS[:-1]:
        _close(got[k], want[k], REL, k)
    mono = EnsembleCalculator(NI_MEMBERS, device="cpu").calculate(s)
    for k in ("energy", "forces", "stress", "energy_std", "forces_std"):
        _close(got[k], mono[k], REL, k)
    for auto_pairs, chunks in ((100, True), (10 ** 9, False)):
        ens = EnsembleCalculator(NI_MEMBERS, device="cpu",
                                 chunk_auto_pairs=auto_pairs)
        jens = JaxEnsemble(NI_MEMBERS, chunk_auto_pairs=auto_pairs)
        res, jres = ens.calculate(s), jens.calculate(js)
        assert ("atomic_energies" not in res) is chunks
        assert ("atomic_energies" not in jres) is chunks
        _close(res["forces"], jres["forces"], REL)


def test_chunked_finite_temperature_committee_heads():
    """Two copies of td_Be on the chunked route: the single chunked
    calculator's U, S and F, zero spread."""
    import chip_smoke
    pos, cell = chip_smoke.jittered_hcp(seed=2)
    s = Structure.from_symbols(["Be"] * len(pos), pos, cell,
                               pbc=[True] * 3, etemperature=0.1)
    single = TensorAlloyCalculator(TD_BE, device="cpu", chunked=True,
                                   chunk_size=10).calculate(s)
    res = EnsembleCalculator([TD_BE, TD_BE], device="cpu", chunked=True,
                             chunk_size=10).calculate(s)
    for k in ("energy", "free_energy", "eentropy", "forces", "stress"):
        _close(res[k], single[k], 1e-12, k)
    assert res["energy_std"] == pytest.approx(0.0, abs=1e-12)


def test_nn_filter_members_use_their_own_descriptors():
    """Two 'nn'-filter GRAP members that differ in every weight, the
    filter's included: each member's descriptors are its own (one
    evaluation a member), the mean equals the mean of single members and
    the JAX committee over the same parameters."""
    from test_torch_grap_legacy_nn import model_pair, nn_kw
    from test_torch_host import mo_ni
    jmodel, p0, m0 = model_pair(nn_kw(2), seed=1)
    _, p1, m1 = model_pair(nn_kw(2), seed=2)
    symbols, pos, cell = mo_ni(seed=3)
    js = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3)
    calc = EnsembleCalculator([m0, m1], device="cpu")
    calls = []
    compute = calc.model.descriptor.compute
    calc.model.descriptor.compute = \
        lambda *a, **k: calls.append(1) or compute(*a, **k)
    got = calc.calculate(s)
    assert len(calls) == 2
    singles = [TensorAlloyCalculator(m, device="cpu").calculate(s)
               for m in (m0, m1)]
    assert abs(singles[0]["energy"] - singles[1]["energy"]) > 1e-3
    for k in ("energy", "forces", "stress"):
        _close(got[k], np.mean([r[k] for r in singles], axis=0), REL, k)
    want = JaxEnsemble(jmodel, [p0, p1]).calculate(js)
    for k in ("energy", "forces", "stress", "energy_std", "forces_std"):
        _close(got[k], want[k], REL, k)


def test_selection_by_uncertainty_matches_jax(ni_committees):
    jcalc, calc = ni_committees
    frames = [jittered_ni(sigma=sig, seed=10 + i)
              for i, sig in enumerate((0.02, 0.15, 0.05, 0.1))]
    got = select_by_uncertainty(calc, [f[1] for f in frames])
    want = jax_select_by_uncertainty(jcalc, [f[0] for f in frames])
    assert got == want
    scores = [calc.get_max_force_std(f[1]) for f in frames]
    assert [scores[i] for i in got] == sorted(scores, reverse=True)
    assert select_by_uncertainty(calc, [f[1] for f in frames],
                                 n_select=2) == got[:2]


def test_refusals(ni_committees):
    _, calc = ni_committees
    with pytest.raises(NotImplementedError):
        calc.get_hessian(jittered_ni()[1])
    # several ranks: the ValueError of too few devices outside a group of
    # them (tests/test_torch_parallel_analysis.py runs one), and JAX's
    # uneven split
    with pytest.raises(ValueError, match="n_shards=3 > available devices"):
        EnsembleCalculator(NI_MEMBERS, n_shards=3, device="cpu")
    for cls, kw in ((EnsembleCalculator, dict(device="cpu")),
                    (JaxEnsemble, {})):
        with pytest.raises(ValueError, match="not divisible by n_shards=2"):
            cls(NI_MEMBERS, n_shards=2, **kw)
    with pytest.raises(ValueError, match="at least 2"):
        EnsembleCalculator(NI_MEMBERS[:1], device="cpu")
    moni = str(ROOT / "artifacts/snap_moni/model/snap_MoNi.npz")
    with pytest.raises(ValueError, match="featurizer"):
        EnsembleCalculator([NI_MEMBERS[0], moni], device="cpu")
