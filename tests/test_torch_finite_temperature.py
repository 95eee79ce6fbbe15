"""The port's finite-temperature models against the JAX package at
float64: the trained td_Be.npz (GRAP + trunk + U/S heads) on a jittered
hcp Be cell, random-init BeNN and Sommerfeld models carried across with
`params_from_jax`, the calculator's U/S/F, and the JAX-reference fixture
that `chip_smoke.py` checks the card against."""
import json
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensoralloy_tpu.atoms import Structure as JaxStructure
from tensoralloy_tpu.calculator import (
    TensorAlloyCalculator as JaxCalculator)
from tensoralloy_tpu.io.model import load_model as jax_load_model
from tensoralloy_tpu.nn.finite_temperature import (
    TemperatureDependentAtomicNN as JaxTDNN)
from tensoralloy_tpu.nn.grap import GenericRadialAtomicPotential as JaxGRAP
from tensoralloy_tpu.nn.special import BeNN as JaxBeNN
from tensoralloy_tpu.ops.dense import make_dense_efs_fn as jax_dense_efs
from tensoralloy_tpu.transform import Featurizer as JaxFeaturizer
from tensoralloy_tpu_torch.atoms import Structure
from tensoralloy_tpu_torch.calculator import TensorAlloyCalculator
from tensoralloy_tpu_torch.io.model import (load_model, model_from_dict,
                                            params_from_jax, params_to_jax)
from tensoralloy_tpu_torch.nn.finite_temperature import (
    TemperatureDependentAtomicNN)
from tensoralloy_tpu_torch.ops.dense import make_dense_efs_fn

from test_torch_model import _features, _rel

ROOT = Path(__file__).resolve().parent.parent
MODEL = "artifacts/td_be/model/td_Be.npz"
FIXTURE = ROOT / "tests" / "data" / "torch_port_ref_td_be.json"
ETEMP = 0.1      # eV
REL = 1e-10
HEADS = ("energy_U", "eentropy", "free_energy_F")
# the same heads under the port's names: its E/F/S function returns the
# by-products of the differentiated pass, 'energy' being U
PORT_HEADS = {"energy_U": "energy", "eentropy": "eentropy",
              "free_energy_F": "free_energy"}


def _be_cell(seed=0):
    pos, cell = chip_smoke.jittered_hcp(seed=seed)
    return ["Be"] * len(pos), pos, cell


def _compare(jax_model, jax_params, model, feats):
    """U, S, F and the forces and stress of F in both packages."""
    want = jax.jit(jax_dense_efs(jax_model.variational_energy,
                                 lambda p, f: _heads_jax(jax_model, p, f)))(
        jax_params, {k: jnp.asarray(v) for k, v in feats.items()})
    t_feats = {k: torch.as_tensor(v) for k, v in feats.items()}
    got = make_dense_efs_fn(model.energy_and_aux)(t_feats)
    got = dict(got, **{k: got[v] for k, v in PORT_HEADS.items()},
               energy=got["free_energy"])
    np.testing.assert_allclose(
        float(model.variational_energy(t_feats).detach()),
        float(got["energy"]),
        rtol=1e-12)
    for key in ("energy", "forces", "stress_voigt") + HEADS:
        assert _rel(got[key].numpy(), want[key]) <= REL, key
    t = float(feats["etemperature"])
    assert abs(float(got["free_energy_F"]) - (
        float(got["energy_U"]) - t * float(got["eentropy"]))) < 1e-9
    np.testing.assert_allclose(float(got["energy"]),
                               float(got["free_energy_F"]), rtol=1e-12)
    return got


def _heads_jax(model, params, feats):
    ops = model.energy_ops(params, feats)
    return {"energy_U": ops["energy"], "eentropy": ops["eentropy"],
            "free_energy_F": ops["free_energy"]}


def test_td_be_matches_jax():
    """The trained td_Be.npz, upcast to float64, backend 'pallas', at an
    electron temperature of 0.1 eV."""
    jax_model, params, _ = jax_load_model(MODEL)
    jax_model.descriptor.backend = "pallas"
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                    params)
    model, _ = load_model(MODEL, device="cpu", dtype="high",
                          backend="pallas")
    assert isinstance(model, TemperatureDependentAtomicNN)
    symbols, pos, cell = _be_cell(seed=3)
    jax_model = jax_model.clone_for(Counter(symbols))
    model = model.clone_for(Counter(symbols))
    feats = _features(jax_model.featurizer, symbols, pos, cell)
    feats["etemperature"] = np.asarray(ETEMP)
    got = _compare(jax_model, params, model, feats)
    assert float(got["eentropy"]) != 0.0


@pytest.mark.parametrize("cls,algo", [("BeNN", "default"),
                                      ("TemperatureDependentAtomicNN",
                                       "sommerfeld")])
def test_random_init_td_models_match_jax(cls, algo):
    """Random-init BeNN (semi-analytic entropy head) and a Sommerfeld
    model (hidden [8], trunk [16, 8], min-max scaling), weights carried
    into the port with params_from_jax."""
    symbols, pos, cell = _be_cell(seed=1)
    fz = JaxFeaturizer(["Be"], rcut=4.5)
    desc = JaxGRAP(["Be"], algorithm="pexp",
                   parameters={"rl": [1.0, 2.0, 3.0], "pl": [2.0, 3.0, 4.0]},
                   moment_tensors=[0, 1, 2], backend="pallas")
    jax_cls = {"BeNN": JaxBeNN, "TemperatureDependentAtomicNN": JaxTDNN}[cls]
    jax_model = jax_cls(fz, Counter(symbols), desc, layers=[16, 8],
                        eentropy_algo=algo, hidden_sizes=[8],
                        atomic_static_energy={"Be": -3.0})
    params = jax_model.init_params(jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)
    lo = rng.uniform(0.0, 0.5, jax_model.feature_dim)
    params["Be"]["norm"] = {"xlo": jnp.asarray(lo), "xhi": jnp.asarray(
        lo + rng.uniform(1.0, 3.0, jax_model.feature_dim))}
    model = model_from_dict(jax_model.as_dict(), dtype=torch.float64)
    assert type(model).__name__ == cls
    assert model.as_dict() == jax_model.as_dict()
    model.load_state_dict(params_from_jax(params))
    feats = _features(fz, symbols, pos, cell)
    feats["etemperature"] = np.asarray(0.3)
    _compare(jax_model, params, model, feats)


def test_td_params_round_trip():
    """The trunk/head_u/head_s tree survives JAX -> port -> JAX."""
    _, params, _ = jax_load_model(MODEL)
    assert set(params["Be"]) == {"trunk", "head_u", "head_s", "norm"}
    back = params_to_jax(params_from_jax(params))
    leaves = jax.tree_util.tree_leaves_with_path(params)
    back_leaves = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in leaves] == [p for p, _ in back_leaves]
    for (_, a), (_, b) in zip(leaves, back_leaves):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert np.asarray(a).dtype == b.dtype


# ----------------------------------------------------------------------
def reference_record():
    """The Be request at 0.1 eV and the U, S, F, forces and stress the
    JAX package computes for it at float64 with the model as saved."""
    symbols, pos, cell = _be_cell()
    s = JaxStructure.from_symbols(symbols, pos, cell, pbc=[True] * 3,
                                  etemperature=ETEMP)
    calc = JaxCalculator(MODEL)
    res = calc.calculate(s)
    return {"model": MODEL,
            "structure": "hcp Be 3x3x2, a=2.2858 A, c=3.5843 A, "
                         "N(0, 0.05 A) jitter, numpy default_rng(0)",
            "etemperature": ETEMP,
            "precision": "float64",
            "units": "eV, eV/A, eV/A^3 (Voigt xx yy zz yz xz xy); "
                     "eentropy in k_B (T in eV, F = U - T S)",
            "positions": s.positions.tolist(), "cell": s.cell.tolist(),
            "energy": float(res["energy"]),
            "eentropy": float(res["eentropy"]),
            "free_energy": float(res["free_energy"]),
            "forces": np.asarray(res["forces"]).tolist(),
            "stress": np.asarray(res["stress"]).tolist()}


def test_td_be_fixture_is_current(monkeypatch):
    """The fixture `chip_smoke.py` checks the Be request against is what
    the JAX package computes today, and the port's calculator reproduces
    it: U, S, F, forces and stress."""
    monkeypatch.setenv("TENSORALLOY_TPU_NO_NATIVE", "1")
    stored = json.loads(FIXTURE.read_text())
    fresh = reference_record()
    for key in ("positions", "cell"):
        np.testing.assert_array_equal(np.asarray(stored[key]),
                                      np.asarray(fresh[key]))
    keys = ("energy", "eentropy", "free_energy", "forces", "stress")
    for key in keys:
        assert _rel(stored[key], fresh[key]) <= REL, key
    s = Structure.from_symbols(["Be"] * len(stored["positions"]),
                               stored["positions"], stored["cell"],
                               pbc=[True] * 3,
                               etemperature=stored["etemperature"])
    calc = TensorAlloyCalculator(str(ROOT / MODEL), device="cpu",
                                 backend="pallas")
    res = calc.calculate(s)
    for key in keys:
        assert _rel(res[key], stored[key]) <= REL, key
    assert calc.get_electron_entropy() == res["eentropy"]
    assert calc.get_free_energy() == res["free_energy"]
    assert calc.get_potential_energy() == res["energy"]
    # a structure at another electron temperature is recalculated
    hot = s.copy()
    hot.info["etemperature"] = 0.2
    assert calc.get_electron_entropy(hot) != res["eentropy"]


def test_td_request_evaluates_descriptors_once():
    """U, S, F, the atomic energies, forces and stress of a
    finite-temperature request come out of one pass over the descriptor
    (on the card: one launch of `grap_kernel`)."""
    from test_torch_calculator import count_descriptor_evaluations
    symbols, pos, cell = _be_cell(seed=2)
    s = Structure.from_symbols(symbols, pos, cell, pbc=[True] * 3,
                               etemperature=ETEMP)
    calc = TensorAlloyCalculator(str(ROOT / MODEL), device="cpu",
                                 backend="pallas")
    assert count_descriptor_evaluations(calc, s) == 1
    res = calc.results
    np.testing.assert_allclose(res["atomic_energies"].sum(), res["energy"],
                               rtol=1e-12)
    np.testing.assert_allclose(
        res["free_energy"], res["energy"] - ETEMP * res["eentropy"],
        rtol=1e-12)


def test_electron_entropy_needs_a_finite_temperature_model():
    calc = TensorAlloyCalculator(
        str(ROOT / "artifacts/snap_ni_v5_readapt/model/snap_Ni.npz"),
        device="cpu")
    pos, cell = chip_smoke.jittered_fcc(1)
    s = Structure.from_symbols(["Ni"] * 4, pos, cell, pbc=[True] * 3)
    with pytest.raises(ValueError, match="electron-entropy"):
        calc.get_electron_entropy(s)
    assert calc.get_free_energy() == calc.get_potential_energy()
